#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its numbers on lines of its own):
  1. the card's name and power limit, then the kernels' build (one nvcc per
     source, started together), and the count of HGMMA (wgmma) and UTMALDG
     (TMA load) instructions in the SASS of every bf16/fp16 library (B1/B2,
     B3, B4, the backward; W8A16's also LDGSTS, the cp.async of the kernel
     kept for unaligned rows, and HMMA, the mma.sync of the streaming
     kernel), and of
     FFMA and SHFL in every fp32 library's
     (every fp32 kernel runs simt_f32.cuh's shuffle-free products: B3 has
     no SHFL at all, the others keep them to their softmax row reductions
     and the backward's delta pre-pass); then each B1/B2/B3 instantiation
     of the bf16 and fp16 libraries with its registers, stack and local
     bytes (cuobjdump --dump-resource-usage) and ptxas's spill bytes, and a
     failure if one of NO_SPILL_KERNELS (the DiT widths' B1/B2 ping-pong
     and B3 cluster kernels) spills;
  2. every kernel against its plain twin at every shape the paths launch
     it at (batch 2), plus a ragged shape, in bf16 and fp32 (each kernel
     also in fp16 at one shape): errors against the stated tolerances, and
     for each shape the kernel's, the twin's and the one PyTorch library
     call's times beside the least time the card needs.  Only what the
     kernels line takes is timed: the contiguous B1/B2/B3 inputs (the paths
     hand head-split views), the ragged shapes, B4's head-split views and
     fp16 are held to the twins untimed.  B1, B2 and B3 are
     also checked on the head-split views the paths hand them (the
     (B, H, S, D) view of a (B, S, H*D) projection, read in place) at every
     path shape and at ragged d=64, d=40 (and, for B1, d=512) shapes; those
     bf16 numbers are the kernels line's.  Kernels and library calls are timed as CUDA graphs
     of 20 calls (graph_ms: device time, the host's launch cost out of the
     way) and also in a loop of calls (call_loop_ms); the twins in a loop.
     W8A16 (int8 weight-only dense, compare_int8) at every (M, K, N) of
     phase 16f's int8 Flux extract and of T5-XXL's encode at 512 and 1024
     rows in bf16, at INT8_ONE_SHAPE in fp16 and fp32, and at the ragged
     INT8_RAGGED in every type: relative L2 and the worst element within
     TOL, which of its kernels served the shape (quant.int8_route: the TMA
     kernel's 128- or 256-row tiles, the streaming kernel, or the cp.async
     kernel) and whether bf16 equals the twin bit for bit, beside the
     kernel the twin, the bound, F.linear on the
     dequantized weight (matmul_ms), the dequantize and that GEMM
     (dequant_matmul_ms) and torch._weight_int8pack_mm (library_ms, the
     same product without the bias);
  3. SDXL at full width (random weights from a seed), 1024^2, batch 2:
     FeatureExtractor('xl-practical') -> encode_prompt -> extract(t=50);
     tap shapes, dtype and finiteness, exactly 71 B1 launches, and the taps
     against the same step with every kernel call on its plain twin;
  4. that extract timed call by call with CUDA events after two untimed
     calls (TIMED_CALLS of them):
     median ms and img/s, and peak memory;
  5. path A, SD-1.5 at full width, 512^2, batch 2, the correspondence
     config's second extractor with 'up_self' added:
     FeatureExtractor('15-amalgamation', version='1-5',
     attention=['up_cross', 'up_self']): exactly 7 B1, 3 B2 and 3 B3
     launches, the taps and 'attn' (2, 1434, 64, 64) in bf16 and finite,
     the same step on the twins within 2e-2 relative L2, and its timing;
  6. path B, the attention store on SDXL: FeatureExtractor('xl-practical',
     version='xl', attention=['up_self']) at 1024^2: exactly 35 B1, 36 B2
     and 36 B3 launches, 'attn' (2, 5120, 128, 128), the twin step, timing;
  7. the port's CLI in-process (extract_feature.main) from a temporary
     working directory: SDXL 'xl-practical' at 1024^2 over 3 seeded images
     in batches of 2 and 1; the .npy tree (every layer, train0..train2,
     the enumerated shapes, fp16, finite), exactly 142 B1 launches and no
     B4, the native dump writer active, and img/s from the first batch to
     the writer's close; then --show_all_layers for xl@1024 (612 ids) and
     1-5@512 (197 ids), timed.  The CLI loads its weights from phase 8's
     tree (--weights, --weights_variant bf16);
  8. SDXL from a checkpoint, the slice at full width (run between phases 4
     and 5): phase 3's extractor writes its U-Net (two shards), VAE
     encoder and both text encoders with config.json files as a diffusers
     tree of the 'bf16' variant (~6.8 GB; the card's machine has room for it
     twice); FeatureExtractor(weights=..., weights_variant='bf16') loads it:
     parameters torch.equal to the source's, its peak memory while loading
     within 5% of the random-init build's, the step on injected noise
     torch.equal with 71 B1 launches, and its first public extract equal to
     the source's first (phase 3's: the noise stream does not depend on the
     init); then a rank-4 peft LoRA over to_q/to_v of one level-2
     transformer block, loaded with offline_lora: one merged weight against
     W + (alpha/r)*up@down computed on the card in fp32, within bf16
     rounding, and finite features that differ from the unmerged ones.
     Write and load seconds and GB/s per component are printed;
  9. SDXL multi-step at full width, 1024^2: 'xl-practical' plus 'vae-out',
     extract(t=50, denoising_from=60): 10 walk forwards and the last one,
     exactly 772 B1 launches (the VAE encoder's, 11 U-Net forwards of 70,
     the decoder's mid block), 'vae-out' (2, 3, 1024, 1024) in bf16 and
     finite, the same extract on the twins within MULTISTEP_REL_TOL
     relative L2, its timing over 3 calls and its peak memory;
 10. Playground v2 ('pgv2') at 1024^2 with 'pg-amalgamation' at t=50, the
     correspondence config's third extractor: 71 B1 launches, the twin
     step, its timing;
 11. SD-2.1 ('2-1') at 512^2, '15-amalgamation' with attention=['up_cross',
     'up_self']: 7 B1 (bf16) and 3 B2 and 3 B3 in fp32 (upcast_attention),
     'attn' (2, 1434, 64, 64), the twin step, its timing; then one
     extract(t=50, use_ddim_inversion=True): 5 inversion forwards of 10 B1
     each and the last forward's 7 B1, 3 B2 and 3 B3, finite features;
 12. generation (after 7): (a) the port's generate_with_extraction.main at
     its defaults from a temporary working directory (SD-1.5, 512^2,
     '15-practical', 50 PNDM steps = 51 U-Net calls, guidance 7.5): a
     512x512 PNG, the kept calls exactly {1, 10, 20, 30, 40} for every
     layer, each over the CFG-doubled batch 2 and finite, and B1 launches
     equal to those derived from the config (51 x 10; the 512^2 decoder's
     head stays explicit); (b) SDXL sample() at 1024^2, batch 1, 50 Euler
     steps, guidance 5.0, one up-level tap: images (1, 3, 1024, 1024) in
     [0, 1], 50 x 70 + 1 (the decoder) B1 launches, then a timed sample (ms
     per sample and per step, peak memory); (c) the SD-1.5 sample at 4 steps
     (5 calls) on the kernels and on the twins: images and every tap
     encounter within MULTISTEP_REL_TOL; (d) the 50-step SD-1.5 sample in
     bf16 (timed) and in fp32 (the same weights, upcast) from one fp32
     draw: relative L2 and cosine of the final latents and images, the
     cosine of the taps at calls 1/10/20/30/40, gated on finiteness only;
 13. ControlNet and depth: a random tree in a temporary dir (phase 12's
     SD-1.5 weights as a diffusers tree; controlnet_canny and
     controlnet_depth with SD-1.5's encoder and the (16, 32, 96, 256)
     conditioning stack, every weight drawn, the zero convs too; an
     Intel/dpt-large-shaped depth_estimator in transformers' keys, fp32),
     loaded with FeatureExtractor('15-amalgamation', version='1-5',
     weights=..., control=['canny', 'depth']); extract(t=50,
     use_control=True) at batch 2: 10 + 2 x 4 B1 launches (the U-Net, each
     ControlNet's levels 0 and 1), finite taps that differ from the step
     without control, the twin step within TAP_REL_TOL, its timing and peak
     memory; the host time of canny_edges and of the DPT estimator per
     512^2 image (and the DPT forward on the card); then the CLI with
     --weights and --control canny depth over three seeded 512^2 images:
     36 B1 launches and the .npy tree;
 14. PixArt (after 13), random weights from seed 0, bf16, batch 2, t=50,
     the JAX benchmark's DiT taps (vit-block13-out, vit-block20-out,
     vit-block20-cross-q, vit-block27-out): (a) pixart-sigma at 1024^2
     (28 blocks of 16 heads x 72 over 4096 tokens, T5-XXL over 300
     tokens): 29 B1 launches (the 28 self-attentions and the SDXL VAE's
     d=512 head), (b) the same with attention=['up_cross', 'up_self']:
     1/28/28 and 'attn' (2, 300 + 4096, 128, 128), (c) pixart-alpha at
     512^2: 28 B1; each with its features, the same step on the twins
     within TAP_REL_TOL and its timing; (d) (a)'s extractor written by
     save_weights (T5-XXL in 4 shards, ~11 GB in all) and loaded back:
     parameters, prompts and the first public extract torch.equal, load
     GB/s, load peak within LOAD_PEAK_RATIO; (e) the CLI on that tree
     over 3 images (58 B1); (f) generate_with_extraction on pixart-alpha
     at 512^2 with the DiT taps and its defaults (50 DPM-Solver steps,
     guidance 7.5, calls 1/10/20/30/40 kept): 1400 B1, the sample timed,
     then a 4-step sample on the kernels and on the twins within
     MULTISTEP_REL_TOL.  The counts come from the config through the JAX
     package's gate, with no head-width condition (dit_launches), so a
     width the card's kernels lack fails them.
 15. HunyuanDiT (after 14), random weights from seed 0, bf16, batch 2,
     t=50, the JAX benchmark's taps (vit-block{13,20,27,39}-self-q):
     (a) 'hunyuan' at 1024^2 (40 blocks of 16 heads x 88 over 4096
     tokens, BERT over 77 and mT5 over 256 tokens): 41 B1 launches (the
     40 self-attentions and the SDXL VAE's d=512 head); (d) its extractor
     written by save_weights (~7.9 GB, mT5 in 2 shards) and loaded back:
     parameters, prompts and the first public extract torch.equal, load
     GB/s, load peak within LOAD_PEAK_RATIO, then the CLI on the tree over
     3 images (82 B1); (b) (a) with attention=['up_cross', 'up_self']:
     the store takes the explicit path, as in JAX, so 1/0/0 and 'attn'
     (2, 333 + 4096, 128, 128); (c) 'hunyuan' at 512^2: 40 B1 at 1024
     tokens; each with the same step on the twins within TAP_REL_TOL and
     its timing; (e) generate_with_extraction on 'hunyuan' at 512^2 with
     the taps (50 DDPM steps, guidance 7.5): 2000 B1, the sample timed,
     then a 4-step sample on the kernels and on the twins (the same DDPM
     step noise) within MULTISTEP_REL_TOL.  Counts from dit_launches.
 16. Flux.1-dev (after 15), random weights from seed 0, bf16, t=50, the
     JAX benchmark's taps (vit-block18-out, vit-block18-q, vit-block37-out,
     vit-block56-out): (a) 'flux' at 1024^2, batch 2 (19 dual and 38
     single blocks of 24 heads x 128 over 512 T5 + 4096 image tokens,
     CLIP-L and T5-XXL): 58 B1 launches (the 57 joint attentions and the
     Flux VAE's d=512 head); (d) its extractor written by save_weights
     (~34 GB: the transformer in FLUX_TRANSFORMER_SHARDS files, T5-XXL in
     FLUX_TEXT_SHARDS), its parameters' fingerprints and first features
     kept and the source freed (two do not fit the card together), loaded
     back: fingerprints, prompts and the first public extract equal, load
     GB/s, load peak within LOAD_PEAK_RATIO, then the CLI on the tree over
     3 images (116 B1); (b) (a) with attention=['up_cross', 'up_self']:
     every block explicit, as in JAX, so 1/0/0 and 'attn'
     (2, 512 + 4096, 128, 128); (c) 'flux' at 512^2 (1536 joint tokens):
     57 B1 (the 512^2 VAE head stays explicit); each with the same step on
     the twins within TAP_REL_TOL and its timing; (e) generate_with_extraction
     on 'flux' at 512^2 with the taps, 28 steps and guidance 3.5 (no CFG
     batch: the guidance embedding takes it): 28 x 57 B1, the sample timed,
     then a 4-step sample on the kernels and on the twins within
     MULTISTEP_REL_TOL.  Counts from dit_launches.  (d)'s loaded-back
     checks ask for bf16 (transformer_8bit=False, t5_8bit=False); its CLI
     runs at the JAX defaults, which load the tree in int8: 495 W8A16
     launches per batch and 168 for the prompt, at the shapes the config
     gives (flux_int8_calls, t5_int8_calls), and its img/s.  (f) the
     int8 Flux (the JAX auto rule) on (d)'s tree, FeatureExtractor with no
     int8 keyword: both spec flags on, load GB/s, the load's peak within
     INT8_LOAD_PEAK_RATIO of the resident bytes plus the largest staged
     bf16 weight, three layers' weight_q and scale equal bit for bit to
     numpy's quantization of the tree's tensors; encode_prompt's 168 and
     one extract's 495 W8A16 launches (and 58 B1) at the derived shapes;
     the features; the step with every W8A16 and B1 call on its twin
     within TAP_REL_TOL; each tap's cosine against (a)'s bf16 features from
     the same draws (>= INT8_COSINE); its timing, and its peak at least
     INT8_PEAK_SAVING_GIB below (a)'s.  (g) after (f) and phase 22's Flux
     part, the last readers of (d)'s tree: its weight files deleted, (f)'s
     extractor written by save_converted as a deployment bundle (~17 GB:
     the int8 transformer and T5-XXL, bf16 CLIP-L and VAE) and loaded back
     with no int8 keyword: both flags from the manifest, every tensor
     torch.equal to (f)'s, the load's peak within INT8_LOAD_PEAK_RATIO of
     the resident bytes (nothing is quantized or staged in bf16), 168 and
     495 W8A16 launches at the derived shapes and 58 B1, the prompts and
     first features torch.equal to (f)'s, the load seconds beside (f)'s;
     the bundle deleted after.
 17. DeepFloyd IF (after 16), random weights from seed 0, the JAX
     benchmark's taps (up-level{1,2}-repeat0-res-out, unet-out): (a) 'if'
     at its native 64^2, batch 2, t=50 (the IF-I-L preset in pixel space,
     T5-XXL over 77 tokens): 0/0/0/0 launches (every added-KV attention
     has 77 + S keys, which the gate refuses: if_launches derives the
     counts through it), the enumerated shapes, its timing (ms, host
     enqueue, peak GiB); (b) the same step in fp32 with the same weights
     and draws: relative L2 and cosine per tap (no kernel, so no twin
     check), then a 4-step sample with CFG in bf16 against fp32 within
     MULTISTEP_REL_TOL; (c) denoising_from=60 (10 thresholded walk steps,
     then the tapped forward): 0/0/0/0, shapes, timing; (d) its tree
     written by save_weights (unet, T5-XXL in IF_TEXT_SHARDS files, no
     VAE) and loaded back: parameters, prompts and the first public
     extract torch.equal, load peak within LOAD_PEAK_RATIO, then the CLI
     on the tree over 3 images; (e) generate_with_extraction on 'if' at
     64^2 with the taps, 50 DDPM steps, guidance 7.0 (CFG batch 2): the
     kept calls, 0 launches, the sample timed.
 18. external_model (after phase 8, on phase 3's SDXL extractor): a
     second extractor with phase 6's request ('xl-practical',
     attention=['up_self']) over phase 3's tensors: under 1% added to
     torch.cuda.memory_allocated, every parameter's data_ptr the
     source's, phase 6's launch counts (35/36/36/0), the source's next
     extract still its own taps only; in phase 6, its first extract
     torch.equal to phase 6's fresh extractor's (same request and seed).
 19. training (after phase 17): (a) the flash backward kernel against its
     twin (JAX's VJP) on head-split views at BWD_SHAPES, the paths' fp32
     and bf16 shapes and one shape at every other width, and at the ragged
     (1000, 333) pair in every type (BWD_RAGGED): relative L2 and
     the worst element of dq, dk, dv against TOL, the kernel's time as
     CUDA graphs, the twin's, the bound (five products, 10 B H Sq Sk D
     flops) and SDPA's backward for the same function (timed only);
     (b) seg_configs/ade_sdxl.json through the port's
     train_segmentation.main at full width (SDXL 1024^2 bf16 frozen, head
     of 512 channels, 150 classes, crop 512, batch 2) on synthetic pairs
     in a temporary dir: SEG_ITERS steps, a val pass with slide
     inference, then --resume --eval_only reproducing the mIoU; 71 B1 and
     0 backward launches per extract, finite losses, ms per step (median
     after the first) and peak GiB; (c) seg_configs/ade_vpd.json (SD-1.5
     512^2 fp32, prompt tuning over the 150-name prompt) for VPD_ITERS
     steps: B1/B2/backward launches per step as prompt_tuning_launches
     derives them from the config and taps, meta_prompt's gradient finite,
     non-zero and within TAP_REL_TOL of the same step's on the twins (the
     twins' extraction backward from the step's own cotangent at the
     features; the twins' whole step is printed, not held: the head's ReLUs
     and the Lovasz order amplify one fp32 rounding there), ms per step and
     peak GiB; (d) train_unet=True on SD-1.5 512^2 fp32, one
     backward of a loss on TRAIN_UNET_TAPS (unet-out included): 0/10/10
     B1/B2/backward launches (grad_launches), every U-Net parameter a
     finite gradient,
     all of them within TAP_REL_TOL (relative L2) of the twins'.
 20. correspondence (after phase 19), SPair-style synthetic pairs in a
     temporary dir (images of unequal sizes, ~10 annotated points, a
     category and the target's bounding box): (a) the port's
     task_corres.main on corres_configs/config_sdxl.json (SDXL 1024^2,
     'xl-practical', 3840 channels, bf16 frozen, the fp32 3x3 conv) for
     CORRES_STEPS steps, a validation over CORRES_VAL_PAIRS pairs at the
     last and its checkpoint, then one step more resumed from it
     (--load_weight): finite losses, both PCKs in [0, 1], 71 B1 launches
     per image (b1_per_forward + vae_b1) and no backward, one pair's
     features (both images, each member) on the kernel path within
     TAP_REL_TOL (relative L2) of the twin path's (the same noise), and
     the clip_loss on them within CORRES_LOSS_TOL (at random weights it is
     near ln(128^2) whatever the features: the features' check is the one
     that holds the path); ms per step (median
     after the first), ms per validation pair, peak GiB; (b) one step of
     the three-extractor corres_configs/config_xl_t.json (xl 1024^2, SD-1.5
     512^2 with 'up_cross' maps, pgv2 1024^2; 8154 -> 4077 channels): the
     B1 launches of each member, measured around its extracts, against the
     config's, the step's ms and the peak GiB.
 21. label-scarce (after phase 20): the port's extraction CLI with
     --aggregate_output on PIXEL_IMAGES synthetic images (the 'xl' path in
     batches of 2, 71 B1 per batch), then task_pixel.main (horse_21,
     PIXEL_TRAIN training images, 2 members, 1 epoch) on those dumps and
     synthetic 256^2 label PNGs:
     the native .npy reader active, 2 member checkpoints, then a second
     main that loads them and trains none, the predictions and
     visualisations written, a finite mIoU and uncertainty; one member
     more with no room on the card (the matrix on the host, each batch
     copied over) equal to the first run's member 0; ms per member,
     training rows per second, predict ms per image, the reader's GB/s
     over the dumps (just written: a warm read).
 22. the mesh (parallel/mesh.py): two rank processes on cuda:0 joined over
     gloo, which carries CUDA tensors through the host (NCCL takes one
     rank per card); after phase 21 this process runs the single-device
     references, frees its models and spawns them for (a), (b), (d)'s
     PixArt and (e); (c) and (d)'s Flux run in phase 16, after 16f, while
     its tree exists (the card's machine counts every byte written to its
     disk against a 45 GiB limit, so the ~34 GB tree is written once and
     lives no longer).  dp's one departure from one device is the batch
     its kernels and GEMMs see (each rank runs its rows), so (a) and (e)
     hold each rank to a one-device witness that runs every extract one
     row at a time from the whole batch's noise (rows_one_at_a_time), and
     show a planted fault beyond the same bound.  (a) the CLI --dp 2 on
     the 'xl' path over MESH_CLI_IMAGES images at batch 2, each rank two
     extracts at batch 1 (its 142 B1 launches the --dp 1 run's count), the
     dump tree named as --dp 1's, each file within MESH_ROWS_REL of the
     witness's and within TAP_REL_TOL of --dp 1's, and the tree of
     --batch_size 1 (each row its own noise, the fault) beyond
     MESH_ROWS_REL of the witness's; (b) SDXL 1024^2 at
     tp=2, 'xl-practical' plus a q and an FFN inner tap and the up_self
     store: phase 6's 35/36/36 launches per rank on 5 and 10 heads, every
     tap and 'attn' within TAP_REL_TOL of tp=1; (c) the int8 Flux at tp=2
     from phase 16d's tree (transformer_8bit=True: the auto rule is off
     under tp): each rank's resident transformer the bytes the config
     gives for its cut (tp_resident_bytes), 58 B1 and the W8A16 launches at the
     shard shapes flux_int8_calls(tp=2) derives, with the kernel
     int8_route picks for each, every tap's cosine against 16f's at least
     MESH_COSINE; (d) sp=2 on PixArt-Sigma 1024^2 bf16 (B1 at (2, 16, 2048,
     4096, 72)) and on the int8 Flux of the auto rule (B1 at 2560 and 2304
     queries against 4608 keys, W8A16 at the token shards), each within
     TAP_REL_TOL of phase 14a's and 16f's features; (e) train_segmentation
     --dp 2 on seg_configs/ade_full.json (xl + pgv2), 2 steps, TF32 off,
     against the --dp 1 witness: the first step's loss within
     MESH_LOSS_REL, its gradients (after the dp average) within
     MESH_GRAD_REL and what it changed in the BatchNorm running
     statistics within MESH_STATS_REL relative L2, every loss within
     MESH_LOSS_REL of plain --dp 1's, the parameters whose first gradient
     is fp32 noise moved at most the steps' rates; the planted fault, rank
     0's own first gradients (the step with the average left out), beyond
     MESH_GRAD_REL (each run's 8.7 GB checkpoint goes to a CountingSink,
     not to the disk); each sub-phase with its seconds and each rank's
     peak GiB; (f) one NCCL world of size 1 through make_mesh(dp=1): its sd15_store extract
     torch.equal to the plain one, and an all_reduce on the card.  The
     ranks' launches and shapes join the kernels line.
Phase 2 also holds B2 and B3 in fp32 at phase 11's store shape (the fp32
kernels, timed against the fp32 non-tensor peak), B3 in fp32 on head-split
views at every STORE_SHAPES entry and B4 in fp32 at every SHORT_SHAPES
entry (the kernels line's 'float32_shapes', SDPA in fp32 as B4's library
call), and B4 (short
attention), which no path routes to, as in the JAX package: against its
twin, with its gradients through short_attention_diff, at the 256-token
bands of SD-1.5 and SDXL at 512^2, the JAX docstring's measured (16, 20,
256, {256, 77}, 64) and a ragged shape, on contiguous tensors and on
head-split views, with its time beside B1's, SDPA's and the explicit
path's there, all (its twin too) timed as CUDA graphs of 20 calls.
Phase 2's shapes include PixArt's d=72 self-attention at 4096 and 1024
tokens for B1, B2 and B3 (and B4 at 256 tokens, with d=72 in its width
tuple), with ragged head-split d=72 shapes (a 144-byte head stride), and
HunyuanDiT's d=88 at the same shapes (a 176-byte head stride; B2 and B3
have no caller at d=88, their numbers are the kernels line's
'no_caller_shapes'), each in bf16, fp32 and fp16.  B1 is held in bf16 at
Flux's four joint-attention shapes (FLUX_B1_SHAPES) on contiguous q/k/v,
the layout the concatenation and RoPE hand it, and at phase 22's head and
token shards (TP_FLUX_B1_SHAPES, SP_FLUX_B1_SHAPES); B1, B2 and B3 at
SDXL's head shards (TP_B1_SHAPES, TP_STORE_SHAPES) and B1 at PixArt's
token shard (SP_B1_SHAPES), on head-split views.
Every path runs with all four counts set to 0 and expects 0 B4 launches.
Launches are recorded with their dtype, and the kernels line sums each
(shape, dtype)'s numbers.
The last line is {"ok": true, "device": {...}}; before it come the card line
and a {"kernels": [...]} line.  Exits non-zero, without the last line,
when there is no CUDA device or any phase fails.

PATHS, open_path and extract_times are also what tools/torch_extract_ab.py
and tools/torch_extract_profile.py time, so their numbers are of the same
paths.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# (b, h, sq, sk, d): the shapes the paths launch each kernel at (batch 2)
B1_SHAPES = [
    (2, 10, 4096, 4096, 64),    # SDXL U-Net level-1 self-attention
    (2, 20, 1024, 1024, 64),    # SDXL U-Net level-2 and mid self-attention
    (2, 1, 16384, 16384, 512),  # SDXL VAE mid-block single head
    (2, 8, 4096, 4096, 40),     # SD-1.5 U-Net level-0 self-attention @512^2
    (2, 8, 1024, 1024, 80),     # SD-1.5 U-Net level-1 self-attention @512^2
    (2, 8, 1024, 1024, 160),    # SD-1.5 U-Net level-2 self-attention @1024^2
    (2, 16, 4096, 4096, 72),    # PixArt-Sigma DiT self-attention @1024^2
    (2, 16, 1024, 1024, 72),    # PixArt-alpha DiT self-attention @512^2
    (2, 16, 4096, 4096, 88),    # HunyuanDiT self-attention @1024^2
    (2, 16, 1024, 1024, 88),    # HunyuanDiT self-attention @512^2
]
STORE_SHAPES = [                # B2 and B3: the attention store's self-attentions
    (2, 8, 1024, 1024, 80),     # path A: SD-1.5 up-level2
    (2, 20, 1024, 1024, 64),    # path B: SDXL up-level0
    (2, 10, 4096, 4096, 64),    # path B: SDXL up-level1
    (2, 16, 4096, 4096, 72),    # phase 14b: PixArt-Sigma's blocks @1024^2
    (2, 16, 1024, 1024, 72),    # PixArt @512^2
    # HunyuanDiT's heads @512^2 and @1024^2: no caller (its store and maps
    # take the explicit path, as in JAX), built and held all the same
    (2, 16, 1024, 1024, 88),
    (2, 16, 4096, 4096, 88),
]
D88_STORE_SHAPES = STORE_SHAPES[-2:]
# B1 at Flux's joint attention, bf16, contiguous (the path's layout): 512
# T5 + 4096 image tokens at 1024^2 and 512 + 1024 at 512^2, 24 heads x 128,
# batch 2 and the CLI's trailing batch of 1
FLUX_B1_SHAPES = [(2, 24, 4608, 4608, 128), (1, 24, 4608, 4608, 128),
                  (2, 24, 1536, 1536, 128), (1, 24, 1536, 1536, 128)]
# phase 11: SD-2.1's upcast store hands B2 and B3 fp32 q, k and v
FP32_STORE_SHAPES = [(2, 10, 1024, 1024, 64)]   # SD-2.1 up-level2 @512^2
RAGGED = (1, 2, 1000, 333, 64)
# B1/B2/B3 on head-split views: ragged lengths at d=40 (TMA zero-fills the
# columns up to the mma depth), at d=72 (144-byte head stride; zero fill up
# to depth 80, the epilogue stops at column 72), at d=88 (176-byte head
# stride; depth 96, P V at N=88), at d=128 (the ping-pong kernel's 192-key
# tiles over 4600 keys) and at d=512 (B1 only: one score pass over two
# consumer warpgroups); B3 also at a d=72 map its 2 x 2 cluster kernel takes
# (odd tile counts, Sk % 8 != 0)
SPLIT_RAGGED = {'flash_attention': [RAGGED, (1, 2, 1000, 333, 40), (1, 16, 1000, 333, 72),
                                    (1, 16, 1000, 333, 88), (1, 24, 1000, 4600, 128),
                                    (1, 1, 1000, 777, 512)],
                'flash_attention_with_lse': [RAGGED, (1, 2, 1000, 333, 40),
                                             (1, 16, 1000, 333, 72), (1, 16, 1000, 333, 88),
                                             (1, 24, 1000, 4600, 128)],
                'headmean_probs': [RAGGED, (1, 2, 1000, 333, 40), (1, 16, 1000, 333, 72),
                                   (1, 16, 1000, 333, 88), (2, 4, 2000, 2050, 72)]}
SHORT_SHAPES = [                # B4: the short-sequence bands (no path launches it)
    (2, 8, 256, 256, 160),      # SD-1.5 @512^2 level-2 self-attention
    (2, 8, 256, 77, 160),       # and its cross-attention
    (2, 20, 256, 256, 64),      # SDXL @512^2 level-2 self-attention
    (2, 20, 256, 77, 64),       # and its cross-attention
    (16, 20, 256, 256, 64),     # the JAX docstring's measured shapes
    (16, 20, 256, 77, 64),
    (2, 16, 256, 256, 72),      # PixArt's heads at 256^2 (d=72 shares B4's width tuple)
    (2, 16, 256, 256, 88),      # HunyuanDiT's heads at 256^2 (as d=72)
]
# phase 2's fp16 checks: one shape per kernel, and every d=88 shape
FP16_SHAPES = [('flash_attention', B1_SHAPES[0]), ('flash_attention', (1, 1, 1000, 777, 512)),
               ('flash_attention_with_lse', STORE_SHAPES[1]), ('headmean_probs', STORE_SHAPES[2]),
               ('short_attention', SHORT_SHAPES[4]), ('flash_attention', B1_SHAPES[7]),
               *(('flash_attention', s) for s in B1_SHAPES[-2:]),
               *((k, s) for k in ('flash_attention_with_lse', 'headmean_probs')
                 for s in D88_STORE_SHAPES),
               ('short_attention', SHORT_SHAPES[-1])]
SHORT_RAGGED = (1, 2, 200, 333, 64)
# bf16: the output is rounded to bf16 and fp32 sums run in another order;
# fp32: summation order alone; fp16: 3 more mantissa bits than bf16
TOL = {'bfloat16': 2e-2, 'float32': 1e-4, 'float16': 5e-3}
# the logsumexp: both sides take fp32 scores from the same inputs
LSE_TOL = 1e-3
# SHFL in the SASS of the fp32 B3 and B4 libraries built from their sources
# on an emulation of mma.sync fragments (four shuffles for four FFMA), as
# phase 1 counted them on an NVIDIA H100 80GB HBM3: the yardstick phase 1
# prints beside today's count
EMULATION_SHFL = {'headmean_f32': 9248, 'short_f32': 14630}
# the card's peaks (NVIDIA H100 SXM data sheet, dense): tensor-core bf16 and
# fp16, fp32 outside the tensor cores (the kernels' exact fp32 path), HBM
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12
XL_PRACTICAL = {  # tap id -> shape at 1024^2, batch 2
    'up-level0-repeat0-vit-block7-out': (2, 1280, 32, 32),
    'up-level0-repeat0-vit-block5-out': (2, 1280, 32, 32),
    'up-level1-repeat0-vit-block0-cross-q': (2, 640, 64, 64),
    'up-level1-repeat0-vit-block0-out': (2, 640, 64, 64),
}
AMALGAMATION_15 = {  # tap id -> shape at 512^2, batch 2, plus the store
    'up-level1-repeat1-vit-block0-cross-q': (2, 1280, 16, 16),
    'up-level2-repeat1-vit-block0-cross-q': (2, 640, 32, 32),
    'up-level2-upsampler-out': (2, 640, 64, 64),
    'up-level3-repeat0-vit-block0-self-k': (2, 320, 64, 64),
    'attn': (2, 77 + 77 + 256 + 1024, 64, 64),
}
XL_STORE = {**XL_PRACTICAL, 'attn': (2, 1024 + 4096, 128, 128)}
DIT_TAPS = dict.fromkeys(('vit-block13-out', 'vit-block20-out', 'vit-block20-cross-q',
                          'vit-block27-out'), True)
# phase 15: the JAX benchmark's HunyuanDiT taps (bench.py:353-358)
HUNYUAN_TAPS = dict.fromkeys(('vit-block13-self-q', 'vit-block20-self-q', 'vit-block27-self-q',
                              'vit-block39-self-q'), True)
# phase 16: the JAX benchmark's Flux taps (bench.py:268-273)
FLUX_TAPS = dict.fromkeys(('vit-block18-out', 'vit-block18-q', 'vit-block37-out',
                           'vit-block56-out'), True)
# phase 17: the JAX benchmark's IF taps (bench.py:413-417) at 64^2, batch 2
IF_FEATS = {'up-level1-repeat0-res-out': (2, 512, 16, 16),
            'up-level2-repeat0-res-out': (2, 256, 32, 32), 'unet-out': (2, 6, 64, 64)}
IF_TAPS = dict.fromkeys(IF_FEATS, True)
# the paths phases 3 to 6 and 9 to 11 drive, at random weights from seed 0,
# bf16, batch 2, t=50: FeatureExtractor's arguments, extract's arguments
# beyond t (none: the single step), the B1/B2/B3 launches of one extract,
# the features it returns, the timed calls
PATHS = {
    'xl': {'args': dict(layer='xl-practical', version='xl', img_size=1024),
           'launches': (71, 0, 0), 'feats': XL_PRACTICAL},
    'sd15_store': {'args': dict(layer='15-amalgamation', version='1-5', img_size=512,
                                attention=['up_cross', 'up_self']),
                   'launches': (7, 3, 3), 'feats': AMALGAMATION_15},
    'xl_store': {'args': dict(layer='xl-practical', version='xl', img_size=1024,
                              attention=['up_self']),
                 'launches': (35, 36, 36), 'feats': XL_STORE},
    # a walk of 10 Euler steps from timestep 60, then the last forward at
    # 50; B1: the VAE encoder, 11 U-Net forwards of 70, the decoder
    'xl_multistep': {'args': dict(layer={**dict.fromkeys(XL_PRACTICAL, True), 'vae-out': True},
                                  version='xl', img_size=1024),
                     'extract': dict(denoising_from=60), 'launches': (1 + 11 * 70 + 1, 0, 0),
                     'feats': {**XL_PRACTICAL, 'vae-out': (2, 3, 1024, 1024)}, 'calls': 3},
    # the correspondence config's third extractor (corres_configs/config_xl_t.json)
    'pgv2': {'args': dict(layer='pg-amalgamation', version='pgv2', img_size=1024),
             'launches': (71, 0, 0),
             'feats': {'up-level0-repeat0-vit-block3-out': (2, 1280, 32, 32)}},
    # SD-2.1: path A's taps and store; upcast_attention runs B2 and B3 in fp32
    'sd21_store': {'args': dict(layer='15-amalgamation', version='2-1', img_size=512,
                                attention=['up_cross', 'up_self']),
                   'launches': (7, 3, 3), 'feats': AMALGAMATION_15},
    # phase 14, PixArt: the JAX benchmark's DiT taps (bench.py:203-208); the
    # launches come from the config through the gate (dit_launches)
    'pixart_sigma': {'args': dict(layer=DIT_TAPS, version='pixart-sigma', img_size=1024),
                     'launches': None, 'feats': dict.fromkeys(DIT_TAPS, (2, 1152, 64, 64))},
    'pixart_sigma_store': {'args': dict(layer=DIT_TAPS, version='pixart-sigma', img_size=1024,
                                        attention=['up_cross', 'up_self']),
                           'launches': None,
                           'feats': {**dict.fromkeys(DIT_TAPS, (2, 1152, 64, 64)),
                                     'attn': (2, 300 + 4096, 128, 128)}},
    'pixart_alpha': {'args': dict(layer=DIT_TAPS, version='pixart-alpha', img_size=512),
                     'launches': None, 'feats': dict.fromkeys(DIT_TAPS, (2, 1152, 32, 32))},
    # phase 15, HunyuanDiT: the JAX benchmark's taps; launches through the
    # gate (dit_launches)
    'hunyuan': {'args': dict(layer=HUNYUAN_TAPS, version='hunyuan', img_size=1024),
                'launches': None, 'feats': dict.fromkeys(HUNYUAN_TAPS, (2, 1408, 64, 64))},
    'hunyuan_store': {'args': dict(layer=HUNYUAN_TAPS, version='hunyuan', img_size=1024,
                                   attention=['up_cross', 'up_self']),
                      'launches': None,
                      'feats': {**dict.fromkeys(HUNYUAN_TAPS, (2, 1408, 64, 64)),
                                'attn': (2, 77 + 256 + 4096, 128, 128)}},
    'hunyuan_512': {'args': dict(layer=HUNYUAN_TAPS, version='hunyuan', img_size=512),
                    'launches': None, 'feats': dict.fromkeys(HUNYUAN_TAPS, (2, 1408, 32, 32))},
    # phase 16, Flux.1-dev: the JAX benchmark's taps; launches through the
    # gate (dit_launches).  The store makes every block explicit (~6 s an
    # extract with TF32 off), hence fewer timed calls
    'flux': {'args': dict(layer=FLUX_TAPS, version='flux', img_size=1024),
             'launches': None, 'feats': dict.fromkeys(FLUX_TAPS, (2, 3072, 64, 64))},
    'flux_store': {'args': dict(layer=FLUX_TAPS, version='flux', img_size=1024,
                                attention=['up_cross', 'up_self']),
                   'launches': None, 'calls': 2,
                   'feats': {**dict.fromkeys(FLUX_TAPS, (2, 3072, 64, 64)),
                             'attn': (2, 512 + 4096, 128, 128)}},
    'flux_512': {'args': dict(layer=FLUX_TAPS, version='flux', img_size=512),
                 'launches': None, 'feats': dict.fromkeys(FLUX_TAPS, (2, 3072, 32, 32))},
    # phase 17, DeepFloyd IF: the JAX benchmark's taps; no kernel (if_launches)
    'if': {'args': dict(layer=IF_TAPS, version='if', img_size=64), 'launches': None,
           'feats': IF_FEATS},
    'if_ms': {'args': dict(layer=IF_TAPS, version='if', img_size=64),
              'extract': dict(denoising_from=60), 'launches': None, 'feats': IF_FEATS,
              'calls': 5},
}
# phase 11's DDIM inversion extract: 5 inverted steps (timesteps 11 to 51,
# the first >= 49) through the plain U-Net, 10 B1 each, then the last forward
INVERSION_PATH, INVERSION_LAUNCHES = 'sd21_store', (5 * 10 + 7, 3, 3)
TIMED_CALLS = 5
# kernel vs twin through ~70 bf16 attention calls and 50+ blocks: relative
# L2 difference per tap
TAP_REL_TOL = 2e-2
# the same through 11 U-Net forwards (each walk step adds the last one's
# difference to the latents) and the decoder: per tap and 'vae-out'
MULTISTEP_REL_TOL = 5e-2
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    'flash_attention': ('diffusion_feature_tpu_torch/csrc/flash_hopper.cuh',
                        'diffusion_feature_tpu/ops/flash_attention.py:86'),
    'flash_attention_with_lse': ('diffusion_feature_tpu_torch/csrc/flash_hopper.cuh',
                                 'diffusion_feature_tpu/ops/flash_attention.py:121'),
    'headmean_probs': ('diffusion_feature_tpu_torch/csrc/headmean_hopper.cuh',
                       'diffusion_feature_tpu/ops/flash_attention.py:461'),
    'short_attention': ('diffusion_feature_tpu_torch/csrc/short_hopper.cuh',
                        'diffusion_feature_tpu/ops/flash_attention.py:375'),
    # the JAX package's flash backward is a custom VJP (XLA), no Pallas kernel
    'flash_attention_bwd': ('diffusion_feature_tpu_torch/csrc/flash_bwd_hopper.cuh',
                            'diffusion_feature_tpu/ops/flash_attention.py:212'),
    # W8A16: the JAX package's Int8Dense, an XLA product with the dequantize
    # fused into the dot, no Pallas kernel
    'int8_linear': ('diffusion_feature_tpu_torch/csrc/w8a16.cuh',
                    'diffusion_feature_tpu/ops/quant.py:38'),
}
# phase 7: the CLI on the 'xl' path over 3 images, in batches of 2 and 1
CLI_PATH, CLI_IMAGES = 'xl', 3
CLI_LAUNCHES = {'flash_attention': 142, 'flash_attention_with_lse': 0, 'headmean_probs': 0,
                'short_attention': 0}
LAYER_COUNTS = {('xl', 1024): 612, ('1-5', 512): 197}   # config_{xl,15}_full.json
# phase 8: the path whose random-init extractor is written and loaded back.
# SDXL at full width: its ~6.8 GB tree fits twice in the card's machine's
# free disk (75 GB, checked there before this phase was written)
TREE_PATH, TREE_VARIANT, TREE_UNET_SHARDS = 'xl', 'bf16', 2
LOAD_PEAK_RATIO = 1.05   # the load's peak over the random-init build's (PERF.md section 2)
LORA_BLOCK = 'down_blocks.2.attentions.0.transformer_blocks.0.attn1'
LORA_RANK, LORA_ALPHA = 4, 8.0
# phase 12: generation.  (a) the port's generate_with_extraction CLI at its
# defaults (SD-1.5, 512^2, '15-practical', 50 PNDM steps = 51 U-Net calls,
# guidance 7.5, keeping calls 1, 10, 20, 30, 40); (b) SDXL sample() at
# 1024^2, batch 1, 50 Euler steps, guidance 5.0, one up-level tap; (c) the
# SD-1.5 sample at TWIN_SAMPLE_STEPS on the kernels and on the twins; (d)
# the SD-1.5 50-step sample in bf16 and in fp32 from one fp32 draw.  Raw
# taps of every call stay on the card, hence small layer sets
XL_SAMPLE = dict(layer={'up-level1-repeat0-vit-block0-out': True}, version='xl',
                 img_size=1024)
XL_SAMPLE_STEPS, XL_GUIDANCE = 50, 5.0
TWIN_SAMPLE_STEPS = 4                 # 5 PNDM calls
DRIFT_STEPS = (1, 10, 20, 30, 40)     # the encounters whose features the drift compares
# phase 13: SD-1.5 with a Canny and a depth ControlNet from a random tree
# (lllyasviel/sd-controlnet-canny's and -depth's architecture: SD-1.5's
# encoder, the (16, 32, 96, 256) conditioning stack; Intel/dpt-large's
# depth estimator), '15-amalgamation', 512^2, batch 2
CONTROL_ARGS = dict(layer='15-amalgamation', version='1-5', img_size=512)
CONTROL_KINDS = ('canny', 'depth')
CONTROL_FEATS = {k: v for k, v in AMALGAMATION_15.items() if k != 'attn'}
CONTROL_CLI_IMAGES = 3
# phase 14: PixArt.  (d) pixart-sigma's random tree, T5-XXL (~9.5 GB in
# bf16) in PIXART_TEXT_SHARDS files; (e) the CLI on it over CLI_IMAGES;
# (f) the generation CLI on pixart-alpha 512^2 with the DiT taps, its other
# flags at their defaults, then a TWIN_SAMPLE_STEPS sample on the twins
PIXART_TREE_PATH, PIXART_TEXT_SHARDS = 'pixart_sigma', 4
PIXART_GEN_ARGS = ['--version', 'pixart-alpha', '--img_size', '512', '--layer',
                   json.dumps(DIT_TAPS)]
# phase 15: HunyuanDiT.  (d) (a)'s random tree (~7.9 GB in bf16: the DiT,
# BERT, mT5 in HUNYUAN_TEXT_SHARDS files, the SDXL VAE) and the CLI on it;
# (e) the generation CLI at 512^2 with the benchmark's taps, its other
# flags at their defaults (50 DDPM steps, guidance 7.5), then a
# TWIN_SAMPLE_STEPS sample on the twins
HUNYUAN_TREE_PATH, HUNYUAN_TEXT_SHARDS = 'hunyuan', 2
HUNYUAN_GEN_ARGS = ['--version', 'hunyuan', '--img_size', '512', '--layer',
                    json.dumps(HUNYUAN_TAPS)]
# phase 16: Flux.  (d) (a)'s random tree (~34 GB in bf16: the transformer
# in FLUX_TRANSFORMER_SHARDS files, the VAE, CLIP-L, T5-XXL in
# FLUX_TEXT_SHARDS) and the CLI on it; (e) the generation CLI at 512^2 with
# the benchmark's taps, 28 steps and guidance 3.5 (the pipeline's), the
# calls kept within the 28, then a TWIN_SAMPLE_STEPS sample on the twins
FLUX_TREE_PATH, FLUX_TRANSFORMER_SHARDS, FLUX_TEXT_SHARDS = 'flux', 4, 2
# phase 2's W8A16 shapes beyond the int8 Flux path's (flux_int8_calls): T5-XXL
# over one prompt of 512 tokens (Flux's encode_prompt) and over two; one
# shape for fp16 and fp32; a ragged shape (odd N, K not a multiple of 16)
INT8_T5_ROWS = (512, 1024)
INT8_ONE_SHAPE = (1024, 3072, 3072)
INT8_RAGGED = (37, 1000, 333)
# phase 16f: the int8 load's peak over the bytes resident after it plus the
# largest staged bf16 weight, and how far its extract's peak must sit
# below phase 16a's bf16 one (~15.3 GiB of bf16 projections become int8)
INT8_LOAD_PEAK_RATIO = 1.05
INT8_PEAK_SAVING_GIB = 12.0
# the int8 extract's taps against the bf16 ones from the same draws: the
# JAX package's bound for int8 against full precision (tests/test_quant.py:225)
INT8_COSINE = 0.98
FLUX_GEN_ARGS = ['--version', 'flux', '--img_size', '512', '--layer', json.dumps(FLUX_TAPS),
                 '--steps', '28', '--guidance_scale', '3.5', '--store_steps', '1', '10', '20',
                 '28']
# phase 17: IF.  (d) the tree (~10 GB in bf16: the U-Net, T5-XXL in
# IF_TEXT_SHARDS files) and the CLI on it; (e) the generation CLI at 64^2
# with the benchmark's taps, 50 DDPM steps and guidance 7.0 (the IF
# pipeline's), the other flags at their defaults
IF_TREE_PATH, IF_TEXT_SHARDS = 'if', 2
IF_GEN_ARGS = ['--version', 'if', '--img_size', '64', '--layer', json.dumps(IF_TAPS),
               '--guidance_scale', '7.0']
# phase 18: external_model on phase 3's extractor with phase 6's request
EXTERNAL_SOURCE, EXTERNAL_PATH = 'xl', 'xl_store'
EXTERNAL_MEMORY_RATIO = 0.01   # what the second extractor may add to the allocated bytes
# phase 19: (a) the backward kernel on head-split views: the training
# paths' shapes (fp32: ade_vpd's SD-1.5 levels 0 and 1; bf16: SDXL's levels
# 1 and 2) and one shape at each other width (bf16; d=80 also fp16)
BWD_SHAPES = [((2, 8, 4096, 4096, 40), 'float32'), ((2, 8, 1024, 1024, 80), 'float32'),
              ((2, 10, 4096, 4096, 64), 'bfloat16'), ((2, 20, 1024, 1024, 64), 'bfloat16'),
              ((2, 8, 4096, 4096, 40), 'bfloat16'), ((2, 8, 1024, 1024, 80), 'bfloat16'),
              ((2, 16, 1024, 1024, 72), 'bfloat16'), ((2, 16, 1024, 1024, 88), 'bfloat16'),
              ((2, 24, 1536, 1536, 128), 'bfloat16'), ((2, 8, 1024, 1024, 160), 'bfloat16'),
              ((2, 8, 1024, 1024, 80), 'float16')]
# the ragged pair in every type: the tiles' edges in keys and queries, and
# the dq accumulator's and its conversion's ragged rows (fp32 at the widths
# of both of its thread layouts, 8 and 16 lanes a row)
BWD_RAGGED = [((1, 2, 1000, 333, 64), dt) for dt in ('bfloat16', 'float16', 'float32')] + [
    ((1, 2, 1000, 333, 40), 'float32'), ((1, 2, 1000, 333, 80), 'float32')]
# (b), (c): the shipped configs through the port's trainer; (d) train_unet
SEG_CONFIG, VPD_CONFIG = 'seg_configs/ade_sdxl.json', 'seg_configs/ade_vpd.json'
SEG_ITERS, VPD_ITERS = 4, 3
SEG_TRAIN_SIZES = [(640, 768), (576, 704)]   # (h, w) of the synthetic training pairs
SEG_VAL_SIZE = (512, 768)                    # one val pair: two 512^2 slide windows
# the resumed evaluation restarts the extraction noise from the seed, as the
# training run's did: the same mIoU up to argmax flips from summation order
SEG_MIOU_TOL = 1e-4
TRAIN_UNET_TAPS = {'down-level1-repeat0-vit-block0-out': True,
                   'up-level2-repeat1-vit-out': True, 'unet-out': True}
# phase 20: the shipped correspondence configs through task_corres.main on
# synthetic pairs; 4 training pairs of these (w, h), 2 validation pairs
CORRES_CONFIG = 'corres_configs/config_sdxl.json'
CORRES_ENSEMBLE = 'corres_configs/config_xl_t.json'
CORRES_STEPS, CORRES_VAL_PAIRS, CORRES_POINTS = 4, 2, 10
CORRES_SIZES = [((500, 375), (375, 500)), ((500, 333), (400, 500)), ((480, 360), (500, 375)),
                ((375, 500), (500, 281)), ((500, 400), (333, 500)), ((500, 375), (500, 375))]
# kernel-path features against twin-path ones, through the fp32 conv and
# the loss: relative difference of one pair's clip_loss
CORRES_LOSS_TOL = 2e-2
# phase 21: the CLI's aggregated dumps of the 'xl' path feed task_pixel
PIXEL_IMAGES, PIXEL_TRAIN = 2, 1      # one training image, one test image
PIXEL_ARGV = ['--category', 'horse_21', '--train_num', str(PIXEL_TRAIN), '--model_num', '2',
              '--max_epochs', '1', '--device', 'cuda']

# phase 22: the mesh on two ranks of cuda:0 over gloo.  22b: phase 6's
# request plus a q and an FFN inner tap; 22e: the two-model ensemble
MESH_XL_LAYERS = {**dict.fromkeys(XL_PRACTICAL, True),
                  'up-level1-repeat0-vit-block0-self-q': True,
                  'up-level1-repeat0-vit-block1-ffn-inner': True}
MESH_CLI_IMAGES = 4
MESH_SEG_CONFIG, MESH_SEG_ITERS = 'seg_configs/ade_full.json', 2
MESH_TIMEOUT = 240          # seconds a rank waits in one collective
MESH_RANK_SECONDS = 600     # the ranks' time from the spawn to their exit
MESH_COSINE = 0.99          # 22c: each tap of the int8 Flux at tp=2 against tp=1
MESH_LOSS_REL = 1e-3        # 22e: each step's loss, --dp 2 against --dp 1
# 22a: each dumped file of --dp 2 against the one-device witness (the same
# rows at batch 1 from the same noise), relative L2; the fault (each row its
# own noise) must exceed it
MESH_ROWS_REL = 1e-3
# 22e: the first step, --dp 2 against the witness, relative L2.  Its
# gradients (after the dp average): 5.2e-2 measured on an H100, where the
# loss agrees to 1.8e-5 (fp32 rounding in the head, which the Lovasz loss
# may amplify: its gradient is piecewise constant in the sort order of the
# pixels' errors); the bf16 batch-size effect (the witness against plain
# --dp 1) reads 0.137, and a rank's own gradients (the step with the
# average left out, the planted fault) 52.5.
MESH_GRAD_REL = 0.2
# what the first step changed in the BatchNorm running statistics
# (E[x^2] - E[x]^2 from sums in another order: 1.24e-3 measured)
MESH_STATS_REL = 1e-2
# 22e: a parameter whose largest first-step gradient is at most this share
# of the largest parameter's has a gradient of fp32 noise
MESH_NOISE_GRAD = 1e-6
MESH_SEG_LR = 1.6e-4        # train_segmentation's default --lr
# the shapes the mesh hands B1 (and B2/B3): SDXL's heads at tp=2, PixArt
# and Flux at sp=2 (each rank's queries against every key; Flux's dual
# blocks keep the 512 text queries whole, its single blocks split the joint
# 4608), and Flux's heads at tp=2
TP_B1_SHAPES = [(2, 5, 4096, 4096, 64), (2, 10, 1024, 1024, 64)]
TP_STORE_SHAPES = [(2, 10, 1024, 1024, 64), (2, 5, 4096, 4096, 64)]
SP_B1_SHAPES = [(2, 16, 2048, 4096, 72)]
SP_FLUX_B1_SHAPES = [(2, 24, 2560, 4608, 128), (2, 24, 2304, 4608, 128)]
TP_FLUX_B1_SHAPES = [(2, 12, 4608, 4608, 128)]
#: what phases 14a and 16f leave for phase 22: their single-device
#: features, launches and the int8 transformer's resident bytes
MESH_REFS = {}


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, min_total_ms=100.0, runs=1) -> float:
    """Mean device time of ``fn`` over a run of launches, after warm-up;
    with ``runs`` > 1 the median of that many such runs.  Where a loop of
    separate calls times the host, one stall of a host that shares its
    cores lifts a single run's mean."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(min_total_ms / max(start.elapsed_time(stop), 1e-3))))
    means = []
    for _ in range(runs):
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / reps)
    return sorted(means)[len(means) // 2]


def graph_ms(torch, fn, per_graph=20) -> float:
    """Device time per call of ``fn`` with the host's launch cost out of
    the way: ``per_graph`` calls captured in one CUDA graph, replayed and
    timed as ``time_ms`` times a call.  At small sizes a loop of separate
    calls measures the host (each call's Python and launch cost exceeds
    the kernel), so the kernels and their library calls are timed this
    way."""
    # warm-up on the current stream: a new stream per call would leave a
    # cuBLAS workspace allocated for each, which phases 3 to 6 would count
    # in their peak memory
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    # the kernel libraries raise their shared-memory limit once per kernel,
    # before capture, so the default (global) capture mode holds
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_ms(torch, graph.replay) / per_graph


def sass_counts(path, ops=('HGMMA', 'UTMALDG')) -> dict:
    """Instructions ``ops`` in a library's SASS (HGMMA: wgmma, UTMALDG: a
    TMA load, HMMA: mma.sync), by cuobjdump from the CUDA toolkit or
    Triton's bundled copy."""
    import shutil
    cands = [os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump'),
             shutil.which('cuobjdump') or '']
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), 'backends', 'nvidia', 'bin',
                                  'cuobjdump'))
    except ImportError:
        pass
    tool = next((c for c in cands if c and os.path.exists(c)), None)
    if tool is None:
        raise RuntimeError('cuobjdump not found (CUDA toolkit or triton)')
    sass = subprocess.run([tool, '-sass', path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {op: sass.count(op) for op in ops}


def resource_usage(path) -> dict:
    """{kernel's mangled name: {'REG': n, 'STACK': n, 'SHARED': n, 'LOCAL':
    n}} of a library, by ``cuobjdump --dump-resource-usage`` (the registers
    the launch reserves a thread, its stack frame and local memory in
    bytes)."""
    import re
    tool = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    out = subprocess.run([tool, '--dump-resource-usage', path], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    found = {}
    for m in re.finditer(r'Function (\S+):\s*\n\s*((?:[A-Z]+(?:\[\d+\])?:\d+\s*)+)', out):
        found[m.group(1)] = {k: int(v) for k, v in re.findall(r'([A-Z]+):(\d+)', m.group(2))}
    return found


#: the kernels this repository designed for the DiTs' head widths (B1/B2's
#: ping-pong kernel, B3's cluster kernel): phase 1 fails if ptxas spills
#: in any of their instantiations
NO_SPILL_KERNELS = ('flash_fwd_pingpong', 'headmean_cluster')


def spill_check(log, paths) -> None:
    """Phase 1: each B1/B2/B3 instantiation of the bf16 and fp16 libraries
    with its registers, stack and local bytes (cuobjdump) and ptxas's spill
    bytes (from ``log``, the build's ``-Xptxas -v`` output; a cached build
    has none); raises if one of NO_SPILL_KERNELS spills."""
    import re
    spills = {}
    for line in ptxas_summary(log):
        m = re.match(r'(\S+): \d+ registers, spill stores (\d+) B, loads (\d+) B', line)
        if m:
            spills[m.group(1)] = (int(m.group(2)), int(m.group(3)))
    bad = []
    for path in paths:
        name = os.path.basename(path)
        if not any(f'_{lib}_{tag}_' in name for lib in ('flash', 'headmean')
                   for tag in ('bf16', 'fp16')):
            continue
        for fn, use in sorted(resource_usage(path).items()):
            if 'flash_fwd' not in fn and 'headmean' not in fn:
                continue
            spill = spills.get(fn)
            note = 'spills not reported (cached build)' if spill is None else (
                f'spill stores {spill[0]} B, loads {spill[1]} B')
            print(f'  resources {name}: {fn}: {use.get("REG")} registers, stack '
                  f'{use.get("STACK")} B, local {use.get("LOCAL")} B, {note}', flush=True)
            if any(k in fn for k in NO_SPILL_KERNELS) and spill is not None and any(spill):
                bad.append(f'{fn} ({note})')
    if bad:
        raise RuntimeError('phase 1: redesigned kernels spill: ' + '; '.join(bad))


def ptxas_summary(log) -> list:
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its
    mangled name, registers and spill bytes (a kernel's template arguments,
    such as the head width, show in the name as ``Li<n>E``)."""
    import re
    lines, name, spill = [], None, 'spills not reported'
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m and name:
            spill = f'spill stores {m.group(1)} B, loads {m.group(2)} B'
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            lines.append(f'{name}: {m.group(1)} registers, {spill}')
            name = None
    return lines


def bound(kernel, shape, dtype_name):
    """(ms, 'bytes' or 'operations'): the least time the card needs for the
    function, from the flops its shape needs and the bytes it must move
    (each input read once, each output written once)."""
    b, h, sq, sk, d = shape
    item = {'bfloat16': 2, 'float16': 2, 'float32': 4}[dtype_name]
    if kernel == 'headmean_probs':      # q, k, lse in; the (B, Sq, Sk) map out
        flops = 2 * b * h * sq * sk * d
        nbytes = (b * h * (sq + sk) * d + b * sq * sk) * item + b * h * sq * 4
    else:                               # q, k, v in; o (and the lse) out (B1, B2, B4)
        flops = 4 * b * h * sq * sk * d
        nbytes = 2 * b * h * (sq + sk) * d * item
        if kernel == 'flash_attention_with_lse':
            nbytes += b * h * sq * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def worst_ratio(torch, out, ref, atol, rtol):
    """(max_abs_err, worst element against atol + rtol*|ref|, as
    torch.testing.assert_close's rule)."""
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), (diff / (atol + rtol * ref.float().abs())).max().item()


def rel_l2_ratio(torch, out, ref, tol, ratio):
    """(ratio folded with the relative L2 error against tol, its note).
    The elementwise rule alone admits a map or an attention output wrong by
    a share of every value where tol is as large as a typical value (an
    output of Sk averaged values is ~Sk^-1/2); the L2 norm of the error over
    that of the reference holds the whole tensor to tol."""
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    return max(ratio, rel / tol), f' rel_l2={rel:.3e} (allowed {tol:g})'


def library_ms(torch, kernel, q, k, v, scale, timer=graph_ms):
    """The one PyTorch call that computes the kernel's function, timed as
    a yardstick (the port never calls it); None where there is none or it
    does not take these inputs.  B2's: the flash op in bf16/fp16, the
    memory-efficient op in fp32."""
    F = torch.nn.functional
    try:
        if kernel in ('flash_attention', 'short_attention'):
            return timer(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        if kernel == 'flash_attention_with_lse':
            if q.dtype == torch.float32:
                # the flash op takes 16-bit inputs only; this one returns the
                # logsumexp too
                op = torch.ops.aten._scaled_dot_product_efficient_attention
                return timer(torch, lambda: op(q, k, v, None, True, scale=scale))
            op = torch.ops.aten._scaled_dot_product_flash_attention
            return timer(torch, lambda: op(q, k, v, 0.0, False, False, scale=scale))
    except RuntimeError as err:
        print(f'  library call for {kernel} on {q.dtype} {tuple(q.shape)} unavailable: '
              f'{str(err).splitlines()[0]}')
    return None


def short_grad_ratio(torch, fa, q, k, v, scale, tol, gen):
    """short_attention_diff's gradients (B4 forward, the twin's backward)
    against the twin's autograd: the worst element against the tolerance.
    A loss linear in the output gives both sides the same output gradient."""
    weight = torch.randn(q.shape, generator=gen, device='cuda')
    ours = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    twin = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    (fa.short_attention_diff(*ours, scale=scale).float() * weight).sum().backward()
    (fa.short_attention_reference(*twin, scale).float() * weight).sum().backward()
    return max(worst_ratio(torch, a.grad, b.grad, tol, tol)[1] for a, b in zip(ours, twin))


PLAIN_MS = {}   # (kernel, shape, dtype name) -> the twin's ms


def compare(torch, fa, kernel, shape, dtype_name, gen, split=False, timed=True):
    """One kernel against its twin on one shape; returns its numbers.  With
    ``split`` q, k and v are the head-split (B, H, S, D) views of
    (B, S, H*D) projections, as the paths hand B1, B2 and B3 their inputs.
    ``timed`` False holds the kernel to its twin and times nothing (a
    layout, type or ragged shape whose times the kernels line does not
    take); the numbers are then the error alone."""
    b, h, sq, sk, d = shape
    dtype = getattr(torch, dtype_name)
    if split:
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device='cuda').to(dtype)
                   .reshape(b, s, h, d).transpose(1, 2) for s in (sq, sk, sk))
    else:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device='cuda').to(dtype)
                   for s in (sq, sk, sk))
    scale = d ** -0.5
    tol = TOL[dtype_name]
    # a head-mean map's entries average 1/Sk, far below tol: its absolute
    # tolerance scales with them, or a zero map would pass
    atol = tol / sk if kernel == 'headmean_probs' else tol
    notes = ''
    if kernel == 'flash_attention':
        run = lambda: fa.flash_attention(q, k, v, scale=scale)              # noqa: E731
        plain = lambda: fa.flash_attention_reference(q, k, v, scale)        # noqa: E731
        out, ref = run(), plain()
        err, ratio = worst_ratio(torch, out, ref, atol, tol)
        ratio, notes = rel_l2_ratio(torch, out, ref, tol, ratio)
    elif kernel == 'flash_attention_with_lse':
        run = lambda: fa.flash_attention_with_lse(q, k, v, scale=scale)     # noqa: E731
        plain = lambda: fa.flash_attention_with_lse_reference(q, k, v, scale)  # noqa: E731
        (out, lse), (ref, ref_lse) = run(), plain()
        err, ratio = worst_ratio(torch, out, ref, atol, tol)
        ratio, notes = rel_l2_ratio(torch, out, ref, tol, ratio)
        lse_err = (lse - ref_lse).abs().max().item()
        ratio = max(ratio, lse_err / LSE_TOL)
        notes += f' lse_max_abs_err={lse_err:.3e} (allowed {LSE_TOL:g})'
    elif kernel == 'short_attention':
        run = lambda: fa.short_attention(q, k, v, scale=scale)              # noqa: E731
        plain = lambda: fa.short_attention_reference(q, k, v, scale)        # noqa: E731
        out, ref = run(), plain()
        err, ratio = worst_ratio(torch, out, ref, atol, tol)
        grad_ratio = short_grad_ratio(torch, fa, q, k, v, scale, tol, gen)
        ratio = max(ratio, grad_ratio)
        notes = f' grad_worst/allowed={grad_ratio:.3f}'
    else:
        # both sides take the logsumexp of the B2 kernel
        _, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
        run = lambda: fa.headmean_probs(q, k, lse, scale=scale)             # noqa: E731
        plain = lambda: fa.headmean_probs_reference(q, k, lse, scale)       # noqa: E731
        out, ref = run(), plain()
        err, ratio = worst_ratio(torch, out, ref, atol, tol)
        ratio, notes = rel_l2_ratio(torch, out, ref, tol, ratio)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    ok = finite and ratio <= 1.0
    if not timed:
        print(f'compare {kernel} {dtype_name} q{(b, h, sq, d)} k{(b, h, sk, d)}'
              f'{" head-split" if split else ""}: max_abs_err={err:.3e} atol={atol:.3g} '
              f'rtol={tol:g} worst/allowed={ratio:.3f}{notes} untimed {"ok" if ok else "FAIL"}',
              flush=True)
        if not ok:
            raise RuntimeError(f'{kernel} disagrees with its twin at {shape} {dtype_name}'
                               f'{" head-split" if split else ""}')
        return {'max_abs_err': err}
    ms = graph_ms(torch, run)
    # the twins repeat the kernels' arithmetic in several large kernels each
    # (fp32 score matrices through memory): a loop of calls times them, once
    # per shape and dtype (the layout does not change their work)
    key = (kernel, shape, dtype_name)
    if key not in PLAIN_MS:
        PLAIN_MS[key] = (graph_ms if kernel == 'short_attention' else time_ms)(torch, plain)
    plain_ms = PLAIN_MS[key]
    lib_ms = library_ms(torch, kernel, q, k, v, scale, graph_ms)
    bound_ms, bound_by = bound(kernel, shape, dtype_name)
    extra = {'call_loop_ms': time_ms(torch, run, runs=3)}
    if kernel == 'short_attention':
        # what else could run there: B1 at this shape, and the explicit
        # path the port's dispatch takes for it; and the kernel in a loop
        # of separate calls, which the host's launch cost bounds
        from diffusion_feature_tpu_torch.ops import attention as attn_ops
        extra.update(b1_ms=graph_ms(torch, lambda: fa.flash_attention(q, k, v, scale=scale)),
                     explicit_ms=graph_ms(torch, lambda: attn_ops.attention_fused_heads(
                         q, k, v, scale=scale)))
    notes += ''.join(f' {key}={val:.4f}' for key, val in extra.items())
    lib = 'none' if lib_ms is None else f'{lib_ms:.4f}'
    print(f'compare {kernel} {dtype_name} q{(b, h, sq, d)} k{(b, h, sk, d)}'
          f'{" head-split" if split else ""}: '
          f'max_abs_err={err:.3e} atol={atol:.3g} rtol={tol:g} worst/allowed={ratio:.3f}{notes} '
          f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} '
          f'bound_ms={bound_ms:.4f} ({bound_by}) share_of_bound={bound_ms / ms:.3f} '
          f'{"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise RuntimeError(f'{kernel} disagrees with its twin at {shape} {dtype_name}'
                           f'{" head-split" if split else ""}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, **extra}


def flux_int8_calls(spec, img_size, batch, vae_scale, tp=1, sp=1):
    """{(M, K, N): launches} of W8A16 in one int8 Flux forward, from the
    config: per dual block the two adaLN projections (M = batch rows),
    q/k/v and the output projection of each stream, and each stream's MLP;
    per single block its adaLN projection, the MLP's up projection, q/k/v
    and the joint output projection; the context embedder once (the JAX
    package's quantized projections, models/flux.py).  On one rank of a
    mesh (phase 22): ``tp`` cuts the column-parallel layers' N and the
    row-parallel ones' K (the adaLN projections and the context embedder
    stay whole), ``sp`` the image tokens of the dual blocks and the joint
    tokens of the single blocks (parallel/mesh.py)."""
    cfg = spec.dit
    image = (img_size // vae_scale // 2) ** 2
    dim, mlp, text = cfg.inner_dim, int(cfg.inner_dim * cfg.mlp_ratio), spec.prompt_max_length
    calls = {}

    def add(shape, n):
        calls[shape] = calls.get(shape, 0) + n
    for rows in (batch * image // sp, batch * text):    # the dual blocks' two streams
        add((rows, dim, dim // tp), 3 * cfg.num_layers)
        add((rows, dim // tp, dim), cfg.num_layers)
        add((rows, dim, mlp // tp), cfg.num_layers)
        add((rows, mlp // tp, dim), cfg.num_layers)
    add((batch, dim, 6 * dim), 2 * cfg.num_layers)
    joint = batch * (image + text) // sp
    add((batch, dim, 3 * dim), cfg.num_single_layers)
    add((joint, dim, mlp // tp), cfg.num_single_layers)
    add((joint, dim, dim // tp), 3 * cfg.num_single_layers)
    add((joint, (dim + mlp) // tp, dim), cfg.num_single_layers)
    add((batch * text, cfg.joint_attention_dim, dim), 1)
    return calls


def t5_int8_calls(cfg, rows):
    """{(M, K, N): launches} of W8A16 in one int8 T5 encode of ``rows``
    tokens: q/k/v/o and wi_0/wi_1/wo of every layer."""
    inner, calls = cfg.num_heads * cfg.d_kv, {}
    for shape, n in (((rows, cfg.d_model, inner), 3), ((rows, inner, cfg.d_model), 1),
                     ((rows, cfg.d_model, cfg.d_ff), 2), ((rows, cfg.d_ff, cfg.d_model), 1)):
        calls[shape] = calls.get(shape, 0) + n * cfg.num_layers
    return calls


def int8_phase2_shapes():
    """[((M, K, N), bias)]: every W8A16 shape of one int8 Flux extract at
    1024^2, batch 2 (with the bias), then T5-XXL's at INT8_T5_ROWS."""
    from diffusion_feature_tpu_torch.models.registry import get_model_spec
    spec = get_model_spec('flux')
    vae_scale = 2 ** (len(spec.vae.block_out_channels) - 1)
    shapes = [(s, True) for s in flux_int8_calls(spec, 1024, 2, vae_scale)]
    for rows in INT8_T5_ROWS:
        shapes += [(s, False) for s in t5_int8_calls(spec.t5, rows)]
    return shapes


def shape_counts(log, name='int8_linear'):
    """{shape: calls} of kernel ``name`` in a recorded log."""
    out = {}
    for n, shape, _ in log:
        if n == name:
            out[shape] = out.get(shape, 0) + 1
    return out


def int8_bound(shape, dtype_name, bias):
    """(ms, 'bytes' or 'operations') of y = x W^T + b with an int8 W: 2 M K
    N flops; x and y in the compute type, W one byte an element, the fp32
    scale and the bias read once."""
    m, k, n = shape
    item = {'bfloat16': 2, 'float16': 2, 'float32': 4}[dtype_name]
    nbytes = item * m * k + n * k + 4 * n + item * m * n + (item * n if bias else 0)
    t_ops, t_bytes = 2 * m * k * n / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


INT8PACK = {}   # dtype name -> whether torch._weight_int8pack_mm ran on it (absent: untried)
INT8PACK_GRAPH_MS = 5.0


def one_call_ms(torch, fn, warm=True) -> float:
    """Device time of one call of ``fn``, after one untimed call where
    ``warm``."""
    if warm:
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def int8_inputs(torch, gen, shape, dtype, bias=True):
    """x (M, K) in ``dtype`` ~ N(0, 1), an (N, K) weight of N(0, 1/K)
    quantized on the card, and a bias in ``dtype`` (or None)."""
    quant = _quant()
    m, k, n = shape
    x = torch.randn(m, k, generator=gen, device='cuda').to(dtype)
    q, scale = quant.quantize_int8(torch.randn(n, k, generator=gen, device='cuda') * k ** -0.5)
    b = torch.randn(n, generator=gen, device='cuda').to(dtype) if bias else None
    return x, q, scale, b


def compare_int8(torch, shape, dtype_name, gen, bias=True):
    """W8A16 against its twin at one (M, K, N): x ~ N(0, 1), a weight of
    N(0, 1/K) quantized on the card, a bias where the path's layer has one;
    relative L2 and the worst element against TOL, which of W8A16's kernels
    served the shape (``kernel``) and whether the result equals the twin's
    bit for bit (``bit_equal``), then the kernel's time
    (CUDA graphs of 20), the twin's (a loop), the bound and the yardsticks
    the port never calls: F.linear on the dequantized weight in the compute
    type (torch.matmul's cuBLAS GEMM), the dequantize and that GEMM
    together, and torch._weight_int8pack_mm (the one PyTorch call of the
    same product on the same int8 inputs, without the bias) where this
    PyTorch runs it on CUDA."""
    quant = _quant()
    m, k, n = shape
    dtype = getattr(torch, dtype_name)
    x, q, scale, b = int8_inputs(torch, gen, shape, dtype, bias)
    run = lambda: quant.int8_linear(x, q, scale, b)                  # noqa: E731
    plain = lambda: quant.int8_linear_reference(x, q, scale, b)      # noqa: E731
    out, ref = run(), plain()
    torch.cuda.synchronize()
    kernel = quant.ROUTES[quant.int8_route(m, n, k, dtype, q.data_ptr() % 16 == 0,
                                           quant._sm_count(x.device))]
    bit_equal = bool(torch.equal(out, ref))
    tol = TOL[dtype_name]
    err, ratio = worst_ratio(torch, out, ref, tol, tol)
    ratio, notes = rel_l2_ratio(torch, out, ref, tol, ratio)
    finite = bool(torch.isfinite(out.float()).all())
    ms = graph_ms(torch, run)
    plain_ms = time_ms(torch, plain)
    F = torch.nn.functional
    w = quant.dequantize_int8(q, scale, dtype)
    extra = {'call_loop_ms': time_ms(torch, run, runs=3),
             'matmul_ms': graph_ms(torch, lambda: F.linear(x, w, b)),
             'dequant_matmul_ms': graph_ms(
                 torch, lambda: F.linear(x, quant.dequantize_int8(q, scale, dtype), b))}
    del w
    lib_ms = None
    if INT8PACK.get(dtype_name, True):
        # x (q s)^T without the bias; tried once per dtype.  A weight-only
        # GEMV kernel: at thousands of rows one call takes up to a second,
        # so a call slower than INT8PACK_GRAPH_MS is timed once, after one
        # untimed call at the dtype's first shape only
        try:
            op = torch._weight_int8pack_mm
            s_dt = scale.to(dtype)
            lib_ms = one_call_ms(torch, lambda: op(x, q, s_dt), warm=dtype_name not in INT8PACK)
            INT8PACK[dtype_name] = True
            if lib_ms < INT8PACK_GRAPH_MS:
                lib_ms = graph_ms(torch, lambda: op(x, q, s_dt))
        except (AttributeError, RuntimeError, NotImplementedError) as err_lib:
            INT8PACK[dtype_name] = False
            torch.cuda.synchronize()
            print(f'  torch._weight_int8pack_mm on {dtype_name} CUDA tensors unavailable: '
                  f'{str(err_lib).splitlines()[0][:160]}')
    bound_ms, bound_by = int8_bound(shape, dtype_name, bias)
    notes += ''.join(f' {key}={val:.4f}' for key, val in extra.items())
    ok = finite and ratio <= 1.0
    lib = 'none' if lib_ms is None else f'{lib_ms:.4f}'
    print(f'compare int8_linear {dtype_name} (M, K, N)={shape}{" +bias" if bias else ""}: '
          f'kernel={kernel} bit_equal={bit_equal} '
          f'max_abs_err={err:.3e} atol={tol:g} rtol={tol:g} worst/allowed={ratio:.3f}{notes} '
          f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} '
          f'bound_ms={bound_ms:.4f} ({bound_by}) share_of_bound={bound_ms / ms:.3f} '
          f'{"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise RuntimeError(f'int8_linear disagrees with its twin at {shape} {dtype_name}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'kernel': kernel,
            'bit_equal': bit_equal, **extra}


# the wrappers the attention ops call (B4 is called by none of them)
WRAPPERS = ('flash_attention', 'flash_attention_with_lse', 'headmean_probs')


def _quant():
    from diffusion_feature_tpu_torch.ops import quant
    return quant


@contextlib.contextmanager
def patched_wrappers(attn_ops, make):
    """Replace each kernel wrapper the attention ops call, and the W8A16
    wrapper that Int8Linear calls (``quant.int8_linear``), by
    ``make(name, wrapper)`` for the duration of the block."""
    targets = [(attn_ops, n) for n in WRAPPERS] + [(_quant(), 'int8_linear')]
    real = {n: getattr(mod, n) for mod, n in targets}
    for mod, n in targets:
        setattr(mod, n, make(n, real[n]))
    try:
        yield
    finally:
        for mod, n in targets:
            setattr(mod, n, real[n])


def recording(log):
    """Record (kernel, shape, dtype name) of every call, then call through
    to the wrapper unchanged: (b, h, sq, sk, d) for the attention kernels,
    (M, K, N) for W8A16."""
    def make(name, wrapper):
        def call(q, k, *args, **kwargs):
            if name == 'int8_linear':
                shape = (q.numel() // q.shape[-1], q.shape[-1], k.shape[0])
            else:
                shape = (*q.shape[:3], k.shape[2], q.shape[3])
            log.append((name, shape, str(q.dtype).replace('torch.', '')))
            return wrapper(q, k, *args, **kwargs)
        return call
    return make


def twin_of(fa):
    """Route every kernel call to its plain twin."""
    twins = {'flash_attention': fa.flash_attention_reference,
             'flash_attention_with_lse': fa.flash_attention_with_lse_reference,
             'headmean_probs': fa.headmean_probs_reference}

    def make(name, _):
        if name == 'int8_linear':
            return _quant().int8_linear_reference
        return lambda *args, scale: twins[name](*args, scale)
    return make


def reset_counts(fa):
    fa.launches = fa.lse_launches = fa.headmean_launches = fa.short_launches = 0
    fa.bwd_launches = 0
    _quant().int8_launches = 0


def read_counts(fa):
    """The four attention kernels' launches, and W8A16's where it launched
    (a path expecting none then fails its comparison)."""
    counts = {'flash_attention': fa.launches, 'flash_attention_with_lse': fa.lse_launches,
              'headmean_probs': fa.headmean_launches, 'short_attention': fa.short_launches}
    if _quant().int8_launches:
        counts['int8_linear'] = _quant().int8_launches
    return counts


def check_feats(torch, feats, expected, label):
    if set(feats) != set(expected):
        raise RuntimeError(f'{label}: features {sorted(feats)} != {sorted(expected)}')
    for key, shape in expected.items():
        val = feats[key]
        finite = bool(torch.isfinite(val.float()).all())
        print(f'  {key}: {tuple(val.shape)} {val.dtype} finite={finite} '
              f'mean_abs={val.float().abs().mean().item():.4g}')
        if tuple(val.shape) != shape or val.dtype != torch.bfloat16 or not finite:
            raise RuntimeError(f'{label} {key}: {tuple(val.shape)} {val.dtype} finite={finite}')


def injected_step(torch, fe, prompts, images, denoising_from=None, use_ddim_inversion=False):
    """``fe._step`` (or, with ``denoising_from`` or ``use_ddim_inversion``,
    ``fe._multistep``) at t=50 on standard-normal noise drawn from seed 2,
    with ``prompts`` unpacked as ``extract`` unpacks them."""
    bsz = images.shape[0]
    gen = torch.Generator(device='cuda').manual_seed(2)
    cond = fe._step_conditioning(prompts, bsz)
    shape = fe.latent_shape(bsz)
    posterior, noise = (torch.randn(shape, generator=gen, device='cuda') for _ in range(2))
    if denoising_from is None and not use_ddim_inversion:
        return fe._step(images.to(fe.dtype), cond, fe._step_kit(50), posterior, noise,
                        torch.bfloat16)
    return fe._multistep(images.to(fe.dtype), cond, 50, denoising_from, use_ddim_inversion,
                         posterior, noise, torch.bfloat16)


def check_twin_step(torch, fe, attn_ops, fa, prompts, images, keys, label, tol=TAP_REL_TOL,
                    **kwargs):
    """The same step with the kernels and with every kernel call on its
    plain twin, on the same noise: relative L2 per feature."""
    with_kernel = injected_step(torch, fe, prompts, images, **kwargs)
    with patched_wrappers(attn_ops, twin_of(fa)):
        with_twin = injected_step(torch, fe, prompts, images, **kwargs)
    for key in keys:
        a, b = with_kernel[key].float(), with_twin[key].float()
        rel = ((a - b).norm() / b.norm()).item()
        print(f'  {label} kernel vs twin step, {key}: rel_l2={rel:.3e} (allowed {tol:g})')
        if not rel <= tol:
            raise RuntimeError(f'{label} {key} differs between kernel and twin: {rel}')


def open_path(torch, name):
    """(extractor, prompts, images) of one of PATHS: the extractor at random
    weights from seed 0, its prompt encoded, a batch of 2 images in [-1, 1]
    drawn from seed 1."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    args = PATHS[name]['args']
    fe = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0)
    prompts = fe.encode_prompt('a photo of a cat')
    size = args['img_size']
    gen = torch.Generator(device='cuda').manual_seed(1)
    return fe, prompts, torch.rand(2, 3, size, size, generator=gen, device='cuda') * 2 - 1


def extract(fe, prompts, images, **kwargs):
    """One public extract at t=50; ``kwargs`` are a path's ``'extract'``
    arguments."""
    return fe.extract(prompts, images.shape[0], images, image_type='tensor', t=50, **kwargs)


def extract_times(torch, fe, prompts, images, calls, **kwargs):
    """``calls`` extracts after two untimed ones; per call the host time
    to enqueue it and the time between CUDA events around it, in ms, each
    list sorted."""
    for _ in range(2):
        extract(fe, prompts, images, **kwargs)
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(calls):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        extract(fe, prompts, images, **kwargs)
        stop.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device.append(start.elapsed_time(stop))
    return sorted(host), sorted(device)


EXTRACT_PEAK_GIB = {}   # time_extract's label -> its peak memory in GiB


def time_extract(torch, fe, prompts, images, label, card, calls=TIMED_CALLS, **kwargs):
    """Median ms, img/s and peak memory over ``calls`` calls; returns (ms,
    peak GiB), the peak also kept in EXTRACT_PEAK_GIB under ``label``."""
    torch.cuda.reset_peak_memory_stats()
    host, times = extract_times(torch, fe, prompts, images, calls, **kwargs)
    ms = times[len(times) // 2]
    peak = EXTRACT_PEAK_GIB[label] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{label} over {len(times)} calls: median {ms:.2f} ms (min {times[0]:.2f}, '
          f'max {times[-1]:.2f}), {1000.0 * images.shape[0] / ms:.3f} img/s, '
          f'host enqueue median {host[len(host) // 2]:.2f} ms, '
          f'peak memory {peak:.2f} GiB ({card})', flush=True)
    return ms, peak


def drive_path(torch, fa, attn_ops, fe, prompts, images, expected_counts, label, **kwargs):
    """One extract with every count set to 0 just before it and read just
    after; returns (features, counts, recorded kernel calls)."""
    shapes = []
    with patched_wrappers(attn_ops, recording(shapes)):
        reset_counts(fa)
        feats = extract(fe, prompts, images, **kwargs)
        torch.cuda.synchronize()
        counts = read_counts(fa)
    print(f'{label} extract: kernel launches {counts} (expected {expected_counts})', flush=True)
    if counts != expected_counts or fa.bwd_launches:
        raise RuntimeError(f'{label}: launches {counts} != {expected_counts} or '
                           f'{fa.bwd_launches} backward launches')
    return feats, counts, shapes


def write_images(n, size):
    """``n`` seeded PNGs of ``size``^2 under imgs/ of the working directory."""
    import numpy as np
    from PIL import Image
    os.makedirs('imgs')
    rng = np.random.RandomState(5)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(f'imgs/img{i}.png')


def run_cli(argv):
    """extract_feature.main(argv) with its standard output captured;
    returns (seconds, output lines)."""
    from diffusion_feature_tpu_torch import extract_feature
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        extract_feature.main(argv)
    return time.perf_counter() - t0, out.getvalue().splitlines()


def check_cli(torch, fa, attn_ops, card, shapes, tree):
    """Phase 7: the CLI on the 'xl' path with the weights of phase 8's
    ``tree`` and its .npy tree, then --show_all_layers; returns the CLI
    run's launch counts."""
    import numpy as np
    from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
    args = PATHS[CLI_PATH]['args']
    version, size = args['version'], args['img_size']
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        write_images(CLI_IMAGES, size)
        with patched_wrappers(attn_ops, recording(shapes)):
            reset_counts(fa)
            seconds, lines = run_cli([
                '--version', version, '--img_size', str(size), '--layer', args['layer'],
                '--batch_size', '2', '--prompt', 'a photo of a cat',
                '--input_dir', 'imgs/*.png', '--output_dir', 'out',
                '--weights', tree, '--weights_variant', TREE_VARIANT])
            torch.cuda.synchronize()
            counts = read_counts(fa)
        for line in lines:
            print(f'  cli: {line}')
        print(f'phase 7 cli extract: {seconds:.1f} s for main() (model build included); kernel '
              f'launches {counts} (expected {CLI_LAUNCHES})', flush=True)
        if counts != CLI_LAUNCHES:
            raise RuntimeError(f'phase 7: launches {counts} != {CLI_LAUNCHES}')
        if 'native async dump writer active' not in lines:
            raise RuntimeError('phase 7: the native dump writer is not active')
        rate = [line for line in lines if line.endswith('img/s)')]
        print(f'phase 7 cli {args["layer"]} {size}^2 batch 2, {CLI_IMAGES} images: {rate[0]} '
              f'({card})')
        want = enumerate_layers(version, size)
        layers = sorted(os.listdir('out'))
        if layers != sorted(PATHS[CLI_PATH]['feats']):
            raise RuntimeError(f'phase 7: layer dirs {layers} != '
                               f'{sorted(PATHS[CLI_PATH]["feats"])}')
        for layer in layers:
            names = sorted(os.listdir(os.path.join('out', layer)))
            if names != [f'train{i}.npy' for i in range(CLI_IMAGES)]:
                raise RuntimeError(f'phase 7 {layer}: files {names}')
            for name in names:
                arr = np.load(os.path.join('out', layer, name))
                finite = bool(np.isfinite(arr).all())
                if arr.shape != want[layer][1:] or arr.dtype != np.float16 or not finite:
                    raise RuntimeError(f'phase 7 {layer}/{name}: {arr.shape} {arr.dtype} '
                                       f'finite={finite}, expected {want[layer][1:]} float16')
            print(f'  {layer}: {len(names)} x {arr.shape} float16 finite')
        for (version, size), count in LAYER_COUNTS.items():
            seconds, _ = run_cli(['--version', version, '--img_size', str(size),
                                  '--show_all_layers', '--output_dir', 'out_layers'])
            with open('layer_record.json') as f:
                record = json.load(f)
            print(f'phase 7 --show_all_layers {version}@{size}: {len(record)} ids in '
                  f'{seconds:.2f} s (expected {count})', flush=True)
            if len(record) != count:
                raise RuntimeError(f'phase 7: {version} enumerates {len(record)} ids')
    return counts


def module_pairs(a, b):
    """(name, module of a, module of b) over two extractors' models (no VAE
    in pixel space)."""
    return [('unet', a.unet, b.unet), *([('vae', a.vae, b.vae)] if a.vae is not None else []),
            *((f'text_encoder{i}', x, y)
              for i, (x, y) in enumerate(zip(a.text_encoders, b.text_encoders)))]


def rates(stats, verb, card, phase='8'):
    for comp, (nbytes, seconds) in stats.items():
        print(f'  {verb} {comp}: {nbytes / 1e9:.3f} GB in {seconds:.3f} s, '
              f'{nbytes / 1e9 / seconds:.3f} GB/s ({card})')
    nbytes, seconds = (sum(v[i] for v in stats.values()) for i in (0, 1))
    print(f'phase {phase} {verb} total: {nbytes / 1e9:.3f} GB in {seconds:.3f} s, '
          f'{nbytes / 1e9 / seconds:.3f} GB/s ({card})', flush=True)


def assert_equal_feats(torch, ours, ref, label):
    if ours.keys() != ref.keys():
        raise RuntimeError(f'{label}: features {sorted(ours)} != {sorted(ref)}')
    for key in ref:
        if not torch.equal(ours[key], ref[key]):
            diff = (ours[key].float() - ref[key].float()).abs().max().item()
            raise RuntimeError(f'{label} {key}: not equal (max abs diff {diff:.3e})')
    print(f'  {label}: {len(ref)} features torch.equal', flush=True)


def check_checkpoint(torch, fa, attn_ops, fe, prompts, images, first_feats, build_gib, tree,
                     card, shapes, bundle_shapes):
    """Phase 8: write ``fe`` (the TREE_PATH path's random-init extractor)
    as a diffusers tree under ``tree``, load it back and hold it to the
    source, write the loaded extractor as a deployment bundle and load that
    (8b), then merge a LoRA; returns the launch counts of the loaded
    extractor's first public extract and of the bundle's."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.io.safetensors import save_file
    args = PATHS[TREE_PATH]['args']
    written = fe.save_weights(tree, variant=TREE_VARIANT, unet_shards=TREE_UNET_SHARDS)
    files = sorted(os.path.relpath(os.path.join(d, f), tree)
                   for d, _, names in os.walk(tree) for f in names)
    print(f'phase 8 tree of {sum(n for n, _ in written.values())} bytes: {files}')
    rates(written, 'write', card)

    def load(**kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0, weights=tree,
                               weights_variant=TREE_VARIANT, **kwargs)
        out_prompts = out.encode_prompt('a photo of a cat')
        torch.cuda.synchronize()
        return (out, out_prompts, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)

    loaded, loaded_prompts, seconds, peak = load()
    rates(loaded.load_stats, 'load', card)
    print(f'phase 8 build from the tree + encode_prompt: {seconds:.1f} s; peak memory '
          f'{peak:.3f} GiB while loading vs {build_gib:.3f} GiB for the random-init build '
          f'(ratio {peak / build_gib:.4f}, allowed {LOAD_PEAK_RATIO}) ({card})', flush=True)
    if peak > LOAD_PEAK_RATIO * build_gib:
        raise RuntimeError(f'phase 8: load peak {peak:.3f} GiB over {LOAD_PEAK_RATIO} x '
                           f'{build_gib:.3f} GiB')
    for name, a, b in module_pairs(fe, loaded):
        sa, sb = a.state_dict(), b.state_dict()
        bad = [k for k in sa if k not in sb or not torch.equal(sa[k], sb[k])]
        if bad or sa.keys() != sb.keys():
            raise RuntimeError(f'phase 8 {name}: parameters differ from the source: {bad[:5]}')
        print(f'  {name}: {len(sa)} parameters torch.equal to the source')
    for a, b in zip(prompts, loaded_prompts):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise RuntimeError('phase 8: encode_prompt differs from the source')

    # the public extract: the loaded extractor's first, against phase 3's first
    feats, counts, shapes[:] = drive_path(
        torch, fa, attn_ops, loaded, loaded_prompts, images,
        {**dict(zip(WRAPPERS, PATHS[TREE_PATH]['launches'])), 'short_attention': 0},
        'phase 8 loaded')
    assert_equal_feats(torch, feats, first_feats, 'phase 8 first public extract vs the source')
    reset_counts(fa)
    ours = injected_step(torch, loaded, loaded_prompts, images)
    torch.cuda.synchronize()
    step_counts = read_counts(fa)
    if step_counts != counts:
        raise RuntimeError(f'phase 8 step: launches {step_counts} != {counts}')
    unmerged = injected_step(torch, fe, prompts, images)
    assert_equal_feats(torch, ours, unmerged, f'phase 8 step on injected noise {step_counts}')
    del feats, ours
    bundle_counts = check_bundle(torch, fa, attn_ops, loaded, loaded_prompts, images,
                                 first_feats, build_gib, written, card, bundle_shapes)
    del loaded
    torch.cuda.empty_cache()

    # a rank-4 peft LoRA over one level-2 block's to_q and to_v
    gen = torch.Generator(device='cuda').manual_seed(3)
    params = dict(fe.unet.named_parameters())
    lora, want = {}, {}
    for proj in ('to_q', 'to_v'):
        w = params[f'{LORA_BLOCK}.{proj}.weight']
        down = (torch.randn(LORA_RANK, w.shape[1], generator=gen, device='cuda') * 0.05).bfloat16()
        up = (torch.randn(w.shape[0], LORA_RANK, generator=gen, device='cuda') * 0.05).bfloat16()
        key = f'unet.{LORA_BLOCK}.{proj}'
        lora.update({f'{key}.lora_A.weight': down, f'{key}.lora_B.weight': up,
                     f'{key}.alpha': torch.tensor(LORA_ALPHA)})
        want[proj] = (w.float() + (LORA_ALPHA / LORA_RANK) * (up.float() @ down.float())
                      ).to(w.dtype)
    lora_path = os.path.join(tree, 'lora.safetensors')
    save_file(lora, lora_path)
    merged, merged_prompts, seconds, peak = load(offline_lora=lora_path)
    print(f'phase 8 build with offline_lora: {seconds:.1f} s, peak {peak:.3f} GiB')
    merged_params = dict(merged.unet.named_parameters())
    for proj, expected in want.items():
        got = merged_params[f'{LORA_BLOCK}.{proj}.weight'].float()
        source = params[f'{LORA_BLOCK}.{proj}.weight'].float()
        # one bf16 rounding of the fp32 sum: at most eps * |value|
        ulp = torch.finfo(torch.bfloat16).eps * expected.float().abs().clamp_min(2.0 ** -126)
        ratio = ((got - expected.float()).abs() / ulp).max().item()
        moved = (got - source).abs().max().item()
        print(f'  lora {LORA_BLOCK}.{proj}: merged vs W + (alpha/r) up@down (fp32 on the '
              f'card) within {ratio:.3f} of a bf16 ulp; max change from W {moved:.3e}')
        if not ratio <= 1.0 or moved == 0.0:
            raise RuntimeError(f'phase 8 lora {proj}: {ratio} ulp, change {moved}')
    lora_feats = injected_step(torch, merged, merged_prompts, images)
    for key, val in lora_feats.items():
        finite = bool(torch.isfinite(val.float()).all())
        rel = ((val.float() - unmerged[key].float()).norm() / unmerged[key].float().norm()).item()
        print(f'  lora step {key}: finite={finite}, rel_l2 from the unmerged step {rel:.3e}')
        if not finite or rel == 0.0:
            raise RuntimeError(f'phase 8 lora {key}: finite={finite} rel_l2={rel}')
    del merged
    torch.cuda.empty_cache()
    return counts, bundle_counts


def bundle_bytes(root) -> dict:
    """{component: bytes} of a deployment bundle's weight files."""
    params = os.path.join(root, 'params')
    return {name.split('.')[0]: os.path.getsize(os.path.join(params, name))
            for name in sorted(os.listdir(params))}


def write_bundle(torch, fe, root, label, card, tree_seconds, tree_bytes):
    """``fe.save_converted(root)``, timed; prints the bytes per component
    and the GB/s beside those of the tree the extractor was loaded from."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe.save_converted(root)
    seconds = time.perf_counter() - t0
    sizes = bundle_bytes(root)
    nbytes = sum(sizes.values())
    parts = ', '.join(f'{c} {n / 1e9:.3f} GB' for c, n in sizes.items())
    print(f'{label} save_converted: {nbytes / 1e9:.3f} GB in {seconds:.3f} s, '
          f'{nbytes / 1e9 / seconds:.3f} GB/s ({parts}); '
          f'the tree: {tree_bytes / 1e9:.3f} GB in {tree_seconds:.3f} s, '
          f'{tree_bytes / 1e9 / tree_seconds:.3f} GB/s ({card})', flush=True)
    return nbytes, seconds


def check_bundle(torch, fa, attn_ops, source, prompts, images, first_feats, build_gib,
                 tree_stats, card, shapes):
    """Phase 8b: ``source`` (phase 8's extractor, loaded from the tree)
    written as a deployment bundle (save_converted) and loaded back with
    default arguments: every parameter and encode_prompt torch.equal to the
    source's, the first public extract torch.equal to phase 3's first with
    the path's launches, the load's peak within LOAD_PEAK_RATIO of the
    random-init build's; write and load seconds and GB/s beside the
    tree's.  The bundle is deleted before the function returns; returns the
    extract's launch counts."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    args = PATHS[TREE_PATH]['args']
    with tempfile.TemporaryDirectory(prefix='chip_smoke_bundle_') as tmp:
        root = os.path.join(tmp, 'bundle')
        write_bundle(torch, source, root, 'phase 8b', card, sum(v[1] for v in tree_stats.values()),
                     sum(v[0] for v in tree_stats.values()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fe = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0, weights=root)
        fe_prompts = fe.encode_prompt('a photo of a cat')
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        rates(fe.load_stats, 'load', card, '8b')
        tree_load = sum(v[1] for v in source.load_stats.values())
        print(f'phase 8b build from the bundle + encode_prompt: {seconds:.1f} s (the tree\'s '
              f'load: {tree_load:.3f} s); peak memory {peak:.3f} GiB while loading vs '
              f'{build_gib:.3f} GiB for the random-init build (ratio {peak / build_gib:.4f}, '
              f'allowed {LOAD_PEAK_RATIO}) ({card})', flush=True)
        if peak > LOAD_PEAK_RATIO * build_gib:
            raise RuntimeError(f'phase 8b: load peak {peak:.3f} GiB over {LOAD_PEAK_RATIO} x '
                               f'{build_gib:.3f} GiB')
        for name, a, b in module_pairs(source, fe):
            sa, sb = a.state_dict(), b.state_dict()
            bad = [k for k in sa if k not in sb or sa[k].dtype != sb[k].dtype
                   or not torch.equal(sa[k], sb[k])]
            if bad or sa.keys() != sb.keys():
                raise RuntimeError(f'phase 8b {name}: parameters differ from the tree load\'s: '
                                   f'{bad[:5]}')
            print(f'  {name}: {len(sa)} parameters torch.equal to the tree load\'s')
        for a, b in zip(prompts, fe_prompts):
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise RuntimeError('phase 8b: encode_prompt differs from the tree load\'s')
        feats, counts, shapes[:] = drive_path(
            torch, fa, attn_ops, fe, fe_prompts, images,
            {**dict(zip(WRAPPERS, PATHS[TREE_PATH]['launches'])), 'short_attention': 0},
            'phase 8b bundle')
        assert_equal_feats(torch, feats, first_feats,
                           'phase 8b first public extract vs phase 3\'s first')
        del fe, feats
    torch.cuda.empty_cache()
    return counts


def b1_per_forward(fa, cfg, latent: int, encoder_only: bool = False) -> int:
    """B1 launches of one U-Net forward on a ``latent``^2 latent (with
    ``encoder_only``, of one ControlNet: the down levels and the mid block),
    derived from the config: the self-attentions whose shape the gate admits
    on the card (cross-attention's 77 keys never pass)."""
    return sum(passes for key, passes in unet_self_attentions(fa, cfg, latent)
               if not encoder_only or key[0] < 2)


def vae_b1(fa, cfg, latent: int) -> int:
    """B1 launches of the VAE encoder's (or decoder's) mid-block attention:
    one head as wide as the last level, over the latent's tokens."""
    d = cfg.block_out_channels[-1]
    return int(fa.is_flash_compatible((1, 1, latent ** 2, d), (1, 1, latent ** 2, d)))


def dit_launches(fa, fe) -> dict:
    """The four launch counts of one DiT extract, derived from the config
    through the JAX package's gate (no head-width condition: a width the
    card's kernels lack then fails the count instead of moving the
    self-attentions to the explicit path unseen), and the VAE encoder's
    mid head.  PixArt: each block's self-attention on B1, or with the
    store's 'up_self' in its band on B2 and B3 (cross-attention carries the
    T5 mask: explicit).  HunyuanDiT: each block's self-attention on B1,
    except where a '-self-map' tap or the store's 'up_self' in its band
    wants the probabilities: the explicit path then, as in JAX (no B2/B3);
    cross-attention (333 keys) and the T5 pool are explicit.  Flux: each
    dual and single block's joint attention (text + image tokens) on B1,
    except where a '-cross-map' or '-self-map' tap or the store in its band
    wants the probabilities: the explicit path then, as in JAX (no
    B2/B3)."""
    cfg = fe.spec.dit
    latent = fe.img_size // fe.vae_scale
    if fe.spec.family == 'flux':
        image = (latent // 2) ** 2
        shape = (1, cfg.num_attention_heads, fe.spec.prompt_max_length + image,
                 cfg.attention_head_dim)
        store = (bool({'up_cross', 'up_self'} & set(fe.attention or ()))
                 and fe._attn_sizes[0] ** 2 <= image <= fe._attn_sizes[1] ** 2)
        fused = 0 if store else sum(
            not any(fe.taps.wants(f'vit-block{i}-{m}') for m in ('cross-map', 'self-map'))
            for i in range(cfg.num_layers + cfg.num_single_layers))
        return only_b1(fused * fa.is_flash_compatible(shape, shape, head_dims=None)
                       + vae_b1(fa, fe.spec.vae, latent))
    tokens = (latent // cfg.patch_size) ** 2
    hunyuan = fe.spec.family == 'hunyuan'
    head_dim = cfg.head_dim if hunyuan else cfg.attention_head_dim
    shape = (1, cfg.num_attention_heads, tokens, head_dim)
    store = ('up_self' in (fe.attention or ())
             and fe._attn_sizes[0] ** 2 <= tokens <= fe._attn_sizes[1] ** 2)
    if hunyuan:
        fused = 0 if store else sum(not fe.taps.wants(f'vit-block{i}-self-map')
                                    for i in range(cfg.num_layers))
        return only_b1(fused * fa.is_flash_compatible(shape, shape, head_dims=None)
                       + vae_b1(fa, fe.spec.vae, latent))
    flash = cfg.num_layers * fa.is_flash_compatible(shape, shape, head_dims=None)
    lse = cfg.num_layers * fa.is_flash_compatible(shape, shape, 512, head_dims=None)
    return {'flash_attention': (0 if store else flash) + vae_b1(fa, fe.spec.vae, latent),
            'flash_attention_with_lse': lse if store else 0,
            'headmean_probs': lse if store else 0, 'short_attention': 0}


def if_launches(fa, fe) -> dict:
    """The four launch counts of one DeepFloyd IF forward, derived from the
    config through the JAX package's gate (no head-width condition): each
    added-KV attention of a SimpleCrossAttn level (and the mid block's)
    has the level's S image tokens as queries and the prompt's tokens and
    the image's as keys, so 77 + S keys, never a multiple of 256.  The
    text-time pooling head is explicit, outside the gate, in both
    packages."""
    cfg, text = fe.spec.unet, fe.spec.prompt_max_length
    levels = len(cfg.block_out_channels)
    attns = [(lv, cfg.layers_per_block) for lv, kind in enumerate(cfg.down_block_types)
             if kind == 'SimpleCrossAttnDownBlock2D']
    attns.append((levels - 1, 1))
    attns += [(levels - 1 - u, cfg.layers_per_block + 1) for u, kind
              in enumerate(cfg.up_block_types) if kind == 'SimpleCrossAttnUpBlock2D']
    n = 0
    for level, count in attns:
        tokens, d = (fe.img_size >> level) ** 2, cfg.attention_head_dim
        heads = cfg.block_out_channels[level] // d
        n += count * fa.is_flash_compatible((1, heads, tokens, d), (1, heads, text + tokens, d),
                                            head_dims=None)
    return only_b1(n)


def path_launches(fa, fe) -> dict:
    """A DiT's or IF's launch counts of one extract (dit_launches,
    if_launches)."""
    return if_launches(fa, fe) if fe.spec.family == 'if' else dit_launches(fa, fe)


def only_b1(b1):
    """The four launch counts of a path that launches ``b1`` B1 kernels and
    nothing else."""
    return {'flash_attention': b1, 'flash_attention_with_lse': 0, 'headmean_probs': 0,
            'short_attention': 0}


def rel_cos(a, b):
    """(relative L2 of a against b, cosine of a and b), in fp64."""
    a, b = a.double().flatten(), b.double().flatten()
    return ((a - b).norm() / b.norm()).item(), (a @ b / (a.norm() * b.norm())).item()


def peak_above(torch, fn):
    """(fn(), GiB at the peak of the call above what was allocated before
    it, GiB allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30, base / 2 ** 30


def timed_sample(torch, fe, prompts, noise, steps, guidance, step_noise=None):
    """``fe._sample`` on ``noise`` and the conditioning of ``prompts``
    (DDPM's with ``step_noise``) with CUDA events around it; returns (images,
    features, latents, ms, the call's peak memory in GiB above what was
    allocated before it, GiB allocated before it)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    conds = fe._sample_conditioning(prompts, noise.shape[0], guidance)

    def run():
        start.record()
        out = fe._sample(*conds, noise, steps, guidance, step_noise)
        stop.record()
        return out
    out, peak, base = peak_above(torch, run)
    return (*out, start.elapsed_time(stop), peak, base)


def check_generation(torch, fa, attn_ops, card, shapes, runs):
    """Phase 12 (a) to (d); returns the CLI's SD-1.5 extractor."""
    from PIL import Image
    from diffusion_feature_tpu_torch import FeatureExtractor, generate_with_extraction
    from diffusion_feature_tpu_torch.models.registry import get_model_spec
    from diffusion_feature_tpu_torch.schedulers.diffusion import make_scheduler

    # (a) the CLI at its defaults
    args = generate_with_extraction.build_parser().parse_args([])
    spec = get_model_spec(args.version)
    latent = args.img_size // 2 ** (len(spec.vae.block_out_channels) - 1)
    calls = len(make_scheduler(spec.scheduler, spec.scheduler_config)
                .set_timesteps(args.steps).timesteps)
    per_call, decode = b1_per_forward(fa, spec.unet, latent), vae_b1(fa, spec.vae, latent)
    want = only_b1(calls * per_call + decode)
    print(f'phase 12a generate_with_extraction at its defaults ({args.version} {args.img_size}^2, '
          f'{args.layer}, {args.steps} steps, guidance {args.guidance_scale}, store_steps '
          f'{args.store_steps}): {calls} U-Net calls x {per_call} B1 + {decode} (decoder) = '
          f'{want["flash_attention"]} B1 launches expected', flush=True)
    shapes['gen_cli'] = []
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        out = io.StringIO()
        with patched_wrappers(attn_ops, recording(shapes['gen_cli'])):
            reset_counts(fa)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                fe = generate_with_extraction.main([])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            runs['gen_cli'] = read_counts(fa)
        size = Image.open(args.output).size
    lines = out.getvalue().splitlines()
    print(f'phase 12a cli: {seconds:.1f} s for main() (model build included), {len(lines)} lines, '
          f'first {lines[0]!r}, last {lines[-1]!r}; image {size}; kernel launches '
          f'{runs["gen_cli"]} ({card})', flush=True)
    if runs['gen_cli'] != want or size != (args.img_size, args.img_size):
        raise RuntimeError(f'phase 12a: launches {runs["gen_cli"]} != {want} or image {size}')
    kept = fe.get_background_extraction()
    for layer, by_step in sorted(kept.items()):
        bad = [i for i, v in by_step.items()
               if v.shape[0] != 2 or not bool(torch.isfinite(v.float()).all())]
        print(f'  {layer}: kept {sorted(by_step)} of {fe._background_feats[layer]["count"]}, '
              f'{tuple(by_step[1].shape)} {by_step[1].dtype}')
        if sorted(by_step) != sorted(args.store_steps) or bad:
            raise RuntimeError(f'phase 12a {layer}: kept {sorted(by_step)}, bad {bad}')
    if set(kept) != set(fe.taps.ids):
        raise RuntimeError(f'phase 12a: kept layers {sorted(kept)} != {sorted(fe.taps.ids)}')

    # (b) SDXL sample() at 1024^2
    xl = FeatureExtractor(**XL_SAMPLE, device='cuda', dtype='bfloat16', seed=0)
    xl_prompts = xl.encode_prompt('a photograph of an astronaut riding a horse')
    xl_latent = xl.img_size // xl.vae_scale
    xl_calls = len(xl.scheduler.set_timesteps(XL_SAMPLE_STEPS).timesteps)
    want = only_b1(xl_calls * b1_per_forward(fa, xl.spec.unet, xl_latent)
                  + vae_b1(fa, xl.spec.vae, xl_latent))
    shapes['xl_sample'] = []
    with patched_wrappers(attn_ops, recording(shapes['xl_sample'])):
        reset_counts(fa)
        images, feats = xl.sample(xl_prompts, 1, XL_SAMPLE_STEPS, XL_GUIDANCE)
        torch.cuda.synchronize()
        runs['xl_sample'] = read_counts(fa)
    lo, hi = images.float().min().item(), images.float().max().item()
    print(f'phase 12b xl sample {xl.img_size}^2 batch 1, {XL_SAMPLE_STEPS} Euler steps, guidance '
          f'{XL_GUIDANCE}: images {tuple(images.shape)} {images.dtype} in [{lo:.4f}, {hi:.4f}]; '
          f'kernel launches {runs["xl_sample"]} (expected {want}: {xl_calls} calls)', flush=True)
    ok = (runs['xl_sample'] == want and tuple(images.shape) == (1, 3, xl.img_size, xl.img_size)
          and 0 <= lo and hi <= 1 and bool(torch.isfinite(images.float()).all()))
    if not ok:
        raise RuntimeError('phase 12b: xl sample launches, shape or range')
    for key, encounters in feats.items():
        if len(encounters) != xl_calls or encounters[0].shape[0] != 2:
            raise RuntimeError(f'phase 12b {key}: {len(encounters)} encounters')
    del images, feats
    noise = torch.randn((1, 4, xl_latent, xl_latent),
                        generator=torch.Generator(device='cuda').manual_seed(7), device='cuda')
    *_, ms, gib, base = timed_sample(torch, xl, xl_prompts, noise, XL_SAMPLE_STEPS, XL_GUIDANCE)
    print(f'phase 12b xl sample timed: {ms:.2f} ms per sample, {ms / xl_calls:.2f} ms per step '
          f'({xl_calls} U-Net calls at CFG batch 2 and the decode); peak memory {gib:.2f} GiB '
          f'above the {base:.2f} GiB held before it ({card})', flush=True)
    del xl
    torch.cuda.empty_cache()

    # (c) SD-1.5 sample on the kernels and on the twins, from one draw
    prompts = fe.encode_prompt(args.prompt)
    noise = torch.randn((1, 4, latent, latent),
                        generator=torch.Generator(device='cuda').manual_seed(7), device='cuda')
    conds = fe._sample_conditioning(prompts, 1, args.guidance_scale)
    with_kernel = fe._sample(*conds, noise, TWIN_SAMPLE_STEPS, args.guidance_scale)
    with patched_wrappers(attn_ops, twin_of(fa)):
        with_twin = fe._sample(*conds, noise, TWIN_SAMPLE_STEPS, args.guidance_scale)
    pairs = [('images', with_kernel[0], with_twin[0])]
    pairs += [(f'{k} call {i + 1}', a, b) for k in with_twin[1]
              for i, (a, b) in enumerate(zip(with_kernel[1][k], with_twin[1][k]))]
    worst = max(rel_cos(a, b)[0] for _, a, b in pairs)
    print(f'phase 12c sd15 sample, {TWIN_SAMPLE_STEPS} steps, kernel vs twin: images and '
          f'{len(pairs) - 1} tap encounters, worst rel_l2={worst:.3e} (allowed '
          f'{MULTISTEP_REL_TOL:g})', flush=True)
    if not worst <= MULTISTEP_REL_TOL:
        raise RuntimeError(f'phase 12c: kernel vs twin {worst}')
    del with_kernel, with_twin

    # (d) bf16 against fp32, the same weights (fp32 copies of the bf16
    # ones) and the same fp32 draw
    runs16 = timed_sample(torch, fe, prompts, noise, args.steps, args.guidance_scale)
    print(f'phase 12d sd15 sample bf16 timed: {runs16[3]:.2f} ms per sample, '
          f'{runs16[3] / calls:.2f} ms per step ({calls} U-Net calls at CFG batch 2 and the '
          f'decode); peak memory {runs16[4]:.2f} GiB above the {runs16[5]:.2f} GiB held before '
          f'it ({card})', flush=True)
    fe32 = FeatureExtractor(args.layer, args.version, device='cuda', dtype='float32',
                            img_size=args.img_size, seed=0)
    for _, a, b in module_pairs(fe, fe32):
        b.load_state_dict(a.state_dict())
    runs32 = timed_sample(torch, fe32, fe32.encode_prompt(args.prompt), noise, args.steps,
                          args.guidance_scale)
    print(f'phase 12d sd15 sample fp32: {runs32[3]:.2f} ms, peak {runs32[4]:.2f} GiB above the '
          f'{runs32[5]:.2f} GiB held before it ({card})')
    for name, i in (('latents', 2), ('images', 0)):
        rel, cos = rel_cos(runs16[i], runs32[i])
        finite = bool(torch.isfinite(runs16[i].float()).all() and torch.isfinite(runs32[i]).all())
        print(f'phase 12d drift bf16 vs fp32, final {name}: rel_l2={rel:.4e} cosine={cos:.6f} '
              f'finite={finite}', flush=True)
        if not finite:
            raise RuntimeError(f'phase 12d: {name} not finite')
    for key in sorted(runs32[1]):
        cos = [rel_cos(runs16[1][key][i - 1], runs32[1][key][i - 1])[1] for i in DRIFT_STEPS]
        print(f'  drift {key}: cosine at calls {DRIFT_STEPS}: '
              + ' '.join(f'{c:.6f}' for c in cos))
        if not all(c == c for c in cos):
            raise RuntimeError(f'phase 12d {key}: not finite')
    del fe32, runs16, runs32
    torch.cuda.empty_cache()
    return fe


def write_control_tree(torch, fe15, tree):
    """``fe15``'s weights as a diffusers tree under ``tree``, with a random
    ``controlnet_{kind}`` per CONTROL_KINDS (every weight drawn, the zero
    convs too, as a trained net's) and a random Intel/dpt-large-shaped
    ``depth_estimator`` (fp32, transformers' keys)."""
    from diffusion_feature_tpu_torch.models import controlnet
    from diffusion_feature_tpu_torch.models.convert import random_module, save_component
    from diffusion_feature_tpu_torch.models.depth import DPTConfig, DPTDepthModel
    fe15.save_weights(tree)
    for i, kind in enumerate(CONTROL_KINDS):
        net = random_module(lambda: controlnet.ControlNetModel(
            fe15.spec.unet, controlnet.cond_embed_channels(fe15.vae_scale)),
            'cuda', torch.bfloat16, torch.Generator(device='cuda').manual_seed(20 + i))
        save_component(tree, f'controlnet_{kind}', net.state_dict(), net.to_diffusers_config())
    dpt = random_module(lambda: DPTDepthModel(DPTConfig()), 'cuda', torch.float32,
                        torch.Generator(device='cuda').manual_seed(30))
    save_component(tree, 'depth_estimator', dpt.state_dict(),
                   DPTConfig().to_transformers_config())


def check_control(torch, fa, attn_ops, card, fe15, shapes, runs):
    """Phase 13: a random SD-1.5 + ControlNet + DPT tree written and loaded,
    the control extract, its twin step and timing, the preprocessors' host
    times, then the CLI with --control over three images."""
    import numpy as np
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
    from diffusion_feature_tpu_torch.models import controlnet
    with tempfile.TemporaryDirectory(prefix='chip_smoke_control_') as tree:
        t0 = time.perf_counter()
        write_control_tree(torch, fe15, tree)
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tree)
                     for f in fs)
        print(f'phase 13 tree: {nbytes / 1e9:.3f} GB in {time.perf_counter() - t0:.1f} s '
              f'({sorted(os.listdir(tree))})', flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fe = FeatureExtractor(**CONTROL_ARGS, device='cuda', dtype='bfloat16', seed=0,
                              weights=tree, control=list(CONTROL_KINDS))
        prompts = fe.encode_prompt('a photo of a cat')
        torch.cuda.synchronize()
        print(f'phase 13 build from the tree with control={list(CONTROL_KINDS)}: '
              f'{time.perf_counter() - t0:.1f} s, peak '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB', flush=True)
        size = CONTROL_ARGS['img_size']
        gen = torch.Generator(device='cuda').manual_seed(1)
        images = torch.rand(2, 3, size, size, generator=gen, device='cuda') * 2 - 1
        latent = size // fe.vae_scale
        per_net = b1_per_forward(fa, fe.spec.unet, latent, encoder_only=True)
        want = only_b1(b1_per_forward(fa, fe.spec.unet, latent)
                      + len(CONTROL_KINDS) * per_net + vae_b1(fa, fe.spec.vae, latent))
        print(f'phase 13 B1 per control extract: U-Net {b1_per_forward(fa, fe.spec.unet, latent)}'
              f' + {len(CONTROL_KINDS)} ControlNets x {per_net} + VAE encoder '
              f'{vae_b1(fa, fe.spec.vae, latent)}')
        feats, runs['control'], shapes['control'] = drive_path(
            torch, fa, attn_ops, fe, prompts, images, want, 'phase 13', use_control=True)
        check_feats(torch, feats, CONTROL_FEATS, 'phase 13')

        # the control images as extract makes them from tensors
        control = fe.control_pipe.prepare_control_images(
            fe.control_pipe.tensors_to_pil(images.to(fe.dtype)), 2)
        cond = fe._step_conditioning(prompts, 2)
        gen = torch.Generator(device='cuda').manual_seed(2)
        posterior, noise = (torch.randn((2, 4, latent, latent), generator=gen, device='cuda')
                            for _ in range(2))

        def step(ctrl):
            return fe._step(images.to(fe.dtype), cond, fe._img2img_kit(50), posterior, noise,
                            torch.bfloat16, ctrl)
        with_kernel = step(control)
        with patched_wrappers(attn_ops, twin_of(fa)):
            with_twin = step(control)
        plain = step(None)
        for key in CONTROL_FEATS:
            rel = rel_cos(with_kernel[key], with_twin[key])[0]
            moved = rel_cos(plain[key], with_kernel[key])[0]
            finite = bool(torch.isfinite(with_kernel[key].float()).all())
            print(f'  phase 13 {key}: kernel vs twin rel_l2={rel:.3e} (allowed {TAP_REL_TOL:g}); '
                  f'use_control=False vs True rel_l2={moved:.3e}; finite={finite}')
            if not (rel <= TAP_REL_TOL and moved > 0 and finite):
                raise RuntimeError(f'phase 13 {key}: twin {rel}, moved {moved}, finite {finite}')
        del with_kernel, with_twin, plain
        time_extract(torch, fe, prompts, images, f'phase 13 control extract {size}^2 batch 2, '
                     f'{len(CONTROL_KINDS)} ControlNets', card, use_control=True)

        # the preprocessors on one 512^2 image
        pil = fe.control_pipe.tensors_to_pil(images[:1].to(fe.dtype))[0]
        arr = np.asarray(pil)
        canny_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            controlnet.canny_edges(arr)
            canny_s.append(time.perf_counter() - t0)
        est = fe.control_pipe.nets[CONTROL_KINDS.index('depth')].preprocess
        est(pil)
        est_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            est(pil)
            est_s.append(time.perf_counter() - t0)
        x = torch.zeros(1, 3, est.cfg.image_size, est.cfg.image_size, device='cuda')
        fwd = {}
        # as set for this run (no TF32 anywhere), then with PyTorch's default
        # for convolutions (cuDNN in TF32; matrix products stay fp32)
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.inference_mode():
                fwd[tf32] = (time_ms(torch, lambda: est.model(x), runs=3),
                             peak_above(torch, lambda: est.model(x))[1])
        torch.backends.cudnn.allow_tf32 = False
        print(f'phase 13 host: canny_edges {sorted(canny_s)[1] * 1e3:.1f} ms per {size}^2 image '
              f'(numpy); DPT estimator {sorted(est_s)[1] * 1e3:.1f} ms per {size}^2 image (PIL '
              f'resizes, fp32 forward, min/max, resize back), of which the forward at '
              f'{est.cfg.image_size}^2 is {fwd[False][0]:.2f} ms on the card, peak '
              f'{fwd[False][1]:.2f} GiB above the weights; with cuDNN convolutions in TF32 '
              f'{fwd[True][0]:.2f} ms, peak {fwd[True][1]:.2f} GiB ({card})', flush=True)
        del fe, feats
        torch.cuda.empty_cache()

        # the CLI with --control over three images
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            write_images(CONTROL_CLI_IMAGES, size)
            shapes['control_cli'] = []
            with patched_wrappers(attn_ops, recording(shapes['control_cli'])):
                reset_counts(fa)
                seconds, lines = run_cli([
                    '--version', CONTROL_ARGS['version'], '--img_size', str(size),
                    '--layer', CONTROL_ARGS['layer'], '--batch_size', '2',
                    '--prompt', 'a photo of a cat', '--input_dir', 'imgs/*.png',
                    '--output_dir', 'out', '--weights', tree, '--control', *CONTROL_KINDS])
                torch.cuda.synchronize()
                runs['control_cli'] = read_counts(fa)
            batches = -(-CONTROL_CLI_IMAGES // 2)
            want_cli = only_b1(batches * want['flash_attention'])
            rate = [line for line in lines if line.endswith('img/s)')]
            print(f'phase 13 cli --control {" ".join(CONTROL_KINDS)}: {seconds:.1f} s for main(), '
                  f'{rate[0]}; kernel launches {runs["control_cli"]} (expected {want_cli}) '
                  f'({card})', flush=True)
            if runs['control_cli'] != want_cli:
                raise RuntimeError(f'phase 13 cli: launches {runs["control_cli"]}')
            enumerated = enumerate_layers(CONTROL_ARGS['version'], size)
            layers = sorted(os.listdir('out'))
            if layers != sorted(CONTROL_FEATS):
                raise RuntimeError(f'phase 13 cli: layer dirs {layers}')
            for layer in layers:
                names = sorted(os.listdir(os.path.join('out', layer)))
                if names != [f'train{i}.npy' for i in range(CONTROL_CLI_IMAGES)]:
                    raise RuntimeError(f'phase 13 cli {layer}: files {names}')
                for name in names:
                    arr = np.load(os.path.join('out', layer, name))
                    if (arr.shape != enumerated[layer][1:] or arr.dtype != np.float16
                            or not np.isfinite(arr).all()):
                        raise RuntimeError(f'phase 13 cli {layer}/{name}: {arr.shape} {arr.dtype}')
                print(f'  {layer}: {len(names)} x {arr.shape} float16 finite')


def describe_prompts(prompts) -> str:
    """A DiT's encode_prompt result in a few words: PixArt's embeddings and
    mask, HunyuanDiT's BERT and T5 pairs, or Flux's T5 embeddings and CLIP
    pooled vector."""
    if isinstance(prompts[0], tuple):
        return '; '.join(f'{name} embeds {tuple(e.shape)}, mask with {int(m.sum())} tokens'
                         for name, (e, m) in zip(('BERT', 'T5'), prompts))
    if prompts[2] is None and prompts[1] is not None and prompts[1].dim() == 3:
        return f'T5 embeds {tuple(prompts[0].shape)}, negative {tuple(prompts[1].shape)}'
    if prompts[1] is None:
        return f'T5 embeds {tuple(prompts[0].shape)}, CLIP pooled {tuple(prompts[2].shape)}'
    return (f'prompt_embeds {tuple(prompts[0].shape)}, mask {tuple(prompts[1].shape)} '
            f'{prompts[1].dtype} with {int(prompts[1].sum())} tokens')


def flat_prompts(prompts):
    """The tensors of an encode_prompt result, nested pairs flattened (its
    None slots left out)."""
    out = []
    for x in prompts:
        out.extend(flat_prompts(x) if isinstance(x, tuple) else [] if x is None else [x])
    return out


def fingerprints(torch, fe) -> dict:
    """{module/parameter: an exact integer fingerprint}: each parameter's
    bytes dotted in int64 with fixed weights from 1 to 99991, so a loaded
    copy can be held to a source that no longer sits on the card."""
    out = {}
    for mod, module, _ in module_pairs(fe, fe):
        for key, t in module.state_dict().items():
            bits = t.detach().reshape(-1).view(torch.uint8).long()
            weights = torch.arange(bits.numel(), device=bits.device) * 2654435761 % 99991 + 1
            out[f'{mod}/{key}'] = int((bits * weights).sum())
    return out


def open_dit(torch, name, phase):
    """``open_path`` of a DiT path with its build's peak memory in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fe, prompts, images = open_path(torch, name)
    torch.cuda.synchronize()
    gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f'phase {phase} {name} build + encode_prompt: {time.perf_counter() - t0:.1f} s, peak '
          f'{gib:.3f} GiB; {describe_prompts(prompts)}', flush=True)
    return fe, prompts, images, gib


def check_dit_path(torch, fa, attn_ops, card, name, shapes, runs, label):
    """Phase 14 (a) to (c) and 15 (a) to (c): one DiT path's extract with
    exact launch counts, its features, the same step on the twins and its
    timing; returns (extractor, prompts, images, first features, build
    GiB)."""
    fe, prompts, images, gib = open_dit(torch, name, label.split()[-1][:2])
    path = PATHS[name]
    want = dit_launches(fa, fe)
    feats, runs[name], shapes[name] = drive_path(torch, fa, attn_ops, fe, prompts, images, want,
                                                 label)
    check_feats(torch, feats, path['feats'], label)
    gib_maps = sum(s[0] * s[2] * s[3] * 2 for n, s, _ in shapes[name]
                   if n == 'headmean_probs') / 2 ** 30
    if gib_maps:
        print(f'  {label} head-mean maps from B3 kept by the store: {gib_maps:.3f} GiB (bf16)')
    check_twin_step(torch, fe, attn_ops, fa, prompts, images, path['feats'], label)
    size = path['args']['img_size']
    time_extract(torch, fe, prompts, images, f'{label} {name} extract {size}^2 batch 2', card,
                 path.get('calls', TIMED_CALLS))
    return fe, prompts, images, feats, gib


TREE_WRITES = {}   # phase tag -> save_weights' {component: (bytes, seconds)}


def check_dit_tree(torch, fa, attn_ops, card, fe, prompts, images, first_feats, build_gib,
                   tree, shapes, runs, name, text_shards, phase, unet_shards=1):
    """Phase 14 (d) and (e), 15 (d), 16 (d): ``fe`` (path ``name`` at random)
    written by ``save_weights`` (the denoiser in ``unet_shards`` files, the
    text encoders in ``text_shards``) and loaded back, parameters (their
    fingerprints, and their tensors where the source is kept), prompts and
    the first extract ``torch.equal``, then the CLI over three images on
    the tree.  ``fe`` given as a one-element list is taken out of it and
    freed once written (two Flux extractors do not fit the card)."""
    import numpy as np
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
    from diffusion_feature_tpu_torch.models.registry import get_model_spec as get_spec
    args = PATHS[name]['args']
    tag, cli_tag = (f'{phase}d', f'{phase}{"e" if phase == 14 else "d"}')
    free = isinstance(fe, list)
    if free:
        fe = fe.pop()
    t0 = time.perf_counter()
    source_prints = fingerprints(torch, fe)
    print(f'phase {tag} fingerprints of {len(source_prints)} source parameters: '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    written = TREE_WRITES[tag] = fe.save_weights(tree, unet_shards=unet_shards,
                                                 text_shards=text_shards)
    files = sorted(os.path.relpath(os.path.join(d, f), tree)
                   for d, _, names in os.walk(tree) for f in names)
    print(f'phase {tag} tree of {sum(n for n, _ in written.values())} bytes: {files}')
    rates(written, 'write', card, tag)
    if free:
        del fe
        torch.cuda.empty_cache()
        print(f'phase {tag} source freed: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB '
              'still allocated', flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # the source was bf16: int8 off (Flux's JAX defaults would load int8)
    loaded = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0, weights=tree,
                              transformer_8bit=False, t5_8bit=False)
    loaded_prompts = loaded.encode_prompt('a photo of a cat')
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    rates(loaded.load_stats, 'load', card, tag)
    print(f'phase {tag} build from the tree + encode_prompt: {seconds:.1f} s; peak memory '
          f'{peak:.3f} GiB while loading vs {build_gib:.3f} GiB for the random-init build '
          f'(ratio {peak / build_gib:.4f}, allowed {LOAD_PEAK_RATIO}) ({card})', flush=True)
    if peak > LOAD_PEAK_RATIO * build_gib:
        raise RuntimeError(f'phase {tag}: load peak {peak:.3f} GiB over {LOAD_PEAK_RATIO} x '
                           f'{build_gib:.3f} GiB')
    loaded_prints = fingerprints(torch, loaded)
    bad = [k for k in source_prints if loaded_prints.get(k) != source_prints[k]]
    if bad or loaded_prints.keys() != source_prints.keys():
        raise RuntimeError(f'phase {tag}: parameter fingerprints differ from the source: '
                           f'{bad[:5]}')
    print(f'  {len(loaded_prints)} parameter fingerprints equal to the source\'s')
    for mod, a, b in ([] if free else module_pairs(fe, loaded)):
        sa, sb = a.state_dict(), b.state_dict()
        bad = [k for k in sa if k not in sb or not torch.equal(sa[k], sb[k])]
        if bad or sa.keys() != sb.keys():
            raise RuntimeError(f'phase {tag} {mod}: parameters differ from the source: {bad[:5]}')
        print(f'  {mod}: {len(sa)} parameters torch.equal to the source')
    if not all(torch.equal(a, b)
               for a, b in zip(flat_prompts(prompts), flat_prompts(loaded_prompts))):
        raise RuntimeError(f'phase {tag}: encode_prompt differs from the source')
    print(f'  encode_prompt: {len(flat_prompts(prompts))} tensors torch.equal to the source')
    want = path_launches(fa, loaded)
    feats, runs[f'{name}_loaded'], shapes[f'{name}_loaded'] = drive_path(
        torch, fa, attn_ops, loaded, loaded_prompts, images, want, f'phase {tag} loaded')
    assert_equal_feats(torch, feats, first_feats,
                       f'phase {tag} first public extract vs the source')
    del loaded, feats
    torch.cuda.empty_cache()

    # the CLI on the tree, over three images in batches of 2 and 1
    size = args['img_size']
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        write_images(CLI_IMAGES, size)
        shapes[f'{name}_cli'] = []
        with patched_wrappers(attn_ops, recording(shapes[f'{name}_cli'])):
            reset_counts(fa)
            seconds, lines = run_cli([
                '--version', args['version'], '--img_size', str(size), '--layer',
                json.dumps(args['layer']), '--batch_size', '2', '--prompt', 'a photo of a cat',
                '--input_dir', 'imgs/*.png', '--output_dir', 'out', '--weights', tree])
            torch.cuda.synchronize()
            runs[f'{name}_cli'] = read_counts(fa)
        batches = -(-CLI_IMAGES // 2)
        want = {k: batches * v for k, v in want.items()}
        int8_note = ''
        if args['version'] == 'flux':
            # the CLI runs at the JAX defaults, so it loads Flux's tree in
            # int8: one T5 encode and one transformer forward per batch
            spec = get_spec('flux')
            vae_scale = 2 ** (len(spec.vae.block_out_channels) - 1)
            derived = t5_int8_calls(spec.t5, spec.prompt_max_length)
            for n in [2] * (CLI_IMAGES // 2) + [1] * (CLI_IMAGES % 2):
                for shape, c in flux_int8_calls(spec, size, n, vae_scale).items():
                    derived[shape] = derived.get(shape, 0) + c
            want['int8_linear'] = sum(derived.values())
            recorded = shape_counts(shapes[f'{name}_cli'])
            int8_note = (f'; W8A16 launches {runs[f"{name}_cli"].get("int8_linear", 0)} at the '
                         f'derived shapes: {recorded == derived}')
            if recorded != derived:
                raise RuntimeError(f'phase {cli_tag}: W8A16 shapes {recorded} != {derived}')
        rate = [line for line in lines if line.endswith('img/s)')]
        print(f'phase {cli_tag} cli {args["version"]} {size}^2 on the tree: {seconds:.1f} s for '
              f'main() (model build included), {rate[0]}; kernel launches '
              f'{runs[f"{name}_cli"]} (expected {want}){int8_note} ({card})', flush=True)
        if runs[f'{name}_cli'] != want:
            raise RuntimeError(f'phase {cli_tag}: launches {runs[f"{name}_cli"]} != {want}')
        enumerated = enumerate_layers(args['version'], size)
        layers = sorted(os.listdir('out'))
        if layers != sorted(args['layer']):
            raise RuntimeError(f'phase {cli_tag}: layer dirs {layers}')
        for layer in layers:
            names = sorted(os.listdir(os.path.join('out', layer)))
            if names != [f'train{i}.npy' for i in range(CLI_IMAGES)]:
                raise RuntimeError(f'phase {cli_tag} {layer}: files {names}')
            for file in names:
                arr = np.load(os.path.join('out', layer, file))
                if (arr.shape != enumerated[layer][1:] or arr.dtype != np.float16
                        or not np.isfinite(arr).all()):
                    raise RuntimeError(f'phase {cli_tag} {layer}/{file}: {arr.shape} {arr.dtype}')
            print(f'  {layer}: {len(names)} x {arr.shape} float16 finite')


def sample_inputs(torch, fe, prompt, steps):
    """``sample``'s prompts for ``prompt`` with the empty negative (PixArt's
    4-tuple, HunyuanDiT's pair of ``encode_prompt`` results) and DDPM's
    step noise, ``steps`` standard-normal draws from seed 8 (None for the
    other schedulers)."""
    if fe.spec.family == 'hunyuan':
        latent = fe.img_size // fe.vae_scale
        gen = torch.Generator(device='cuda').manual_seed(8)
        step_noise = [torch.randn((1, 4, latent, latent), generator=gen, device='cuda')
                      for _ in range(steps)]
        return (fe.encode_prompt(prompt), fe.encode_prompt('')), step_noise
    return fe.encode_prompt(prompt), None


def check_dit_generation(torch, fa, attn_ops, card, shapes, runs, gen_args, name, phase):
    """Phase 14 (f) and 15 (e): the generation CLI with ``gen_args``, then a
    short sample on the kernels and on the twins."""
    from PIL import Image
    from diffusion_feature_tpu_torch import generate_with_extraction
    args = generate_with_extraction.build_parser().parse_args(gen_args)
    taps = json.loads(args.layer)
    shapes[name] = []
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        out = io.StringIO()
        with patched_wrappers(attn_ops, recording(shapes[name])):
            reset_counts(fa)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                fe = generate_with_extraction.main(gen_args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            runs[name] = read_counts(fa)
        size = Image.open(args.output).size
    calls = len(fe.scheduler.set_timesteps(args.steps).timesteps)
    latent = fe.img_size // fe.vae_scale
    per_call = dit_launches(fa, fe)['flash_attention'] - vae_b1(fa, fe.spec.vae, latent)
    want = only_b1(calls * per_call + vae_b1(fa, fe.spec.vae, latent))
    # Flux is guidance-distilled: no CFG batch, the guidance embedding takes it
    batch, batch_note = (1, 'batch 1, no CFG') if fe.spec.family == 'flux' else (
        2, 'CFG batch 2')
    print(f'phase {phase} generate_with_extraction {" ".join(gen_args[:4])} (steps '
          f'{args.steps}, guidance {args.guidance_scale}, store_steps {args.store_steps}): '
          f'{seconds:.1f} s for main() (model build included), image {size}; {calls} DiT calls '
          f'x {per_call} B1 + decoder; kernel launches {runs[name]} (expected {want}) '
          f'({card})', flush=True)
    if runs[name] != want or size != (args.img_size, args.img_size):
        raise RuntimeError(f'phase {phase}: launches {runs[name]} or image {size}')
    kept = fe.get_background_extraction()
    for layer, by_step in sorted(kept.items()):
        bad = [i for i, v in by_step.items()
               if v.shape[0] != batch or not bool(torch.isfinite(v.float()).all())]
        print(f'  {layer}: kept {sorted(by_step)} of {fe._background_feats[layer]["count"]}, '
              f'{tuple(by_step[1].shape)} {by_step[1].dtype}')
        if sorted(by_step) != sorted(args.store_steps) or bad:
            raise RuntimeError(f'phase {phase} {layer}: kept {sorted(by_step)}, bad {bad}')
    if set(kept) != set(taps):
        raise RuntimeError(f'phase {phase}: kept layers {sorted(kept)}')
    prompts, step_noise = sample_inputs(torch, fe, args.prompt, args.steps)
    noise = torch.randn((1, fe.spec.vae.latent_channels, latent, latent),
                        generator=torch.Generator(device='cuda').manual_seed(7), device='cuda')
    *_, ms, gib, base = timed_sample(torch, fe, prompts, noise, args.steps, args.guidance_scale,
                                     step_noise)
    print(f'phase {phase} {args.version} sample timed: {ms:.2f} ms per sample, {ms / calls:.2f} '
          f'ms per step ({calls} DiT calls at {batch_note} and the decode); peak memory '
          f'{gib:.2f} GiB above the {base:.2f} GiB held before it ({card})', flush=True)
    run = (*fe._sample_conditioning(prompts, 1, args.guidance_scale), noise, TWIN_SAMPLE_STEPS,
           args.guidance_scale, None if step_noise is None else step_noise[:TWIN_SAMPLE_STEPS])
    with_kernel = fe._sample(*run)
    with patched_wrappers(attn_ops, twin_of(fa)):
        with_twin = fe._sample(*run)
    pairs = [('images', with_kernel[0], with_twin[0])]
    pairs += [(f'{k} call {i + 1}', a, b) for k in with_twin[1]
              for i, (a, b) in enumerate(zip(with_kernel[1][k], with_twin[1][k]))]
    worst = max(rel_cos(a, b)[0] for _, a, b in pairs)
    print(f'phase {phase} {args.version} sample, {TWIN_SAMPLE_STEPS} steps, kernel vs twin: '
          f'images and {len(pairs) - 1} tap encounters, worst rel_l2={worst:.3e} (allowed '
          f'{MULTISTEP_REL_TOL:g})', flush=True)
    if not worst <= MULTISTEP_REL_TOL:
        raise RuntimeError(f'phase {phase}: kernel vs twin {worst}')
    del fe, with_kernel, with_twin
    torch.cuda.empty_cache()


def check_pixart(torch, fa, attn_ops, card, shapes, runs):
    """Phase 14: PixArt-Sigma 1024^2 (a), with the store (b), PixArt-alpha
    512^2 (c), Sigma's tree written and loaded (d), the CLI on it (e), the
    generation CLI and a kernel-vs-twin sample on PixArt-alpha (f).  Each
    extractor is freed before the next is built (T5-XXL is ~9.5 GB)."""
    fe, prompts, images, first, gib = check_dit_path(
        torch, fa, attn_ops, card, 'pixart_sigma', shapes, runs, 'phase 14a')
    MESH_REFS['pixart_sigma'] = cpu_feats(first)
    MESH_REFS['pixart_counts'] = {**runs['pixart_sigma'], 'flash_attention_bwd': 0}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_pixart_') as tree:
        check_dit_tree(torch, fa, attn_ops, card, fe, prompts, images, first, gib, tree,
                       shapes, runs, PIXART_TREE_PATH, PIXART_TEXT_SHARDS, 14)
    del fe, first
    torch.cuda.empty_cache()
    for name, label in (('pixart_sigma_store', 'phase 14b'), ('pixart_alpha', 'phase 14c')):
        fe, *_ = check_dit_path(torch, fa, attn_ops, card, name, shapes, runs, label)
        del fe, _
        torch.cuda.empty_cache()
    check_dit_generation(torch, fa, attn_ops, card, shapes, runs, PIXART_GEN_ARGS, 'pixart_gen',
                         '14f')


def check_hunyuan(torch, fa, attn_ops, card, shapes, runs):
    """Phase 15: HunyuanDiT 1024^2 (a), its tree written and loaded and the
    CLI on it (d), with the store (b), at 512^2 (c), the generation CLI
    and a kernel-vs-twin sample at 512^2 (e).  Each extractor (~7.9 GB) is
    freed before the next is built."""
    fe, prompts, images, first, gib = check_dit_path(
        torch, fa, attn_ops, card, 'hunyuan', shapes, runs, 'phase 15a')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_hunyuan_') as tree:
        check_dit_tree(torch, fa, attn_ops, card, fe, prompts, images, first, gib, tree,
                       shapes, runs, HUNYUAN_TREE_PATH, HUNYUAN_TEXT_SHARDS, 15)
    del fe, first
    torch.cuda.empty_cache()
    for name, label in (('hunyuan_store', 'phase 15b'), ('hunyuan_512', 'phase 15c')):
        fe, *_ = check_dit_path(torch, fa, attn_ops, card, name, shapes, runs, label)
        del fe, _
        torch.cuda.empty_cache()
    check_dit_generation(torch, fa, attn_ops, card, shapes, runs, HUNYUAN_GEN_ARGS,
                         'hunyuan_gen', '15e')


def check_flux(torch, fa, attn_ops, card, shapes, runs):
    """Phase 16: Flux.1-dev 1024^2 (a), its tree written, the source freed,
    the tree loaded and the CLI on it (d), the tree in int8 (f) and on two
    ranks (phase 22c and 22d's Flux part), (f)'s extractor as a deployment
    bundle once the tree's weights are gone (g), with the store (b), at 512^2
    (c), the generation CLI and a kernel-vs-twin sample at 512^2 (e).  Each
    extractor (~34 GB: the 11.9 B-parameter transformer and T5-XXL in bf16)
    is freed before the next is built."""
    fe, prompts, images, first, gib = check_dit_path(
        torch, fa, attn_ops, card, 'flux', shapes, runs, 'phase 16a')
    source = [fe]
    del fe
    with tempfile.TemporaryDirectory(prefix='chip_smoke_flux_') as tree:
        check_dit_tree(torch, fa, attn_ops, card, source, prompts, images, first, gib, tree,
                       shapes, runs, FLUX_TREE_PATH, FLUX_TEXT_SHARDS, 16,
                       FLUX_TRANSFORMER_SHARDS)
        int8 = check_flux_int8(torch, fa, attn_ops, card, tree, images, first, shapes, runs)
        check_mesh_flux(torch, fa, attn_ops, card, shapes, runs, tree)
        check_flux_bundle(torch, fa, attn_ops, card, tree, *int8, images, shapes, runs)
        del int8
    del first
    torch.cuda.empty_cache()
    for name, label in (('flux_store', 'phase 16b'), ('flux_512', 'phase 16c')):
        fe, *_ = check_dit_path(torch, fa, attn_ops, card, name, shapes, runs, label)
        del fe, _
        torch.cuda.empty_cache()
    check_dit_generation(torch, fa, attn_ops, card, shapes, runs, FLUX_GEN_ARGS, 'flux_gen',
                         '16e')


def numpy_quantize_int8(w):
    """The JAX package's quantize_int8 (diffusion_feature_tpu/ops/quant.py:24)
    in numpy on the host: (in, out) float -> (int8 kernel, (out,) fp32
    scale), symmetric per output channel."""
    import numpy as np
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8), scale


def check_flux_int8(torch, fa, attn_ops, card, tree, images, bf16_feats, shapes, runs):
    """Phase 16f: FeatureExtractor on phase 16d's Flux tree at the JAX
    defaults, whose auto rule loads the transformer and T5-XXL in int8 (the
    weights quantized on the card as they load): both spec flags on, the
    load's GB/s and its peak against the resident bytes plus the largest
    staged bf16 weight; three layers' weight_q and scale equal bit for bit
    to numpy's quantization of the tree's tensors on the host;
    encode_prompt's and one extract's W8A16 launches and shapes as the
    config derives them (t5_int8_calls, flux_int8_calls), B1 as
    dit_launches; the features' shapes, dtype and finiteness; the step with
    every W8A16 and B1 call on its twin within TAP_REL_TOL; each tap's
    cosine against phase 16a's bf16 features from the same draws; the
    extract's timing, and its peak memory INT8_PEAK_SAVING_GIB below phase
    16a's.  Returns (the extractor, its prompts, its load's seconds) for
    phase 16g."""
    import numpy as np
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.models.convert import load_component_state
    quant = _quant()
    args = PATHS['flux']['args']
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fe = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0, weights=tree)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak, resident = torch.cuda.max_memory_allocated() - base, torch.cuda.memory_allocated() - base
    layers = [m for module in (fe.unet, *fe.text_encoders) for m in module.modules()
              if isinstance(m, quant.Int8Linear)]
    staged = 2 * max(m.weight_q.numel() for m in layers)
    int8_bytes = sum(m.weight_q.numel() + 4 * m.scale.numel() for m in layers)
    flags = (fe.spec.dit.quantize_int8, fe.spec.t5.quantize_int8)
    rates(fe.load_stats, 'load', card, '16f')
    allowed = INT8_LOAD_PEAK_RATIO * resident + staged
    print(f'phase 16f int8 build from the tree (auto rule: transformer_8bit, t5_8bit = {flags}): '
          f'{seconds:.1f} s; {len(layers)} int8 layers hold {int8_bytes / 2 ** 30:.3f} GiB; '
          f'resident {resident / 2 ** 30:.3f} GiB, load peak {peak / 2 ** 30:.3f} GiB (allowed '
          f'{INT8_LOAD_PEAK_RATIO} x resident + the largest staged bf16 weight, '
          f'{staged / 2 ** 20:.1f} MiB: {allowed / 2 ** 30:.3f} GiB) ({card})', flush=True)
    if flags != (True, True) or peak > allowed:
        raise RuntimeError(f'phase 16f: flags {flags}, load peak {peak} over {allowed}')
    # the bits: three layers against numpy's quantization of the tree's tensors
    n_single, n_t5 = fe.spec.dit.num_single_layers, fe.spec.t5.num_layers
    for comp, key, layer in (
            ('transformer', 'transformer_blocks.0.attn.to_q',
             fe.unet.transformer_blocks[0].attn.to_q),
            ('transformer', f'single_transformer_blocks.{n_single - 1}.proj_out',
             fe.unet.single_transformer_blocks[-1].proj_out),
            ('text_encoder_2', f'encoder.block.{n_t5 - 1}.layer.1.DenseReluDense.wo',
             fe.text_encoders[-1].encoder.block[-1].layer[1].DenseReluDense.wo)):
        w = load_component_state(tree, comp)[f'{key}.weight']
        q, scale = numpy_quantize_int8(w.float().numpy().T)
        equal = (np.array_equal(layer.weight_q.cpu().numpy(), q.T)
                 and np.array_equal(layer.scale.cpu().numpy().view(np.int32), scale.view(np.int32)))
        print(f'  {comp}/{key}: weight_q {tuple(layer.weight_q.shape)} and scale equal bit for bit '
              f'to numpy\'s quantization on the host: {equal}')
        if not equal:
            raise RuntimeError(f'phase 16f {comp}/{key}: the card\'s quantization differs')
    # encode_prompt: T5-XXL's 168 projections
    shapes['flux_int8_prompt'] = []
    with patched_wrappers(attn_ops, recording(shapes['flux_int8_prompt'])):
        reset_counts(fa)
        prompts = fe.encode_prompt('a photo of a cat')
        torch.cuda.synchronize()
        runs['flux_int8_prompt'] = read_counts(fa)
    derived = t5_int8_calls(fe.spec.t5, fe.spec.prompt_max_length)
    want = {**only_b1(0), 'int8_linear': sum(derived.values())}
    print(f'phase 16f encode_prompt: kernel launches {runs["flux_int8_prompt"]} (expected '
          f'{want}), W8A16 shapes {shape_counts(shapes["flux_int8_prompt"])}', flush=True)
    if runs['flux_int8_prompt'] != want or shape_counts(shapes['flux_int8_prompt']) != derived:
        raise RuntimeError(f'phase 16f: encode_prompt launches {runs["flux_int8_prompt"]}')
    # one extract: the main path of W8A16
    derived = flux_int8_calls(fe.spec, fe.img_size, images.shape[0], fe.vae_scale)
    want = {**dit_launches(fa, fe), 'int8_linear': sum(derived.values())}
    feats, runs['flux_int8'], shapes['flux_int8'] = drive_path(
        torch, fa, attn_ops, fe, prompts, images, want, 'phase 16f')
    recorded = shape_counts(shapes['flux_int8'])
    print(f'  phase 16f W8A16 shapes of one extract (M, K, N): calls {recorded}', flush=True)
    if recorded != derived:
        raise RuntimeError(f'phase 16f: W8A16 shapes {recorded} != derived {derived}')
    check_feats(torch, feats, PATHS['flux']['feats'], 'phase 16f')
    MESH_REFS['flux_int8'] = cpu_feats(feats)
    MESH_REFS['flux_int8_bytes'] = resident_bytes(fe.unet)
    MESH_REFS['flux_b1'] = runs['flux_int8']['flash_attention']
    for key in sorted(bf16_feats):
        rel, cos = rel_cos(feats[key], bf16_feats[key])
        print(f'  phase 16f int8 vs bf16 (phase 16a, the same draws), {key}: rel_l2={rel:.4e} '
              f'cosine={cos:.6f} (allowed >= {INT8_COSINE})')
        if not cos >= INT8_COSINE:
            raise RuntimeError(f'phase 16f {key}: cosine {cos} against bf16')
    check_twin_step(torch, fe, attn_ops, fa, prompts, images, PATHS['flux']['feats'], 'phase 16f')
    _, peak_gib = time_extract(torch, fe, prompts, images,
                               'phase 16f flux int8 extract 1024^2 batch 2', card)
    bf16_gib = EXTRACT_PEAK_GIB['phase 16a flux extract 1024^2 batch 2']
    print(f'phase 16f peak {peak_gib:.3f} GiB against phase 16a\'s bf16 {bf16_gib:.3f} GiB: '
          f'{bf16_gib - peak_gib:.3f} GiB less (required {INT8_PEAK_SAVING_GIB}) ({card})',
          flush=True)
    if not peak_gib <= bf16_gib - INT8_PEAK_SAVING_GIB:
        raise RuntimeError(f'phase 16f: peak {peak_gib} GiB, bf16 {bf16_gib} GiB')
    del feats
    torch.cuda.empty_cache()
    return fe, prompts, sum(v[1] for v in fe.load_stats.values())


def check_flux_bundle(torch, fa, attn_ops, card, tree, source, prompts, int8_seconds, images,
                      shapes, runs):
    """Phase 16g, after every phase that reads phase 16d's tree: its weight
    files deleted (its config.json and tokenizer dirs kept: the card's
    machine ends a call whose disk use passes 45 GiB), phase 16f's int8
    extractor ``source`` written as a deployment bundle (~17 GB, computed)
    and loaded back with default arguments: both int8 flags from the
    manifest, every tensor (each weight_q and scale) torch.equal to
    ``source``'s, the load's peak within INT8_LOAD_PEAK_RATIO of the
    resident bytes (no bf16 weight is staged), encode_prompt's 168 and one
    extract's 495 W8A16 launches at the derived shapes with 58 B1, the
    prompts and the first features torch.equal to 16f's; the load's seconds
    beside 16f's quantize-on-load.  The bundle is deleted after."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    removed = 0
    for d, _, names in os.walk(tree):
        for name in names:
            if name.endswith('.safetensors'):
                removed += os.path.getsize(os.path.join(d, name))
                os.remove(os.path.join(d, name))
    print(f'phase 16g: the tree\'s {removed / 1e9:.3f} GB of weight files deleted, its '
          f'config.json and tokenizer dirs kept', flush=True)
    args = PATHS['flux']['args']
    with tempfile.TemporaryDirectory(prefix='chip_smoke_flux_bundle_') as tmp:
        root = os.path.join(tmp, 'bundle')
        write_bundle(torch, source, root, 'phase 16g', card,
                     sum(v[1] for v in TREE_WRITES['16d'].values()),
                     sum(v[0] for v in TREE_WRITES['16d'].values()))
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fe = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0, weights=root)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        resident = torch.cuda.memory_allocated() - base
        flags = (fe.spec.dit.quantize_int8, fe.spec.t5.quantize_int8)
        rates(fe.load_stats, 'load', card, '16g')
        print(f'phase 16g build from the bundle (no int8 keyword: transformer_8bit, t5_8bit = '
              f'{flags} from the manifest): {seconds:.1f} s, against {int8_seconds:.1f} s for '
              f'phase 16f\'s load of the tree quantized on the card; resident '
              f'{resident / 2 ** 30:.3f} GiB, load peak {peak / 2 ** 30:.3f} GiB (ratio '
              f'{peak / resident:.4f}, allowed {INT8_LOAD_PEAK_RATIO}) ({card})', flush=True)
        if flags != (True, True) or peak > INT8_LOAD_PEAK_RATIO * resident:
            raise RuntimeError(f'phase 16g: flags {flags}, load peak {peak} over {resident}')
        quant = _quant()
        for name, a, b in module_pairs(source, fe):
            sa, sb = a.state_dict(), b.state_dict()
            bad = [k for k in sa if k not in sb or sa[k].dtype != sb[k].dtype
                   or not torch.equal(sa[k], sb[k])]
            if bad or sa.keys() != sb.keys():
                raise RuntimeError(f'phase 16g {name}: tensors differ from 16f\'s: {bad[:5]}')
            n_int8 = sum(isinstance(m, quant.Int8Linear) for m in b.modules())
            print(f'  {name}: {len(sa)} tensors torch.equal to 16f\'s ({n_int8} int8 layers\' '
                  f'weight_q and scale among them)')
        shapes['flux_bundle_prompt'] = []
        with patched_wrappers(attn_ops, recording(shapes['flux_bundle_prompt'])):
            reset_counts(fa)
            fe_prompts = fe.encode_prompt('a photo of a cat')
            torch.cuda.synchronize()
            runs['flux_bundle_prompt'] = read_counts(fa)
        derived = t5_int8_calls(fe.spec.t5, fe.spec.prompt_max_length)
        want = {**only_b1(0), 'int8_linear': sum(derived.values())}
        print(f'phase 16g encode_prompt: kernel launches {runs["flux_bundle_prompt"]} (expected '
              f'{want})', flush=True)
        if (runs['flux_bundle_prompt'] != want
                or shape_counts(shapes['flux_bundle_prompt']) != derived):
            raise RuntimeError(f'phase 16g: encode_prompt launches {runs["flux_bundle_prompt"]}')
        for a, b in zip(prompts, fe_prompts):
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise RuntimeError('phase 16g: encode_prompt differs from 16f\'s')
        derived = flux_int8_calls(fe.spec, fe.img_size, images.shape[0], fe.vae_scale)
        want = {**dit_launches(fa, fe), 'int8_linear': sum(derived.values())}
        feats, runs['flux_bundle'], shapes['flux_bundle'] = drive_path(
            torch, fa, attn_ops, fe, fe_prompts, images, want, 'phase 16g')
        recorded = shape_counts(shapes['flux_bundle'])
        print(f'  phase 16g W8A16 shapes of one extract (M, K, N): calls {recorded}', flush=True)
        if recorded != derived:
            raise RuntimeError(f'phase 16g: W8A16 shapes {recorded} != derived {derived}')
        assert_equal_feats(torch, cpu_feats(feats), MESH_REFS['flux_int8'],
                           'phase 16g first public extract vs 16f\'s first')
        del fe, feats
    torch.cuda.empty_cache()


def if_step_drift(torch, fe, prompts, images, card):
    """Phase 17b: the single step in bf16 against the same step in fp32
    (an fp32 copy of the U-Net's weights, the same T5 embeddings and the
    same draws), relative L2 and cosine per tap, gated on finiteness; then
    a TWIN_SAMPLE_STEPS sample with CFG in both, the images within
    MULTISTEP_REL_TOL.  IF runs no kernel, so there is no twin to hold it
    to."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    t0 = time.perf_counter()
    fe32 = FeatureExtractor(**PATHS['if']['args'], dtype='float32', device='cuda', seed=0)
    fe32.unet.load_state_dict(fe.unet.state_dict())
    print(f'phase 17b fp32 copy of the U-Net: {time.perf_counter() - t0:.1f} s', flush=True)
    ours, ref = (injected_step(torch, f, prompts, images) for f in (fe, fe32))
    for key in sorted(ref):
        rel, cos = rel_cos(ours[key], ref[key])
        finite = bool(torch.isfinite(ours[key].float()).all())
        print(f'  phase 17b step bf16 vs fp32, {key}: rel_l2={rel:.4e} cosine={cos:.6f} '
              f'finite={finite}')
        if not finite:
            raise RuntimeError(f'phase 17b {key}: not finite')
    gen = torch.Generator(device='cuda').manual_seed(7)
    shape = fe.latent_shape(1)
    noise, *step_noise = (torch.randn(shape, generator=gen, device='cuda')
                          for _ in range(TWIN_SAMPLE_STEPS + 1))
    guidance = float(IF_GEN_ARGS[IF_GEN_ARGS.index('--guidance_scale') + 1])
    pairs = [f._sample(*f._sample_conditioning(prompts, 1, guidance), noise, TWIN_SAMPLE_STEPS,
                       guidance, step_noise) for f in (fe, fe32)]
    rel, cos = rel_cos(pairs[0][0], pairs[1][0])
    print(f'phase 17b {TWIN_SAMPLE_STEPS}-step sample with CFG, bf16 vs fp32: images '
          f'rel_l2={rel:.4e} cosine={cos:.6f} (allowed {MULTISTEP_REL_TOL:g}) ({card})',
          flush=True)
    if not rel <= MULTISTEP_REL_TOL:
        raise RuntimeError(f'phase 17b: bf16 sample {rel} from fp32')
    del fe32, pairs
    torch.cuda.empty_cache()


def check_if(torch, fa, attn_ops, card, shapes, runs):
    """Phase 17: DeepFloyd IF at 64^2 (a), bf16 against fp32 (b), with
    denoising_from (c), its tree and the CLI on it (d), the generation CLI
    and a timed 50-step sample (e)."""
    from PIL import Image
    from diffusion_feature_tpu_torch import generate_with_extraction
    fe, prompts, images, gib = open_dit(torch, 'if', 17)
    want = if_launches(fa, fe)
    first, runs['if'], shapes['if'] = drive_path(torch, fa, attn_ops, fe, prompts, images, want,
                                                 'phase 17a')
    check_feats(torch, first, IF_FEATS, 'phase 17a')
    time_extract(torch, fe, prompts, images, 'phase 17a if extract 64^2 batch 2', card)
    if_step_drift(torch, fe, prompts, images, card)
    kwargs = PATHS['if_ms']['extract']
    feats, runs['if_ms'], shapes['if_ms'] = drive_path(torch, fa, attn_ops, fe, prompts, images,
                                                       want, 'phase 17c', **kwargs)
    check_feats(torch, feats, IF_FEATS, 'phase 17c')
    time_extract(torch, fe, prompts, images, 'phase 17c if extract 64^2 batch 2, '
                 'denoising_from=60', card, PATHS['if_ms']['calls'], **kwargs)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_if_') as tree:
        check_dit_tree(torch, fa, attn_ops, card, fe, prompts, images, first, gib, tree, shapes,
                       runs, IF_TREE_PATH, IF_TEXT_SHARDS, 17)
    del fe, first, feats
    torch.cuda.empty_cache()

    # (e) the generation CLI, then its extractor's sample timed
    args = generate_with_extraction.build_parser().parse_args(IF_GEN_ARGS)
    shapes['if_gen'] = []
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        out = io.StringIO()
        with patched_wrappers(attn_ops, recording(shapes['if_gen'])):
            reset_counts(fa)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                fe = generate_with_extraction.main(IF_GEN_ARGS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            runs['if_gen'] = read_counts(fa)
        size = Image.open(args.output).size
    calls = len(fe.scheduler.set_timesteps(args.steps).timesteps)
    want = only_b1(calls * if_launches(fa, fe)['flash_attention'])
    print(f'phase 17e generate_with_extraction {" ".join(IF_GEN_ARGS[:4])} (steps {args.steps}, '
          f'guidance {args.guidance_scale}, store_steps {args.store_steps}): {seconds:.1f} s for '
          f'main() (model build included), image {size}; {calls} U-Net calls at CFG batch 2; '
          f'kernel launches {runs["if_gen"]} (expected {want}) ({card})', flush=True)
    if runs['if_gen'] != want or size != (args.img_size, args.img_size):
        raise RuntimeError(f'phase 17e: launches {runs["if_gen"]} or image {size}')
    kept = fe.get_background_extraction()
    for layer, by_step in sorted(kept.items()):
        bad = [i for i, v in by_step.items()
               if v.shape[0] != 2 or not bool(torch.isfinite(v.float()).all())]
        print(f'  {layer}: kept {sorted(by_step)} of {fe._background_feats[layer]["count"]}, '
              f'{tuple(by_step[1].shape)} {by_step[1].dtype}')
        if sorted(by_step) != sorted(args.store_steps) or bad:
            raise RuntimeError(f'phase 17e {layer}: kept {sorted(by_step)}, bad {bad}')
    if set(kept) != set(IF_TAPS):
        raise RuntimeError(f'phase 17e: kept layers {sorted(kept)}')
    gen = torch.Generator(device='cuda').manual_seed(8)
    noise, *step_noise = (torch.randn(fe.latent_shape(1), generator=gen, device='cuda')
                          for _ in range(args.steps + 1))
    images, _, _, ms, gib, base = timed_sample(torch, fe, fe.encode_prompt(args.prompt), noise,
                                               args.steps, args.guidance_scale, step_noise)
    finite = bool(torch.isfinite(images).all())
    print(f'phase 17e if sample timed: {ms:.2f} ms per sample, {ms / calls:.2f} ms per step '
          f'({calls} U-Net calls at CFG batch 2, no decode: pixel space); images '
          f'{tuple(images.shape)} in [{images.min().item():.3f}, {images.max().item():.3f}] '
          f'finite={finite}; peak memory {gib:.2f} GiB above the {base:.2f} GiB held before it '
          f'({card})', flush=True)
    if not finite or images.min() < 0 or images.max() > 1:
        raise RuntimeError('phase 17e: sample not finite or out of [0, 1]')
    del fe, images
    torch.cuda.empty_cache()


def check_external(torch, fa, attn_ops, card, fe, prompts, images, shapes, runs):
    """Phase 18: a second extractor with EXTERNAL_PATH's request over
    ``fe``'s tensors (phase 3's, EXTERNAL_SOURCE's): the memory it adds,
    the parameters it shares, its launch counts and features, then the
    source's own taps.  Returns its first features, on the host, for
    phase 6 to hold against a fresh extractor's with the same request and
    seed (so no phase between holds them on the card)."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    path = PATHS[EXTERNAL_PATH]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    second = FeatureExtractor(**path['args'], dtype='bfloat16', device='cuda', seed=0,
                              external_model=fe)
    torch.cuda.synchronize()
    seconds, added = time.perf_counter() - t0, torch.cuda.memory_allocated() - before
    states = [(a.state_dict(), b.state_dict()) for _, a, b in module_pairs(fe, second)]
    total = sum(len(sa) for sa, _ in states)
    shared = sum(sb[k].data_ptr() == t.data_ptr() for sa, sb in states for k, t in sa.items())
    print(f'phase 18 external_model: {EXTERNAL_PATH} request over the {EXTERNAL_SOURCE} '
          f'extractor built in {seconds:.3f} s, {added / 2 ** 20:.3f} MiB added to '
          f'{before / 2 ** 30:.3f} GiB allocated (allowed {EXTERNAL_MEMORY_RATIO:.0%}); '
          f'{shared} of {total} parameters share the source\'s data_ptr ({card})', flush=True)
    if added > EXTERNAL_MEMORY_RATIO * before or shared != total:
        raise RuntimeError(f'phase 18: {added} bytes added, {shared}/{total} shared')
    want = {**dict(zip(WRAPPERS, path['launches'])), 'short_attention': 0}
    feats, runs['external'], shapes['external'] = drive_path(
        torch, fa, attn_ops, second, second.encode_prompt('a photo of a cat'), images, want,
        'phase 18')
    check_feats(torch, feats, path['feats'], 'phase 18')
    own = extract(fe, prompts, images)
    if set(own) != set(PATHS[EXTERNAL_SOURCE]['feats']):
        raise RuntimeError(f'phase 18: the source now returns {sorted(own)}')
    print(f'  phase 18 the source\'s next extract: {sorted(own)}', flush=True)
    feats = {k: v.cpu() for k, v in feats.items()}
    del second, own, states
    torch.cuda.empty_cache()
    return feats


# ------------------------------------------------------------- phase 19
def bwd_bound(shape, dtype_name):
    """(ms, 'bytes' or 'operations') of the flash backward: five products,
    10 B H Sq Sk D flops; q, o, do, the logsumexp, k, v read once and dq,
    dk, dv written once."""
    b, h, sq, sk, d = shape
    item = {'bfloat16': 2, 'float16': 2, 'float32': 4}[dtype_name]
    flops = 10 * b * h * sq * sk * d
    nbytes = 4 * b * h * (sq + sk) * d * item + b * h * sq * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def sdpa_backward_ms(torch, q, k, v, grad, scale):
    """SDPA's backward for the same function (timed as a yardstick only):
    autograd.grad through one SDPA forward, its graph kept."""
    F = torch.nn.functional
    try:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        return time_ms(torch, lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True))
    except RuntimeError as err:
        print(f'  SDPA backward on {q.dtype} {tuple(q.shape)} unavailable: '
              f'{str(err).splitlines()[0]}')
        return None


def compare_bwd(torch, fa, shape, dtype_name, gen):
    """The backward kernel against its twin on head-split views of one
    shape: dq, dk, dv by relative L2 and elementwise (atol TOL times the
    gradient's largest entry), the kernel as CUDA graphs and in a loop of
    calls, the twin, SDPA's backward, the bound; returns the numbers."""
    b, h, sq, sk, d = shape
    dtype = getattr(torch, dtype_name)
    q, k, v, grad = (torch.randn(b, s, h * d, generator=gen, device='cuda').to(dtype)
                     .reshape(b, s, h, d).transpose(1, 2) for s in (sq, sk, sk, sq))
    scale = d ** -0.5
    out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
    run = lambda: fa.flash_attention_bwd(q, k, v, out, lse, grad, scale=scale)   # noqa: E731
    plain = lambda: fa.flash_attention_bwd_reference(q, k, v, grad, scale)       # noqa: E731
    got, ref = run(), plain()
    torch.cuda.synchronize()
    tol = TOL[dtype_name]
    err, ratio, notes, finite = 0.0, 0.0, '', True
    for name, a, r in zip(('dq', 'dk', 'dv'), got, ref):
        e, worst = worst_ratio(torch, a, r, tol * r.float().abs().max().item(), tol)
        ratio, note = rel_l2_ratio(torch, a, r, tol, max(ratio, worst))
        err = max(err, e)
        finite = finite and bool(torch.isfinite(a.float()).all())
        notes += f' {name}:{note.strip()} worst/allowed={worst:.3f}'
    del got, ref
    ms = graph_ms(torch, run)
    plain_ms = time_ms(torch, plain)
    lib_ms = sdpa_backward_ms(torch, q, k, v, grad, scale)
    bound_ms, bound_by = bwd_bound(shape, dtype_name)
    loop_ms = time_ms(torch, run, runs=3)
    ok = finite and ratio <= 1.0
    lib = 'none' if lib_ms is None else f'{lib_ms:.4f}'
    print(f'compare flash_attention_bwd {dtype_name} q{(b, h, sq, d)} k{(b, h, sk, d)} head-split:'
          f' max_abs_err={err:.3e}{notes} kernel_ms={ms:.4f} call_loop_ms={loop_ms:.4f} '
          f'plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={bound_ms:.4f} ({bound_by}) '
          f'share_of_bound={bound_ms / ms:.3f} {"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise RuntimeError(f'flash_attention_bwd disagrees with its twin at {shape} {dtype_name}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'call_loop_ms': loop_ms}


@contextlib.contextmanager
def recording_all(fa, attn_ops, log):
    """``recording`` on the wrappers the attention ops call and on the two
    the flash Function calls (B2 and the backward, through the kernel
    module's names)."""
    make = recording(log)
    real = {n: getattr(fa, n) for n in ('flash_attention_with_lse', 'flash_attention_bwd')}
    for n, f in real.items():
        setattr(fa, n, make(n, f))
    try:
        with patched_wrappers(attn_ops, make):
            yield
    finally:
        for n, f in real.items():
            setattr(fa, n, f)


@contextlib.contextmanager
def grad_twins(attn_ops, fa):
    """Every kernel call on its twin, the differentiable flash call too
    (B1's twin, differentiated by autograd)."""
    real = attn_ops.flash_attention_diff
    attn_ops.flash_attention_diff = lambda q, k, v, *, scale: fa.flash_attention_reference(
        q, k, v, scale)
    try:
        with patched_wrappers(attn_ops, twin_of(fa)):
            yield
    finally:
        attn_ops.flash_attention_diff = real


def all_counts(fa):
    return {**read_counts(fa), 'flash_attention_bwd': fa.bwd_launches}


def unet_self_attentions(fa, cfg, latent):
    """(order key, gate passes) of each U-Net self-attention in forward
    order: down blocks, mid, up blocks, one per transformer block, the key
    (stage, level, repeat, 1) that tap_key gives a tap of that repeat's
    transformer ('up' levels counted from the deepest, as the tap ids)."""
    levels = len(cfg.block_out_channels)
    depth = cfg.transformer_layers_per_block

    def passes(level):
        tokens = (latent >> level) ** 2
        d = cfg.block_out_channels[level] // cfg.num_attention_heads[level]
        return fa.is_flash_compatible((1, 1, tokens, d), (1, 1, tokens, d))

    out = []
    for lv, kind in enumerate(cfg.down_block_types):
        if kind == 'CrossAttnDownBlock2D':
            for r in range(cfg.layers_per_block):
                out += [((0, lv, r, 1), passes(lv))] * depth[lv]
    out += [((1, 0, 0, 1), passes(levels - 1))] * depth[-1]
    for u, kind in enumerate(cfg.up_block_types):
        if kind == 'CrossAttnUpBlock2D':
            for r in range(cfg.layers_per_block + 1):
                out += [((2, u, r, 1), passes(levels - 1 - u))] * depth[levels - 1 - u]
    return out


def tap_key(tap: str):
    """The forward-order key of a tap id: (stage, level, repeat, 0 for a
    resnet, 1 for the transformer, 2 for a sampler); 'unet-out' last."""
    import re
    if tap.startswith('unet-out'):
        return (3, 0, 0, 0)
    m = re.match(r'(down|mid|up)(?:-level(\d+))?(?:-repeat(\d+))?-(res|vit|\w*sampler)', tap)
    if m is None:
        raise ValueError(f'no forward position for tap {tap!r}')
    stage = {'down': 0, 'mid': 1, 'up': 2}[m.group(1)]
    sub = {'res': 0, 'vit': 1}.get(m.group(4), 2)
    return (stage, int(m.group(2) or 0), int(m.group(3) or 0), sub)


def grad_launches(fa, cfg, latent, taps, train_unet):
    """B1/B2/backward launches of one training step (one forward with
    gradients, one backward) of a U-Net with these taps, derived from the
    config through the gate: with train_unet every self-attention's q, k
    and v require grad, so each gate-passing one runs B2; with prompt
    tuning only those after the first cross-attention do (the first
    transformer block's self-attention sees the latents alone: B1).  A
    B2 call gets a backward launch when its output reaches a tap of the
    loss (its position at or before the last tap's; the U-Net always runs
    to its end)."""
    last = max(tap_key(t) for t in taps)
    b1 = b2 = bwd = 0
    for i, (key, passes) in enumerate(unet_self_attentions(fa, cfg, latent)):
        if not passes:
            continue
        if i == 0 and not train_unet:
            b1 += 1
        else:
            b2 += 1
            bwd += key <= last
    return b1, b2, bwd


def write_seg_pairs(root):
    """Synthetic ADE20K-style pairs under ``root``: random RGB images and
    label maps of ids 0..150 (0 unlabelled, as --reduce_zero_label takes
    them) at SEG_TRAIN_SIZES (train) and SEG_VAL_SIZE (val)."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(19)
    dirs = {}
    for split, sizes in (('train', SEG_TRAIN_SIZES), ('val', [SEG_VAL_SIZE])):
        for kind in ('img', 'lab'):
            dirs[split, kind] = os.path.join(root, split, kind)
            os.makedirs(dirs[split, kind])
        for i, (h, w) in enumerate(sizes):
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                os.path.join(dirs[split, 'img'], f'{i}.png'))
            Image.fromarray(rng.randint(0, 151, (h, w)).astype(np.uint8)).save(
                os.path.join(dirs[split, 'lab'], f'{i}.png'))
    return dirs


def seg_argv(config, dirs, work, iters, val=True):
    argv = ['--config', config, '--train_img_dir', dirs['train', 'img'],
            '--train_label_dir', dirs['train', 'lab'], '--work_dir', work,
            '--max_iters', str(iters), '--val_every', str(iters), '--batch_size', '2',
            '--reduce_zero_label', '--device', 'cuda']
    if val:
        argv += ['--val_img_dir', dirs['val', 'img'], '--val_label_dir', dirs['val', 'lab']]
    return argv


def run_trainer(torch, fa, attn_ops, argv):
    """train_segmentation.main(argv) with every count set to 0 just before
    and read just after, its output captured; returns (result, counts,
    recorded calls, seconds, peak GiB)."""
    from diffusion_feature_tpu_torch import train_segmentation
    log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with recording_all(fa, attn_ops, log):
        reset_counts(fa)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = train_segmentation.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = all_counts(fa)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for line in out.getvalue().splitlines():
        print(f'  | {line}')
    return result, counts, log, seconds, peak


def step_ms(result):
    """The median step time after the first, in ms."""
    later = sorted(result['step_seconds'][1:])
    return later[len(later) // 2] * 1e3


def check_training(torch, fa, attn_ops, card, shapes, runs, numbers, gen):
    """Phase 19 (a) to (d)."""
    import numpy as np
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.models.registry import get_model_spec
    # (a) the backward kernel against its twin
    for shape, dt in BWD_SHAPES:
        numbers['flash_attention_bwd', shape, dt] = compare_bwd(torch, fa, shape, dt, gen)
    for shape, dt in BWD_RAGGED:
        compare_bwd(torch, fa, shape, dt, gen)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix='chip_smoke_seg_') as root:
        dirs = write_seg_pairs(root)
        # (b) ade_sdxl: frozen bf16 SDXL, the head trained, val, resume
        with open(SEG_CONFIG) as f:
            cfg = json.load(f)
        argv = seg_argv(SEG_CONFIG, dirs, os.path.join(root, 'sdxl'), SEG_ITERS)
        result, runs['seg_sdxl'], shapes['seg_sdxl'], seconds, peak = run_trainer(
            torch, fa, attn_ops, argv)
        crop, stride = cfg['crop_size'][0], cfg['stride'][1]
        windows = (max(SEG_VAL_SIZE[1] - crop + stride - 1, 0) // stride + 1) * (
            max(SEG_VAL_SIZE[0] - crop + stride - 1, 0) // stride + 1)
        extracts = SEG_ITERS + windows
        want = {**only_b1(71 * extracts), 'flash_attention_bwd': 0}
        losses = result['losses']
        print(f'phase 19b ade_sdxl train_segmentation.main (xl 1024^2 bf16 frozen, head '
              f'{cfg["head_channels"]} x {cfg["num_classes"]} classes, crop {crop}, batch 2), '
              f'{SEG_ITERS} steps + val over {windows} slide windows: {seconds:.1f} s for main() '
              f'(model build included); losses {[round(x, 4) for x in losses]}; '
              f'{step_ms(result):.2f} ms per step (median after the first; all '
              f'{[round(x * 1e3, 2) for x in result["step_seconds"]]}); peak {peak:.2f} GiB; '
              f'val mIoU {result["miou"]}; launches {runs["seg_sdxl"]} (expected {want}: 71 B1 '
              f'per extract, {extracts} extracts, no backward) ({card})', flush=True)
        if runs['seg_sdxl'] != want or not all(np.isfinite(losses)) or len(losses) != SEG_ITERS:
            raise RuntimeError(f'phase 19b: launches {runs["seg_sdxl"]}, losses {losses}')
        train_miou = result['miou'][0][1]
        del result
        torch.cuda.empty_cache()
        ckpt = os.path.join(root, 'sdxl', f'iter_{SEG_ITERS}.pt')
        again, runs['seg_sdxl_eval'], shapes['seg_sdxl_eval'], seconds, _ = run_trainer(
            torch, fa, attn_ops, argv + ['--resume', ckpt, '--eval_only'])
        want_eval = {**only_b1(71 * windows), 'flash_attention_bwd': 0}
        miou = again['miou'][0][1]
        print(f'phase 19b --resume --eval_only: {seconds:.1f} s for main(), mIoU {miou} (the '
              f'training run\'s {train_miou}, allowed difference {SEG_MIOU_TOL:g}), launches '
              f'{runs["seg_sdxl_eval"]} (expected {want_eval})', flush=True)
        del again
        torch.cuda.empty_cache()
        if runs['seg_sdxl_eval'] != want_eval or not abs(miou - train_miou) <= SEG_MIOU_TOL:
            raise RuntimeError(f'phase 19b eval: launches {runs["seg_sdxl_eval"]}, mIoU {miou} '
                               f'vs {train_miou}')

        # (c) ade_vpd: SD-1.5 fp32, prompt tuning through the extraction step
        with open(VPD_CONFIG) as f:
            vcfg = json.load(f)
        df = vcfg['diffusion_feature']
        spec = get_model_spec(df['version'])
        latent = df['img_size'] // 2 ** (len(spec.vae.block_out_channels) - 1)
        # the VAE encoder's mid head runs B1 without gradients where the gate admits it
        per_step = grad_launches(fa, spec.unet, latent, df['layer'], False)
        per_step = (per_step[0] + vae_b1(fa, spec.vae, latent), *per_step[1:])
        argv = seg_argv(VPD_CONFIG, dirs, os.path.join(root, 'vpd'), VPD_ITERS, val=False)
        result, runs['seg_vpd'], shapes['seg_vpd'], seconds, peak = run_trainer(
            torch, fa, attn_ops, argv)
        want = {'flash_attention': VPD_ITERS * per_step[0],
                'flash_attention_with_lse': VPD_ITERS * per_step[1], 'headmean_probs': 0,
                'short_attention': 0, 'flash_attention_bwd': VPD_ITERS * per_step[2]}
        seg, losses = result['seg'], result['losses']
        print(f'phase 19c ade_vpd train_segmentation.main (1-5 512^2 fp32, prompt tuning over '
              f'the {len(vcfg["prompt"].split(","))}-name prompt, batch 2), {VPD_ITERS} steps: '
              f'{seconds:.1f} s for main(); losses {[round(x, 4) for x in losses]}; '
              f'{step_ms(result):.2f} ms per step (median after the first; all '
              f'{[round(x * 1e3, 2) for x in result["step_seconds"]]}); peak {peak:.2f} GiB; '
              f'launches {runs["seg_vpd"]} (expected {want}: per step B1/B2/backward {per_step}, '
              'the first self-attention sees no prompt, every later gate-passing one runs B2, '
              'those at or before the last tap a backward) '
              f'({card})', flush=True)
        if runs['seg_vpd'] != want or not all(np.isfinite(losses)):
            raise RuntimeError(f'phase 19c: launches {runs["seg_vpd"]}, losses {losses}')
        # the same step on the kernels and on the twins: meta_prompt's gradient
        from diffusion_feature_tpu_torch.train_segmentation import list_pairs, load_pair
        import random
        pairs = list_pairs(dirs['train', 'img'], dirs['train', 'lab'])
        batch = [load_pair(*pairs[i], (512, 512), random.Random(i), True, True) for i in range(2)]
        images = torch.from_numpy(np.stack([x[0] for x in batch])).cuda()
        labels = torch.from_numpy(np.stack([x[1] for x in batch])).cuda()

        def step_features():
            """One training step's features (with their graph to
            meta_prompt) and the loss on them; the same noise each time."""
            seg.reseed_noise(0)
            feats = seg.extract_features(images)
            loss, _ = seg.head_loss(feats, labels)
            # the taps the head reads ('attn', the store's maps, it does not)
            return [feats[lid] for lvl in seg.head.model_feature_layers[0]
                    for lid, _ in lvl], loss

        # the step on the kernels: meta_prompt's gradient, and the loss's
        # gradient at the features (the cotangent the extraction receives)
        feats, loss = step_features()
        cotangent = torch.autograd.grad(loss, feats, retain_graph=True)
        (g_kernel,) = torch.autograd.grad(feats, seg.meta_prompt, cotangent)
        l_kernel = float(loss.detach())
        del feats, loss
        # the same step on the twins: its extraction's backward from the same
        # cotangent (the twin extraction's vector-Jacobian product), and, for
        # the record, its whole gradient, which the head's ReLU kinks and the
        # Lovasz sort order move by percents when the features move by one
        # fp32 rounding (this small gradient is mostly cancellation)
        with grad_twins(attn_ops, fa):
            feats, loss = step_features()
            (g_twin,) = torch.autograd.grad(feats, seg.meta_prompt, cotangent,
                                            retain_graph=True)
            (g_twin_step,) = torch.autograd.grad(loss, seg.meta_prompt)
        l_twin = float(loss.detach())
        del feats, loss
        rel, cos = rel_cos(g_kernel, g_twin)
        rel_step, _ = rel_cos(g_kernel, g_twin_step)
        finite = bool(torch.isfinite(g_kernel).all())
        print(f'  phase 19c meta_prompt gradient {tuple(g_kernel.shape)}: kernels vs twins from '
              f'the same cotangent rel_l2={rel:.3e} cosine={cos:.6f} (allowed {TAP_REL_TOL:g}); '
              f'against the twins\' whole step rel_l2={rel_step:.3e} (not held); |g| max '
              f'{g_kernel.abs().max().item():.3e}, finite={finite}; loss {l_kernel:.6f} vs '
              f'{l_twin:.6f}', flush=True)
        if not (finite and g_kernel.abs().max() > 0 and rel <= TAP_REL_TOL):
            raise RuntimeError(f'phase 19c: meta_prompt gradient rel {rel}, finite {finite}')
        del seg, result, g_kernel, g_twin, g_twin_step, cotangent
        torch.cuda.empty_cache()

    # (d) train_unet on SD-1.5 512^2 fp32: one backward, kernels vs twins
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fe = FeatureExtractor(TRAIN_UNET_TAPS, '1-5', device='cuda', dtype='float32', img_size=512,
                          train_unet=True, seed=0)
    prompts = fe.encode_prompt('a photo of a cat')
    build_s = time.perf_counter() - t0
    images = torch.rand(2, 3, 512, 512, generator=torch.Generator(device='cuda').manual_seed(1),
                        device='cuda') * 2 - 1
    latent = fe.img_size // fe.vae_scale
    per_step = grad_launches(fa, fe.spec.unet, latent, TRAIN_UNET_TAPS, True)
    per_step = (per_step[0] + vae_b1(fa, fe.spec.vae, latent), *per_step[1:])

    def unet_grads():
        g = torch.Generator(device='cuda').manual_seed(2)
        shape = fe.latent_shape(2)
        posterior, noise = (torch.randn(shape, generator=g, device='cuda') for _ in range(2))
        fe.unet.zero_grad(set_to_none=True)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        feats = fe._step(images, fe._step_conditioning(prompts, 2), fe._step_kit(50), posterior,
                         noise, fe.feature_dtype)
        loss = sum((v.float() ** 2).mean() for v in feats.values())
        loss.backward()
        stop.record()
        torch.cuda.synchronize()
        return ({k: None if p.grad is None else p.grad.detach().clone()
                 for k, p in fe.unet.named_parameters()}, float(loss.detach()),
                start.elapsed_time(stop))

    log = []
    with recording_all(fa, attn_ops, log):
        reset_counts(fa)
        grads, loss, ms = unet_grads()
        torch.cuda.synchronize()
        runs['train_unet'], shapes['train_unet'] = all_counts(fa), log
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {'flash_attention': per_step[0], 'flash_attention_with_lse': per_step[1],
            'headmean_probs': 0, 'short_attention': 0, 'flash_attention_bwd': per_step[2]}
    _, _, ms_again = unet_grads()
    with grad_twins(attn_ops, fa):
        twin, twin_loss, twin_ms = unet_grads()
    missing = [k for k, g in grads.items() if g is None or not bool(torch.isfinite(g).all())]
    num = sum(((grads[k] - twin[k]).double() ** 2).sum().item() for k in grads if k not in missing)
    den = sum((twin[k].double() ** 2).sum().item() for k in grads if k not in missing)
    rel = (num / den) ** 0.5
    zero = sum(1 for k, g in grads.items() if g is not None and not bool(g.abs().max() > 0))
    print(f'phase 19d train_unet 1-5 512^2 fp32 batch 2, taps {sorted(TRAIN_UNET_TAPS)}: build '
          f'{build_s:.1f} s; forward + backward {ms:.2f} ms ({ms_again:.2f} ms again; twins '
          f'{twin_ms:.2f}); peak {peak:.2f} GiB; loss {loss:.6f} (twins {twin_loss:.6f}); '
          f'{len(grads)} parameters, {len(missing)} without a finite gradient, {zero} all zero; '
          f'gradients kernels vs twins rel_l2={rel:.3e} (allowed {TAP_REL_TOL:g}); launches '
          f'{runs["train_unet"]} (expected {want}) ({card})', flush=True)
    if missing or rel > TAP_REL_TOL or runs['train_unet'] != want:
        raise RuntimeError(f'phase 19d: missing {missing[:5]}, rel {rel}, '
                           f'launches {runs["train_unet"]}')
    del fe, grads, twin
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 20, 21
def write_corres_pairs(root):
    """SPair-style pairs under ``root`` (random RGB JPEGs of CORRES_SIZES,
    CORRES_POINTS (x, y) points each, a category, the target's bounding
    box); returns the paths of the training and validation annotation
    files (the last CORRES_VAL_PAIRS pairs validate)."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(20)
    anns = []
    for i, sizes in enumerate(CORRES_SIZES):
        names = []
        for j, (w, h) in enumerate(sizes):
            names.append(f'pair{i}_{j}.jpg')
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                os.path.join(root, names[-1]))
        (sw, sh), (tw, th) = sizes
        anns.append({'source_path': names[0], 'target_path': names[1], 'category': 'cat',
                     'source_points': (rng.rand(CORRES_POINTS, 2) * [sw, sh]).tolist(),
                     'target_points': (rng.rand(CORRES_POINTS, 2) * [tw, th]).tolist(),
                     'target_bounding_box': [20, 10, tw - 40, th - 30]})
    paths = []
    for name, part in (('train', anns[:-CORRES_VAL_PAIRS]), ('val', anns[-CORRES_VAL_PAIRS:])):
        paths.append(os.path.join(root, f'{name}.json'))
        with open(paths[-1], 'w') as f:
            json.dump(part, f)
    return paths


def extract_b1(fa, fe) -> int:
    """B1 launches of one single-step extract of a U-Net extractor: its
    self-attentions through the gate and the VAE encoder's mid head (the
    store's 'up_cross' maps are cross-attention: explicit)."""
    latent = fe.img_size // fe.vae_scale
    return b1_per_forward(fa, fe.spec.unet, latent) + vae_b1(fa, fe.spec.vae, latent)


@contextlib.contextmanager
def member_launches(fa, per_member):
    """Add each FeatureExtractor.extract call's B1 launches to
    ``per_member[version]`` for the duration of the block."""
    from diffusion_feature_tpu_torch.facade import FeatureExtractor
    real = FeatureExtractor.extract

    def counted(self, *args, **kwargs):
        before = fa.launches
        out = real(self, *args, **kwargs)
        per_member[self.version] = per_member.get(self.version, 0) + fa.launches - before
        return out

    FeatureExtractor.extract = counted
    try:
        yield
    finally:
        FeatureExtractor.extract = real


def run_main(torch, fa, attn_ops, main, argv):
    """``main(argv)`` with every count set to 0 just before and read just
    after, its output captured; returns (result, counts, recorded calls,
    {version: B1 launches of its extracts}, seconds, peak GiB)."""
    log, per_member = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with recording_all(fa, attn_ops, log), member_launches(fa, per_member):
        reset_counts(fa)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = all_counts(fa)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for line in out.getvalue().splitlines():
        print(f'  | {line}')
    return result, counts, log, per_member, seconds, peak


def corres_argv(config, root, anns, work, steps, *more):
    return ['--config', config, '--train_anns', anns[0], '--val_anns', anns[1],
            '--dataset_path', root, '--task_path', work, '--max_steps', str(steps),
            '--val_every', str(CORRES_STEPS), '--device', 'cuda', *more]


def check_correspondence(torch, fa, attn_ops, card, shapes, runs):
    """Phase 20 (a) and (b)."""
    import numpy as np
    from diffusion_feature_tpu_torch import task_corres
    from diffusion_feature_tpu_torch.tasks.correspondence import load_annotation, points_to_idxs
    from diffusion_feature_tpu_torch.tasks.correspondence import rescale_points
    with tempfile.TemporaryDirectory(prefix='chip_smoke_corres_') as root:
        anns = write_corres_pairs(root)
        # (a) config_sdxl: 4 steps, the validation, its checkpoint
        work = os.path.join(root, 'sdxl')
        result, runs['corres_sdxl'], shapes['corres_sdxl'], members, seconds, peak = run_main(
            torch, fa, attn_ops, task_corres.main,
            corres_argv(CORRES_CONFIG, root, anns, work, CORRES_STEPS))
        net, losses = result['net'], result['losses']
        per_image = {ex['model'].version: extract_b1(fa, ex['model']) for ex in net.extractors}
        extracts = 2 * CORRES_STEPS + 2 * CORRES_VAL_PAIRS
        want = {**only_b1(sum(per_image.values()) * extracts), 'flash_attention_bwd': 0}
        (step, pck_img, pck_bbox), = result['pck']
        val_ms = result['val_seconds'][0] * 1e3 / CORRES_VAL_PAIRS
        print(f'phase 20a config_sdxl task_corres.main (xl 1024^2 xl-practical bf16 frozen, '
              f'{net.feature_dim} -> {net.out_dim} channels fp32 conv, TF32 off), {CORRES_STEPS} '
              f'steps + val over {CORRES_VAL_PAIRS} pairs: {seconds:.1f} s for main() (model build '
              f'included); losses {[round(x, 4) for x in losses]}; {step_ms(result):.2f} ms per '
              f'step (median after the first; all '
              f'{[round(x * 1e3, 2) for x in result["step_seconds"]]}); {val_ms:.2f} ms per val '
              f'pair; val at step {step}: pck_img {pck_img:.4f} pck_bbox {pck_bbox:.4f}; peak '
              f'{peak:.2f} GiB; launches {runs["corres_sdxl"]} (expected {want}: B1 per image '
              f'{per_image}, {extracts} extracts, no backward; measured per member {members}) '
              f'({card})', flush=True)
        if (runs['corres_sdxl'] != want or len(losses) != CORRES_STEPS
                or not all(np.isfinite(losses)) or not 0 <= pck_img <= 1
                or not 0 <= pck_bbox <= 1):
            raise RuntimeError(f'phase 20a: launches {runs["corres_sdxl"]}, losses {losses}, '
                               f'pck {result["pck"]}')
        # one pair's loss on kernel-path and on twin-path features, the same noise
        with open(anns[0]) as f:
            ann = json.load(f)[0]
        sp, tp, src, tgt, _ = load_annotation(ann, task_corres.LOAD_SIZE, root)
        idx = [torch.as_tensor(points_to_idxs(rescale_points(p, task_corres.LOAD_SIZE,
                                                             task_corres.OUTPUT_SIZE),
                                              task_corres.OUTPUT_SIZE),
                               dtype=torch.long, device='cuda') for p in (sp, tp)]

        with open(CORRES_CONFIG) as f:
            widths = [c['feature_len'] for c in json.load(f)]

        def pair_features():
            for ex in net.extractors:
                ex['model']._noise_gen.manual_seed(0)
            return [net.extract(os.path.join(root, p)) for p in (src, tgt)]

        f_kernel = pair_features()
        with patched_wrappers(attn_ops, twin_of(fa)):
            f_twin = pair_features()
        # each image's features, member by member, within TAP_REL_TOL
        errs = [((a - b).norm() / b.norm()).item() for fk, ft in zip(f_kernel, f_twin)
                for a, b in zip(fk.split(widths, dim=1), ft.split(widths, dim=1))]
        with torch.no_grad():
            l_kernel, l_twin = (float(task_corres.clip_loss(net, *f, *idx))
                                for f in (f_kernel, f_twin))
        print(f'  phase 20a pair 0 features (source, target x {len(widths)} member(s)) on the '
              f'kernel path against the twin path: relative L2 {[f"{e:.3e}" for e in errs]} '
              f'(allowed {TAP_REL_TOL:g}); clip_loss {l_kernel:.6f} vs {l_twin:.6f} (relative '
              f'{abs(l_kernel - l_twin) / abs(l_twin):.3e}, allowed {CORRES_LOSS_TOL:g}: near '
              f'ln(128^2) at random weights, whatever the features)', flush=True)
        if not (max(errs) <= TAP_REL_TOL
                and abs(l_kernel - l_twin) <= CORRES_LOSS_TOL * abs(l_twin)):
            raise RuntimeError(f'phase 20a: features kernel vs twin {errs}, clip_loss '
                               f'{l_kernel} vs {l_twin}')
        del f_kernel, f_twin
        del result, net
        torch.cuda.empty_cache()
        # resumed from the checkpoint: one step more
        ckpt = os.path.join(work, f'checkpoint_step_{CORRES_STEPS}.pt')
        again, runs['corres_sdxl_resume'], shapes['corres_sdxl_resume'], _, seconds, _ = run_main(
            torch, fa, attn_ops, task_corres.main,
            corres_argv(CORRES_CONFIG, root, anns, work, CORRES_STEPS + 1, '--load_weight', ckpt))
        want = {**only_b1(2 * sum(per_image.values())), 'flash_attention_bwd': 0}
        print(f'phase 20a --load_weight: {seconds:.1f} s for main(), from step '
              f'{again["start_step"]}, losses {again["losses"]}, launches '
              f'{runs["corres_sdxl_resume"]} (expected {want})', flush=True)
        if (runs['corres_sdxl_resume'] != want or again['start_step'] != CORRES_STEPS
                or len(again['losses']) != 1 or not np.isfinite(again['losses'][0])):
            raise RuntimeError(f'phase 20a resume: {runs["corres_sdxl_resume"]}, '
                               f'{again["start_step"]}, {again["losses"]}')
        del again
        torch.cuda.empty_cache()

        # (b) config_xl_t: the three-extractor ensemble, one step
        result, runs['corres_xl_t'], shapes['corres_xl_t'], members, seconds, peak = run_main(
            torch, fa, attn_ops, task_corres.main,
            corres_argv(CORRES_ENSEMBLE, root, anns, os.path.join(root, 'xl_t'), 1))
        net = result['net']
        per_image = {ex['model'].version: extract_b1(fa, ex['model']) for ex in net.extractors}
        want_members = {v: 2 * n for v, n in per_image.items()}
        want = {**only_b1(sum(want_members.values())), 'flash_attention_bwd': 0}
        print(f'phase 20b config_xl_t task_corres.main (xl 1024^2, 1-5 512^2 with up_cross maps, '
              f'pgv2 1024^2, bf16 frozen; {net.feature_dim} -> {net.out_dim} channels fp32 conv, '
              f'TF32 off), 1 step: {seconds:.1f} s for main() (three builds included); loss '
              f'{result["losses"]}; step {result["step_seconds"][0] * 1e3:.2f} ms; peak '
              f'{peak:.2f} GiB; B1 launches per member {members} (expected {want_members}); '
              f'launches {runs["corres_xl_t"]} (expected {want}) ({card})', flush=True)
        if (runs['corres_xl_t'] != want or members != want_members
                or not np.isfinite(result['losses'][0])):
            raise RuntimeError(f'phase 20b: launches {runs["corres_xl_t"]}, members {members}, '
                               f'loss {result["losses"]}')
        del result, net
        torch.cuda.empty_cache()


def check_scarce(torch, fa, attn_ops, card, shapes, runs):
    """Phase 21."""
    import numpy as np
    from PIL import Image
    from diffusion_feature_tpu_torch import extract_feature, task_pixel
    from diffusion_feature_tpu_torch.native import AsyncNpyReader
    args = PATHS['xl']['args']
    with tempfile.TemporaryDirectory(prefix='chip_smoke_pixel_') as root, contextlib.chdir(root):
        write_images(PIXEL_IMAGES, 512)
        rng = np.random.RandomState(21)
        os.makedirs('labels')
        for i in range(PIXEL_IMAGES):
            lab = rng.randint(0, 21, (256, 256)).astype(np.uint8)
            lab[:8] = 255
            Image.fromarray(lab).save(f'labels/img{i}.png')
        _, runs['pixel_cli'], shapes['pixel_cli'], _, seconds, peak = run_main(
            torch, fa, attn_ops, extract_feature.main,
            ['--version', args['version'], '--img_size', str(args['img_size']), '--layer',
             args['layer'], '--batch_size', '2', '--prompt', 'a photo of a horse',
             '--input_dir', 'imgs/*.png', '--output_dir', 'feats', '--aggregate_output',
             '--use_original_filename', '--device', 'cuda'])
        # one launch per attention per batch of 2: ceil(images / 2) forwards
        forwards = -(-PIXEL_IMAGES // 2)
        want = {**only_b1(PATHS['xl']['launches'][0] * forwards), 'flash_attention_bwd': 0}
        dumps = sorted(os.listdir('feats'))
        arr = np.load(os.path.join('feats', dumps[0]), mmap_mode='r')
        print(f'phase 21 cli --aggregate_output {args["version"]} {args["img_size"]}^2 over '
              f'{PIXEL_IMAGES} images: {seconds:.1f} s for main() (model build included), peak '
              f'{peak:.2f} GiB; dumps {dumps} {arr.shape} {arr.dtype}; launches '
              f'{runs["pixel_cli"]} (expected {want})', flush=True)
        if runs['pixel_cli'] != want or dumps != [f'img{i}.npy' for i in range(PIXEL_IMAGES)] \
                or arr.shape != (3840, 64, 64) or arr.dtype != np.float16:
            raise RuntimeError(f'phase 21 cli: {runs["pixel_cli"]}, {dumps}, {arr.shape}')
        # the reader alone over the dumps (just written: a warm read)
        reader = AsyncNpyReader(n_threads=4)
        if not reader.is_native:
            raise RuntimeError('phase 21: the native .npy reader (native/npyio.cpp) did not build')
        t0 = time.perf_counter()
        nbytes = sum(a.nbytes for a in reader.read_all([os.path.join('feats', d) for d in dumps]))
        read_s = time.perf_counter() - t0
        reader.close()
        argv = ['--feature_dir', 'feats', '--label_dir', 'labels', '--exp_dir', 'exp'] + PIXEL_ARGV
        result, runs['pixel_task'], shapes['pixel_task'], _, seconds, peak = run_main(
            torch, fa, attn_ops, task_pixel.main, argv)
        rows, member_s = result['rows'], result['member_seconds']
        steps = rows // 64
        predict_ms = [round(x * 1e3, 2) for x in result['predict_seconds']]
        written = {d: sorted(os.listdir(os.path.join('exp', d)))
                   for d in ('predictions', 'visualizations')}
        print(f'phase 21 task_pixel.main horse_21 ({PIXEL_TRAIN} train / '
              f'{PIXEL_IMAGES - PIXEL_TRAIN} test images, 2 members, 1 epoch of {steps} steps of '
              f'64 rows, {rows} rows of {arr.shape[0]} channels on the card): {seconds:.1f} s for main(); '
              f'{[round(x * 1e3, 2) for x in member_s]} ms per member '
              f'({[round(steps * 64 / x) for x in member_s]} training rows/s); predict '
              f'{predict_ms} ms per image; mIoU {result["miou"]:.4f}, uncertainty '
              f'{result["uncertainties"]}; written {written}; peak {peak:.2f} GiB; reader '
              f'{nbytes / read_s / 1e9:.3f} GB/s over {nbytes} bytes (warm); launches '
              f'{runs["pixel_task"]} ({card})', flush=True)
        names = [f'{n}.png' for n in result['names']]
        if (result['trained'] != [0, 1] or sorted(os.listdir('exp'))[:2] != ['model_0.pt',
                                                                            'model_1.pt']
                or written != {'predictions': names, 'visualizations': names}
                or not np.isfinite(result['miou'])
                or not all(np.isfinite(result['uncertainties']))):
            raise RuntimeError(f'phase 21: trained {result["trained"]}, written {written}, '
                               f'mIoU {result["miou"]}, {result["uncertainties"]}')
        if result['matrix_on_host']:
            raise RuntimeError(f'phase 21: a matrix of {PIXEL_TRAIN} images left on the host')
        first = result['ensemble'][0].state_dict()
        del result
        # a matrix too large for the card's room stays on the host; each
        # batch is copied over and trains the same member
        room = task_pixel._device_room
        task_pixel._device_room = lambda device: 0
        try:
            hosted, _, _, _, seconds, _ = run_main(
                torch, fa, attn_ops, task_pixel.main,
                ['--feature_dir', 'feats', '--label_dir', 'labels', '--exp_dir', 'exp_host',
                 *PIXEL_ARGV, '--model_num', '1'])
        finally:
            task_pixel._device_room = room
        same = all(torch.equal(v, hosted['ensemble'][0].state_dict()[k]) for k, v in first.items())
        print(f'phase 21 task_pixel.main with no room on the card: {seconds:.1f} s, matrix on '
              f'the host {hosted["matrix_on_host"]}, {hosted["member_seconds"][0] * 1e3:.2f} ms '
              f'for the member, equal to the card matrix\'s member {same}', flush=True)
        if not (hosted['matrix_on_host'] and same):
            raise RuntimeError(f'phase 21 host matrix: on host {hosted["matrix_on_host"]}, '
                               f'same member {same}')
        del hosted
        again, runs['pixel_task_loaded'], shapes['pixel_task_loaded'], _, seconds, _ = run_main(
            torch, fa, attn_ops, task_pixel.main, argv)
        print(f'phase 21 task_pixel.main again: {seconds:.1f} s, trained {again["trained"]} (the '
              f'checkpoints loaded), mIoU {again["miou"]:.4f}', flush=True)
        if again['trained'] or again['rows'] or not np.isfinite(again['miou']):
            raise RuntimeError(f'phase 21 again: trained {again["trained"]}')
        del again
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 22
def mesh_counted(torch, fa, attn_ops, fn):
    """``fn()`` with every count set to 0 just before and read just after,
    each kernel call recorded; returns (result, counts, recorded calls,
    seconds, this process's peak GiB)."""
    log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with recording_all(fa, attn_ops, log):
        reset_counts(fa)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = all_counts(fa)
    return result, counts, log, seconds, torch.cuda.max_memory_allocated() / 2 ** 30


def cpu_feats(feats):
    return {k: v.detach().cpu() for k, v in feats.items()}


def resident_bytes(module):
    return sum(t.numel() * t.element_size() for t in module.state_dict().values())


def mesh_cli_argv(work, out, dp, batch=2):
    args = PATHS[CLI_PATH]['args']
    return ['--version', args['version'], '--img_size', str(args['img_size']), '--layer',
            args['layer'], '--batch_size', str(batch), '--prompt', 'a photo of a cat', '--input_dir',
            os.path.join(work, 'imgs', '*.png'), '--output_dir', os.path.join(work, out),
            '--device', 'cuda:0', '--dp', str(dp)]


def mesh_seg_argv(work, dp):
    dirs = {(split, kind): os.path.join(work, 'seg', split, kind)
            for split in ('train', 'val') for kind in ('img', 'lab')}
    return seg_argv(MESH_SEG_CONFIG, dirs, os.path.join(work, f'seg_dp{dp}'), MESH_SEG_ITERS,
                    val=False) + ['--dp', str(dp)]


def seg_state(seg):
    return {k: v.float().cpu() for k, v in seg.state_dict().items()}


@contextlib.contextmanager
def rows_one_at_a_time(torch):
    """Every extract of the block runs its batch one row at a time, each
    row from the whole batch's noise: on one device, what each rank of a
    dp mesh that holds one row of the batch computes."""
    from diffusion_feature_tpu_torch.facade import FeatureExtractor
    real = FeatureExtractor._extract

    def by_row(self, prompts, batch_size, image, rows, **kwargs):
        lo, hi = rows
        if hi - lo < 2:
            return real(self, prompts, batch_size, image, rows, **kwargs)
        state = self._noise_gen.get_state()
        parts = []
        for i in range(lo, hi):
            self._noise_gen.set_state(state)
            parts.append(real(self, prompts, batch_size, image[i - lo:i - lo + 1], (i, i + 1),
                              **kwargs))
        return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}
    FeatureExtractor._extract = by_row
    try:
        yield
    finally:
        FeatureExtractor._extract = real


@contextlib.contextmanager
def first_step_recorded(record):
    """train_segmentation's first step recorded into ``record``, on the
    host: the gradients it took, after the dp average ('grad'); under dp
    this rank's own gradients before the average ('local': what the step
    would take with the average left out, phase 22e's planted fault); what
    the step changed in the BatchNorm running statistics ('stats'); and,
    once the block ends, how far the steps moved each parameter whose
    first gradient is fp32 noise ('noise_moved')."""
    from diffusion_feature_tpu_torch import train_segmentation
    real_step, real_average = train_segmentation.train_step, train_segmentation.average_gradients

    def host(named):
        return {f'head.{k}': v.detach().to('cpu', copy=True).float() for k, v in named}

    def step(seg, opt, *args, **kwargs):
        first = 'grad' not in record
        if first:
            record['seg'] = seg
            buffers = host(seg.head.named_buffers())
            params = host(seg.head.named_parameters())
        result = real_step(seg, opt, *args, **kwargs)
        if first:
            record['grad'] = host((k, p.grad) for k, p in seg.head.named_parameters()
                                  if p.grad is not None)
            record['stats'] = {k: v - buffers[k] for k, v in host(seg.head.named_buffers()).items()
                               if '.running_' in k}
            record['initial'] = {k: params[k] for k in noise_params(record['grad'])}
        return result

    def average(params, dp):
        if 'local' not in record:
            record['local'] = {id(p): p.grad.detach().to('cpu', copy=True).float()
                               for p in params if p.grad is not None}
        real_average(params, dp)
    train_segmentation.train_step, train_segmentation.average_gradients = step, average
    try:
        yield
    finally:
        train_segmentation.train_step = real_step
        train_segmentation.average_gradients = real_average
    named = dict(record.pop('seg').head.named_parameters())
    if 'local' in record:
        names = {id(p): f'head.{k}' for k, p in named.items()}
        record['local'] = {names[i]: g for i, g in record['local'].items() if i in names}
    record['noise_moved'] = {
        k: float((named[k[len('head.'):]].detach().float().cpu() - v).abs().max())
        for k, v in record.pop('initial').items()}


def noise_params(grad):
    """The parameters whose first gradient is fp32 noise: a largest
    magnitude above 0 and at most MESH_NOISE_GRAD of the largest
    parameter's (a bias whose every path meets a training-mode BatchNorm:
    mathematically 0)."""
    top = max(float(g.abs().max()) for g in grad.values())
    return [k for k, g in sorted(grad.items()) if 0 < float(g.abs().max()) <= MESH_NOISE_GRAD * top]


def rel_l2_over(torch, ours, ref, keys):
    """Relative L2 of the dict ``ours`` against ``ref`` over ``keys``
    together, summed on the card."""
    num = den = 0.0
    for k in keys:
        a, b = ours[k].to('cuda', torch.float64), ref[k].to('cuda', torch.float64)
        num += float((a - b).pow(2).sum())
        den += float(b.pow(2).sum())
    return (num / den) ** 0.5


def grad_fingerprint(torch, grad):
    """Each gradient's sum and sum of squares in fp64: equal on every rank
    exactly when the ranks hold the same gradients."""
    return {k: (float(g.double().sum()), float(g.double().pow(2).sum())) for k, g in grad.items()}


def mesh_xl(torch, mesh):
    """Phase 22b's extractor, prompt and images (phase 6's request plus a q
    and an FFN inner tap)."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    fe = FeatureExtractor(MESH_XL_LAYERS, 'xl', img_size=1024, attention=['up_self'],
                          dtype='bfloat16', device='cuda', seed=0, mesh=mesh)
    gen = torch.Generator(device='cuda').manual_seed(1)
    images = torch.rand(2, 3, 1024, 1024, generator=gen, device='cuda') * 2 - 1
    return fe, fe.encode_prompt('a photo of a cat'), images


def mesh_flux(torch, tree, mesh, **kwargs):
    """Phase 16f's int8 Flux on phase 16d's tree over ``mesh``, with its
    prompt and images (open_path's)."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    fe = FeatureExtractor(**PATHS['flux']['args'], dtype='bfloat16', device='cuda', seed=0,
                          weights=tree, mesh=mesh, **kwargs)
    gen = torch.Generator(device='cuda').manual_seed(1)
    images = torch.rand(2, 3, 1024, 1024, generator=gen, device='cuda') * 2 - 1
    return fe, fe.encode_prompt('a photo of a cat'), images


class CountingSink:
    """A file that keeps only the count of the bytes written to it: where
    phase 22e's trainer saves its 8.7 GB checkpoints (the card's machine
    counts every byte written to its disk against a limit)."""

    def __init__(self):
        self.nbytes = 0

    def write(self, data):
        self.nbytes += len(data)
        return len(data)

    def flush(self):
        pass


@contextlib.contextmanager
def checkpoints_counted(torch, sink):
    """``torch.save`` into ``sink`` for the duration of the block."""
    real = torch.save
    torch.save = lambda obj, f, *args, **kwargs: real(obj, sink, *args, **kwargs)
    try:
        yield
    finally:
        torch.save = real


def mesh_rank(rank, world, port, work, names, flux_tree):
    """A phase-22 rank process, one of ``world`` on cuda:0 joined over gloo
    (NCCL takes one rank per card): the sub-phases ``names`` in turn, each
    with every count set to 0 just before and read just after, this rank's
    numbers and features written to ``{work}/rank{rank}.pt``."""
    import datetime
    import torch
    import torch.distributed as dist
    from diffusion_feature_tpu_torch import FeatureExtractor, extract_feature, train_segmentation
    from diffusion_feature_tpu_torch.ops import attention as attn_ops
    from diffusion_feature_tpu_torch.ops import flash_attention as fa
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    fa.build()   # the parent's libraries, by their source hashes: no nvcc here
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}', world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    out = {}

    def run(name, fn):
        dist.barrier()
        result, counts, log, seconds, peak = mesh_counted(torch, fa, attn_ops, fn)
        out[name] = {'counts': counts, 'log': log, 'seconds': seconds, 'peak': peak,
                     **(result or {})}

    def extract_on(fe, prompts, images):
        return lambda: {'feats': cpu_feats(extract(fe, prompts, images))}

    def train():
        sink, record = CountingSink(), {}
        with checkpoints_counted(torch, sink), first_step_recorded(record):
            result = train_segmentation.main(mesh_seg_argv(work, 2))
        if rank:   # the all-reduce hands every rank the same gradients: rank 0's are
            # compared whole, the others' by fingerprint; rank 0's own are the fault's
            del record['local']
            record['grad'] = grad_fingerprint(torch, record['grad'])
        return {'losses': result['losses'], 'checkpoint_bytes': sink.nbytes, **record}

    try:
        for name in names:
            t0 = time.perf_counter()
            if name == '22a':      # the CLI, --dp 2
                run(name, lambda: extract_feature.main(mesh_cli_argv(work, 'dp2', 2)))
            elif name == '22b':    # tp=2 on SDXL
                fe, prompts, images = mesh_xl(torch, make_mesh(tp=2))
                out['22b_bytes'] = resident_bytes(fe.unet)
                run(name, extract_on(fe, prompts, images))
            elif name == '22c':    # tp=2 on the int8 Flux: explicit, the auto rule is off
                fe, prompts, images = mesh_flux(torch, flux_tree, make_mesh(tp=2),
                                                transformer_8bit=True)
                out['22c_bytes'] = resident_bytes(fe.unet)
                run(name, extract_on(fe, prompts, images))
            elif name == '22d_pixart':   # sp=2 on PixArt-Sigma, bf16
                fe = FeatureExtractor(**PATHS['pixart_sigma']['args'], dtype='bfloat16',
                                      device='cuda', seed=0, mesh=make_mesh(sp=2))
                gen = torch.Generator(device='cuda').manual_seed(1)
                images = torch.rand(2, 3, 1024, 1024, generator=gen, device='cuda') * 2 - 1
                run(name, extract_on(fe, fe.encode_prompt('a photo of a cat'), images))
            elif name == '22d_flux':     # sp=2 on the int8 Flux of the auto rule
                fe, prompts, images = mesh_flux(torch, flux_tree, make_mesh(sp=2))
                out['22d_flux_int8'] = fe._int8_denoiser
                run(name, extract_on(fe, prompts, images))
            else:                  # 22e: the trainer, --dp 2 on ade_full.json
                run(name, train)
            out[name]['wall'] = time.perf_counter() - t0
            fe = None
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(work, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn_ranks(torch, work, names, flux_tree=None):
    """Two rank processes of ``mesh_rank`` running ``names``; returns each
    rank's results once both exited 0, else raises."""
    import multiprocessing
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=mesh_rank, args=(r, 2, port, work, names, flux_tree))
             for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=MESH_RANK_SECONDS)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    print(f'phase 22 two ranks on one card ({", ".join(names)}): '
          f'{time.perf_counter() - t0:.1f} s from the spawn to the last exit, exit codes '
          f'{codes}', flush=True)
    if codes != [0, 0]:
        raise RuntimeError(f'phase 22 {names}: rank exit codes {codes}')
    return [torch.load(os.path.join(work, f'rank{r}.pt'), weights_only=False) for r in range(2)]


def report_ranks(ranks, name, label, shapes, runs, want):
    """Each rank's seconds, peak GiB and launches of sub-phase ``name``,
    held to ``want``; its launches and recorded calls join the kernels
    line."""
    for r, res in enumerate(ranks):
        sub = res[name]
        runs[f'mesh_{name}_r{r}'], shapes[f'mesh_{name}_r{r}'] = sub['counts'], sub['log']
        print(f'phase {name} rank {r} (two ranks on one card): {label}: {sub["seconds"]:.1f} s '
              f'({sub["wall"]:.1f} s with the build), peak {sub["peak"]:.2f} GiB, launches '
              f'{sub["counts"]} (expected {want})', flush=True)
        if sub['counts'] != want:
            raise RuntimeError(f'phase {name} rank {r}: launches {sub["counts"]}')


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def tp_resident_bytes(torch, spec, rank, tp):
    """The bytes of rank ``rank``'s int8 Flux transformer at ``tp``, from the
    config: the module built on the meta device, cut by parallel/mesh.py
    for that rank, summed."""
    import dataclasses
    from diffusion_feature_tpu_torch.models.flux import FluxTransformer2D
    from diffusion_feature_tpu_torch.parallel import mesh
    axes = {name: mesh.Axis(name, None, rank if name == 'tp' else 0, tp if name == 'tp' else 1)
            for name in mesh.AXES}
    fake = mesh.Mesh({name: a.size for name, a in axes.items()},
                     {name: a.rank for name, a in axes.items()}, axes, 'none')
    with torch.device('meta'):
        module = FluxTransformer2D(dataclasses.replace(spec.dit, quantize_int8=True))
    module.to(dtype=torch.bfloat16)
    mesh.cut_parameters_(module, mesh.parallelize(module, fake))
    return resident_bytes(module)


def check_mesh_flux(torch, fa, attn_ops, card, shapes, runs, tree):
    """Phase 22c and 22d's Flux part, run in phase 16 after 16f while its
    tree exists (the card's machine counts every byte written to its disk,
    so the ~34 GB tree is written once and lives no longer): the int8 Flux
    at tp=2 (22c) and sp=2 (22d) on two ranks, against phase 16f's
    features."""
    from diffusion_feature_tpu_torch.models.registry import get_model_spec
    quant = _quant()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_mesh_flux_') as work:
        ranks = spawn_ranks(torch, work, ('22c', '22d_flux'), tree)
    spec = get_model_spec('flux')
    vae_scale = 2 ** (len(spec.vae.block_out_channels) - 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, label, kw, b1 in (
            ('22c', "the int8 Flux 1024^2 tp=2 from phase 16d's tree", dict(tp=2),
             TP_FLUX_B1_SHAPES),
            ('22d_flux', 'the int8 Flux 1024^2 sp=2 (the auto rule)', dict(sp=2),
             SP_FLUX_B1_SHAPES)):
        derived = flux_int8_calls(spec, 1024, 2, vae_scale, **kw)
        report_ranks(ranks, name, label, shapes, runs,
                     {**only_b1(MESH_REFS['flux_b1']), 'int8_linear': sum(derived.values()),
                      'flash_attention_bwd': 0})
        routes = {s: quant.ROUTES[quant.int8_route(s[0], s[2], s[1], torch.bfloat16, True, sms)]
                  for s in derived}
        print(f'  phase {name} W8A16 shard shapes (M, K, N): calls {derived}; the kernel '
              f'int8_route picks for each: {routes}', flush=True)
        for r, res in enumerate(ranks):
            recorded = shape_counts(res[name]['log'])
            attn = shape_counts(res[name]['log'], 'flash_attention')
            rel, cos = zip(*(rel_cos(res[name]['feats'][k], v)
                             for k, v in MESH_REFS['flux_int8'].items()))
            print(f'  phase {name} rank {r}: B1 shapes {attn}; against phase 16f\'s single '
                  f'device, relative L2 {[f"{x:.3e}" for x in rel]}, cosine '
                  f'{[f"{x:.6f}" for x in cos]}', flush=True)
            if (recorded != derived or not set(b1) <= set(attn)
                    or min(cos) < MESH_COSINE or (name == '22d_flux' and max(rel) > TAP_REL_TOL)):
                raise RuntimeError(f'phase {name} rank {r}: W8A16 {recorded}, B1 {attn}, '
                                   f'relative {rel}, cosine {cos}')
    for r, res in enumerate(ranks):
        want = tp_resident_bytes(torch, spec, r, 2)
        ratio = res['22c_bytes'] / MESH_REFS['flux_int8_bytes']
        print(f'  phase 22c rank {r}: resident transformer {res["22c_bytes"] / 2 ** 30:.3f} GiB, '
              f'{ratio:.3f} of phase 16f\'s {MESH_REFS["flux_int8_bytes"] / 2 ** 30:.3f} GiB: '
              f'the layers the rules cut in half, the adaLN projections, embedders and norms '
              f'whole ({want / 2 ** 30:.3f} GiB from the config); 22d int8 by the auto rule: '
              f'{res["22d_flux_int8"]} ({card})', flush=True)
        if res['22c_bytes'] != want or not res['22d_flux_int8']:
            raise RuntimeError(f'phase 22c/d rank {r}: {res["22c_bytes"]} bytes, derived {want}, '
                               f'int8 {res["22d_flux_int8"]}')
    torch.cuda.empty_cache()


def mesh_dp_references(torch, fa, attn_ops, work):
    """Phase 22a's and 22e's one-device runs: the CLI --dp 1 at batch 2,
    its witness (rows_one_at_a_time) and --batch_size 1 (the fault), each
    into its own tree; the trainer --dp 1 and its witness, each with its
    first step recorded and what the steps changed."""
    from diffusion_feature_tpu_torch import extract_feature
    refs = {}
    for out, batch, label in (('dp1', 2, 'at batch 2'),
                              ('rows', 2, 'at batch 2, its rows one at a time (the witness)'),
                              ('bs1', 1, 'at batch 1, each row its own noise (the fault)')):
        with rows_one_at_a_time(torch) if out == 'rows' else contextlib.nullcontext():
            _, counts, _, _, seconds, _ = run_main(
                torch, fa, attn_ops, extract_feature.main, mesh_cli_argv(work, out, 1, batch))
        refs.setdefault('22a', counts)
        print(f'phase 22a reference: the CLI --dp 1 over {MESH_CLI_IMAGES} images {label}: '
              f'{seconds:.1f} s, launches {counts}', flush=True)
    for tag, label in (('22e', 'plain'), ('22e_rows', 'its witness, rows one at a time')):
        sink, record = CountingSink(), {}
        with (checkpoints_counted(torch, sink), first_step_recorded(record),
              rows_one_at_a_time(torch) if tag == '22e_rows' else contextlib.nullcontext()):
            result, counts, _, seconds, _ = run_trainer(torch, fa, attn_ops,
                                                        mesh_seg_argv(work, 1))
        refs[tag] = {'losses': result['losses'], **record}
        refs.setdefault('22e_counts', counts)
        print(f'phase 22e reference ({label}): train_segmentation --dp 1 on {MESH_SEG_CONFIG}, '
              f'{MESH_SEG_ITERS} steps: {seconds:.1f} s, losses {result["losses"]}, launches '
              f'{counts}, its checkpoint {sink.nbytes / 1e9:.3f} GB counted, not written',
              flush=True)
        del result, record
        torch.cuda.empty_cache()
    return refs


def read_tree(root):
    import numpy as np
    return {os.path.relpath(os.path.join(d, f), root):
            np.load(os.path.join(d, f)).astype(np.float32)
            for d, _, fs in os.walk(root) for f in fs}


def tree_rel(torch, tree, ref):
    """The worst file's relative L2 of ``tree`` against ``ref``."""
    return max(rel_l2(torch.from_numpy(tree[n]), torch.from_numpy(v)) for n, v in ref.items())


def check_mesh_cli(torch, ranks, work, shapes, runs, refs):
    """Phase 22a: each rank's rows of each batch of 2, two extracts at
    batch 1; the --dp 2 tree against the witness's and --dp 1's."""
    report_ranks(ranks, '22a', f'the CLI --dp 2 over {MESH_CLI_IMAGES} images at batch 2',
                 shapes, runs, refs['22a'])
    for r, res in enumerate(ranks):
        batches = {s[0] for n, s, _ in res['22a']['log'] if n == 'flash_attention'}
        if batches != {1}:
            raise RuntimeError(f'phase 22a rank {r}: B1 batches {batches}, expected 1')
    trees = {out: read_tree(os.path.join(work, out)) for out in ('dp1', 'rows', 'bs1', 'dp2')}
    names = sorted(trees['dp1'])
    if any(sorted(tree) != names for tree in trees.values()):
        raise RuntimeError(f'phase 22a: the trees name {[sorted(t) for t in trees.values()]}')
    ours, witness, fault = (tree_rel(torch, trees[o], trees['rows']) for o in ('dp2', 'rows',
                                                                              'bs1'))
    plain, cause = (tree_rel(torch, trees[o], trees['dp1']) for o in ('dp2', 'rows'))
    print(f'phase 22a tree: {len(names)} files named as --dp 1 names them; worst relative L2 '
          f'against the witness (rows one at a time, the whole batch\'s noise) {ours:.3e} '
          f'(allowed {MESH_ROWS_REL:g}), the fault (--batch_size 1, each row its own noise) '
          f'{fault:.3e} (must exceed {MESH_ROWS_REL:g}); against --dp 1 at batch 2 {plain:.3e} '
          f'(allowed {TAP_REL_TOL:g}), the witness against it {cause:.3e} (bf16 at batch 1 '
          f'against batch 2)', flush=True)
    if ours > MESH_ROWS_REL or fault <= MESH_ROWS_REL or plain > TAP_REL_TOL:
        raise RuntimeError(f'phase 22a: witness {ours}, fault {fault}, --dp 1 {plain}')


def check_mesh_trainer(torch, ranks, shapes, runs, refs):
    """Phase 22e: --dp 2 against the --dp 1 witness.  The first step: its
    loss within MESH_LOSS_REL, the gradients it took within
    MESH_GRAD_REL, what it changed in the BatchNorm running statistics
    within MESH_STATS_REL; the planted fault (rank 0's own gradients, which
    the step would take with the average left out) beyond MESH_GRAD_REL;
    every loss within MESH_LOSS_REL of plain --dp 1's; the parameters
    whose first gradient is fp32 noise moved at most the steps' rates."""
    report_ranks(ranks, '22e', f'train_segmentation --dp 2 on {MESH_SEG_CONFIG}, '
                 f'{MESH_SEG_ITERS} steps', shapes, runs, refs['22e_counts'])
    witness, plain = refs['22e_rows'], refs['22e']
    rate = MESH_SEG_ITERS * MESH_SEG_LR

    loss = abs(witness['losses'][0] - plain['losses'][0]) / abs(plain['losses'][0])
    grad = rel_l2_over(torch, witness['grad'], plain['grad'], sorted(plain['grad']))
    stat = rel_l2_over(torch, witness['stats'], plain['stats'], sorted(plain['stats']))
    print(f'  phase 22e: {len(witness["grad"])} parameter tensors, {len(witness["stats"])} '
          f'BatchNorm statistics, {len(witness["noise_moved"])} parameters with a first '
          f'gradient of fp32 noise ({sorted(witness["noise_moved"])}); the witness against '
          f'plain --dp 1 (bf16 features at batch 1 against 2): the first step\'s loss '
          f'{loss:.3e}, gradients {grad:.3e}, statistics {stat:.3e}', flush=True)
    failed = []
    grad0 = ranks[0]['22e']['grad']   # the other ranks' by fingerprint
    grad = rel_l2_over(torch, grad0, witness['grad'], sorted(witness['grad']))
    for r, res in enumerate(ranks):
        sub = res['22e']
        same = r == 0 or sub['grad'] == grad_fingerprint(torch, grad0)
        loss = abs(sub['losses'][0] - witness['losses'][0]) / abs(witness['losses'][0])
        stat = rel_l2_over(torch, sub['stats'], witness['stats'], sorted(witness['stats']))
        losses = max(abs(a - b) / abs(b) for a, b in zip(sub['losses'], plain['losses']))
        worst = max(sub['noise_moved'].values(), default=0.0)
        print(f'  phase 22e rank {r}: losses {sub["losses"]}, the witness\'s '
              f'{witness["losses"]}, plain --dp 1\'s {plain["losses"]}; the first step against '
              f'the witness: loss {loss:.3e} (allowed {MESH_LOSS_REL:g}), gradients {grad:.3e} '
              f'(allowed {MESH_GRAD_REL:g}; every rank\'s equal to rank 0\'s: {same}), '
              f'statistics {stat:.3e} (allowed {MESH_STATS_REL:g}); every loss against plain '
              f'--dp 1 {losses:.3e} (allowed {MESH_LOSS_REL:g}); the noise-gradient parameters '
              f'{sorted(sub["noise_moved"])} moved at most {worst:.3e} (allowed {rate:g}); TF32 '
              f'off; checkpoint {sub["checkpoint_bytes"] / 1e9:.3f} GB counted', flush=True)
        if (not same or loss > MESH_LOSS_REL or losses > MESH_LOSS_REL or grad > MESH_GRAD_REL
                or stat > MESH_STATS_REL or worst > rate
                or sorted(sub['noise_moved']) != sorted(witness['noise_moved'])):
            failed.append(f'rank {r}: same gradients {same}, loss {loss}, losses {losses}, '
                          f'gradients {grad}, statistics {stat}, noise parameters {worst}')
    fault = rel_l2_over(torch, ranks[0]['22e']['local'], witness['grad'], sorted(witness['grad']))
    print(f'  phase 22e planted fault: rank 0\'s own first gradients, which the step would take '
          f'with the average left out, against the witness {fault:.3e} (must exceed '
          f'{MESH_GRAD_REL:g})', flush=True)
    if fault <= MESH_GRAD_REL:
        failed.append(f'the planted fault reads {fault}, within the bound')
    if failed:
        raise RuntimeError(f'phase 22e: {failed}')


def check_mesh(torch, fa, attn_ops, card, shapes, runs):
    """Phase 22: the mesh over two ranks on cuda:0 (gloo), each a process of
    its own, against the single-device runs (22c and the Flux part of 22d
    ran in phase 16, check_mesh_flux); then one NCCL world of size 1.  The
    single-device references run first in this process (22a's and 22e's,
    mesh_dp_references; 22b's tp=1 extract; 22d holds phase 14a's
    features), then this process frees its memory and spawns the ranks."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_mesh_') as work:
        with contextlib.chdir(work):
            write_images(MESH_CLI_IMAGES, 512)
            write_seg_pairs(os.path.join(work, 'seg'))
        refs = mesh_dp_references(torch, fa, attn_ops, work)
        fe, prompts, images = mesh_xl(torch, None)
        refs['22b'] = cpu_feats(extract(fe, prompts, images))
        refs['22b_bytes'] = resident_bytes(fe.unet)
        del fe
        torch.cuda.empty_cache()
        print(f'phase 22 references: {time.perf_counter() - t_phase:.1f} s; '
              f'{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB still allocated here',
              flush=True)
        ranks = spawn_ranks(torch, work, ('22a', '22b', '22d_pixart', '22e'))
        check_mesh_cli(torch, ranks, work, shapes, runs, refs)

    # 22b: tp=2 on SDXL, phase 6's launches on each rank at head-shard shapes
    report_ranks(ranks, '22b', "SDXL 1024^2 tp=2 'xl-practical' + q and FFN inner taps, "
                 'up_self store', shapes, runs,
                 {**dict(zip(WRAPPERS, PATHS['xl_store']['launches'])), 'short_attention': 0,
                  'flash_attention_bwd': 0})
    for r, res in enumerate(ranks):
        heads = sorted({s[1] for n, s, _ in res['22b']['log'] if s[-1] == 64})
        rel = {k: rel_l2(res['22b']['feats'][k], v) for k, v in refs['22b'].items()}
        print(f'  phase 22b rank {r}: heads per call {heads} (of 10 and 20), resident U-Net '
              f'{res["22b_bytes"] / 2 ** 30:.3f} GiB of {refs["22b_bytes"] / 2 ** 30:.3f}; '
              f'relative L2 against tp=1 { {k: f"{x:.3e}" for k, x in rel.items()} } (allowed '
              f'{TAP_REL_TOL:g})', flush=True)
        if (set(res['22b']['feats']) != set(refs['22b']) or heads != [5, 10]
                or max(rel.values()) > TAP_REL_TOL):
            raise RuntimeError(f'phase 22b rank {r}: heads {heads}, relative {rel}')

    # 22d: sp=2 on PixArt-Sigma, each rank's queries against every key
    report_ranks(ranks, '22d_pixart', 'PixArt-Sigma 1024^2 bf16 sp=2', shapes, runs,
                 MESH_REFS['pixart_counts'])
    for r, res in enumerate(ranks):
        attn = shape_counts(res['22d_pixart']['log'], 'flash_attention')
        rel = [rel_l2(res['22d_pixart']['feats'][k], v)
               for k, v in MESH_REFS['pixart_sigma'].items()]
        print(f'  phase 22d_pixart rank {r}: B1 shapes {attn}; relative L2 against phase 14a '
              f'{[f"{x:.3e}" for x in rel]} (allowed {TAP_REL_TOL:g})', flush=True)
        if not set(SP_B1_SHAPES) <= set(attn) or max(rel) > TAP_REL_TOL:
            raise RuntimeError(f'phase 22d_pixart rank {r}: B1 {attn}, relative {rel}')

    # 22e: the trainer, --dp 2 against --dp 1's witness
    check_mesh_trainer(torch, ranks, shapes, runs, refs)
    del ranks
    torch.cuda.empty_cache()

    # 22f: NCCL, one rank
    check_nccl(torch)
    print(f'phase 22: {time.perf_counter() - t_phase:.1f} s ({card})', flush=True)


def check_nccl(torch):
    """Phase 22f: an NCCL world of size 1 through make_mesh(dp=1): its
    extract torch.equal to the plain extract, and one all_reduce on the
    card through NCCL."""
    import socket
    import torch.distributed as dist
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    dist.init_process_group('nccl', init_method=f'tcp://localhost:{port}', world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(dp=1)
        args = PATHS['sd15_store']['args']
        feats = []
        for m in (mesh, None):
            fe = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0, mesh=m)
            gen = torch.Generator(device='cuda').manual_seed(1)
            images = torch.rand(2, 3, 512, 512, generator=gen, device='cuda') * 2 - 1
            feats.append(extract(fe, fe.encode_prompt('a photo of a cat'), images))
            del fe
        total = torch.stack([v.float().sum() for v in feats[0].values()])
        summed = total.clone()
        dist.all_reduce(summed)
        torch.cuda.synchronize()
        equal = all(torch.equal(feats[0][k], feats[1][k]) for k in feats[1])
        print(f'phase 22f NCCL world of 1 ({dist.get_backend()}), {mesh}: sd15_store extract '
              f'torch.equal to the plain extract {equal}; all_reduce over NCCL '
              f'{torch.equal(summed, total)}', flush=True)
        if not equal or not torch.equal(summed, total) or set(feats[0]) != set(feats[1]):
            raise RuntimeError('phase 22f: the NCCL mesh extract differs')
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU',
              file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch.ops import attention as attn_ops
    from diffusion_feature_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f'card: {card}', flush=True)

    t_start = time.perf_counter()

    def done(phases):
        print(f'[{time.perf_counter() - t_start:.1f} s] {phases} done', flush=True)

    # 1. build
    info = fa.build()
    print(f'phase 1 build: {info["seconds"]:.1f} s -> {", ".join(info["paths"])}', flush=True)
    for line in ptxas_summary(info['log']):
        print(f'  ptxas: {line}')

    def sass_ops(path):
        if '_bf16_' in path or '_fp16_' in path:
            # W8A16: the TMA kernel's HGMMA and UTMALDG, the cp.async kernel's
            # LDGSTS (kept for rows TMA cannot describe), the streaming
            # kernel's HMMA (mma.sync)
            return (('HGMMA', 'UTMALDG', 'LDGSTS', 'HMMA') if '_w8a16_' in path
                    else ('HGMMA', 'UTMALDG'))
        # fp32: simt_f32.cuh's FMA products, no shuffle in a product; B1/B2,
        # B4 and the backward keep shuffles to the softmax's row reductions
        # and the delta pre-pass, B3 reduces nothing across lanes
        return ('FFMA', 'SHFL', 'LDGSTS') if '_w8a16_' in path else ('FFMA', 'SHFL')
    # one cuobjdump per library, all started together
    with concurrent.futures.ThreadPoolExecutor(len(info['paths'])) as pool:
        sass = dict(zip(info['paths'], pool.map(lambda p: sass_counts(p, sass_ops(p)),
                                                info['paths'])))
    for path in info['paths']:
        counts = sass[path]
        if '_bf16_' in path or '_fp16_' in path:
            print(f'phase 1 SASS of {os.path.basename(path)}: {counts}', flush=True)
            if not all(counts.values()):
                raise RuntimeError(f'{path}: no {" or ".join(counts)} in the SASS: {counts}')
        elif '_w8a16_' in path:
            print(f'phase 1 SASS of {os.path.basename(path)}: {counts}', flush=True)
            if not counts['FFMA']:
                raise RuntimeError(f'{path}: no FFMA in the SASS: {counts}')
        else:
            lib = next((n for n in EMULATION_SHFL if f'_{n}_' in path), None)
            before = '' if lib is None else f' (SHFL on the emulation: {EMULATION_SHFL[lib]})'
            print(f'phase 1 SASS of {os.path.basename(path)}: {counts}{before}', flush=True)
            if lib == 'headmean_f32' and counts['SHFL']:
                raise RuntimeError(f'{path}: {counts["SHFL"]} SHFL in the SASS; fp32 B3 '
                                   'needs no cross-lane exchange')
    spill_check(info['log'], info['paths'])
    from diffusion_feature_tpu_torch.native import load_library
    writer_lib = load_library('dumpio')
    if writer_lib is None:
        raise RuntimeError('the native dump writer (native/dumpio.cpp) did not build with g++')
    print(f'phase 1 native dump writer: {writer_lib._name}', flush=True)
    done('phase 1')

    # 2. every kernel against its twin, with times, at every path shape
    gen = torch.Generator(device='cuda').manual_seed(0)
    numbers = {}   # (kernel, shape, dtype name) -> numbers
    # every comparison holds the kernel to its twin; only the shapes and
    # layouts whose numbers the kernels line takes are timed
    for dtype_name in ('bfloat16', 'float32'):
        for kernel, shapes in (('flash_attention', B1_SHAPES),
                               ('flash_attention_with_lse', STORE_SHAPES),
                               ('headmean_probs', STORE_SHAPES)):
            # contiguous inputs: held, not timed (the paths hand head-split views)
            for shape in shapes + [RAGGED]:
                compare(torch, fa, kernel, shape, dtype_name, gen, timed=False)
            # the layout the paths hand B1, B2 and B3; fp32 at the ragged
            # shapes, and B3's at every store shape too
            every = dtype_name == 'bfloat16' or kernel == 'headmean_probs'
            for shape in (shapes if every else []) + SPLIT_RAGGED[kernel]:
                res = compare(torch, fa, kernel, shape, dtype_name, gen, split=True,
                              timed=shape in shapes)
                if shape in shapes:
                    numbers[kernel, shape, dtype_name] = res
        # B4 on no path: contiguous inputs (the kernels line's), then
        # head-split views
        for shape in SHORT_SHAPES + [SHORT_RAGGED]:
            res = compare(torch, fa, 'short_attention', shape, dtype_name, gen,
                          timed=shape in SHORT_SHAPES)
            if shape in SHORT_SHAPES:
                numbers['short_attention', shape, dtype_name] = res
        for shape in (SHORT_SHAPES if dtype_name == 'bfloat16' else []) + [SHORT_RAGGED]:
            compare(torch, fa, 'short_attention', shape, dtype_name, gen, split=True, timed=False)
    for kernel, shape in FP16_SHAPES:
        compare(torch, fa, kernel, shape, 'float16', gen, split=True, timed=False)
    # Flux hands B1 contiguous q/k/v (joined and rotated): its shapes so,
    # phase 22's head and token shards too
    for shape in FLUX_B1_SHAPES + SP_FLUX_B1_SHAPES + TP_FLUX_B1_SHAPES:
        numbers['flash_attention', shape, 'bfloat16'] = compare(
            torch, fa, 'flash_attention', shape, 'bfloat16', gen)
    # phase 22's head shards (SDXL at tp=2) and PixArt's token shards (sp=2)
    # on the head-split views the paths hand the kernels
    for kernel, mesh_shapes in (('flash_attention', TP_B1_SHAPES + SP_B1_SHAPES),
                                ('flash_attention_with_lse', TP_STORE_SHAPES),
                                ('headmean_probs', TP_STORE_SHAPES)):
        for shape in mesh_shapes:
            numbers[kernel, shape, 'bfloat16'] = compare(torch, fa, kernel, shape, 'bfloat16',
                                                         gen, split=True)
    # the fp32 store kernels at the shape SD-2.1's upcast hands them (phase 11)
    for kernel in ('flash_attention_with_lse', 'headmean_probs'):
        for shape in FP32_STORE_SHAPES:
            numbers[kernel, shape, 'float32'] = compare(torch, fa, kernel, shape, 'float32', gen,
                                                        split=True)
    # W8A16 at every shape of phase 16f's int8 Flux extract (with its bias)
    # and of T5-XXL's encode at INT8_T5_ROWS (none), one shape in fp16 and
    # fp32, and the ragged shape in every type
    for shape, bias in int8_phase2_shapes():
        numbers['int8_linear', shape, 'bfloat16'] = compare_int8(torch, shape, 'bfloat16', gen,
                                                                 bias)
    for dtype_name in ('float16', 'float32'):
        numbers['int8_linear', INT8_ONE_SHAPE, dtype_name] = compare_int8(
            torch, INT8_ONE_SHAPE, dtype_name, gen)
    for dtype_name in ('bfloat16', 'float16', 'float32'):
        compare_int8(torch, INT8_RAGGED, dtype_name, gen)
    torch.cuda.empty_cache()
    print(f'phase 2 done: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB still allocated '
          '(what phases 3 to 7 count in their peak beside their own)', flush=True)
    done('phase 2')

    # 3 and 4: SDXL single-step extraction (the port's first slice) and its
    # timing; 5: path A, SD-1.5 with the attention store; 6: path B, the
    # attention store on SDXL; 9: SDXL multi-step with 'vae-out'; 10:
    # Playground v2; 11: SD-2.1 with the upcast store, then DDIM inversion
    # phase 8 (SDXL from a checkpoint) runs after phase 4; its tree feeds phase 7
    runs, shapes = {}, {}
    tree_dir = tempfile.TemporaryDirectory(prefix='chip_smoke_tree_')
    tree = tree_dir.name
    unet_paths = ((3, 4, 'xl'), (5, 5, 'sd15_store'), (6, 6, 'xl_store'),
                  (9, 9, 'xl_multistep'), (10, 10, 'pgv2'), (11, 11, 'sd21_store'))
    for phase, timing_phase, name in unet_paths:
        path = PATHS[name]
        kwargs = path.get('extract', {})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fe, prompts, images = open_path(torch, name)
        torch.cuda.synchronize()
        build_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        pooled = None if prompts[2] is None else tuple(prompts[2].shape)
        print(f'phase {phase} {name} build + encode_prompt: {time.perf_counter() - t0:.1f} s, '
              f'peak {build_gib:.3f} GiB; prompt_embeds {tuple(prompts[0].shape)}, '
              f'pooled {pooled}', flush=True)
        feats, runs[name], shapes[name] = drive_path(
            torch, fa, attn_ops, fe, prompts, images,
            {**dict(zip(WRAPPERS, path['launches'])), 'short_attention': 0}, f'phase {phase}',
            **kwargs)
        check_feats(torch, feats, path['feats'], f'phase {phase}')
        if 'attention' in path['args']:
            gib = sum(s[0] * s[2] * s[3] * 2 for n, s, _ in shapes[name]
                      if n == 'headmean_probs') / 2 ** 30
            print(f'  phase {phase} head-mean maps from B3 kept by the store: {gib:.3f} GiB (bf16)')
        check_twin_step(torch, fe, attn_ops, fa, prompts, images, path['feats'], f'phase {phase}',
                        tol=MULTISTEP_REL_TOL if kwargs else TAP_REL_TOL, **kwargs)
        size = path['args']['img_size']
        time_extract(torch, fe, prompts, images,
                     f'phase {timing_phase} {name} extract {size}^2 batch 2'
                     f'{"".join(f", {k}={v}" for k, v in kwargs.items())}', card,
                     path.get('calls', TIMED_CALLS), **kwargs)
        if name == TREE_PATH:
            shapes['checkpoint'], shapes['bundle'] = [], []
            runs['checkpoint'], runs['bundle'] = check_checkpoint(
                torch, fa, attn_ops, fe, prompts, images, feats, build_gib, tree, card,
                shapes['checkpoint'], shapes['bundle'])
        if name == EXTERNAL_PATH:
            assert_equal_feats(torch, {k: v.cpu() for k, v in feats.items()}, external_feats,
                               f'phase 18 first extract vs phase {phase}\'s fresh {name} '
                               'extractor\'s')
        if name == INVERSION_PATH:
            label = f'phase {phase} use_ddim_inversion'
            inv, runs['sd21_inversion'], shapes['sd21_inversion'] = drive_path(
                torch, fa, attn_ops, fe, prompts, images,
                {**dict(zip(WRAPPERS, INVERSION_LAUNCHES)), 'short_attention': 0}, label,
                use_ddim_inversion=True)
            check_feats(torch, inv, path['feats'], label)
        if name == EXTERNAL_SOURCE:
            external_feats = check_external(torch, fa, attn_ops, card, fe, prompts, images,
                                            shapes, runs)
        del fe, feats
        torch.cuda.empty_cache()

    done('phases 3 to 6 and 8 to 11, 18')

    # 7. the CLI, on phase 8's tree
    try:
        shapes['cli'] = []
        runs['cli'] = check_cli(torch, fa, attn_ops, card, shapes['cli'], tree)
    finally:
        tree_dir.cleanup()

    # 12. generation; 13. ControlNet and depth, from the generation CLI's
    # SD-1.5 weights
    fe15 = check_generation(torch, fa, attn_ops, card, shapes, runs)
    check_control(torch, fa, attn_ops, card, fe15, shapes, runs)
    del fe15
    torch.cuda.empty_cache()
    done('phases 7, 12 and 13')

    # 14. PixArt; 15. HunyuanDiT; 16. Flux (and phase 22's Flux part while
    # its tree exists); 17. DeepFloyd IF
    check_pixart(torch, fa, attn_ops, card, shapes, runs)
    done('phase 14')
    check_hunyuan(torch, fa, attn_ops, card, shapes, runs)
    done('phase 15')
    check_flux(torch, fa, attn_ops, card, shapes, runs)
    done('phase 16 (22c, 22d on Flux)')
    check_if(torch, fa, attn_ops, card, shapes, runs)
    done('phase 17')

    # 19. training: the backward kernel, the segmentation trainer on
    # ade_sdxl and ade_vpd (prompt tuning), train_unet
    check_training(torch, fa, attn_ops, card, shapes, runs, numbers, gen)
    done('phase 19')

    # 20. correspondence on config_sdxl and config_xl_t; 21. label-scarce
    check_correspondence(torch, fa, attn_ops, card, shapes, runs)
    check_scarce(torch, fa, attn_ops, card, shapes, runs)
    done('phases 20 and 21')

    # 22. the mesh: two ranks on the card over gloo, then NCCL alone
    check_mesh(torch, fa, attn_ops, card, shapes, runs)
    done('phase 22')

    # the kernels line: per kernel, the launches of every path and the sum
    # over those launches of each (shape, dtype)'s numbers from phase 2 (one
    # phase 2 did not hold, such as the CLI's trailing batch of 1, is
    # compared and timed here); B4, which no path launches, sums one call
    # at each of its phase-2 shapes
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
                 'launches': sum(r.get(name, 0) for r in runs.values()),
                 'launches_by_path': {p: r.get(name, 0) for p, r in runs.items()},
                 'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                 'library_ms': 0.0, 'call_loop_ms': 0.0, 'shapes': {}}
        calls = [(s, dt) for path in shapes.values() for n, s, dt in path if n == name]
        if len(calls) != entry['launches']:
            raise RuntimeError(f'{name}: {len(calls)} recorded calls, {entry["launches"]} launches')
        if name == 'short_attention':
            calls = [(s, 'bfloat16') for s in SHORT_SHAPES]
            entry['timed_over'] = 'one bf16 call at each phase-2 shape; no path launches B4'
            entry['b1_ms'] = entry['explicit_ms'] = 0.0
        if name == 'int8_linear':
            entry['matmul_ms'] = entry['dequant_matmul_ms'] = 0.0
        for shape, dt in sorted(set(calls)):
            if (name, shape, dt) not in numbers:
                numbers[name, shape, dt] = (
                    compare_bwd(torch, fa, shape, dt, gen) if name == 'flash_attention_bwd'
                    else compare_int8(torch, shape, dt, gen) if name == 'int8_linear'
                    else compare(torch, fa, name, shape, dt, gen, split=True))
            res = numbers[name, shape, dt]
            count = calls.count((shape, dt))
            label = str(shape) if dt == 'bfloat16' else f'{shape} {dt}'
            entry['shapes'][label] = {'calls': count, 'dtype': dt, **res}
            entry['max_abs_err'] = max(entry['max_abs_err'], res['max_abs_err'])
            for key in ('ms', 'plain_ms', 'bound_ms', 'b1_ms', 'explicit_ms', 'call_loop_ms',
                        'matmul_ms', 'dequant_matmul_ms'):
                if key in entry:
                    entry[key] += count * res[key]
            entry['library_ms'] = (None if entry['library_ms'] is None or res['library_ms'] is None
                                   else entry['library_ms'] + count * res['library_ms'])
        # what bounds the calls that take most of the bound
        entry['bound_by'] = max(entry['shapes'].values(),
                                key=lambda v: v['calls'] * v['bound_ms'],
                                default={'bound_by': None})['bound_by']
        if name in ('headmean_probs', 'short_attention'):
            # the fp32 kernels at every phase-2 shape: B3 on head-split views
            # at the store's shapes, B4 on contiguous inputs
            entry['float32_shapes'] = {
                str(s): numbers[name, s, 'float32']
                for s in (STORE_SHAPES + FP32_STORE_SHAPES if name == 'headmean_probs'
                          else SHORT_SHAPES)}
        if name == 'int8_linear':
            # phase 2's fp16 and fp32 shape, which no path launches
            entry['other_dtype_shapes'] = {
                f'{INT8_ONE_SHAPE} {dt}': numbers[name, INT8_ONE_SHAPE, dt]
                for dt in ('float16', 'float32')}
        if name in ('flash_attention_with_lse', 'headmean_probs'):
            # built for HunyuanDiT's heads, which no path hands them (its store
            # is explicit, as in JAX): phase 2's bf16 numbers on head-split views
            entry['no_caller_shapes'] = {str(s): numbers[name, s, 'bfloat16']
                                         for s in D88_STORE_SHAPES
                                         if (name, s, 'bfloat16') in numbers}
        kernels.append(entry)
        print(f'{name}: {entry["launches"]} launches {entry["launches_by_path"]}, '
              f'kernel {entry["ms"]:.3f} ms, twin {entry["plain_ms"]:.3f} ms, '
              f'library {entry["library_ms"]}, bound {entry["bound_ms"]:.3f} ms over those calls')

    done('the kernels line')
    print(f'card: {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
