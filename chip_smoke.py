#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its numbers on lines of its own):
  1. the card's name and power limit, then the kernels' build (one nvcc per
     source, started together), and the count of HGMMA (wgmma) and UTMALDG
     (TMA load) instructions in the SASS of every bf16/fp16 library (B1/B2,
     B3, B4, the backward), and of FFMA and SHFL in every fp32 library's;
  2. every kernel against its plain twin at every shape the paths launch
     it at (batch 2), plus a ragged shape, in bf16 and fp32 (each kernel
     also in fp16 at one shape): errors against the stated tolerances, and
     for each shape the kernel's, the twin's and the one PyTorch library
     call's times beside the least time the card needs.  B1, B2 and B3 are
     also checked on the head-split views the paths hand them (the
     (B, H, S, D) view of a (B, S, H*D) projection, read in place) at every
     path shape and at ragged d=64, d=40 (and, for B1, d=512) shapes; those
     bf16 numbers are the kernels line's.  Kernels and library calls are timed as CUDA graphs
     of 20 calls (graph_ms: device time, the host's launch cost out of the
     way) and also in a loop of calls (call_loop_ms); the twins in a loop;
  3. SDXL at full width (random weights from a seed), 1024^2, batch 2:
     FeatureExtractor('xl-practical') -> encode_prompt -> extract(t=50);
     tap shapes, dtype and finiteness, exactly 71 B1 launches, and the taps
     against the same step with every kernel call on its plain twin;
  4. that extract timed call by call with CUDA events after warm-up:
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
     relative L2, its timing over 5 calls and its peak memory;
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
     MULTISTEP_REL_TOL.  Counts from dit_launches.
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
Phase 2 also holds B2 and B3 in fp32 at phase 11's store shape (the fp32
kernels, timed against the fp32 non-tensor peak), and B4 (short
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
the layout the concatenation and RoPE hand it.
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
# stride; depth 96, P V at N=88) and at d=512 (B1 only: one score pass over
# two consumer warpgroups)
SPLIT_RAGGED = {'flash_attention': [RAGGED, (1, 2, 1000, 333, 40), (1, 16, 1000, 333, 72),
                                    (1, 16, 1000, 333, 88), (1, 1, 1000, 777, 512)],
                'flash_attention_with_lse': [RAGGED, (1, 2, 1000, 333, 40),
                                             (1, 16, 1000, 333, 72), (1, 16, 1000, 333, 88)],
                'headmean_probs': [RAGGED, (1, 2, 1000, 333, 40), (1, 16, 1000, 333, 72),
                                   (1, 16, 1000, 333, 88)]}
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
                     'feats': {**XL_PRACTICAL, 'vae-out': (2, 3, 1024, 1024)}, 'calls': 5},
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
TIMED_CALLS = 7
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


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, min_total_ms=200.0, runs=1) -> float:
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


def compare(torch, fa, kernel, shape, dtype_name, gen, split=False):
    """One kernel against its twin on one shape; returns its numbers.  With
    ``split`` q, k and v are the head-split (B, H, S, D) views of
    (B, S, H*D) projections, as the paths hand B1, B2 and B3 their inputs."""
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
    ok = finite and ratio <= 1.0
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


# the wrappers the attention ops call (B4 is called by none of them)
WRAPPERS = ('flash_attention', 'flash_attention_with_lse', 'headmean_probs')


@contextlib.contextmanager
def patched_wrappers(attn_ops, make):
    """Replace each kernel wrapper the attention ops call by
    ``make(name, wrapper)`` for the duration of the block."""
    real = {n: getattr(attn_ops, n) for n in WRAPPERS}
    for n in WRAPPERS:
        setattr(attn_ops, n, make(n, real[n]))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(attn_ops, n, f)


def recording(log):
    """Record (kernel, (b, h, sq, sk, d), dtype name) of every call, then
    call through to the wrapper unchanged."""
    def make(name, wrapper):
        def call(q, k, *args, **kwargs):
            log.append((name, (*q.shape[:3], k.shape[2], q.shape[3]),
                        str(q.dtype).replace('torch.', '')))
            return wrapper(q, k, *args, **kwargs)
        return call
    return make


def twin_of(fa):
    """Route every kernel call to its plain twin."""
    twins = {'flash_attention': fa.flash_attention_reference,
             'flash_attention_with_lse': fa.flash_attention_with_lse_reference,
             'headmean_probs': fa.headmean_probs_reference}
    return lambda name, _: lambda *args, scale: twins[name](*args, scale)


def reset_counts(fa):
    fa.launches = fa.lse_launches = fa.headmean_launches = fa.short_launches = 0
    fa.bwd_launches = 0


def read_counts(fa):
    return {'flash_attention': fa.launches, 'flash_attention_with_lse': fa.lse_launches,
            'headmean_probs': fa.headmean_launches, 'short_attention': fa.short_launches}


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
    """``calls`` extracts after three untimed ones; per call the host time
    to enqueue it and the time between CUDA events around it, in ms, each
    list sorted."""
    for _ in range(3):
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


def time_extract(torch, fe, prompts, images, label, card, calls=TIMED_CALLS, **kwargs):
    """Median ms, img/s and peak memory over ``calls`` calls."""
    torch.cuda.reset_peak_memory_stats()
    host, times = extract_times(torch, fe, prompts, images, calls, **kwargs)
    ms = times[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{label} over {len(times)} calls: median {ms:.2f} ms (min {times[0]:.2f}, '
          f'max {times[-1]:.2f}), {1000.0 * images.shape[0] / ms:.3f} img/s, '
          f'host enqueue median {host[len(host) // 2]:.2f} ms, '
          f'peak memory {peak:.2f} GiB ({card})', flush=True)


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
                     card, shapes):
    """Phase 8: write ``fe`` (the TREE_PATH path's random-init extractor)
    as a diffusers tree under ``tree``, load it back and hold it to the
    source, then merge a LoRA; returns the launch counts of the loaded
    extractor's first public extract."""
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
    del loaded, feats, ours
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
    args = PATHS[name]['args']
    tag, cli_tag = (f'{phase}d', f'{phase}{"e" if phase == 14 else "d"}')
    free = isinstance(fe, list)
    if free:
        fe = fe.pop()
    t0 = time.perf_counter()
    source_prints = fingerprints(torch, fe)
    print(f'phase {tag} fingerprints of {len(source_prints)} source parameters: '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    written = fe.save_weights(tree, unet_shards=unet_shards, text_shards=text_shards)
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
    loaded = FeatureExtractor(**args, dtype='bfloat16', device='cuda', seed=0, weights=tree)
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
        rate = [line for line in lines if line.endswith('img/s)')]
        print(f'phase {cli_tag} cli {args["version"]} {size}^2 on the tree: {seconds:.1f} s for '
              f'main() (model build included), {rate[0]}; kernel launches '
              f'{runs[f"{name}_cli"]} (expected {want}) ({card})', flush=True)
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
    the tree loaded and the CLI on it (d), with the store (b), at 512^2 (c),
    the generation CLI and a kernel-vs-twin sample at 512^2 (e).  Each
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
    del first
    torch.cuda.empty_cache()
    for name, label in (('flux_store', 'phase 16b'), ('flux_512', 'phase 16c')):
        fe, *_ = check_dit_path(torch, fa, attn_ops, card, name, shapes, runs, label)
        del fe, _
        torch.cuda.empty_cache()
    check_dit_generation(torch, fa, attn_ops, card, shapes, runs, FLUX_GEN_ARGS, 'flux_gen',
                         '16e')


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

    # 1. build
    info = fa.build()
    print(f'phase 1 build: {info["seconds"]:.1f} s -> {", ".join(info["paths"])}', flush=True)
    for line in ptxas_summary(info['log']):
        print(f'  ptxas: {line}')
    for path in info['paths']:
        if '_bf16_' in path or '_fp16_' in path:
            ops = ('HGMMA', 'UTMALDG')
            counts = sass_counts(path, ops)
            print(f'phase 1 SASS of {os.path.basename(path)}: {counts}', flush=True)
            if not all(counts.values()):
                raise RuntimeError(f'{path}: no {" or ".join(ops)} in the SASS: {counts}')
        else:
            # fp32: FMA products; flash and flash_bwd keep their shuffles to the
            # softmax's row reductions and the delta pre-pass (simt_f32.cuh)
            print(f'phase 1 SASS of {os.path.basename(path)}: '
                  f'{sass_counts(path, ("FFMA", "SHFL"))}', flush=True)
    from diffusion_feature_tpu_torch.native import load_library
    writer_lib = load_library('dumpio')
    if writer_lib is None:
        raise RuntimeError('the native dump writer (native/dumpio.cpp) did not build with g++')
    print(f'phase 1 native dump writer: {writer_lib._name}', flush=True)

    # 2. every kernel against its twin, with times, at every path shape
    gen = torch.Generator(device='cuda').manual_seed(0)
    numbers = {}   # (kernel, shape, dtype name) -> numbers
    for dtype_name in ('bfloat16', 'float32'):
        for kernel, shapes in (('flash_attention', B1_SHAPES),
                               ('flash_attention_with_lse', STORE_SHAPES),
                               ('headmean_probs', STORE_SHAPES)):
            for shape in shapes + [RAGGED]:
                compare(torch, fa, kernel, shape, dtype_name, gen)
            # the layout the paths hand B1, B2 and B3; fp32 at the ragged shapes
            for shape in (shapes if dtype_name == 'bfloat16' else []) + SPLIT_RAGGED[kernel]:
                res = compare(torch, fa, kernel, shape, dtype_name, gen, split=True)
                if dtype_name == 'bfloat16':
                    numbers[kernel, shape, dtype_name] = res
        # B4 on no path: contiguous inputs (the kernels line's), then
        # head-split views
        for shape in SHORT_SHAPES + [SHORT_RAGGED]:
            res = compare(torch, fa, 'short_attention', shape, dtype_name, gen)
            if dtype_name == 'bfloat16' and shape in SHORT_SHAPES:
                numbers['short_attention', shape, dtype_name] = res
        for shape in (SHORT_SHAPES if dtype_name == 'bfloat16' else []) + [SHORT_RAGGED]:
            compare(torch, fa, 'short_attention', shape, dtype_name, gen, split=True)
    for kernel, shape in FP16_SHAPES:
        compare(torch, fa, kernel, shape, 'float16', gen, split=True)
    # Flux hands B1 contiguous q/k/v (joined and rotated): its shapes so
    for shape in FLUX_B1_SHAPES:
        numbers['flash_attention', shape, 'bfloat16'] = compare(
            torch, fa, 'flash_attention', shape, 'bfloat16', gen)
    # the fp32 store kernels at the shape SD-2.1's upcast hands them (phase 11)
    for kernel in ('flash_attention_with_lse', 'headmean_probs'):
        for shape in FP32_STORE_SHAPES:
            numbers[kernel, shape, 'float32'] = compare(torch, fa, kernel, shape, 'float32', gen,
                                                        split=True)
    torch.cuda.empty_cache()
    print(f'phase 2 done: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB still allocated '
          '(what phases 3 to 7 count in their peak beside their own)', flush=True)

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
            shapes['checkpoint'] = []
            runs['checkpoint'] = check_checkpoint(torch, fa, attn_ops, fe, prompts, images,
                                                  feats, build_gib, tree, card,
                                                  shapes['checkpoint'])
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

    # 14. PixArt; 15. HunyuanDiT; 16. Flux; 17. DeepFloyd IF
    check_pixart(torch, fa, attn_ops, card, shapes, runs)
    check_hunyuan(torch, fa, attn_ops, card, shapes, runs)
    check_flux(torch, fa, attn_ops, card, shapes, runs)
    check_if(torch, fa, attn_ops, card, shapes, runs)

    # 19. training: the backward kernel, the segmentation trainer on
    # ade_sdxl and ade_vpd (prompt tuning), train_unet
    check_training(torch, fa, attn_ops, card, shapes, runs, numbers, gen)

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
        for shape, dt in sorted(set(calls)):
            if (name, shape, dt) not in numbers:
                numbers[name, shape, dt] = (
                    compare_bwd(torch, fa, shape, dt, gen) if name == 'flash_attention_bwd'
                    else compare(torch, fa, name, shape, dt, gen, split=True))
            res = numbers[name, shape, dt]
            count = calls.count((shape, dt))
            label = str(shape) if dt == 'bfloat16' else f'{shape} {dt}'
            entry['shapes'][label] = {'calls': count, 'dtype': dt, **res}
            entry['max_abs_err'] = max(entry['max_abs_err'], res['max_abs_err'])
            for key in ('ms', 'plain_ms', 'bound_ms', 'b1_ms', 'explicit_ms', 'call_loop_ms'):
                if key in entry:
                    entry[key] += count * res[key]
            entry['library_ms'] = (None if entry['library_ms'] is None or res['library_ms'] is None
                                   else entry['library_ms'] + count * res['library_ms'])
        # what bounds the calls that take most of the bound
        entry['bound_by'] = max(entry['shapes'].values(),
                                key=lambda v: v['calls'] * v['bound_ms'],
                                default={'bound_by': None})['bound_by']
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

    print(f'card: {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
