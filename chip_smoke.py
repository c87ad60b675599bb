#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its numbers on lines of its own):
  1. the card's name and power limit, then the kernels' build (one nvcc per
     source, started together), and the count of HGMMA (wgmma) and UTMALDG
     (TMA load) instructions in the SASS of every bf16/fp16 library (B1/B2,
     B3, B4);
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
'no_caller_shapes'), each in bf16, fp32 and fp16.
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


def sass_counts(path) -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in a library's
    SASS, by cuobjdump from the CUDA toolkit or Triton's bundled copy."""
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
    return {op: sass.count(op) for op in ('HGMMA', 'UTMALDG')}


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
    lat = fe.img_size // fe.vae_scale
    gen = torch.Generator(device='cuda').manual_seed(2)
    pe, pooled, mask = fe._step_conditioning(prompts, bsz)
    posterior, noise = (torch.randn((bsz, 4, lat, lat), generator=gen, device='cuda')
                        for _ in range(2))
    if denoising_from is None and not use_ddim_inversion:
        return fe._step(images.to(fe.dtype), pe, pooled, fe._step_kit(50), posterior, noise,
                        torch.bfloat16, mask=mask)
    return fe._multistep(images.to(fe.dtype), pe, pooled, 50, denoising_from,
                         use_ddim_inversion, posterior, noise, torch.bfloat16, mask=mask)


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
    if counts != expected_counts:
        raise RuntimeError(f'{label}: launches {counts} != {expected_counts}')
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
    """(name, module of a, module of b) over two extractors' models."""
    return [('unet', a.unet, b.unet), ('vae', a.vae, b.vae),
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
    levels = len(cfg.block_out_channels)

    def passes(level):
        tokens = (latent >> level) ** 2
        d = cfg.block_out_channels[level] // cfg.num_attention_heads[level]
        return fa.is_flash_compatible((1, 1, tokens, d), (1, 1, tokens, d))

    depth = cfg.transformer_layers_per_block
    n = sum(cfg.layers_per_block * depth[lv] for lv, kind in enumerate(cfg.down_block_types)
            if kind == 'CrossAttnDownBlock2D' and passes(lv))
    n += depth[-1] if passes(levels - 1) else 0
    if not encoder_only:
        n += sum((cfg.layers_per_block + 1) * depth[levels - 1 - u]
                 for u, kind in enumerate(cfg.up_block_types)
                 if kind == 'CrossAttnUpBlock2D' and passes(levels - 1 - u))
    return n


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
    cross-attention (333 keys) and the T5 pool are explicit."""
    cfg = fe.spec.dit
    latent = fe.img_size // fe.vae_scale
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


def timed_sample(torch, fe, prompts, noise, steps, guidance, mask=None, step_noise=None):
    """``fe._sample`` on ``noise`` (a DiT's with the CFG ``mask``, DDPM's
    with ``step_noise``) with CUDA events around it; returns (images,
    features, latents, ms, the call's peak memory in GiB above what was
    allocated before it, GiB allocated before it)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        out = fe._sample(*prompts, noise, steps, guidance, mask, step_noise)
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
    with_kernel = fe._sample(*prompts, noise, TWIN_SAMPLE_STEPS, args.guidance_scale)
    with patched_wrappers(attn_ops, twin_of(fa)):
        with_twin = fe._sample(*prompts, noise, TWIN_SAMPLE_STEPS, args.guidance_scale)
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
        pe = prompts[0].expand(2, -1, -1)
        gen = torch.Generator(device='cuda').manual_seed(2)
        posterior, noise = (torch.randn((2, 4, latent, latent), generator=gen, device='cuda')
                            for _ in range(2))

        def step(ctrl):
            return fe._step(images.to(fe.dtype), pe, None, fe._img2img_kit(50), posterior,
                            noise, torch.bfloat16, ctrl)
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
    mask, or HunyuanDiT's BERT and T5 pairs."""
    if isinstance(prompts[0], tuple):
        return '; '.join(f'{name} embeds {tuple(e.shape)}, mask with {int(m.sum())} tokens'
                         for name, (e, m) in zip(('BERT', 'T5'), prompts))
    return (f'prompt_embeds {tuple(prompts[0].shape)}, mask {tuple(prompts[1].shape)} '
            f'{prompts[1].dtype} with {int(prompts[1].sum())} tokens')


def flat_prompts(prompts):
    """The tensors of an encode_prompt result, nested pairs flattened."""
    out = []
    for x in prompts:
        out.extend(flat_prompts(x) if isinstance(x, tuple) else [x])
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
    time_extract(torch, fe, prompts, images, f'{label} {name} extract {size}^2 batch 2', card)
    return fe, prompts, images, feats, gib


def check_dit_tree(torch, fa, attn_ops, card, fe, prompts, images, first_feats, build_gib,
                   tree, shapes, runs, name, text_shards, phase):
    """Phase 14 (d) and (e), 15 (d): ``fe`` (path ``name`` at random) written
    by ``save_weights`` (the text encoders in ``text_shards`` files) and
    loaded back, parameters, prompts and the first extract ``torch.equal``,
    then the CLI over three images on the tree."""
    import numpy as np
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
    args = PATHS[name]['args']
    tag, cli_tag = (f'{phase}d', f'{phase}{"e" if phase == 14 else "d"}')
    written = fe.save_weights(tree, text_shards=text_shards)
    files = sorted(os.path.relpath(os.path.join(d, f), tree)
                   for d, _, names in os.walk(tree) for f in names)
    print(f'phase {tag} tree of {sum(n for n, _ in written.values())} bytes: {files}')
    rates(written, 'write', card, tag)
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
    for mod, a, b in module_pairs(fe, loaded):
        sa, sb = a.state_dict(), b.state_dict()
        bad = [k for k in sa if k not in sb or not torch.equal(sa[k], sb[k])]
        if bad or sa.keys() != sb.keys():
            raise RuntimeError(f'phase {tag} {mod}: parameters differ from the source: {bad[:5]}')
        print(f'  {mod}: {len(sa)} parameters torch.equal to the source')
    if not all(torch.equal(a, b)
               for a, b in zip(flat_prompts(prompts), flat_prompts(loaded_prompts))):
        raise RuntimeError(f'phase {tag}: encode_prompt differs from the source')
    print(f'  encode_prompt: {len(flat_prompts(prompts))} tensors torch.equal to the source')
    want = dit_launches(fa, loaded)
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
    """``fe._sample``'s prompts, CFG mask and DDPM step noise for
    ``prompt`` with the empty negative: PixArt's T5 embeddings and mask,
    or HunyuanDiT's BERT embeddings (the T5 ones in the pooled slot), the
    pair of masks and ``steps`` standard-normal draws from seed 8."""
    if fe.spec.family == 'hunyuan':
        (pe, bmask), (t5, tmask) = fe.encode_prompt(prompt)
        (ne, nbmask), (nt5, ntmask) = fe._encode_hunyuan('')
        latent = fe.img_size // fe.vae_scale
        gen = torch.Generator(device='cuda').manual_seed(8)
        step_noise = [torch.randn((1, 4, latent, latent), generator=gen, device='cuda')
                      for _ in range(steps)]
        return ((pe, ne, t5, nt5), (torch.cat([nbmask, bmask]), torch.cat([ntmask, tmask])),
                step_noise)
    pe, mask, ne, nmask = fe.encode_prompt(prompt)
    return (pe, ne, None, None), torch.cat([nmask, mask]), None


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
               if v.shape[0] != 2 or not bool(torch.isfinite(v.float()).all())]
        print(f'  {layer}: kept {sorted(by_step)} of {fe._background_feats[layer]["count"]}, '
              f'{tuple(by_step[1].shape)} {by_step[1].dtype}')
        if sorted(by_step) != sorted(args.store_steps) or bad:
            raise RuntimeError(f'phase {phase} {layer}: kept {sorted(by_step)}, bad {bad}')
    if set(kept) != set(taps):
        raise RuntimeError(f'phase {phase}: kept layers {sorted(kept)}')
    prompts, cfg_mask, step_noise = sample_inputs(torch, fe, args.prompt, args.steps)
    noise = torch.randn((1, 4, latent, latent),
                        generator=torch.Generator(device='cuda').manual_seed(7), device='cuda')
    *_, ms, gib, base = timed_sample(torch, fe, prompts, noise, args.steps, args.guidance_scale,
                                     cfg_mask, step_noise)
    print(f'phase {phase} {args.version} sample timed: {ms:.2f} ms per sample, {ms / calls:.2f} '
          f'ms per step ({calls} DiT calls at CFG batch 2 and the decode); peak memory '
          f'{gib:.2f} GiB above the {base:.2f} GiB held before it ({card})', flush=True)
    run = (*prompts, noise, TWIN_SAMPLE_STEPS, args.guidance_scale, cfg_mask,
           None if step_noise is None else step_noise[:TWIN_SAMPLE_STEPS])
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
            counts = sass_counts(path)
            print(f'phase 1 SASS of {os.path.basename(path)}: {counts}', flush=True)
            if not all(counts.values()):
                raise RuntimeError(f'{path}: no wgmma or TMA load in the SASS: {counts}')
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
        if name == INVERSION_PATH:
            label = f'phase {phase} use_ddim_inversion'
            inv, runs['sd21_inversion'], shapes['sd21_inversion'] = drive_path(
                torch, fa, attn_ops, fe, prompts, images,
                {**dict(zip(WRAPPERS, INVERSION_LAUNCHES)), 'short_attention': 0}, label,
                use_ddim_inversion=True)
            check_feats(torch, inv, path['feats'], label)
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

    # 14. PixArt; 15. HunyuanDiT
    check_pixart(torch, fa, attn_ops, card, shapes, runs)
    check_hunyuan(torch, fa, attn_ops, card, shapes, runs)

    # the kernels line: per kernel, the launches of every path and the sum
    # over those launches of each (shape, dtype)'s numbers from phase 2 (one
    # phase 2 did not hold, such as the CLI's trailing batch of 1, is
    # compared and timed here); B4, which no path launches, sums one call
    # at each of its phase-2 shapes
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
                 'launches': sum(r[name] for r in runs.values()),
                 'launches_by_path': {p: r[name] for p, r in runs.items()},
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
                numbers[name, shape, dt] = compare(torch, fa, name, shape, dt, gen, split=True)
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
