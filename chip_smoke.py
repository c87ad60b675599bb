#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its numbers on lines of its own):
  1. the card's name and power limit, then the flash-attention kernel build;
  2. the kernel against its plain twin at the main path's shapes (batch 2)
     in bf16 and fp32, a ragged shape, and fp16 once: errors against the
     stated tolerances, and both times (CUDA events after warm-up);
  3. SDXL at full width (random weights from a seed), 1024^2, batch 2:
     FeatureExtractor('xl-practical') -> encode_prompt -> extract(t=50);
     tap shapes, dtype and finiteness, exactly 71 kernel launches, and the
     taps against the same step with every flash call on the plain twin;
  4. extract timed call by call with CUDA events after warm-up: median
     ms and img/s, and peak memory.
The last line is {"ok": true, "device": {...}}; before it come the card line
and a {"kernels": [...]} line.  Exits non-zero, without the last line,
when there is no CUDA device or any phase fails.
"""

import json
import subprocess
import sys
import time

MAIN_SHAPES = [  # (b, h, sq, sk, d, calls per extract at 1024^2)
    (2, 10, 4096, 4096, 64, 10),    # U-Net level-1 self-attention
    (2, 20, 1024, 1024, 64, 60),    # U-Net level-2 and mid self-attention
    (2, 1, 16384, 16384, 512, 1),   # VAE mid-block single head
]
RAGGED = (1, 2, 1000, 333, 64)
# bf16: the output is rounded to bf16 and fp32 sums run in another order;
# fp32: summation order alone; fp16: 3 more mantissa bits than bf16
TOL = {'bfloat16': 2e-2, 'float32': 1e-4, 'float16': 5e-3}
XL_PRACTICAL = {  # tap id -> shape at 1024^2, batch 2
    'up-level0-repeat0-vit-block7-out': (2, 1280, 32, 32),
    'up-level0-repeat0-vit-block5-out': (2, 1280, 32, 32),
    'up-level1-repeat0-vit-block0-cross-q': (2, 640, 64, 64),
    'up-level1-repeat0-vit-block0-out': (2, 640, 64, 64),
}
# kernel vs twin through ~70 bf16 attention calls and 50+ blocks: relative
# L2 difference per tap
TAP_REL_TOL = 2e-2


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, min_total_ms=200.0) -> float:
    """Mean device time of ``fn`` over a run of launches, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(min_total_ms / max(start.elapsed_time(stop), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_kernel(torch, fa, shape, dtype_name, gen):
    """Kernel vs twin on one shape; returns (max_abs_err, kernel_ms, plain_ms)."""
    b, h, sq, sk, d = shape[:5]
    dtype = getattr(torch, dtype_name)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device='cuda').to(dtype)
               for s in (sq, sk, sk))
    scale = d ** -0.5
    out = fa.flash_attention(q, k, v, scale=scale)
    ref = fa.flash_attention_reference(q, k, v, scale)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    tol = TOL[dtype_name]
    # worst element against atol + rtol*|ref| (torch.testing.assert_close's rule)
    ratio = (diff / (tol + tol * ref.float().abs())).max().item()
    err = diff.max().item()
    rel = err / ref.float().abs().max().item()
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, scale=scale))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, scale))
    ok = bool(torch.isfinite(out.float()).all()) and ratio <= 1.0
    print(f'compare {dtype_name} q{(b, h, sq, d)} k{(b, h, sk, d)}: max_abs_err={err:.3e} '
          f'max_abs_err/max|ref|={rel:.3e} atol=rtol={tol:g} worst/allowed={ratio:.3f} '
          f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise RuntimeError(f'kernel disagrees with its twin at {shape} {dtype_name}')
    return err, ms, plain_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU',
              file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch import FeatureExtractor
    from diffusion_feature_tpu_torch.ops import attention as attn_ops
    from diffusion_feature_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f'card: {card}', flush=True)

    # 1. build
    info = fa.build()
    print(f'phase 1 build: {info["seconds"]:.1f} s -> {info["path"]}', flush=True)
    for line in info['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}')

    # 2. kernel vs twin
    gen = torch.Generator(device='cuda').manual_seed(0)
    main_err, main_ms, main_plain_ms = 0.0, 0.0, 0.0
    for dtype_name in ('bfloat16', 'float32'):
        for shape in MAIN_SHAPES + [RAGGED]:
            err, ms, plain_ms = compare_kernel(torch, fa, shape, dtype_name, gen)
            if dtype_name == 'bfloat16' and shape is not RAGGED:
                calls = shape[5]
                main_err = max(main_err, err)
                main_ms += calls * ms
                main_plain_ms += calls * plain_ms
    compare_kernel(torch, fa, MAIN_SHAPES[0], 'float16', gen)
    print(f'phase 2: flash attention per 1024^2 batch-2 extract (71 calls, bf16): '
          f'kernel {main_ms:.3f} ms, plain twin {main_plain_ms:.3f} ms', flush=True)

    # 3. the main path
    t0 = time.perf_counter()
    fe = FeatureExtractor(layer='xl-practical', version='xl', img_size=1024,
                          dtype='bfloat16', device='cuda', seed=0)
    prompts = fe.encode_prompt('a photo of a cat')
    torch.cuda.synchronize()
    print(f'phase 3 build + encode_prompt: {time.perf_counter() - t0:.1f} s; '
          f'prompt_embeds {tuple(prompts[0].shape)}, pooled {tuple(prompts[2].shape)}',
          flush=True)
    img_gen = torch.Generator(device='cuda').manual_seed(1)
    images = torch.rand(2, 3, 1024, 1024, generator=img_gen, device='cuda') * 2 - 1

    fa.launches = 0
    feats = fe.extract(prompts, 2, images, image_type='tensor', t=50)
    torch.cuda.synchronize()
    launches = fa.launches
    print(f'phase 3 extract: kernel launches {launches} (expected 71)', flush=True)
    if launches != 71:
        raise RuntimeError(f'flash kernel launched {launches} times, expected 71')
    if set(feats) != set(XL_PRACTICAL):
        raise RuntimeError(f'taps {sorted(feats)} != {sorted(XL_PRACTICAL)}')
    for key, shape in XL_PRACTICAL.items():
        val = feats[key]
        finite = bool(torch.isfinite(val.float()).all())
        print(f'  {key}: {tuple(val.shape)} {val.dtype} finite={finite} '
              f'mean_abs={val.float().abs().mean().item():.4f}')
        if tuple(val.shape) != shape or val.dtype != torch.bfloat16 or not finite:
            raise RuntimeError(f'tap {key}: {tuple(val.shape)} {val.dtype} finite={finite}')

    # the same step with every flash call routed to the plain twin
    pe = prompts[0].expand(2, -1, -1)
    pooled = prompts[2].expand(2, -1)
    img = images.to(torch.bfloat16)
    noise_gen = torch.Generator(device='cuda').manual_seed(2)
    lat = (2, 4, 128, 128)
    posterior = torch.randn(lat, generator=noise_gen, device='cuda')
    noise = torch.randn(lat, generator=noise_gen, device='cuda')
    kit = fe._img2img_kit(50)
    with_kernel = fe._step(img, pe, pooled, kit, posterior, noise, torch.bfloat16)
    attn_ops.flash_attention = (
        lambda q, k, v, *, scale: fa.flash_attention_reference(q, k, v, scale))
    try:
        with_twin = fe._step(img, pe, pooled, kit, posterior, noise, torch.bfloat16)
    finally:
        attn_ops.flash_attention = fa.flash_attention
    for key in XL_PRACTICAL:
        a, b = with_kernel[key].float(), with_twin[key].float()
        rel = ((a - b).norm() / b.norm()).item()
        print(f'  kernel vs twin step, {key}: rel_l2={rel:.3e} (allowed {TAP_REL_TOL:g})')
        if not rel <= TAP_REL_TOL:
            raise RuntimeError(f'tap {key} differs between kernel and twin: {rel}')

    # 4. timing: each call between CUDA events, after one warm-up call
    torch.cuda.reset_peak_memory_stats()
    fe.extract(prompts, 2, images, image_type='tensor', t=50)
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fe.extract(prompts, 2, images, image_type='tensor', t=50)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    ms = times[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'phase 4 extract 1024^2 batch 2 over {len(times)} calls: median {ms:.2f} ms '
          f'(min {times[0]:.2f}, max {times[-1]:.2f}), {2000.0 / ms:.3f} img/s, '
          f'peak memory {peak:.2f} GiB ({card})', flush=True)

    print(f'card: {card}')
    print(json.dumps({'kernels': [{
        'name': 'flash_attention',
        'route': 'cuda',
        'source': 'diffusion_feature_tpu_torch/csrc/flash_attention.cu',
        'replaces': 'diffusion_feature_tpu/ops/flash_attention.py:86',
        'launches': launches,
        'max_abs_err': main_err,
        'ms': main_ms,
        'plain_ms': main_plain_ms,
    }]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
