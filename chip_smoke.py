#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its numbers on lines of its own):
  1. the card's name and power limit, then the kernels' build (one nvcc per
     source, started together);
  2. every kernel against its plain twin at every shape the paths launch
     it at (batch 2), plus a ragged shape, in bf16 and fp32 (B1 also in
     fp16 once): errors against the stated tolerances, and for each shape
     the kernel's, the twin's and the one PyTorch library call's times
     (CUDA events after warm-up) beside the least time the card needs;
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
     and 36 B3 launches, 'attn' (2, 5120, 128, 128), the twin step, timing.
The last line is {"ok": true, "device": {...}}; before it come the card line
and a {"kernels": [...]} line.  Exits non-zero, without the last line,
when there is no CUDA device or any phase fails.

PATHS, open_path and extract_times are also what tools/torch_extract_ab.py
and tools/torch_extract_profile.py time, so their numbers are of the same
paths.
"""

import contextlib
import json
import subprocess
import sys
import time

# (b, h, sq, sk, d): the shapes the paths launch each kernel at (batch 2)
B1_SHAPES = [
    (2, 10, 4096, 4096, 64),    # SDXL U-Net level-1 self-attention
    (2, 20, 1024, 1024, 64),    # SDXL U-Net level-2 and mid self-attention
    (2, 1, 16384, 16384, 512),  # SDXL VAE mid-block single head
    (2, 8, 4096, 4096, 40),     # SD-1.5 U-Net level-0 self-attention @512^2
    (2, 8, 1024, 1024, 80),     # SD-1.5 U-Net level-1 self-attention @512^2
    (2, 8, 1024, 1024, 160),    # SD-1.5 U-Net level-2 self-attention @1024^2
]
STORE_SHAPES = [                # B2 and B3: the attention store's self-attentions
    (2, 8, 1024, 1024, 80),     # path A: SD-1.5 up-level2
    (2, 20, 1024, 1024, 64),    # path B: SDXL up-level0
    (2, 10, 4096, 4096, 64),    # path B: SDXL up-level1
]
RAGGED = (1, 2, 1000, 333, 64)
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
# the paths phases 3 to 6 drive, at random weights from seed 0, bf16, batch
# 2, t=50: FeatureExtractor's arguments, the B1/B2/B3 launches of one
# extract, and the features it returns
PATHS = {
    'xl': {'args': dict(layer='xl-practical', version='xl', img_size=1024),
           'launches': (71, 0, 0), 'feats': XL_PRACTICAL},
    'sd15_store': {'args': dict(layer='15-amalgamation', version='1-5', img_size=512,
                                attention=['up_cross', 'up_self']),
                   'launches': (7, 3, 3), 'feats': AMALGAMATION_15},
    'xl_store': {'args': dict(layer='xl-practical', version='xl', img_size=1024,
                              attention=['up_self']),
                 'launches': (35, 36, 36), 'feats': XL_STORE},
}
TIMED_CALLS = 7
# kernel vs twin through ~70 bf16 attention calls and 50+ blocks: relative
# L2 difference per tap
TAP_REL_TOL = 2e-2
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    'flash_attention': ('diffusion_feature_tpu_torch/csrc/flash_attention.cu',
                        'diffusion_feature_tpu/ops/flash_attention.py:86'),
    'flash_attention_with_lse': ('diffusion_feature_tpu_torch/csrc/flash_attention.cu',
                                 'diffusion_feature_tpu/ops/flash_attention.py:121'),
    'headmean_probs': ('diffusion_feature_tpu_torch/csrc/headmean.cu',
                       'diffusion_feature_tpu/ops/flash_attention.py:461'),
}


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


def bound(kernel, shape, dtype_name):
    """(ms, 'bytes' or 'operations'): the least time the card needs for the
    function, from the flops its shape needs and the bytes it must move
    (each input read once, each output written once)."""
    b, h, sq, sk, d = shape
    item = {'bfloat16': 2, 'float16': 2, 'float32': 4}[dtype_name]
    if kernel == 'headmean_probs':      # q, k, lse in; the (B, Sq, Sk) map out
        flops = 2 * b * h * sq * sk * d
        nbytes = (b * h * (sq + sk) * d + b * sq * sk) * item + b * h * sq * 4
    else:                               # q, k, v in; o (and the lse) out
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


def library_ms(torch, kernel, q, k, v, scale):
    """The one PyTorch call that computes the kernel's function, timed as
    a yardstick (the port never calls it); None where there is none or it
    does not take these inputs."""
    F = torch.nn.functional
    try:
        if kernel == 'flash_attention':
            return time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        if kernel == 'flash_attention_with_lse':
            op = torch.ops.aten._scaled_dot_product_flash_attention
            return time_ms(torch, lambda: op(q, k, v, 0.0, False, False, scale=scale))
    except RuntimeError as err:
        print(f'  library call for {kernel} on {q.dtype} {tuple(q.shape)} unavailable: '
              f'{str(err).splitlines()[0]}')
    return None


def compare(torch, fa, kernel, shape, dtype_name, gen):
    """One kernel against its twin on one shape; returns its numbers."""
    b, h, sq, sk, d = shape
    dtype = getattr(torch, dtype_name)
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
    elif kernel == 'flash_attention_with_lse':
        run = lambda: fa.flash_attention_with_lse(q, k, v, scale=scale)     # noqa: E731
        plain = lambda: fa.flash_attention_with_lse_reference(q, k, v, scale)  # noqa: E731
        (out, lse), (ref, ref_lse) = run(), plain()
        err, ratio = worst_ratio(torch, out, ref, atol, tol)
        lse_err = (lse - ref_lse).abs().max().item()
        ratio = max(ratio, lse_err / LSE_TOL)
        notes = f' lse_max_abs_err={lse_err:.3e} (allowed {LSE_TOL:g})'
    else:
        # both sides take the logsumexp of the B2 kernel
        _, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
        run = lambda: fa.headmean_probs(q, k, lse, scale=scale)             # noqa: E731
        plain = lambda: fa.headmean_probs_reference(q, k, lse, scale)       # noqa: E731
        out, ref = run(), plain()
        err, ratio = worst_ratio(torch, out, ref, atol, tol)
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        ratio = max(ratio, rel / tol)
        notes = f' rel_l2={rel:.3e} (allowed {tol:g})'
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    ms, plain_ms = time_ms(torch, run), time_ms(torch, plain)
    lib_ms = library_ms(torch, kernel, q, k, v, scale)
    bound_ms, bound_by = bound(kernel, shape, dtype_name)
    ok = finite and ratio <= 1.0
    lib = 'none' if lib_ms is None else f'{lib_ms:.4f}'
    print(f'compare {kernel} {dtype_name} q{(b, h, sq, d)} k{(b, h, sk, d)}: '
          f'max_abs_err={err:.3e} atol={atol:.3g} rtol={tol:g} worst/allowed={ratio:.3f}{notes} '
          f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} '
          f'bound_ms={bound_ms:.4f} ({bound_by}) share_of_bound={bound_ms / ms:.3f} '
          f'{"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise RuntimeError(f'{kernel} disagrees with its twin at {shape} {dtype_name}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by}


WRAPPERS = tuple(KERNELS)   # the wrappers' names in ops.flash_attention and ops.attention


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
    """Record (kernel, (b, h, sq, sk, d)) of every call, then call through
    to the wrapper unchanged."""
    def make(name, wrapper):
        def call(q, k, *args, **kwargs):
            log.append((name, (*q.shape[:3], k.shape[2], q.shape[3])))
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
    fa.launches = fa.lse_launches = fa.headmean_launches = 0


def read_counts(fa):
    return {'flash_attention': fa.launches, 'flash_attention_with_lse': fa.lse_launches,
            'headmean_probs': fa.headmean_launches}


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


def check_twin_step(torch, fe, attn_ops, fa, prompts, images, keys, label):
    """The same step with the kernels and with every kernel call on its
    plain twin, on the same noise: relative L2 per feature."""
    bsz = images.shape[0]
    pe = prompts[0].expand(bsz, -1, -1)
    pooled = None if prompts[2] is None else prompts[2].expand(bsz, -1)
    img = images.to(fe.dtype)
    lat = fe.img_size // fe.vae_scale
    noise_gen = torch.Generator(device='cuda').manual_seed(2)
    posterior, noise = (torch.randn((bsz, 4, lat, lat), generator=noise_gen, device='cuda')
                        for _ in range(2))
    kit = fe._img2img_kit(50)
    with_kernel = fe._step(img, pe, pooled, kit, posterior, noise, torch.bfloat16)
    with patched_wrappers(attn_ops, twin_of(fa)):
        with_twin = fe._step(img, pe, pooled, kit, posterior, noise, torch.bfloat16)
    for key in keys:
        a, b = with_kernel[key].float(), with_twin[key].float()
        rel = ((a - b).norm() / b.norm()).item()
        print(f'  {label} kernel vs twin step, {key}: rel_l2={rel:.3e} (allowed {TAP_REL_TOL:g})')
        if not rel <= TAP_REL_TOL:
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


def extract(fe, prompts, images):
    return fe.extract(prompts, images.shape[0], images, image_type='tensor', t=50)


def extract_times(torch, fe, prompts, images, calls):
    """``calls`` extracts after three untimed ones; per call the host time
    to enqueue it and the time between CUDA events around it, in ms, each
    list sorted."""
    for _ in range(3):
        extract(fe, prompts, images)
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(calls):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        extract(fe, prompts, images)
        stop.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device.append(start.elapsed_time(stop))
    return sorted(host), sorted(device)


def time_extract(torch, fe, prompts, images, label, card):
    """Median ms, img/s and peak memory over TIMED_CALLS calls."""
    torch.cuda.reset_peak_memory_stats()
    host, times = extract_times(torch, fe, prompts, images, TIMED_CALLS)
    ms = times[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{label} over {len(times)} calls: median {ms:.2f} ms (min {times[0]:.2f}, '
          f'max {times[-1]:.2f}), {1000.0 * images.shape[0] / ms:.3f} img/s, '
          f'host enqueue median {host[len(host) // 2]:.2f} ms, '
          f'peak memory {peak:.2f} GiB ({card})', flush=True)


def drive_path(torch, fa, attn_ops, fe, prompts, images, expected_counts, label):
    """One extract with every count set to 0 just before it and read just
    after; returns (features, counts, recorded kernel shapes)."""
    shapes = []
    with patched_wrappers(attn_ops, recording(shapes)):
        reset_counts(fa)
        feats = extract(fe, prompts, images)
        torch.cuda.synchronize()
        counts = read_counts(fa)
    print(f'{label} extract: kernel launches {counts} (expected {expected_counts})', flush=True)
    if counts != expected_counts:
        raise RuntimeError(f'{label}: launches {counts} != {expected_counts}')
    return feats, counts, shapes


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
    for line in info['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}')

    # 2. every kernel against its twin, with times, at every path shape
    gen = torch.Generator(device='cuda').manual_seed(0)
    numbers = {}   # (kernel, shape) -> bf16 numbers
    for dtype_name in ('bfloat16', 'float32'):
        for kernel, shapes in (('flash_attention', B1_SHAPES),
                               ('flash_attention_with_lse', STORE_SHAPES),
                               ('headmean_probs', STORE_SHAPES)):
            for shape in shapes + [RAGGED]:
                res = compare(torch, fa, kernel, shape, dtype_name, gen)
                if dtype_name == 'bfloat16':
                    numbers[kernel, shape] = res
    compare(torch, fa, 'flash_attention', B1_SHAPES[0], 'float16', gen)

    # 3 and 4: SDXL single-step extraction (the port's first slice) and its
    # timing; 5: path A, SD-1.5 with the attention store; 6: path B, the
    # attention store on SDXL
    runs, shapes = {}, {}
    for phase, timing_phase, name in ((3, 4, 'xl'), (5, 5, 'sd15_store'), (6, 6, 'xl_store')):
        path = PATHS[name]
        t0 = time.perf_counter()
        fe, prompts, images = open_path(torch, name)
        torch.cuda.synchronize()
        pooled = None if prompts[2] is None else tuple(prompts[2].shape)
        print(f'phase {phase} {name} build + encode_prompt: {time.perf_counter() - t0:.1f} s; '
              f'prompt_embeds {tuple(prompts[0].shape)}, pooled {pooled}', flush=True)
        feats, runs[name], shapes[name] = drive_path(
            torch, fa, attn_ops, fe, prompts, images, dict(zip(WRAPPERS, path['launches'])),
            f'phase {phase}')
        check_feats(torch, feats, path['feats'], f'phase {phase}')
        if 'attention' in path['args']:
            gib = sum(s[0] * s[2] * s[3] * 2 for n, s in shapes[name]
                      if n == 'headmean_probs') / 2 ** 30
            print(f'  phase {phase} head-mean maps from B3 kept by the store: {gib:.3f} GiB (bf16)')
        check_twin_step(torch, fe, attn_ops, fa, prompts, images, path['feats'], f'phase {phase}')
        size = path['args']['img_size']
        time_extract(torch, fe, prompts, images,
                     f'phase {timing_phase} {name} extract {size}^2 batch 2', card)
        del fe, feats
        torch.cuda.empty_cache()

    # the kernels line: per kernel, the launches of the three paths and the
    # sum over those launches of each shape's bf16 numbers from phase 2
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
                 'launches': sum(r[name] for r in runs.values()),
                 'launches_by_path': {p: r[name] for p, r in runs.items()},
                 'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                 'library_ms': 0.0, 'shapes': {}}
        calls = [s for path in shapes.values() for n, s in path if n == name]
        if len(calls) != entry['launches']:
            raise RuntimeError(f'{name}: {len(calls)} recorded calls, {entry["launches"]} launches')
        for shape in sorted(set(calls)):
            res = numbers[name, shape]
            count = calls.count(shape)
            entry['shapes'][str(shape)] = {'calls': count, **res}
            entry['max_abs_err'] = max(entry['max_abs_err'], res['max_abs_err'])
            for key in ('ms', 'plain_ms', 'bound_ms'):
                entry[key] += count * res[key]
            entry['library_ms'] = (None if entry['library_ms'] is None or res['library_ms'] is None
                                   else entry['library_ms'] + count * res['library_ms'])
        # what bounds the calls that take most of the bound
        entry['bound_by'] = max(entry['shapes'].values(),
                                key=lambda v: v['calls'] * v['bound_ms'])['bound_by']
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
