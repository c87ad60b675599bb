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
     1-5@512 (197 ids), timed.
Phase 2 also holds B4 (short attention), which no path routes to, as in
the JAX package: against its twin, with its gradients through
short_attention_diff, at the 256-token bands of SD-1.5 and SDXL at 512^2,
the JAX docstring's measured (16, 20, 256, {256, 77}, 64) and a ragged
shape, on contiguous tensors and on head-split views, with its time beside
B1's, SDPA's and the explicit path's there, all (its twin too) timed as
CUDA graphs of 20 calls.
Every path runs with all four counts set to 0 and expects 0 B4 launches.
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
]
STORE_SHAPES = [                # B2 and B3: the attention store's self-attentions
    (2, 8, 1024, 1024, 80),     # path A: SD-1.5 up-level2
    (2, 20, 1024, 1024, 64),    # path B: SDXL up-level0
    (2, 10, 4096, 4096, 64),    # path B: SDXL up-level1
]
RAGGED = (1, 2, 1000, 333, 64)
# B1/B2/B3 on head-split views: ragged lengths at d=40 (TMA zero-fills the
# columns up to the mma depth) and at d=512 (B1 only: one score pass over
# two consumer warpgroups)
SPLIT_RAGGED = {'flash_attention': [RAGGED, (1, 2, 1000, 333, 40), (1, 1, 1000, 777, 512)],
                'flash_attention_with_lse': [RAGGED, (1, 2, 1000, 333, 40)],
                'headmean_probs': [RAGGED, (1, 2, 1000, 333, 40)]}
SHORT_SHAPES = [                # B4: the short-sequence bands (no path launches it)
    (2, 8, 256, 256, 160),      # SD-1.5 @512^2 level-2 self-attention
    (2, 8, 256, 77, 160),       # and its cross-attention
    (2, 20, 256, 256, 64),      # SDXL @512^2 level-2 self-attention
    (2, 20, 256, 77, 64),       # and its cross-attention
    (16, 20, 256, 256, 64),     # the JAX docstring's measured shapes
    (16, 20, 256, 77, 64),
]
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
    does not take these inputs."""
    F = torch.nn.functional
    try:
        if kernel in ('flash_attention', 'short_attention'):
            return timer(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        if kernel == 'flash_attention_with_lse':
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


def check_cli(torch, fa, attn_ops, card, shapes):
    """Phase 7: the CLI on the 'xl' path and its .npy tree, then
    --show_all_layers; returns the CLI run's launch counts."""
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
                '--input_dir', 'imgs/*.png', '--output_dir', 'out'])
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
    numbers = {}   # (kernel, shape) -> bf16 numbers
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
                    numbers[kernel, shape] = res
        # B4 on no path: contiguous inputs (the kernels line's), then
        # head-split views
        for shape in SHORT_SHAPES + [SHORT_RAGGED]:
            res = compare(torch, fa, 'short_attention', shape, dtype_name, gen)
            if dtype_name == 'bfloat16' and shape in SHORT_SHAPES:
                numbers['short_attention', shape] = res
        for shape in (SHORT_SHAPES if dtype_name == 'bfloat16' else []) + [SHORT_RAGGED]:
            compare(torch, fa, 'short_attention', shape, dtype_name, gen, split=True)
    for kernel, shape in (('flash_attention', B1_SHAPES[0]),
                          ('flash_attention', SPLIT_RAGGED['flash_attention'][-1]),
                          ('flash_attention_with_lse', STORE_SHAPES[1]),
                          ('headmean_probs', STORE_SHAPES[2]),
                          ('short_attention', SHORT_SHAPES[4])):
        compare(torch, fa, kernel, shape, 'float16', gen, split=True)
    torch.cuda.empty_cache()
    print(f'phase 2 done: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB still allocated '
          '(what phases 3 to 7 count in their peak beside their own)', flush=True)

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
            torch, fa, attn_ops, fe, prompts, images,
            {**dict(zip(WRAPPERS, path['launches'])), 'short_attention': 0}, f'phase {phase}')
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

    # 7. the CLI
    shapes['cli'] = []
    runs['cli'] = check_cli(torch, fa, attn_ops, card, shapes['cli'])

    # the kernels line: per kernel, the launches of the four paths and the
    # sum over those launches of each shape's bf16 numbers from phase 2 (a
    # shape phase 2 did not hold, such as the CLI's trailing batch of 1, is
    # compared and timed here); B4, which no path launches, sums one call
    # at each of its phase-2 shapes
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
                 'launches': sum(r[name] for r in runs.values()),
                 'launches_by_path': {p: r[name] for p, r in runs.items()},
                 'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                 'library_ms': 0.0, 'call_loop_ms': 0.0, 'shapes': {}}
        calls = [s for path in shapes.values() for n, s in path if n == name]
        if len(calls) != entry['launches']:
            raise RuntimeError(f'{name}: {len(calls)} recorded calls, {entry["launches"]} launches')
        if name == 'short_attention':
            calls = list(SHORT_SHAPES)
            entry['timed_over'] = 'one bf16 call at each phase-2 shape; no path launches B4'
            entry['b1_ms'] = entry['explicit_ms'] = 0.0
        for shape in sorted(set(calls)):
            if (name, shape) not in numbers:
                numbers[name, shape] = compare(torch, fa, name, shape, 'bfloat16', gen,
                                               split=True)
            res = numbers[name, shape]
            count = calls.count(shape)
            entry['shapes'][str(shape)] = {'calls': count, **res}
            entry['max_abs_err'] = max(entry['max_abs_err'], res['max_abs_err'])
            for key in ('ms', 'plain_ms', 'bound_ms', 'b1_ms', 'explicit_ms', 'call_loop_ms'):
                if key in entry:
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
