"""Attention kernels written by hand for Hopper, and their plain twins.

Replaces the Pallas TPU kernels of ``diffusion_feature_tpu/ops/flash_attention.py``:

  B1 ``_flash_kernel``      -> ``flash_attention``           (csrc/flash_bf16.cu, flash_fp16.cu,
                                                               flash_f32.cu)
  B2 ``_flash_lse_kernel``  -> ``flash_attention_with_lse``  (the same sources, kLse)
  B3 ``_headmean_kernel``   -> ``headmean_probs``            (csrc/headmean_bf16.cu,
                                                               headmean_fp16.cu, headmean_f32.cu)
  B4 ``_short_attn_kernel`` -> ``short_attention``           (csrc/short_bf16.cu, short_fp16.cu,
                                                               short_f32.cu)

and the JAX package's flash backward, the custom VJP ``_flash_diff_bwd``
(an XLA VJP there, no Pallas kernel), by a kernel of its own:

  ``_flash_diff_bwd``       -> ``flash_attention_bwd``       (csrc/flash_bwd_bf16.cu,
                                                               flash_bwd_fp16.cu, flash_bwd_f32.cu)

``flash_attention_diff`` is the differentiable B1: B2 forward (saving the
logsumexp), this backward; the attention ops call it wherever q, k or v
requires grad.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (one ``nvcc`` per source, started
together), cached by source hash in ``_build/`` beside this package, and
called through ``ctypes`` on PyTorch's current stream.

What bounds them on an H100: B1/B2 at d=64 and 4096 tokens do ~4000 flops
per byte they read, so tensor-core flops and the Sq*Sk exponentials bound
them, not memory; B3 does half B1's flops per score and no PV product, so
its exponentials (one per head and score, on the special-function unit)
and its re-reads of Q/K tiles from L2 bound it; B4, at the short sequences
its gate admits, moves so few bytes that a block's chain of loads and
products, and a launch's own cost, exceed its bound.  In bf16 and fp16
every kernel is written for Hopper: a producer warp issues TMA loads into
mbarrier rings and consumer warpgroups run ``wgmma`` with the scores in
registers (B1/B2 ``flash_hopper.cuh``: online softmax, d=512 computes each
score once; B3 ``headmean_hopper.cuh``: a ring over heads, the mean kept
in registers, a persistent grid; B4 ``short_hopper.cuh``: two passes, the
row maxima first).  ``hopper_common.cuh`` holds what they share.  float32
runs on training paths (ade_vpd's prompt tuning and train_unet
differentiate SD-1.5 in fp32, whose self-attentions are B2 forwards under
the backward) and in SD-2.1's upcast attention store (B2 and B3).  wgmma
has no exact fp32 product, so fp32 B1/B2 (``flash_f32.cu``) run
``simt_f32.cuh``'s register-tiled FMA products (float4 operands from
shared memory, no shuffles, cp.async staging), bound by the FMA issue
rate; fp32 B3 and B4 (``headmean_f32.cu``, ``short_f32.cu``) keep
``tile_ops.cuh``'s emulation of mma.sync fragments, whose shuffles limit
it.  See the sources.

Head widths: each kernel is instantiated per width (``SUPPORTED_HEAD_DIMS``,
``HEADMEAN_HEAD_DIMS``).  A width that is no multiple of the 64-column
tile runs QK^T over TMA's zero fill up to the next multiple of 16 (d=40 at
48, d=72 at 80, HunyuanDiT's d=88 at 96) and P V at N = d itself
(``m64n72k16``, ``m64n88k16``), the epilogue stopping at column d.

Inputs: every kernel takes (B, H, S, D) tensors with unit stride along D
and 16-byte aligned bases and strides (``tma_strides``), so the head-split
view ``split_heads`` returns (stride H*D along S) is read in place.  B1, B2
and B4 write their output in (B, S, H, D) memory and return the
(B, H, S, D) view, so ``merge_heads`` of it is a view too; B3 writes a
contiguous (B, Sq, Sk) map.  No wrapper copies an input it cannot take: it
raises.

The backward (``csrc/flash_bwd.cuh``) computes every score once: after a
pre-pass for rowsum(dO * O), one block per key tile keeps that tile's dK
and dV in registers, walks every query tile, and adds its share of dQ into
an fp32 sum, so no (Sq, Sk) tensor reaches memory.  Its five products bound
it by operations.  bf16/fp16 (``flash_bwd_hopper.cuh``) run them on
``wgmma`` in two consumer warpgroups fed by a TMA ring of Q/dO tiles, and
add each dQ piece with one bulk reduce-add into an fp32 accumulator that a
last pass converts; float32 (``flash_bwd_f32.cu``) runs
them as ``simt_f32.cuh``'s products with fp32 atomics into dQ.  dQ is
therefore summed in no fixed order: not bitwise repeatable between calls,
as SDPA's backward is not.

Routing: CPU tensors go to the ``*_reference`` twins, and so do meta
tensors, which carry shapes only (layer enumeration runs the U-Net on
them); CUDA tensors launch the kernel or raise.  ``launches``,
``lse_launches``, ``headmean_launches``, ``short_launches`` and
``bwd_launches`` count the launches of B1, B2, B3, B4 and the backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

#: Head widths B1 is built for: the U-Nets' 40, 64, 80, 128, 160, PixArt's
#: 72, HunyuanDiT's 88 and the VAE's single 512-wide head.
SUPPORTED_HEAD_DIMS = (40, 64, 72, 80, 88, 128, 160, 512)
#: Head widths B2, B3 and B4 are built for (the U-Nets' and the DiTs' heads).
HEADMEAN_HEAD_DIMS = (40, 64, 72, 80, 88, 128, 160)
#: Head widths the backward is built for: B2's, whose logsumexp it takes.
#: The VAE's d=512 head never needs a gradient (the VAE runs without one).
BWD_HEAD_DIMS = HEADMEAN_HEAD_DIMS
#: B4 takes at most this many keys (its exact softmax walks every key tile
#: twice, and the fp32 kernel keeps a 64 x Sk score tile in shared memory).
SHORT_MAX_KEYS = 512
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
#: one library per kernel and dtype: <kernel>_<bf16|fp16|f32>
_SOURCES = {f'{kernel}_{tag}': _CSRC / f'{kernel}_{tag}.cu'
            for kernel in ('flash', 'headmean', 'short', 'flash_bwd')
            for tag in ('bf16', 'fp16', 'f32')}
_HEADERS = tuple(_CSRC / name for name in ('tile_ops.cuh', 'simt_f32.cuh', 'hopper_common.cuh',
                                           'wgmma.cuh', 'flash_hopper.cuh', 'headmean_hopper.cuh',
                                           'short_hopper.cuh', 'flash_bwd.cuh',
                                           'flash_bwd_hopper.cuh'))
_DTYPE_TAGS = {torch.bfloat16: 'bf16', torch.float16: 'fp16', torch.float32: 'f32'}
_BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
               '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, k, v, o, lse, b, h, sq, sk, d, dtype, scale, strides (sb, sh, ss of
    # q, k, v, o), stream
    'dft_flash_attention_forward': [_VP] * 5 + [_INT] * 6 + [
        _F32, ctypes.POINTER(ctypes.c_longlong), _VP],
    # q, k, lse, out, b, h, sq, sk, d, dtype, scale, strides (sb, sh, ss of
    # q, k), stream
    'dft_headmean_probs': [_VP] * 4 + [_INT] * 6 + [
        _F32, ctypes.POINTER(ctypes.c_longlong), _VP],
    # q, k, v, o, b, h, sq, sk, d, dtype, scale, strides (as B1's), stream
    'dft_short_attention_forward': [_VP] * 4 + [_INT] * 6 + [
        _F32, ctypes.POINTER(ctypes.c_longlong), _VP],
    # q, k, v, o, do, lse, delta (scratch), dq_acc (scratch), dq, dk, dv, b, h,
    # sq, sk, d, dtype, scale, strides (sb, sh, ss of q, k, v, o, do, dq, dk,
    # dv), stream
    'dft_flash_attention_backward': [_VP] * 11 + [_INT] * 6 + [
        _F32, ctypes.POINTER(ctypes.c_longlong), _VP],
}

#: Kernel launches since import (or since a caller reset them to 0).
launches = 0            # B1
lse_launches = 0        # B2
headmean_launches = 0   # B3
short_launches = 0      # B4
bwd_launches = 0        # the backward (one per call of its wrapper)

_libs = {}


def is_flash_compatible(q_shape, k_shape, min_seq: int = 1024,
                        head_dims=SUPPORTED_HEAD_DIMS) -> bool:
    """The JAX package's gate (``is_flash_compatible``): long self-attention
    with 256-aligned sequence lengths, and the wide d=512 head only at
    >= 8192 tokens (the VAE mid block at 1024^2, where the explicit path's
    fp32 score tensor is 1 GiB per image).  The port adds one condition:
    the head dim must be one of ``head_dims``, the widths a kernel is built
    for; ``None`` drops it (the CPU twins take any width)."""
    *_, sq, d = q_shape
    sk = k_shape[-2]
    return (
        (head_dims is None or d in head_dims)
        and sq >= min_seq
        and sq % 256 == 0
        and sk % 256 == 0
        and (d <= 256 or (d <= 512 and sq >= 8192))
    )


def is_short_attn_compatible(q_shape, k_shape, max_seq: int = 512,
                             head_dims=HEADMEAN_HEAD_DIMS) -> bool:
    """The JAX package's gate for ``short_attention``
    (``is_short_attn_compatible``): Sq a multiple of 128 from 8 up to
    ``max_seq``, Sk up to ``max_seq`` (padded keys are masked, so any Sk is
    exact), d up to 256.  The port adds the head widths B4 is built for,
    as in ``is_flash_compatible``; ``None`` drops them.  As in the JAX
    package, no dispatch of the port consults this gate: the explicit path
    keeps these shapes."""
    *_, sq, d = q_shape
    sk = k_shape[-2]
    return ((head_dims is None or d in head_dims)
            and 8 <= sq <= max_seq and sq % 128 == 0
            and sk <= max_seq and d <= 256)


# ------------------------------------------------------------------- twins
def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Plain twin of B1: fp32 scores, softmax and PV product, result cast to
    q's dtype.  (B, H, Sq, D) x (B, H, Sk, D) -> (B, H, Sq, D)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(scores.softmax(dim=-1), v.float()).to(q.dtype)


def flash_attention_with_lse_reference(q, k, v, scale: float):
    """Plain twin of B2: B1's output and the fp32 logsumexp of each row's
    scaled scores, (B, H, Sq)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    out = torch.matmul(scores.softmax(dim=-1), v.float()).to(q.dtype)
    return out, torch.logsumexp(scores, dim=-1)


def short_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Plain twin of B4: fp32 scores over exactly the Sk keys given (so
    there is no padding to mask), softmax, fp32 PV product, the result cast
    to q's dtype; B1's twin computes the same function."""
    return flash_attention_reference(q, k, v, scale)


def headmean_probs_reference(q, k, lse, scale: float) -> torch.Tensor:
    """Plain twin of B3: (1/H) sum_h exp(q_h k_h^T * scale - lse_h) in fp32,
    cast to q's dtype.  (B,H,Sq,D), (B,H,Sk,D), (B,H,Sq) -> (B,Sq,Sk).  One
    head at a time, so the per-head (B,H,Sq,Sk) tensor never exists here
    either."""
    acc = None
    for h in range(q.shape[1]):
        s = torch.matmul(q[:, h].float(), k[:, h].float().transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, h, :, None].float())
        acc = p if acc is None else acc + p
    return (acc / q.shape[1]).to(q.dtype)


#: JAX's ``_CHUNKED_BWD_ELEMS``: at or above this Sq*Sk the backward's twin
#: walks q in chunks (``_chunked_attention_bwd``) instead of the one-shot VJP,
#: whose fp32 (B, H, Sq, Sk) temporaries stop fitting the device.
CHUNKED_BWD_ELEMS = 8192 * 8192


def attention_vjp_reference(q, k, v, scale: float) -> torch.Tensor:
    """The JAX package's ``_reference_attention``, what its flash backward
    differentiates below ``CHUNKED_BWD_ELEMS``: fp32 scores, softmax, the
    probabilities cast to q's dtype, the PV product accumulated in fp32 and
    cast back."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = scores.softmax(dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def chunked_attention_bwd(q, k, v, scale: float, grad, chunk: int = 512):
    """The JAX package's ``_chunked_attention_bwd``: (dq, dk, dv) with
    O(Sk * chunk) memory, a walk over chunks of ``chunk`` query rows that
    recomputes each chunk's scores and output in fp32 and uses
    rowsum(dP * P) = rowsum(grad * O).  (JAX pads q to a multiple of
    ``chunk`` with rows whose gradient is 0; they add nothing, so the last
    chunk here is ragged instead.)"""
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    for start in range(0, q.shape[2], chunk):
        qi = q[:, :, start:start + chunk].float()
        gi = grad[:, :, start:start + chunk].float()
        p = (torch.matmul(qi, kf.transpose(-1, -2)) * scale).softmax(dim=-1)
        d_row = (gi * torch.matmul(p, vf)).sum(dim=-1, keepdim=True)
        dv += torch.matmul(p.transpose(-1, -2), gi)
        ds = p * (torch.matmul(gi, vf.transpose(-1, -2)) - d_row) * scale
        dqs.append(torch.matmul(ds, kf))
        dk += torch.matmul(ds.transpose(-1, -2), qi)
    return torch.cat(dqs, dim=2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, grad, scale: float):
    """Plain twin of the backward, JAX's ``_flash_diff_bwd`` exactly: the
    VJP of ``attention_vjp_reference`` below ``CHUNKED_BWD_ELEMS`` query-key
    pairs, ``chunked_attention_bwd`` at or above.  Returns (dq, dk, dv) in
    the inputs' dtypes."""
    if q.shape[2] * k.shape[2] >= CHUNKED_BWD_ELEMS:
        return chunked_attention_bwd(q, k, v, scale, grad)
    inputs = tuple(x.detach().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        out = attention_vjp_reference(*inputs, scale)
    return torch.autograd.grad(out, inputs, grad.to(out.dtype))


# ------------------------------------------------------------------- build
def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); it is needed to build '
                           f'{", ".join(p.name for p in _SOURCES.values())} for the GPU')
    return found


def build() -> dict:
    """Compile every kernel library whose source changed, one ``nvcc`` per
    source, all started together, and load them.

    Returns {'paths', 'seconds', 'log'}: seconds is the wall time of the
    builds (0.0 when every cached build for these source hashes was
    reused); log is the nvcc/ptxas output of fresh builds (registers,
    shared memory, spills per kernel)."""
    common = b''.join(h.read_bytes() for h in _HEADERS) + ' '.join(_NVCC_FLAGS).encode()
    paths, procs = {}, {}
    start = time.perf_counter()
    for name, src in _SOURCES.items():
        digest = hashlib.sha256(src.read_bytes() + common).hexdigest()[:16]
        path = paths[name] = _BUILD_DIR / f'libdft_{name}_{digest}.so'
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f'.tmp{os.getpid()}.so')
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, '-o', str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f'== {_SOURCES[name].name}\n{out}')
        if proc.returncode != 0:
            failed.append(f'{_SOURCES[name]} (exit {proc.returncode})')
        else:
            os.replace(tmp, paths[name])
    seconds = time.perf_counter() - start if procs else 0.0
    log = ''.join(logs)
    if failed:
        raise RuntimeError(f'nvcc failed on {", ".join(failed)}:\n{log}')
    for name, path in paths.items():
        lib = _libs.get(name)
        if lib is None or lib._name != str(path):
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, fn_name, None)
                if fn is not None:
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _libs[name] = lib
    return {'paths': [str(p) for p in paths.values()], 'seconds': seconds, 'log': log}


def _lib(kernel: str, dtype: torch.dtype):
    """The library of ``kernel`` ('flash', 'headmean', 'short' or
    'flash_bwd') for
    ``dtype``, built at first use."""
    name = f'{kernel}_{_DTYPE_TAGS[dtype]}'
    if name not in _libs:
        build()
    return _libs[name]


# ---------------------------------------------------------------- wrappers
def _on_host(*tensors) -> bool:
    """Where the twins run: tensors on the CPU, or on the meta device,
    which carries shapes only."""
    return all(x.device.type in ('cpu', 'meta') for x in tensors)


def tma_strides(x: torch.Tensor) -> tuple:
    """(sb, sh, ss): the element strides of a (B, H, S, D) tensor as the
    kernels take them (a TMA tensor map; the fp32 kernels the same).
    A dimension of size 1 has no meaningful stride, so it gets the one a
    packed layout would give it.  Raises ValueError unless D has unit
    stride and every stride is a multiple of 16 bytes."""
    b, h, s, d = x.shape
    sb, sh, ss, sd = x.stride()
    if sd != 1 and d != 1:
        raise ValueError(f'must be contiguous along D (unit stride), got strides {x.stride()}')
    ss = d if s == 1 else ss
    sh = s * ss if h == 1 else sh
    sb = h * sh if b == 1 else sb
    if any(st * x.element_size() % 16 for st in (sb, sh, ss)):
        raise ValueError(f'strides {x.stride()} of {x.dtype} {tuple(x.shape)} are not '
                         'multiples of 16 bytes')
    return sb, sh, ss


def _check_cuda_inputs(op: str, tensors, head_dims):
    """Device, dtype, rank, shape and alignment of (B, H, S, D) inputs of
    one dtype and one head width, on the current CUDA device.  The layout
    is ``tma_strides``'s to check."""
    first = tensors[0][1]
    for name, x in tensors:
        if x.device.type != 'cuda' or x.device != first.device:
            raise ValueError(f'{op}: {name} is on {x.device}, '
                             f'expected the CUDA device of q ({first.device})')
        if x.dtype != first.dtype or x.dtype not in _DTYPE_CODES:
            raise ValueError(f'{op}: {name} has dtype {x.dtype}; the kernel takes '
                             'float32, float16 or bfloat16, one dtype for all inputs')
        if x.dim() != 4:
            raise ValueError(f'{op}: {name} must be (B, H, S, D), got {tuple(x.shape)}')
        if x.data_ptr() % 16:
            raise ValueError(f'{op}: {name} must be 16-byte aligned')
        if x.shape[:2] != first.shape[:2] or x.shape[3] != first.shape[3]:
            raise ValueError(f'{op}: shapes ' + ', '.join(
                f'{n} {tuple(t.shape)}' for n, t in tensors) + ' do not match')
        if x.shape[2] == 0:
            raise ValueError(f'{op}: empty sequence')
        if x.numel() >= 2 ** 31:
            raise ValueError(f'{op}: {tuple(x.shape)} exceeds the launch limits')
    if first.device.index != torch.cuda.current_device():
        raise ValueError(f'{op}: q is on {first.device} but the current CUDA device '
                         f'is {torch.cuda.current_device()}')
    d = first.shape[3]
    if d not in head_dims:
        raise ValueError(f'{op}: head dim {d} not supported (kernel is built for {head_dims})')
    if first.shape[0] * first.shape[1] > 65535:
        raise ValueError(f'{op}: {tuple(first.shape)} exceeds the launch limits')


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_output(q: torch.Tensor) -> torch.Tensor:
    """B1/B2/B4's output for (B, H, Sq, D) q: (B, Sq, H, D) memory returned as
    the (B, H, Sq, D) view, so ``merge_heads`` of it is a view."""
    b, h, sq, d = q.shape
    return torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def _tma_stride_array(op, tensors):
    """(sb, sh, ss) of each named (B, H, S, D) tensor, as a ctypes array;
    raises ValueError, naming the tensor, where ``tma_strides`` does."""
    strides = []
    for name, x in tensors:
        try:
            strides += tma_strides(x)
        except ValueError as err:
            raise ValueError(f'{op}: {name} {err}') from None
    return (ctypes.c_longlong * len(strides))(*strides)


def _qkv_launch(op, kernel, q, k, v, lse, scale, head_dims):
    """Check q, k, v and launch B1, B2 (``lse`` given) or B4 into
    ``flash_output(q)``."""
    _check_cuda_inputs(op, (('q', q), ('k', k), ('v', v)), head_dims)
    if k.shape != v.shape:
        raise ValueError(f'{op}: k {tuple(k.shape)} and v {tuple(v.shape)} differ')
    if kernel == 'short' and k.shape[2] > SHORT_MAX_KEYS:
        raise ValueError(f'{op}: {k.shape[2]} keys; the kernel takes at most {SHORT_MAX_KEYS}')
    b, h, sq, d = q.shape
    out = flash_output(q)
    strides = _tma_stride_array(op, (('q', q), ('k', k), ('v', v), ('output', out)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if kernel == 'flash':
        err = _lib(kernel, q.dtype).dft_flash_attention_forward(
            *args, None if lse is None else lse.data_ptr(), b, h, sq, k.shape[2], d,
            _DTYPE_CODES[q.dtype], float(scale), strides, _stream(q))
    else:
        err = _lib(kernel, q.dtype).dft_short_attention_forward(
            *args, b, h, sq, k.shape[2], d, _DTYPE_CODES[q.dtype], float(scale), strides,
            _stream(q))
    if err != 0:
        raise RuntimeError(f'{op} kernel launch failed: cudaError {err} '
                           f'for q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}')
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """B1: (B, H, Sq, D) x (B, H, Sk, D) -> (B, H, Sq, D) in q's dtype, with
    fp32 softmax statistics and accumulation.  Non-causal, no mask.  On the
    card the inputs may be strided views (unit stride along D, 16-byte
    aligned strides, as ``tma_strides`` checks) and the output is the
    (B, H, Sq, D) view of (B, Sq, H, D) memory."""
    global launches
    if _on_host(q, k, v):
        return flash_attention_reference(q, k, v, scale)
    out = _qkv_launch('flash_attention', 'flash', q, k, v, None, scale, SUPPORTED_HEAD_DIMS)
    launches += 1
    return out


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             scale: float):
    """B2: B1's output and each row's logsumexp, (B, H, Sq) in fp32.  Takes
    and returns the layouts B1 does."""
    global lse_launches
    if _on_host(q, k, v):
        return flash_attention_with_lse_reference(q, k, v, scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _qkv_launch('flash_attention_with_lse', 'flash', q, k, v, lse, scale,
                      HEADMEAN_HEAD_DIMS)
    lse_launches += 1
    return out, lse


def headmean_probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
                   scale: float) -> torch.Tensor:
    """B3: head-mean normalised probabilities (B, Sq, Sk) in q's dtype from
    (B,H,Sq,D) q, (B,H,Sk,D) k and B2's (B,H,Sq) fp32 logsumexp; fp32
    accumulation, and no per-head (B,H,Sq,Sk) tensor.  On the card q and k
    may be strided views, as B1's inputs (``tma_strides``); the map is
    contiguous."""
    global headmean_launches
    if _on_host(q, k, lse):
        return headmean_probs_reference(q, k, lse, scale)
    op = 'headmean_probs'
    _check_cuda_inputs(op, (('q', q), ('k', k)), HEADMEAN_HEAD_DIMS)
    b, h, sq, d = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(f'{op}: lse must be a contiguous float32 {(b, h, sq)} '
                         f'tensor on {q.device}, got {lse.dtype} {tuple(lse.shape)} '
                         f'on {lse.device}')
    sk = k.shape[2]
    if b * sq * sk >= 2 ** 31:
        raise ValueError(f'{op}: a ({b}, {sq}, {sk}) map exceeds the launch limits')
    strides = _tma_stride_array(op, (('q', q), ('k', k)))
    out = torch.empty((b, sq, sk), dtype=q.dtype, device=q.device)
    err = _lib('headmean', q.dtype).dft_headmean_probs(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(), out.data_ptr(), b, h, sq, sk, d,
        _DTYPE_CODES[q.dtype], float(scale), strides, _stream(q))
    if err != 0:
        raise RuntimeError(f'{op} kernel launch failed: cudaError {err} '
                           f'for q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}')
    headmean_launches += 1
    return out


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """B4: (B, H, Sq, D) x (B, H, Sk, D) -> (B, H, Sq, D) in q's dtype, for
    Sk <= 512, with fp32 math whatever the input dtype and an exact (not
    online) softmax; the score matrix never reaches device memory.  Takes
    and returns the layouts B1 does."""
    global short_launches
    if _on_host(q, k, v):
        return short_attention_reference(q, k, v, scale)
    out = _qkv_launch('short_attention', 'short', q, k, v, None, scale, HEADMEAN_HEAD_DIMS)
    short_launches += 1
    return out


class _ShortAttentionDiff(torch.autograd.Function):
    """B4 forward; the backward differentiates the twin (the JAX custom VJP
    takes XLA's einsum-softmax VJP, not a kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return short_attention(q, k, v, scale=scale)

    @staticmethod
    def backward(ctx, grad):
        inputs = tuple(x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = short_attention_reference(*inputs, ctx.scale)
        return (*torch.autograd.grad(out, inputs, grad), None)


def short_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float) -> torch.Tensor:
    """``short_attention`` with gradients for q, k and v."""
    return _ShortAttentionDiff.apply(q, k, v, scale)


def _kernel_ready(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x`` in place: 16-byte aligned, with the
    strides ``tma_strides`` accepts."""
    if x.data_ptr() % 16:
        return False
    try:
        tma_strides(x)
    except ValueError:
        return False
    return True


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, grad: torch.Tensor, *, scale: float):
    """The backward of B1/B2: (dq, dk, dv) of softmax(q k^T * scale) v for
    the output gradient ``grad``, from B2's ``out`` and fp32 ``lse``
    (B, H, Sq).  On the card q, k, v and out are taken as B2 took them
    (strided views that ``tma_strides`` accepts); ``grad``, which autograd
    may hand over expanded or unaligned, is copied to a contiguous tensor
    first where the kernel cannot read it in place.  dq, dk and dv are the
    (B, H, S, D) views of (B, S, H, D) memory, as B1's output, in the
    inputs' dtype; dq is summed across key blocks in no fixed order, so it
    is not bitwise repeatable between calls (dk and dv are).  Widths are
    ``BWD_HEAD_DIMS``; any other (the VAE's d=512) raises ValueError.  On
    the host: ``flash_attention_bwd_reference``."""
    global bwd_launches
    if _on_host(q, k, v, grad):
        return flash_attention_bwd_reference(q, k, v, grad, scale)
    op = 'flash_attention_bwd'
    grad = grad.to(q.dtype)
    if not _kernel_ready(grad):
        grad = grad.contiguous()
    _check_cuda_inputs(op, (('q', q), ('k', k), ('v', v), ('out', out), ('grad', grad)),
                       BWD_HEAD_DIMS)
    if k.shape != v.shape or out.shape != q.shape or grad.shape != q.shape:
        raise ValueError(f'{op}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, '
                         f'out {tuple(out.shape)} and grad {tuple(grad.shape)} do not match')
    b, h, sq, d = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(f'{op}: lse must be a contiguous float32 {(b, h, sq)} tensor on '
                         f'{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}')
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = flash_output(q), flash_output(k), flash_output(v)
    if q.dtype == torch.float32:
        # the key blocks add their dq into dq itself
        dq.zero_()
        dq_acc = None
    else:
        # they add it into an fp32 accumulator, which the kernel converts
        dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    strides = _tma_stride_array(op, (('q', q), ('k', k), ('v', v), ('out', out),
                                     ('grad', grad), ('dq', dq), ('dk', dk), ('dv', dv)))
    err = _lib('flash_bwd', q.dtype).dft_flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[2], d,
        _DTYPE_CODES[q.dtype], float(scale), strides, _stream(q))
    if err != 0:
        raise RuntimeError(f'{op} kernel launch failed: cudaError {err} '
                           f'for q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}')
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """B1 with gradients, the counterpart of the JAX package's ``_flash_diff``
    custom VJP: the forward is B2 (``flash_attention_with_lse``), which
    saves each row's logsumexp; the backward is ``flash_attention_bwd``.
    On the host both run their twins."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_with_lse(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, grad, scale=ctx.scale), None)


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float) -> torch.Tensor:
    """``flash_attention`` with gradients for q, k and v (B2 forward, the
    backward kernel), for the attention ops to call wherever an input
    requires grad.  Takes and returns the layouts B1 does; on the card the
    width must be one of ``BWD_HEAD_DIMS`` (else ValueError, from B2)."""
    return _FlashAttention.apply(q, k, v, scale)
