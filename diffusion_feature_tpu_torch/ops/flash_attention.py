"""Flash-attention forward: the hand-written Hopper kernel and its plain twin.

Replaces ``diffusion_feature_tpu/ops/flash_attention.py::_flash_kernel`` (the
Pallas TPU kernel).  The kernel lives in ``csrc/flash_attention.cu``; it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, cached by source hash in ``_build/`` beside this
package, and called through ``ctypes`` on PyTorch's current stream.

What bounds it on an H100: at the main path's d=64 and 4096 tokens the
kernel does ~4000 flops per byte it reads, so it is bounded by tensor-core
flops (and the S^2 exponentials), not by memory.  The design keeps the
scores in registers, runs QK^T and PV on the tensor cores (``mma.sync``
m16n8k16, fp32 accumulation) and reads each K/V tile once per 64 query rows;
overlapping loads with compute (TMA, ``wgmma``, warp specialisation) is left
to later work.  See the source for the tile layout.

Routing: a CPU tensor goes to ``flash_attention_reference``; a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches.
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

SUPPORTED_HEAD_DIMS = (64, 128, 512)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SOURCE = Path(__file__).resolve().parent.parent / 'csrc' / 'flash_attention.cu'
_BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
               '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_lib = None


def is_flash_compatible(q_shape, k_shape, min_seq: int = 1024) -> bool:
    """The JAX package's gate (``is_flash_compatible``): long self-attention
    with 256-aligned sequence lengths, and the wide d=512 head only at
    >= 8192 tokens (the VAE mid block at 1024^2, where the explicit path's
    fp32 score tensor is 1 GiB per image).  The port adds one shape
    condition: the head dim must be one the kernel is built for."""
    *_, sq, d = q_shape
    sk = k_shape[-2]
    return (
        d in SUPPORTED_HEAD_DIMS
        and sq >= min_seq
        and sq % 256 == 0
        and sk % 256 == 0
        and (d <= 256 or sq >= 8192)
    )


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Plain twin of the kernel: fp32 scores, softmax and PV product, result
    cast to q's dtype.  (B, H, Sq, D) x (B, H, Sk, D) -> (B, H, Sq, D)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(scores.softmax(dim=-1), v.float()).to(q.dtype)


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); it is needed to build '
                           f'{_SOURCE.name} for the GPU')
    return found


def build() -> dict:
    """Compile the kernel library if its source changed and load it.

    Returns {'path', 'seconds', 'log'}: seconds is 0.0 when a cached build
    for this source hash was reused; log is nvcc/ptxas output of a fresh
    build (registers, shared memory, spills per kernel)."""
    global _lib
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + ' '.join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f'libdft_flash_attention_{digest}.so'
    seconds, log = 0.0, ''
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f'.tmp{os.getpid()}.so')
        start = time.perf_counter()
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, '-o', str(tmp), str(_SOURCE)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {_SOURCE} (exit {proc.returncode}):\n{log}')
        os.replace(tmp, path)
    if _lib is None or _lib._name != str(path):
        lib = ctypes.CDLL(str(path))
        fn = lib.dft_flash_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return {'path': str(path), 'seconds': seconds, 'log': log}


def _check_cuda_inputs(q, k, v):
    for name, x in (('q', q), ('k', k), ('v', v)):
        if x.device.type != 'cuda' or x.device != q.device:
            raise ValueError(f'flash_attention: {name} is on {x.device}, '
                             f'expected the CUDA device of q ({q.device})')
        if x.dtype != q.dtype or x.dtype not in _DTYPE_CODES:
            raise ValueError(f'flash_attention: {name} has dtype {x.dtype}; the kernel '
                             'takes float32, float16 or bfloat16, one dtype for q, k, v')
        if x.dim() != 4:
            raise ValueError(f'flash_attention: {name} must be (B, H, S, D), got {tuple(x.shape)}')
        if not x.is_contiguous():
            raise ValueError(f'flash_attention: {name} must be contiguous')
        if x.data_ptr() % 16:
            raise ValueError(f'flash_attention: {name} must be 16-byte aligned')
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f'flash_attention: q is on {q.device} but the current CUDA device '
                         f'is {torch.cuda.current_device()}')
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f'flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, '
                         f'v {tuple(v.shape)} do not match')
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f'flash_attention: head dim {d} not supported '
                         f'(kernel is built for {SUPPORTED_HEAD_DIMS})')
    if sq == 0 or k.shape[2] == 0:
        raise ValueError('flash_attention: empty sequence')
    if b * h > 65535 or q.numel() >= 2 ** 31 or k.numel() >= 2 ** 31:
        raise ValueError(f'flash_attention: {tuple(q.shape)} exceeds the launch limits')


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """(B, H, Sq, D) x (B, H, Sk, D) -> (B, H, Sq, D) in q's dtype, with fp32
    softmax statistics and accumulation.  Non-causal, no mask."""
    global launches
    if q.device.type == 'cpu' and k.device.type == 'cpu' and v.device.type == 'cpu':
        return flash_attention_reference(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    if _lib is None:
        build()
    out = torch.empty_like(q)
    b, h, sq, d = q.shape
    err = _lib.dft_flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq, k.shape[2], d,
        _DTYPE_CODES[q.dtype], float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'flash_attention kernel launch failed: cudaError {err} '
                           f'for q {tuple(q.shape)} {q.dtype}')
    launches += 1
    return out
