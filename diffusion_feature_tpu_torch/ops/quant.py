"""Weight-only int8 dense layers (port of ``diffusion_feature_tpu/ops/quant.py``).

The reference loads Flux's T5-XXL in 8-bit (bitsandbytes,
feature/components/models.py:158-163); the JAX package quantizes Flux's
transformer projections and the T5 projections to symmetric per-output-channel
int8 with an fp32 scale, and XLA fuses the dequantize into the dot's operand
pipeline so that no full-precision copy of a weight exists.  Here that fused
product is written by hand for Hopper, the W8A16 kernels of
``csrc/w8a16.cuh`` (one library per type: ``w8a16_bf16.cu``, ``w8a16_fp16.cu``,
``w8a16_f32.cu``, built with the attention kernels by
``flash_attention.build``): ``y = x @ deq(q, s)^T + b`` with each int8 tile
dequantized in shared memory or in registers, never in device memory.
``int8_route`` picks the kernel of each call: in bf16/fp16 a warp-specialised
TMA kernel (tiles of 128 or 256 rows) for more than ``STREAM_MAX_ROWS`` rows,
a weight-streaming kernel for the few-row calls (the adaLN projections' batch
rows), and the cp.async kernel for rows TMA cannot describe; in fp32 an FMA
kernel.

Layout: the port keeps PyTorch's (out, in) weight orientation, so
``weight_q`` is the transpose of JAX's ``kernel_q`` (in, out); ``scale`` is
the same (out,) fp32 vector.  ``quantize_int8`` computes exactly what JAX's
numpy does, so both packages hold the same bits for the same checkpoint.

Routing: a CPU or meta tensor goes to the plain twin
``int8_linear_reference`` (JAX's formula); a CUDA tensor launches the kernel
or raises.  ``int8_launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from . import flash_attention as _fa

#: Kernel launches since import (or since a caller reset them to 0).
int8_launches = 0

#: The W8A16 kernels, by the C entry's ``route``: the cp.async kernel (any
#: shape; fp32's FMA kernel), the TMA kernel on tiles of 128 and of 256 rows
#: of x, and the weight-streaming kernel.
ROUTES = ('staged', 'tma128', 'tma256', 'streaming')
#: The streaming kernel takes up to this many rows of x (two n8 tiles); on
#: an H100 it beat the TMA kernel at every M up to 16 (0.0120 against
#: 0.0326 ms at (2, 3072, 9216), 0.0303 against 0.0630 at (16, 3072, 18432):
#: ``tools/torch_extract_ab.py --int8_routes``).
STREAM_MAX_ROWS = 16
#: Output columns of a tile of the TMA kernel, and the tiles of a cluster
#: (neighbouring column tiles that share their x tile).
TILE_COLS, CLUSTER = 128, 2
#: A tile of 256 rows of x takes about this many times one of 128 rows
#: (1.36 to 1.52 on an H100, the same sweep), so ``int8_route`` weighs the
#: waves of 256-row tiles by it against the waves of 128-row ones.
WIDE_TILE_COST = 1.5

_sm_counts = {}


def int8_route(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool, sms: int) -> int:
    """The index in ``ROUTES`` of the kernel that computes an (m, k) x (n, k)
    W8A16 product in ``dtype`` on a card of ``sms`` SMs; ``aligned``: x and
    the weight start on 16-byte boundaries.  fp32, and rows TMA cannot
    describe (k not a multiple of 16, or a base not aligned), go to the
    cp.async kernel; up to ``STREAM_MAX_ROWS`` rows to the streaming kernel;
    more to the TMA kernel, on tiles of 256 or 128 rows of x, whichever
    takes fewer waves of the card's SMs once a wave of 256-row tiles counts
    ``WIDE_TILE_COST`` (the sweep's pick at every shape it timed)."""
    if dtype == torch.float32 or k % 16 or not aligned:
        return 0
    if m <= STREAM_MAX_ROWS:
        return 3

    def cdiv(a, b):
        return (a + b - 1) // b

    def waves(rows):   # CTAs come in clusters of neighbouring column tiles
        return cdiv(cdiv(m, rows) * cdiv(cdiv(n, TILE_COLS), CLUSTER) * CLUSTER, sms)
    return 2 if WIDE_TILE_COST * waves(256) <= waves(128) else 1


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def quantize_int8(w: torch.Tensor, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight -> ((out, in) int8, (out,) fp32 scale),
    symmetric per output channel: scale = absmax / 127 (1 for an all-zero
    channel), q = round-half-even(w / scale) clipped to +-127.  In fp32 on
    ``w``'s device, bit for bit what the JAX package's numpy computes (both
    divisions are tensor by tensor, so neither becomes a multiply by a
    reciprocal).  ``absmax`` (out,) fp32: the channels' maxima where ``w``
    holds only some input columns of the whole weight (a row-parallel
    shard), so its part is the whole weight's quantization cut."""
    w = w.to(torch.float32, copy=True)
    if absmax is None:
        absmax = w.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = w.div_(scale[:, None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(weight_q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(out, in) int8 and (out,) scale -> the (out, in) weight in ``dtype``:
    q converted exactly, times the scale rounded to ``dtype``, the product
    rounded to it (JAX's ``dequantize_int8``)."""
    return weight_q.to(dtype) * scale.to(dtype)[:, None]


def int8_linear_reference(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the W8A16 kernel, the JAX ``Int8Dense`` exactly:
    ``x @ (q * s)^T`` in x's dtype, then the bias in that dtype."""
    dt = x.dtype
    y = x @ dequantize_int8(weight_q, scale, dt).T
    if bias is not None:
        y = y + bias.to(dt)
    return y


def _check_cuda(x, weight_q, scale, bias):
    op = 'int8_linear'
    n, k = weight_q.shape
    tensors = [('x', x), ('weight_q', weight_q), ('scale', scale)]
    if bias is not None:
        tensors.append(('bias', bias))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f'{op}: {name} is on {t.device}, x on {x.device}')
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f'{op}: x is on {x.device} but the current CUDA device is '
                         f'{torch.cuda.current_device()}')
    if x.dtype not in _fa._DTYPE_CODES:
        raise ValueError(f'{op}: x has dtype {x.dtype}; the kernel takes float32, float16 '
                         'or bfloat16')
    if weight_q.dtype != torch.int8 or weight_q.dim() != 2 or not weight_q.is_contiguous():
        raise ValueError(f'{op}: weight_q must be a contiguous (out, in) int8 tensor, got '
                         f'{weight_q.dtype} {tuple(weight_q.shape)}')
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,) or not scale.is_contiguous():
        raise ValueError(f'{op}: scale must be a contiguous float32 ({n},) tensor, got '
                         f'{scale.dtype} {tuple(scale.shape)}')
    if bias is not None and (bias.dtype != x.dtype or tuple(bias.shape) != (n,)
                             or not bias.is_contiguous()):
        raise ValueError(f'{op}: bias must be a contiguous {x.dtype} ({n},) tensor, got '
                         f'{bias.dtype} {tuple(bias.shape)}')
    if x.shape[-1] != k:
        raise ValueError(f'{op}: x {tuple(x.shape)} does not take a ({n}, {k}) weight')


def int8_linear(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A16: ``x (..., K) @ deq(weight_q (N, K), scale (N,))^T + bias`` in
    x's dtype with fp32 sums, the dequantize in shared memory or registers,
    on the kernel ``int8_route`` picks.  On the card x is taken as
    contiguous (M, K) rows (a strided x is copied first); the output is a
    new contiguous (..., N) tensor.  On the host: the twin."""
    global int8_launches
    if _fa._on_host(x, weight_q, scale):
        return int8_linear_reference(x, weight_q, scale, bias)
    _check_cuda(x, weight_q, scale, bias)
    n, k = weight_q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    route = int8_route(m, n, k, x.dtype, weight_q.data_ptr() % 16 == 0, _sm_count(x.device))
    # the cp.async kernels' grids hold N in their second dimension (at most
    # 65535 tiles of 64 columns in fp32, 128 in bf16/fp16); the others are 1-d
    cols = 64 if x.dtype == torch.float32 else 128
    if (m * k >= 2 ** 31 or m * n >= 2 ** 31 or n * k >= 2 ** 31
            or (route == 0 and (n + cols - 1) // cols > 65535)):
        raise ValueError(f'int8_linear: ({m}, {k}) x ({n}, {k}) exceeds the launch limits')
    lib = _fa._lib('w8a16', x.dtype)
    err = lib.dft_w8a16_linear(x2.data_ptr(), weight_q.data_ptr(), scale.data_ptr(),
                               None if bias is None else bias.data_ptr(), out.data_ptr(),
                               m, n, k, _fa._DTYPE_CODES[x.dtype], route, _fa._stream(x))
    if err != 0:
        raise RuntimeError(f'int8_linear kernel launch failed: cudaError {err} for x '
                           f'{tuple(x2.shape)} weight {tuple(weight_q.shape)} {x.dtype} '
                           f'on the {ROUTES[route]} kernel')
    int8_launches += 1
    return out.reshape(*lead, n)


class _Int8LinearFunction(torch.autograd.Function):
    """The W8A16 product with a gradient for x (and the bias): the JAX
    package differentiates ``x @ (q * s)`` with XLA, so the backward is the
    plain product ``dx = grad @ deq(W)``.  The int8 weight and its scale
    take no gradient."""

    @staticmethod
    def forward(ctx, x, weight_q, scale, bias):
        ctx.save_for_backward(weight_q, scale)
        return int8_linear(x, weight_q, scale, bias)

    @staticmethod
    def backward(ctx, grad):
        weight_q, scale = ctx.saved_tensors
        dx = grad @ dequantize_int8(weight_q, scale, grad.dtype)
        dbias = grad.reshape(-1, grad.shape[-1]).sum(0) if ctx.needs_input_grad[3] else None
        return dx, None, None, dbias


class Int8Linear(nn.Module):
    """Drop-in for ``nn.Linear`` with an int8 weight-only weight: the buffers
    ``weight_q`` (out, in) int8 and ``scale`` (out,) fp32, and a ``bias``
    parameter in the compute dtype where the layer has one.  Built with
    zeros and unit scales: it is filled from a checkpoint, whose
    full-precision ``weight`` ``models/convert.load_state_into`` quantizes
    as it loads.  A cast of the module (``module.to(dtype=...)``) leaves
    ``scale`` in fp32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.register_buffer('weight_q', torch.zeros((out_features, in_features),
                                                     dtype=torch.int8))
        self.register_buffer('scale', torch.ones(out_features, dtype=torch.float32))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        else:
            self.register_parameter('bias', None)

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != torch.float32:
            self.scale = scale.to(self.scale.device)
        return self

    def forward(self, x):
        return _Int8LinearFunction.apply(x, self.weight_q, self.scale, self.bias)


def linear_factory(quantize: bool):
    """``(in, out, bias=True) -> module``: ``Int8Linear`` where ``quantize``,
    else ``nn.Linear`` (the models' projection factory, JAX's ``_dense``)."""
    return Int8Linear if quantize else nn.Linear


def has_int8(module: nn.Module) -> bool:
    """Whether any submodule of ``module`` is an ``Int8Linear``."""
    return any(isinstance(m, Int8Linear) for m in module.modules())
