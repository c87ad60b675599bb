"""Segmentation heads and adapters (port of
``diffusion_feature_tpu/tasks/segmentation/heads.py``), as ``nn.Module``s
in NCHW.

The reference trains mmseg's UPerHead + FCNHead over adapted diffusion
features (segmentation/models/diffusion_segmentor.py, configs/ade_*.py):

  ResBlockAdapter  per-layer zero-init residual conv adapter (identity at
                   step 0: conv kernels and BN scales start at zero)
  ConvModule       conv + BN + ReLU
  UPerHead         PSP pooling on the last level + FPN fusion
  FCNHead          auxiliary head (conv blocks + classifier)

Every module takes ``train`` explicitly, as the Flax modules do, and keeps
the Flax modules' child names, so ``seg_head_from_jax`` maps a JAX tree by
name.  ``BatchNorm`` is Flax's (momentum 0.99, eps 1e-5, the biased batch
variance E[x^2] - E[x]^2 in the running average), which
``torch.nn.BatchNorm2d`` is not.  Resizes are ``jax.image.resize``'s
bilinear (``ops.resize.resize_bilinear_nchw``: antialiased where they
shrink).  Dropout2d drops whole channels per sample, drawn from an explicit
``torch.Generator``; without one there is no dropout, as JAX skips it
without a ``dropout_rng``.

Data parallelism (``set_data_parallel``, the trainer's ``--dp``): each
rank holds its rows of the batch; BatchNorm's training statistics are the
whole batch's (its sums all-reduced, with their gradient), and dropout
draws the whole batch's masks and keeps the rank's rows, so a step equals
the one-device step on the whole batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear_nchw
from ...parallel.mesh import all_reduce_with_grad
from ...store import adaptive_avg_pool2d


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channels of NCHW maps or (N, C) rows:
    in training the batch mean and biased variance (E[x^2] - E[x]^2,
    clamped at 0) normalise, and the running statistics move by
    ``momentum`` (new = momentum * old + (1 - momentum) * batch); in
    evaluation the running statistics normalise.  ``weight`` is Flax's
    scale, ``zero_scale`` its zero init."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))
        self.dp = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dims = (0,) + tuple(range(2, x.dim()))
        if train and self.dp is not None:
            # the whole batch's E[x] and E[x^2]: equal rows on every rank
            sums = all_reduce_with_grad(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]),
                                        self.dp)
            count = x.numel() // x.shape[1] * self.dp.size
            mean = sums[0] / count
            var = (sums[1] / count - mean * mean).clamp(min=0.0)
        elif train:
            mean = x.mean(dim=dims)
            var = ((x * x).mean(dim=dims) - mean * mean).clamp(min=0.0)
        if train:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def _conv(cin: int, cout: int, kernel: int, bias: bool = True, zero: bool = False) -> nn.Conv2d:
    """Flax ``nn.Conv`` with ``padding=kernel // 2``; ``zero`` is its zero
    kernel init (the adapters')."""
    conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=bias)
    conv.zero_init = zero
    if zero:
        nn.init.zeros_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class ResBlockAdapter(nn.Module):
    """x + BN(conv(relu(BN(conv(x))))) with every conv kernel and BN scale
    zero, so it starts as the identity (reference ResBlock :23-41).  NCHW
    in and out, fp32 compute."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = _conv(dim, dim, 3, zero=True)
        self.bn1 = BatchNorm(dim, zero_scale=True)
        self.conv2 = _conv(dim, dim, 3, zero=True)
        self.bn2 = BatchNorm(dim, zero_scale=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        h = F.relu(self.bn1(self.conv1(x), train))
        return x + self.bn2(self.conv2(h), train)


class ConvModule(nn.Module):
    """conv (no bias) + BN + ReLU (mmseg ConvModule)."""

    def __init__(self, cin: int, channels: int, kernel: int = 3):
        super().__init__()
        self.conv = _conv(cin, channels, kernel, bias=False)
        self.bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x), train))


def _dropout2d(x: torch.Tensor, ratio: float, train: bool,
               generator: Optional[torch.Generator], dp=None) -> torch.Tensor:
    """mmseg's Dropout2d: whole channels per sample, kept with 1 - ratio
    and scaled by 1 / (1 - ratio); nothing without a generator.  ``dp``
    (an ``Axis`` whose ranks hold equal rows): the whole batch's draws, this
    rank's rows of them."""
    if not train or ratio <= 0 or generator is None:
        return x
    n = x.shape[0] if dp is None else x.shape[0] * dp.size
    keep = torch.rand((n, x.shape[1], 1, 1), generator=generator, device=x.device) >= ratio
    if dp is not None:
        keep = dp.take(keep, 0)
    return x * keep.to(x.dtype) / (1 - ratio)


class UPerHead(nn.Module):
    """Unified Perceptual Parsing head: PSP on the last input level + FPN.
    ``in_channels`` per level, in the order of the inputs; logits at the
    first level's resolution."""

    def __init__(self, in_channels: Sequence[int], channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), num_classes: int = 150,
                 dropout_ratio: float = 0.1):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        self.num_classes, self.dropout_ratio = num_classes, dropout_ratio
        levels = len(in_channels)
        for i in range(len(self.pool_scales)):
            self.add_module(f'psp_{i}', ConvModule(in_channels[-1], channels, 1))
        self.bottleneck = ConvModule(in_channels[-1] + len(self.pool_scales) * channels,
                                     channels, 3)
        for i in range(levels - 1):
            self.add_module(f'lateral_{i}', ConvModule(in_channels[i], channels, 1))
            self.add_module(f'fpn_{i}', ConvModule(channels, channels, 3))
        self.fpn_bottleneck = ConvModule(levels * channels, channels, 3)
        self.conv_seg = _conv(channels, num_classes, 1)
        self.dp = None

    def forward(self, inputs: List[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xs = [x.float() for x in inputs]
        deep = xs[-1]
        hw = deep.shape[2:]
        # PSP: exact adaptive pooling (mmseg's AdaptiveAvgPool2d)
        psp_outs = [deep]
        for i, scale in enumerate(self.pool_scales):
            pooled = getattr(self, f'psp_{i}')(adaptive_avg_pool2d(deep, (scale, scale)), train)
            psp_outs.append(resize_bilinear_nchw(pooled, hw))
        psp = self.bottleneck(torch.cat(psp_outs, dim=1), train)
        # FPN laterals (all levels but the last) and the top-down pathway
        laterals = [getattr(self, f'lateral_{i}')(x, train) for i, x in enumerate(xs[:-1])]
        laterals.append(psp)
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear_nchw(laterals[i],
                                                                     laterals[i - 1].shape[2:])
        fpn_outs = [getattr(self, f'fpn_{i}')(laterals[i], train)
                    for i in range(len(laterals) - 1)] + [laterals[-1]]
        target = fpn_outs[0].shape[2:]
        fpn_outs = [resize_bilinear_nchw(f, target) for f in fpn_outs]
        out = self.fpn_bottleneck(torch.cat(fpn_outs, dim=1), train)
        out = _dropout2d(out, self.dropout_ratio, train, generator, self.dp)
        return self.conv_seg(out)


class FCNHead(nn.Module):
    """Auxiliary FCN head (mmseg FCNHead; the configs' num_convs=1)."""

    def __init__(self, in_channels: int, channels: int = 512, num_convs: int = 1,
                 num_classes: int = 150, dropout_ratio: float = 0.1):
        super().__init__()
        self.num_convs, self.dropout_ratio = num_convs, dropout_ratio
        for i in range(num_convs):
            self.add_module(f'conv_{i}', ConvModule(in_channels if i == 0 else channels,
                                                    channels, 3))
        self.conv_seg = _conv(channels, num_classes, 1)
        self.dp = None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x.float()
        for i in range(self.num_convs):
            h = getattr(self, f'conv_{i}')(h, train)
        return self.conv_seg(_dropout2d(h, self.dropout_ratio, train, generator, self.dp))


def set_data_parallel(module: nn.Module, dp) -> nn.Module:
    """Give every module under ``module`` that takes one (the BatchNorms,
    the heads' dropout, the segmentor's loss) the dp ``Axis``
    (``parallel/mesh.py``) whose ranks hold the batch's rows."""
    for m in module.modules():
        if hasattr(m, 'dp'):
            m.dp = dp
    return module


def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's initial state for every conv and BN under ``module``: conv
    kernels lecun-normal (a normal of variance 1/fan_in truncated at two
    standard deviations, drawn from ``generator``) or zero where the Flax
    module zero-initialises them (the adapters'), biases zero, BN scales
    one (the adapters': zero), running mean 0 and variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                if getattr(m, 'zero_init', False):
                    m.weight.zero_()
                else:
                    std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                    draw = torch.randn(m.weight.shape, generator=generator,
                                       device=generator.device)
                    m.weight.copy_(torch.fmod(draw, 2.0) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(0.0 if m.zero_scale else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return module
