"""NCHW resizes with torch ``F.interpolate`` semantics (port of
``diffusion_feature_tpu/ops/resize.py``, which reproduces them in JAX), and
``jax.image.resize``'s bilinear where the JAX package calls it directly."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, align_corners=False, no antialiasing."""
    return F.interpolate(x, size=tuple(size), mode='bilinear', align_corners=False)


def interpolate_nearest_nchw(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode='nearest')


def resize_bilinear_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., method='bilinear')`` on NCHW: half-pixel
    centres, antialiased where it shrinks (a triangle kernel widened by the
    scale), which is ``F.interpolate``'s antialiased bilinear."""
    shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x, size=tuple(size), mode='bilinear', align_corners=False,
                         antialias=shrink)
