"""NCHW resizes with torch ``F.interpolate`` semantics (port of
``diffusion_feature_tpu/ops/resize.py``, which reproduces them in JAX)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, align_corners=False, no antialiasing."""
    return F.interpolate(x, size=tuple(size), mode='bilinear', align_corners=False)


def interpolate_nearest_nchw(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode='nearest')
