"""NCHW resizes with torch ``F.interpolate`` semantics (port of
``diffusion_feature_tpu/ops/resize.py``, which reproduces them in JAX), and
``jax.image.resize``'s bilinear where the JAX package calls it directly
(the segmentation heads and losses)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def interpolate_bilinear_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, align_corners=False, no antialiasing."""
    return F.interpolate(x, size=tuple(size), mode='bilinear', align_corners=False)


def interpolate_nearest_nchw(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode='nearest')


_WEIGHTS = {}   # (in, out, device, dtype) -> the weight matrix


def _bilinear_weights(in_size: int, out_size: int, device, dtype) -> torch.Tensor:
    """(out_size, in_size) weights of ``jax.image.resize``'s bilinear along
    one axis (its ``compute_weight_mat`` with antialiasing): half-pixel
    centres, the triangle kernel widened by in/out where the axis shrinks,
    each output's weights over the input normalised to sum to one."""
    key = (in_size, out_size, device, dtype)
    if key not in _WEIGHTS:
        inv = in_size / out_size
        sample = (np.arange(out_size) + 0.5) * inv - 0.5
        tri = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(in_size)) / max(inv, 1.0))
        _WEIGHTS[key] = torch.tensor(tri / tri.sum(axis=1, keepdims=True), dtype=dtype,
                                     device=device)
    return _WEIGHTS[key]


def resize_bilinear_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., method='bilinear')`` on NCHW: half-pixel
    centres, antialiased where it shrinks, as two products with the axes'
    weight matrices, so its backward is two products as well
    (``F.interpolate``'s backward adds into the input with atomics, which
    upsampling 150 class maps from 8 x 8 to 512 x 512 made 42% of a
    training step on an H100)."""
    h, w = size
    if (h, w) == tuple(x.shape[2:]):
        return x
    rows = _bilinear_weights(x.shape[2], h, x.device, x.dtype)
    cols = _bilinear_weights(x.shape[3], w, x.device, x.dtype)
    return torch.matmul(rows, torch.matmul(x, cols.t()))
