"""Rotary position embeddings shared by the DiTs (port of ``rope_cos_sin``
and ``apply_rope`` in ``diffusion_feature_tpu/models/flux.py``).

The tables are built on the host in float64 numpy from integer or
fractional position ids, one rotary frequency ladder per axis, and come
back as float32 (S, head_dim) arrays; a model turns them into tensors once
per grid and device.  The rotation itself runs in float32 and is cast back
to the input's dtype, as diffusers' ``apply_rotary_emb`` (real form,
``use_real_unbind_dim=-1``) does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def rope_cos_sin(ids: np.ndarray, axes_dim: Sequence[int],
                 theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """FluxPosEmbed numerics (repeat-interleaved real form, float64 host
    math): ids (S, n_axes) -> cos, sin (S, sum(axes_dim)), float32."""
    coss, sins = [], []
    for i, d in enumerate(axes_dim):
        freqs = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
        ang = np.asarray(ids[:, i], np.float64)[:, None] * freqs[None, :]
        coss.append(np.repeat(np.cos(ang), 2, axis=1))
        sins.append(np.repeat(np.sin(ang), 2, axis=1))
    return (np.concatenate(coss, axis=1).astype(np.float32),
            np.concatenate(sins, axis=1).astype(np.float32))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D) rotated by the (S, D) tables: each pair (x[2i],
    x[2i+1]) turns by its angle, in float32, cast back to x's dtype."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    rotated = torch.stack([-x2, x1], dim=-1).reshape(xf.shape)
    return (xf * cos[None, None] + rotated * sin[None, None]).to(x.dtype)
