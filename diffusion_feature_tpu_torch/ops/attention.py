"""Attention ops with optional score-map export (port of
``diffusion_feature_tpu/ops/attention.py``).

The default path never materialises scores: shapes that pass
``is_flash_compatible`` go to the flash kernel, the rest to an explicit
fp32-score softmax.  The explicit path is also what a ``*-map`` tap uses,
since it needs the probabilities.  The attention store (the facade's
``attention=``) takes ``attention_with_headmean_heads``: the flash kernel
with logsumexp, then the streaming head-mean kernel, so only the head-mean
map reaches memory.

The kernels are built for some head widths only; that condition binds on
the card.  A CPU (or meta) tensor runs the kernels' plain twins, which take
any width, so there the routing is the JAX package's exactly.  B4
(``short_attention``) is not routed to, as in the JAX package.

Public functions take q/k/v in the pre-head-split layout (B, S, inner), so
the q/k/v taps observe the same tensors as the reference; ``*_heads``
variants take (B, H, S, D).  The kernels read the head-split views in
place (B1/B2 write (B, S, H, D) memory), so no copy surrounds them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import (
    HEADMEAN_HEAD_DIMS, SUPPORTED_HEAD_DIMS, flash_attention, flash_attention_with_lse,
    headmean_probs, is_flash_compatible,
)


def _use_flash(qh, kh, min_seq: int = 1024, head_dims=SUPPORTED_HEAD_DIMS) -> bool:
    """The gate, with the kernels' head widths where they run (the card)."""
    return is_flash_compatible(qh.shape, kh.shape, min_seq,
                               head_dims if qh.device.type == 'cuda' else None)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D)."""
    b, s, inner = x.shape
    return x.reshape(b, s, heads, inner // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _softmax_attention(qh, kh, vh, scale, mask):
    """Explicit attention on heads with the JAX package's numerics: fp32
    scores (plus mask), softmax, probabilities cast to the input dtype, PV
    accumulated in fp32 and cast back.  Scores are fp32 whatever the input
    dtype, which is what SD-2.1's ``upcast_attention`` asks for, so the port
    has no upcast switch."""
    dtype = qh.dtype
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    probs = scores.softmax(dim=-1).to(dtype)
    out = torch.matmul(probs.float(), vh.float()).to(dtype)
    return out, probs


def attention_with_probs(q, k, v, heads: int, *, scale: Optional[float] = None,
                         mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit attention returning (out (B,Sq,inner), probs (B,H,Sq,Sk))."""
    d = q.shape[-1] // heads
    scale = d ** -0.5 if scale is None else scale
    out, probs = _softmax_attention(split_heads(q, heads), split_heads(k, heads),
                                    split_heads(v, heads), scale, mask)
    return merge_heads(out), probs


def attention_with_probs_heads(qh, kh, vh, *, scale: Optional[float] = None,
                               mask: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit attention on pre-split heads (B,H,S,D) returning
    (out (B,H,Sq,D), probs (B,H,Sq,Sk))."""
    scale = qh.shape[-1] ** -0.5 if scale is None else scale
    return _softmax_attention(qh, kh, vh, scale, mask)


def attention_fused_heads(qh, kh, vh, *, scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention on pre-split heads (B,H,S,D) without score export: the flash
    kernel where the gate admits the shape, explicit softmax otherwise."""
    scale = qh.shape[-1] ** -0.5 if scale is None else scale
    if mask is None and _use_flash(qh, kh):
        return flash_attention(qh, kh, vh, scale=scale)
    out, _ = _softmax_attention(qh, kh, vh, scale, mask)
    return out


def attention_fused(q, k, v, heads: int, *, scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention on (B, S, inner) projections without score export."""
    d = q.shape[-1] // heads
    scale = d ** -0.5 if scale is None else scale
    qh, kh, vh = split_heads(q, heads), split_heads(k, heads), split_heads(v, heads)
    if mask is None and _use_flash(qh, kh):
        return merge_heads(flash_attention(qh, kh, vh, scale=scale))
    out, _ = _softmax_attention(qh, kh, vh, scale, mask)
    return merge_heads(out)


def _headmean_explicit(qh, kh, vh, scale):
    out, probs = _softmax_attention(qh, kh, vh, scale, None)
    return out, probs.mean(dim=1)


def attention_with_headmean_heads(qh, kh, vh, *, scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention plus HEAD-MEAN probabilities on pre-split heads (B,H,S,D):
    (out (B,H,Sq,D), mean_probs (B,Sq,Sk)), the attention store's path.
    Where the gate admits the shape (``min_seq=512``, as in JAX) the flash
    kernel with logsumexp (B2) and the head-mean kernel (B3) stream the
    score tiles, so the per-head (B,H,Sq,Sk) tensor never exists; otherwise
    the explicit softmax's probabilities are averaged over heads.
    Inference only: no backward."""
    scale = qh.shape[-1] ** -0.5 if scale is None else scale
    if _use_flash(qh, kh, min_seq=512, head_dims=HEADMEAN_HEAD_DIMS):
        # B2 and B3 read the same head-split views in place
        out, lse = flash_attention_with_lse(qh, kh, vh, scale=scale)
        return out, headmean_probs(qh, kh, lse, scale=scale)
    return _headmean_explicit(qh, kh, vh, scale)
