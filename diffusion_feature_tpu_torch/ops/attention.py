"""Attention ops with optional score-map export (port of
``diffusion_feature_tpu/ops/attention.py``).

The default path never materialises scores: shapes that pass
``is_flash_compatible`` go to the flash kernel, the rest to an explicit
fp32-score softmax.  The explicit path is also what a ``*-map`` tap uses,
since it needs the probabilities.  The attention store (the facade's
``attention=``) takes ``attention_with_headmean_heads``: the flash kernel
with logsumexp, then the streaming head-mean kernel, so only the head-mean
map reaches memory.

Gradients: wherever q, k or v requires grad (``train_unet``, prompt
tuning), a shape the gate sends to B1 takes ``flash_attention_diff``
instead (B2 forward, the backward kernel), and the store's B2 + B3 pair a
custom backward through the explicit path, as the JAX package's custom
VJPs do; without grad the routing and the launches stay as they were.

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
    HEADMEAN_HEAD_DIMS, SUPPORTED_HEAD_DIMS, flash_attention, flash_attention_diff,
    flash_attention_with_lse, headmean_probs, is_flash_compatible,
)


def _use_flash(qh, kh, min_seq: int = 1024, head_dims=SUPPORTED_HEAD_DIMS,
               q_len: Optional[int] = None) -> bool:
    """The gate, with the kernels' head widths where they run (the card).
    ``q_len``: the global query count where sequence parallelism holds a
    piece of it (JAX's gate sees the global shapes)."""
    q_shape = qh.shape if q_len is None else (*qh.shape[:-2], q_len, qh.shape[-1])
    return is_flash_compatible(q_shape, kh.shape, min_seq,
                               head_dims if qh.device.type == 'cuda' else None)


def _needs_grad(*tensors) -> bool:
    """Whether autograd records this call: grad mode on and an input that
    requires grad."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _flash(qh, kh, vh, scale):
    """B1, or with gradients ``flash_attention_diff``."""
    if _needs_grad(qh, kh, vh):
        return flash_attention_diff(qh, kh, vh, scale=scale)
    return flash_attention(qh, kh, vh, scale=scale)


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
    accumulated in fp32 and cast back.  The scores always come from q and k
    cast to fp32, which is what SD-2.1's ``upcast_attention`` asks of this
    path (JAX ``ops/attention.py:195-196``; without it JAX accumulates the
    same exact products in fp32), so the explicit path needs no switch.
    Where upcast does change the computation, the store's kernels take fp32
    q, k and v: the U-Net ``Attention`` casts them."""
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
                          mask: Optional[torch.Tensor] = None,
                          q_len: Optional[int] = None) -> torch.Tensor:
    """Attention on pre-split heads (B,H,S,D) without score export: the flash
    kernel where the gate admits the shape (of ``q_len`` queries where
    given), explicit softmax otherwise."""
    scale = qh.shape[-1] ** -0.5 if scale is None else scale
    if mask is None and _use_flash(qh, kh, q_len=q_len):
        return _flash(qh, kh, vh, scale)
    out, _ = _softmax_attention(qh, kh, vh, scale, mask)
    return out


def attention_fused(q, k, v, heads: int, *, scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    q_len: Optional[int] = None) -> torch.Tensor:
    """Attention on (B, S, inner) projections without score export; the
    gate sees ``q_len`` queries where given."""
    d = q.shape[-1] // heads
    scale = d ** -0.5 if scale is None else scale
    qh, kh, vh = split_heads(q, heads), split_heads(k, heads), split_heads(v, heads)
    if mask is None and _use_flash(qh, kh, q_len=q_len):
        return merge_heads(_flash(qh, kh, vh, scale))
    out, _ = _softmax_attention(qh, kh, vh, scale, mask)
    return merge_heads(out)


def _headmean_explicit(qh, kh, vh, scale):
    out, probs = _softmax_attention(qh, kh, vh, scale, None)
    return out, probs.mean(dim=1)


def _headmean_kernels(qh, kh, vh, scale):
    """B2 then B3 over the same head-split views read in place."""
    out, lse = flash_attention_with_lse(qh, kh, vh, scale=scale)
    return out, headmean_probs(qh, kh, lse, scale=scale)


class _HeadmeanKernelPath(torch.autograd.Function):
    """The JAX package's ``_headmean_kernel_path`` custom VJP: the forward
    is B2 + B3, the backward autograd through ``_headmean_explicit`` (JAX's
    ``_headmean_bwd``), which materialises the per-head probabilities of
    one layer while it runs."""

    @staticmethod
    def forward(ctx, qh, kh, vh, scale):
        ctx.save_for_backward(qh, kh, vh)
        ctx.scale = scale
        return _headmean_kernels(qh, kh, vh, scale)

    @staticmethod
    def backward(ctx, grad_out, grad_mean):
        inputs = tuple(x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out, mean_p = _headmean_explicit(*inputs, ctx.scale)
        return (*torch.autograd.grad((out, mean_p), inputs, (grad_out, grad_mean)), None)


def attention_with_headmean_heads(qh, kh, vh, *, scale: Optional[float] = None,
                                  q_len: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention plus HEAD-MEAN probabilities on pre-split heads (B,H,S,D):
    (out (B,H,Sq,D), mean_probs (B,Sq,Sk)), the attention store's path.
    Where the gate admits the shape (``min_seq=512``, as in JAX) the flash
    kernel with logsumexp (B2) and the head-mean kernel (B3) stream the
    score tiles, so the per-head (B,H,Sq,Sk) tensor never exists; otherwise
    the explicit softmax's probabilities are averaged over heads.  With
    gradients the kernel pair's backward is the explicit path's
    (``_HeadmeanKernelPath``, JAX's custom VJP).  The gate sees ``q_len``
    queries where given."""
    scale = qh.shape[-1] ** -0.5 if scale is None else scale
    if _use_flash(qh, kh, min_seq=512, head_dims=HEADMEAN_HEAD_DIMS, q_len=q_len):
        if _needs_grad(qh, kh, vh):
            return _HeadmeanKernelPath.apply(qh, kh, vh, scale)
        return _headmean_kernels(qh, kh, vh, scale)
    return _headmean_explicit(qh, kh, vh, scale)
