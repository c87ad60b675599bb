"""U-Net and DiT building blocks with activation taps (port of
``diffusion_feature_tpu/models/layers.py``; block math promoted from the
golden-parity transcriptions in ``tests/torch_ref.py``).

Parameter names follow the diffusers checkpoint keys.  Tensors are NCHW
inside the U-Net; transformer blocks work on (B, S, C) tokens.  Tap call
sites match the reference overlay:
  ResnetBlock2D 'increment'/'out'   <- diffusers models/resnet.py:371-377
  BasicTransformerBlock 'out'       <- models/attention.py:589-590
  FeedForward 'inner'               <- models/attention.py:1253-1257
  Attention 'q'/'k'/'v'             <- models/attention_processor.py:1128-1131
  Attention 'map'                   <- components/attention.py:238-244
  Downsample2D/Upsample2D 'out'     <- downsampling.py:149-150, upsampling.py:192-193
  Transformer2DModel 'out'          <- transformers/transformer_2d.py:474-475
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    attention_fused, attention_with_headmean_heads, attention_with_probs, merge_heads,
    split_heads,
)
from ..ops.resize import interpolate_nearest_nchw
from ..parallel.mesh import cut_heads, head_mean, linear_cuts, row_linear, span, tap_gather
from ..taps import EMPTY, TapSite, TapSpec, child_id


#: Key of the ``feats`` dict under which attention-store maps are kept:
#: {'{place}_{self|cross}': [(B, Sq, Sk) head-mean maps, in call order]}.
ATTN_STORE = 'attn_store'


@dataclasses.dataclass(frozen=True)
class AttnStoreCfg:
    """Attention-store registration (the facade's ``attention=``): the U-Net
    region this attention lives in, the size band to keep in tokens per
    side, and the requested categories ('{place}_{self|cross}')."""
    place: str            # 'down' | 'mid' | 'up'
    min_size: int
    max_size: int
    categories: frozenset = frozenset()

    def slot(self, is_cross: bool):
        """(store key, (min, max) query tokens) of a self- or
        cross-attention of this place, or (None, None) when its category
        was not requested.  The JAX models compute head-mean maps in every
        place whose size is in the band and let XLA drop the ones the
        facade never reads; eager PyTorch cannot drop them, so only a
        requested category takes the store path, and every other attention
        stays on the fused path, which computes the same output."""
        key = f"{self.place}_{'cross' if is_cross else 'self'}"
        if key not in self.categories:
            return None, None
        return key, (self.min_size ** 2, self.max_size ** 2)


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: int = 10000) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` numerics (sinusoidal, fp32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> act -> linear_2 (diffusers TimestepEmbedding; act_fn
    'silu', or 'gelu', exact, as DeepFloyd-IF's)."""

    def __init__(self, in_dim: int, embed_dim: int, act_fn: str = 'silu'):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)
        self.act = F.gelu if act_fn == 'gelu' else F.silu

    def forward(self, x):
        return self.linear_2(self.act(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """norm1 -> SiLU -> conv1 (+ temb) -> norm2 -> SiLU -> conv2; taps
    'increment' (before the residual) and 'out'."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, eps: float = 1e-5,
                 taps: TapSpec = EMPTY, tap_name: str = ''):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(32, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.tap_site = TapSite(taps, tap_name, ('increment', 'out'))

    def forward(self, x, temb, feats=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        self.tap_site.put(feats, 'increment', h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        out = x + h
        self.tap_site.put(feats, 'out', out)
        return out


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; tap 'out'."""

    def __init__(self, channels: int, taps: TapSpec = EMPTY, tap_name: str = ''):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        self.tap_site = TapSite(taps, tap_name, ('out',))

    def forward(self, x, feats=None):
        x = self.conv(x)
        self.tap_site.put(feats, 'out', x)
        return x


class Upsample2D(nn.Module):
    """2x nearest upsample + 3x3 conv; tap 'out'."""

    def __init__(self, channels: int, taps: TapSpec = EMPTY, tap_name: str = ''):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.tap_site = TapSite(taps, tap_name, ('out',))

    def forward(self, x, feats=None):
        x = interpolate_nearest_nchw(x, (x.shape[2] * 2, x.shape[3] * 2))
        x = self.conv(x)
        self.tap_site.put(feats, 'out', x)
        return x


class Attention(nn.Module):
    """Multi-head attention with q/k/v/map taps.  q/k/v taps observe the
    pre-head-split (B, S, inner) projections; 'map' is the per-head
    post-softmax (B, H, Sq, Sk).  With ``attn_store`` the head-mean map of
    a query count inside the size band is kept in ``feats[ATTN_STORE]``.
    Without a requested map or store the fused path (flash kernel where the
    gate admits the shape) runs.  ``upcast`` (SD-2.1's ``upcast_attention``)
    hands the store's kernels fp32 q, k and v; the explicit path's scores
    are fp32 anyway and the flash path ignores it, as in the JAX package.
    ``qkv_bias``: biased q/k/v projections (the DiTs').
    ``plain`` (set by ``UNet2DConditionModel.forward(plain=True)``) runs
    every attention on the fused path, with no taps and no store.
    ``parallelize`` (``parallel/mesh.py``): under tp this rank's heads;
    under sp (a DiT's ``seq``) its query tokens, with the self-attention's
    K and V gathered over the sequence."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None,
                 taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None, is_cross: bool = False,
                 upcast: bool = False, qkv_bias: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = query_dim if cross_attention_dim is None else cross_attention_dim
        self.heads = self.heads_total = heads
        self.head_dim = dim_head
        self.upcast = upcast
        self.plain = False
        self.tp = self.seq = None
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        self.tap_site = TapSite(taps, tap_name, ('q', 'k', 'v', 'map'))
        self.store_key, self.store_band = (attn_store.slot(is_cross) if attn_store is not None
                                           else (None, None))

    def parallelize(self, tp, seq):
        """Keep this rank's heads of ``tp`` (q/k/v rows, to_out.0's
        columns) and attend from the ``seq`` tokens; the taps' gathers.
        Returns the cuts."""
        cuts = {} if tp is None else cut_heads(self, tp, ('to_q', 'to_k', 'to_v'), ('to_out.0',))
        self.seq = seq
        # self-attention K/V are gathered over the sequence before the taps
        self.tap_site.gathers = {'q': tap_gather((seq, 1), (tp, -1)),
                                 'k': tap_gather((tp, -1)), 'v': tap_gather((tp, -1)),
                                 'map': tap_gather((tp, 1), (seq, 2))}
        return cuts

    def forward(self, x, context=None, feats=None, mask=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        seq = self.seq
        if seq is not None and context is None:
            k, v = seq.gather(k), seq.gather(v)
        q_len = None if seq is None else seq.n
        if self.plain:
            out = attention_fused(q, k, v, self.heads, mask=mask, q_len=q_len)
            return row_linear(self.to_out[0], out, self.tp)
        self.tap_site.put(feats, 'q', q)
        self.tap_site.put(feats, 'k', k)
        self.tap_site.put(feats, 'v', v)
        # size-band filter on the query token count (components/attention.py:113-114)
        n_q = x.shape[1] if seq is None else seq.n
        store = self.store_key is not None and self.store_band[0] <= n_q <= self.store_band[1]
        if self.tap_site.wants('map'):
            out, probs = attention_with_probs(q, k, v, self.heads, mask=mask)
            self.tap_site.put(feats, 'map', probs)
            mean_p = probs.mean(dim=1) if store else None
        elif store and mask is None:
            # head-mean kernels: the per-head (B,H,Sq,Sk) tensor never exists
            heads = [split_heads(t, self.heads) for t in (q, k, v)]
            if self.upcast:   # fp32 kernels (JAX models/layers.py:205-208)
                heads = [t.float() for t in heads]
            out_h, mean_p = attention_with_headmean_heads(*heads, q_len=q_len)
            out = merge_heads(out_h).to(q.dtype)
        elif store:
            out, probs = attention_with_probs(q, k, v, self.heads, mask=mask)
            mean_p = probs.mean(dim=1)
        else:
            out, mean_p = attention_fused(q, k, v, self.heads, mask=mask, q_len=q_len), None
        if mean_p is not None and feats is not None:
            mean_p = head_mean(mean_p, self.tp, self.heads, self.heads_total).to(q.dtype)
            if seq is not None:
                mean_p = seq.gather(mean_p)
            feats.setdefault(ATTN_STORE, {}).setdefault(self.store_key, []).append(mean_p)
        return row_linear(self.to_out[0], out, self.tp)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class GELU(nn.Module):
    """proj -> GELU (diffusers' GELU activation block); tanh-approximate
    for activation_fn='gelu-approximate' (the DiTs')."""

    def __init__(self, dim: int, inner: int, approximate: str = 'none', linear=nn.Linear):
        super().__init__()
        self.proj = linear(dim, inner)
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(self.proj(x), approximate=self.approximate)


class FeedForward(nn.Module):
    """GEGLU (or, with activation_fn 'gelu'/'gelu-approximate', GELU) MLP
    of ``inner`` (default 4 * dim) hidden units; tap 'inner' on the
    activation (after net[0]).  ``linear`` builds the GELU MLP's two
    projections (Flux passes its int8 factory)."""

    def __init__(self, dim: int, taps: TapSpec = EMPTY, tap_name: str = '',
                 activation_fn: str = 'geglu', inner: Optional[int] = None, linear=nn.Linear):
        super().__init__()
        inner = dim * 4 if inner is None else inner
        if activation_fn == 'geglu':
            act = GEGLU(dim, inner)
        else:
            act = GELU(dim, inner, 'tanh' if activation_fn == 'gelu-approximate' else 'none',
                       linear)
        self.net = nn.ModuleList([act, nn.Identity(), linear(inner, dim)])
        self.inner = inner
        self.tp = None
        self.tap_site = TapSite(taps, tap_name, ('inner',))

    def parallelize(self, tp, seq):
        """Keep this rank's part [lo, hi) of the inner width of ``tp``:
        GEGLU's matching rows of the hidden and the gate halves, GELU's
        rows, net.2's columns; the tap gathers over ``seq`` and ``tp``."""
        cuts = {}
        if tp is not None:
            self.tp = tp
            part = span(*tp.bounds(self.inner))
            rows = torch.cat([part, part + self.inner]) if isinstance(self.net[0], GEGLU) else part
            cuts.update(linear_cuts('net.0.proj', self.net[0].proj, 0, rows))
            cuts.update(linear_cuts('net.2', self.net[2], 1, part))
        self.tap_site.gathers = {'inner': tap_gather((seq, 1), (tp, -1))}
        return cuts

    def forward(self, x, feats=None):
        h = self.net[0](x)
        self.tap_site.put(feats, 'inner', h)
        return row_linear(self.net[2], h, self.tp)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> FF with residuals; tap
    'out' at the block end."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int,
                 taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None, upcast_attention: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, taps=taps,
                               tap_name=child_id(tap_name, 'self'), attn_store=attn_store,
                               upcast=upcast_attention)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim, taps=taps,
                               tap_name=child_id(tap_name, 'cross'), attn_store=attn_store,
                               is_cross=True, upcast=upcast_attention)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, taps=taps, tap_name=child_id(tap_name, 'ffn'))
        self.tap_site = TapSite(taps, tap_name, ('out',))

    def forward(self, x, context, feats=None):
        x = x + self.attn1(self.norm1(x), feats=feats)
        x = x + self.attn2(self.norm2(x), context, feats=feats)
        x = x + self.ff(self.norm3(x), feats=feats)
        self.tap_site.put(feats, 'out', x)
        return x


class Transformer2DModel(nn.Module):
    """GroupNorm -> proj_in -> blocks -> proj_out (+ residual); tap 'out' on
    the NCHW output.  Linear projections (SDXL) or 1x1 convs (the tiny test
    config, SD-1.5)."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int,
                 cross_attention_dim: int, use_linear_projection: bool = False,
                 upcast_attention: bool = False, norm_eps: float = 1e-6,
                 taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        inner = heads * dim_head
        self.use_linear = use_linear_projection
        self.norm = nn.GroupNorm(32, in_channels, eps=norm_eps)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, taps=taps,
                                  tap_name=child_id(tap_name, f'block{i}'),
                                  attn_store=attn_store, upcast_attention=upcast_attention)
            for i in range(depth)])
        self.tap_site = TapSite(taps, tap_name, ('out',))
        self.tp = self.proj_cols = None

    def parallelize(self, tp, seq):
        """Under ``tp`` a linear proj_out keeps this rank's input columns
        and slices its replicated input (a 1x1 conv stays whole)."""
        if tp is None or not self.use_linear:
            return {}
        self.tp = tp
        self.proj_cols = tp.bounds(self.proj_out.in_features)
        return {'proj_out.weight': (1, span(*self.proj_cols))}

    def forward(self, x, context, feats=None):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.use_linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h)
            h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, h.shape[1])
        for blk in self.transformer_blocks:
            h = blk(h, context, feats=feats)
        if self.use_linear:
            h = row_linear(self.proj_out, h, self.tp, self.proj_cols)
            h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, h.shape[-1]).permute(0, 3, 1, 2))
        out = h + x
        self.tap_site.put(feats, 'out', out)
        return out
