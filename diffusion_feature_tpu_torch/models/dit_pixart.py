"""PixArt-alpha / PixArt-Sigma transformer (DiT) with activation taps (port
of ``diffusion_feature_tpu/models/dit_pixart.py``), with diffusers'
``PixArtTransformer2DModel`` key names (``pos_embed.proj``,
``adaln_single.emb.timestep_embedder.linear_{1,2}``, ``adaln_single.linear``,
``caption_projection.linear_{1,2}``, ``transformer_blocks.N.*``,
``scale_shift_table``, ``proj_out``), so a ``transformer/`` dir loads with
no renames.

A patch embed with fixed 2-D sin-cos positions (interpolation-scaled), one
6*dim timestep modulation (AdaLayerNormSingle) that every block shifts by
its own ``scale_shift_table``, the caption projection from T5's width, and
learned-sigma outputs (2 x the latent channels; the facade keeps the first
half).  Blocks tap as ``vit-block{i}`` with ``-self``/``-cross``/``-ffn``
children (reference feature_extractor.py:250-287); the transformer's own
output is never tapped there, so there is no ``vit-out``.  The attention
store registers the blocks as place ``'up'``, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..taps import EMPTY, TapSite, TapSpec, child_id
from .layers import Attention, AttnStoreCfg, FeedForward, TimestepEmbedding, timestep_embedding


@dataclasses.dataclass(frozen=True)
class PixArtConfig:
    sample_size: int = 64              # latent side (img/8)
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8              # learned sigma
    num_layers: int = 28
    num_attention_heads: int = 16
    attention_head_dim: int = 72
    cross_attention_dim: int = 1152
    caption_channels: int = 4096
    norm_eps: float = 1e-6
    interpolation_scale: int = 1

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @staticmethod
    def from_diffusers_config(d: dict) -> 'PixArtConfig':
        """Adapt a diffusers transformer config.json, as the JAX package
        does (missing keys take the PixArt-XL-2 defaults)."""
        return PixArtConfig(
            sample_size=d.get('sample_size', 64),
            patch_size=d.get('patch_size', 2),
            in_channels=d.get('in_channels', 4),
            out_channels=d.get('out_channels', 8),
            num_layers=d.get('num_layers', 28),
            num_attention_heads=d.get('num_attention_heads', 16),
            attention_head_dim=d.get('attention_head_dim', 72),
            cross_attention_dim=d.get('cross_attention_dim') or 1152,
            caption_channels=d.get('caption_channels', 4096),
            interpolation_scale=d.get('interpolation_scale', 1) or 1,
            norm_eps=d.get('norm_eps', 1e-6),
        )

    def to_diffusers_config(self) -> dict:
        return {'_class_name': 'PixArtTransformer2DModel', **dataclasses.asdict(self),
                'norm_type': 'ada_norm_single', 'activation_fn': 'gelu-approximate',
                'attention_bias': True, 'norm_elementwise_affine': False,
                'use_additional_conditions': False}


PIXART_ALPHA_512 = PixArtConfig(sample_size=64, interpolation_scale=1)
PIXART_SIGMA_512 = PixArtConfig(sample_size=64, interpolation_scale=1)
PIXART_SIGMA_1024 = PixArtConfig(sample_size=128, interpolation_scale=2)


def tiny_pixart_config() -> PixArtConfig:
    return PixArtConfig(sample_size=8, num_layers=2, num_attention_heads=2,
                        attention_head_dim=8, cross_attention_dim=16, caption_channels=32)


def sincos_2d_pos_embed(dim: int, grid: int, base_size: int,
                        interpolation_scale: float) -> np.ndarray:
    """diffusers ``get_2d_sincos_pos_embed`` numerics, float64, (grid^2, dim).

    MAE's axis convention: ``np.meshgrid(grid_w, grid_h)`` puts the column
    (w) coordinate first, so the first half of the embedding encodes w and
    the second half h.  Tokens flatten row-major (r*W + c)."""
    g = np.arange(grid, dtype=np.float64) / (grid / base_size) / interpolation_scale
    col, row = np.meshgrid(g, g)        # 'xy': col[i,j]=g[j], row[i,j]=g[i]

    def embed_1d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum('m,d->md', pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([embed_1d(dim // 2, col), embed_1d(dim // 2, row)], axis=1)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)


class CombinedTimestepEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, dim)


class AdaLayerNormSingle(nn.Module):
    """The shared timestep modulation: the embedding, and 6*dim from it."""

    def __init__(self, dim: int):
        super().__init__()
        self.emb = CombinedTimestepEmbedding(dim)
        self.linear = nn.Linear(dim, 6 * dim)


class CaptionProjection(nn.Module):
    """T5 width -> dim: linear_1 -> tanh-GELU -> linear_2."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x), approximate='tanh'))


def _modulation(table: torch.Tensor, emb: torch.Tensor, n: int, dtype):
    """table (n, dim) plus the batch's embedding (B, n*dim or dim) in fp32,
    split into n (B, 1, dim) tensors of ``dtype``."""
    mods = table[None].float() + emb.reshape(emb.shape[0], -1, table.shape[1]).float()
    return [m.to(dtype) for m in mods.chunk(n, dim=1)]


class PixArtBlock(nn.Module):
    """diffusers BasicTransformerBlock with norm_type='ada_norm_single':
    modulated LN -> self-attention -> (no norm) cross-attention ->
    modulated LN -> GELU-tanh MLP, gated residuals; tap 'out'."""

    def __init__(self, cfg: PixArtConfig, taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        dim, heads, head_dim = cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim
        self.scale_shift_table = nn.Parameter(torch.randn(6, dim) / dim ** 0.5)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.attn1 = Attention(dim, heads, head_dim, taps=taps,
                               tap_name=child_id(tap_name, 'self'), attn_store=attn_store,
                               qkv_bias=True)
        self.attn2 = Attention(dim, heads, head_dim, cfg.cross_attention_dim, taps=taps,
                               tap_name=child_id(tap_name, 'cross'), attn_store=attn_store,
                               is_cross=True, qkv_bias=True)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.ff = FeedForward(dim, taps=taps, tap_name=child_id(tap_name, 'ffn'),
                              activation_fn='gelu-approximate')
        self.tap_site = TapSite(taps, tap_name, ('out',))

    def forward(self, x, context, t6, mask=None, feats=None):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = _modulation(
            self.scale_shift_table, t6, 6, x.dtype)
        h = self.norm1(x) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn1(h, feats=feats)
        x = x + self.attn2(x, context, feats=feats, mask=mask)
        h = self.norm2(x) * (1 + scale_mlp) + shift_mlp
        x = x + gate_mlp * self.ff(h, feats=feats)
        self.tap_site.put(feats, 'out', x)
        return x


class PixArtTransformer2D(nn.Module):
    """forward(latents NCHW, timestep, encoder_hidden_states (B, L, T5
    width), encoder_attention_mask (B, L) of 1/0 or None, feats=None) ->
    the prediction NCHW with ``out_channels`` channels (noise, then the
    learned sigma).  Requested taps land in ``feats``; with
    ``attn_store_sizes`` (min, max tokens per side) and ``attn_categories``
    ('up_self', 'up_cross') the store's maps land in
    ``feats[layers.ATTN_STORE]``."""

    def __init__(self, cfg: PixArtConfig, taps: TapSpec = EMPTY,
                 attn_store_sizes: Optional[Tuple[int, int]] = None,
                 attn_categories: Sequence[str] = ()):
        super().__init__()
        self.cfg = cfg
        dim, p = cfg.inner_dim, cfg.patch_size
        store = None
        if attn_store_sizes is not None:
            store = AttnStoreCfg('up', *attn_store_sizes, frozenset(attn_categories))
        self.pos_embed = PatchEmbed(cfg.in_channels, dim, p)
        self.adaln_single = AdaLayerNormSingle(dim)
        self.caption_projection = CaptionProjection(cfg.caption_channels, dim)
        self.transformer_blocks = nn.ModuleList([
            PixArtBlock(cfg, taps, f'vit-block{i}', store) for i in range(cfg.num_layers)])
        self.scale_shift_table = nn.Parameter(torch.randn(2, dim) / dim ** 0.5)
        self.norm_out = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.proj_out = nn.Linear(dim, p * p * cfg.out_channels)
        self._pos = {}   # (grid, device, dtype) -> the position embedding

    def _pos_embed(self, grid: int, x: torch.Tensor) -> torch.Tensor:
        """The (1, grid^2, dim) sin-cos positions, cast once per grid,
        device and dtype: computed in float64 on the host, as in JAX."""
        key = (grid, x.device, x.dtype)
        if key not in self._pos:
            cfg = self.cfg
            pos = sincos_2d_pos_embed(cfg.inner_dim, grid, cfg.sample_size // cfg.patch_size,
                                      cfg.interpolation_scale)
            self._pos[key] = torch.from_numpy(pos).to(x.device, x.dtype)[None]
        return self._pos[key]

    def forward(self, sample, timestep, encoder_hidden_states, encoder_attention_mask=None,
                feats=None):
        cfg = self.cfg
        b, _, hh, ww = sample.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        dtype = self.proj_out.weight.dtype

        # 1. patchify and position embed
        x = self.pos_embed.proj(sample.to(dtype)).flatten(2).transpose(1, 2)
        x = x + self._pos_embed(gh, x)

        # 2. the shared timestep modulation
        t = torch.full((b,), float(timestep), dtype=torch.float32, device=sample.device)
        emb = self.adaln_single.emb.timestep_embedder(timestep_embedding(t, 256).to(dtype))
        t6 = self.adaln_single.linear(F.silu(emb))

        # 3. the caption projection and the -10000 key mask
        context = self.caption_projection(encoder_hidden_states.to(dtype))
        mask = None
        if encoder_attention_mask is not None:
            mask = ((1.0 - encoder_attention_mask[:, None, None, :].float()) * -10000.0).to(dtype)

        # 4. blocks
        for blk in self.transformer_blocks:
            x = blk(x, context, t6, mask, feats)

        # 5. modulated norm, projection, unpatchify
        shift, scale = _modulation(self.scale_shift_table, emb, 2, dtype)
        h = self.proj_out(self.norm_out(x) * (1 + scale) + shift)
        h = h.reshape(b, gh, gw, p, p, cfg.out_channels).permute(0, 5, 1, 3, 2, 4)
        return h.reshape(b, cfg.out_channels, gh * p, gw * p)
