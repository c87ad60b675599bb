"""UNet2DConditionModel with activation taps (port of
``diffusion_feature_tpu/models/unet2d.py``), NCHW throughout.

Tap grammar follows the reference's U-Net walk (feature/components/
feature_extractor.py:125-249): down-level{L}-repeat{R}-..., mid-...,
up-level{L}-..., plus the root taps unet-in / unet-after-conv-in / unet-out.
Module and parameter names are the diffusers checkpoint keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..taps import EMPTY, TapSite, TapSpec, child_id
from .layers import (
    Attention, AttnStoreCfg, Downsample2D, ResnetBlock2D, TimestepEmbedding, Transformer2DModel,
    Upsample2D, timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        'CrossAttnDownBlock2D', 'CrossAttnDownBlock2D',
        'CrossAttnDownBlock2D', 'DownBlock2D')
    up_block_types: Tuple[str, ...] = (
        'UpBlock2D', 'CrossAttnUpBlock2D',
        'CrossAttnUpBlock2D', 'CrossAttnUpBlock2D')
    layers_per_block: int = 2
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    upcast_attention: bool = False                  # fp32 attention (SD-2.1)
    addition_embed_type: Optional[str] = None       # 'text_time' for SDXL
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    norm_eps: float = 1e-5
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def from_diffusers_config(d: dict) -> 'UNetConfig':
        """Adapt a diffusers unet/config.json, as the JAX package does
        (fine-tunes may deviate from the presets).  diffusers names the
        head count ``attention_head_dim`` and leaves ``num_attention_heads``
        null; either is read.  A null ``upcast_attention`` reads as false."""
        n_blocks = len(d.get('block_out_channels', SD15_UNET.block_out_channels))

        def per_block(v, default):
            if v is None:
                v = default
            return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n_blocks

        heads = d.get('num_attention_heads') or d.get('attention_head_dim', 8)
        return UNetConfig(
            in_channels=d.get('in_channels', 4),
            out_channels=d.get('out_channels', 4),
            block_out_channels=tuple(d.get('block_out_channels', SD15_UNET.block_out_channels)),
            down_block_types=tuple(d.get('down_block_types', SD15_UNET.down_block_types)),
            up_block_types=tuple(d.get('up_block_types', SD15_UNET.up_block_types)),
            layers_per_block=d.get('layers_per_block', 2),
            num_attention_heads=per_block(heads, 8),
            transformer_layers_per_block=per_block(d.get('transformer_layers_per_block'), 1),
            cross_attention_dim=d.get('cross_attention_dim', 768),
            use_linear_projection=d.get('use_linear_projection', False),
            upcast_attention=bool(d.get('upcast_attention')),
            addition_embed_type=d.get('addition_embed_type'),
            addition_time_embed_dim=d.get('addition_time_embed_dim', 256),
            projection_class_embeddings_input_dim=d.get(
                'projection_class_embeddings_input_dim', 2816),
            norm_eps=d.get('norm_eps', 1e-5),
            freq_shift=d.get('freq_shift', 0.0),
            flip_sin_to_cos=d.get('flip_sin_to_cos', True),
        )

    def to_diffusers_config(self) -> dict:
        """The unet/config.json that ``from_diffusers_config`` reads back,
        with the head count where diffusers keeps it."""
        d = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(self).items()}
        d['attention_head_dim'], d['num_attention_heads'] = d['num_attention_heads'], None
        return {'_class_name': 'UNet2DConditionModel', **d}


SD15_UNET = UNetConfig()
SD21_UNET = UNetConfig(
    num_attention_heads=(5, 10, 20, 20),
    cross_attention_dim=1024,
    use_linear_projection=True,
    upcast_attention=True,
)
SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    down_block_types=('DownBlock2D', 'CrossAttnDownBlock2D', 'CrossAttnDownBlock2D'),
    up_block_types=('CrossAttnUpBlock2D', 'CrossAttnUpBlock2D', 'UpBlock2D'),
    num_attention_heads=(5, 10, 20),
    transformer_layers_per_block=(1, 2, 10),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type='text_time',
)


def tiny_unet_config(cross_dim: int = 32, with_xl_embeds: bool = False) -> UNetConfig:
    """Small config for offline tests: same topology family as SD-1.5/XL."""
    return UNetConfig(
        block_out_channels=(32, 64),
        down_block_types=('CrossAttnDownBlock2D', 'DownBlock2D'),
        up_block_types=('UpBlock2D', 'CrossAttnUpBlock2D'),
        layers_per_block=1,
        num_attention_heads=(2, 2),
        transformer_layers_per_block=(1, 1),
        cross_attention_dim=cross_dim,
        addition_embed_type='text_time' if with_xl_embeds else None,
        # test-xl's 32-wide pooled embedding + 6 time ids x 32 (Flax infers
        # this width from its input; torch's Linear has to be told)
        projection_class_embeddings_input_dim=32 + 6 * 32,
        addition_time_embed_dim=32,
    )


def _transformer(cfg: UNetConfig, channels: int, heads: int, depth: int, taps, tap_name,
                 attn_store):
    return Transformer2DModel(
        channels, heads, channels // heads, depth, cfg.cross_attention_dim,
        use_linear_projection=cfg.use_linear_projection,
        upcast_attention=cfg.upcast_attention, taps=taps, tap_name=tap_name,
        attn_store=attn_store)


class CrossAttnDownBlock2D(nn.Module):
    """Down level: resnets (+ transformers when ``has_attn``) + downsampler."""

    def __init__(self, cfg: UNetConfig, level: int, in_ch: int, out_ch: int,
                 add_downsample: bool, has_attn: bool, taps: TapSpec = EMPTY,
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        temb = cfg.time_embed_dim
        prefixes = [f'down-level{level}-repeat{r}' for r in range(cfg.layers_per_block)]
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if r == 0 else out_ch, out_ch, temb, cfg.norm_eps,
                          taps, child_id(p, 'res'))
            for r, p in enumerate(prefixes)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, out_ch, cfg.num_attention_heads[level],
                         cfg.transformer_layers_per_block[level], taps, child_id(p, 'vit'),
                         attn_store)
            for p in prefixes]) if has_attn else None
        self.downsamplers = nn.ModuleList([
            Downsample2D(out_ch, taps, f'down-level{level}-downsampler')
        ]) if add_downsample else None

    def forward(self, x, temb, context, feats=None):
        outputs = []
        for r, res in enumerate(self.resnets):
            x = res(x, temb, feats)
            if self.attentions is not None:
                x = self.attentions[r](x, context, feats)
            outputs.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x, feats)
            outputs.append(x)
        return x, outputs


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, taps: TapSpec = EMPTY,
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb, cfg.norm_eps, taps, f'mid-repeat{r}-res')
            for r in range(2)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, channels, cfg.num_attention_heads[-1],
                         cfg.transformer_layers_per_block[-1], taps, 'mid-vit', attn_store)])

    def forward(self, x, temb, context, feats=None):
        x = self.resnets[0](x, temb, feats)
        x = self.attentions[0](x, context, feats)
        return self.resnets[1](x, temb, feats)


class CrossAttnUpBlock2D(nn.Module):
    """Up level: (layers_per_block + 1) resnets over concatenated skips
    (+ transformers when ``has_attn``) + upsampler."""

    def __init__(self, cfg: UNetConfig, level: int, in_ch: int, prev_ch: int, out_ch: int,
                 add_upsample: bool, has_attn: bool, heads: int, depth: int,
                 taps: TapSpec = EMPTY, attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        n = cfg.layers_per_block + 1
        prefixes = [f'up-level{level}-repeat{r}' for r in range(n)]
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_ch if r == 0 else out_ch) + (in_ch if r == n - 1 else out_ch),
                          out_ch, cfg.time_embed_dim, cfg.norm_eps, taps, child_id(p, 'res'))
            for r, p in enumerate(prefixes)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, out_ch, heads, depth, taps, child_id(p, 'vit'), attn_store)
            for p in prefixes]) if has_attn else None
        self.upsamplers = nn.ModuleList([
            Upsample2D(out_ch, taps, f'up-level{level}-upsampler')
        ]) if add_upsample else None

    def forward(self, x, skips, temb, context, feats=None):
        for r, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb, feats)
            if self.attentions is not None:
                x = self.attentions[r](x, context, feats)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, feats)
        return x


def embed_time(module, cfg: UNetConfig, timestep, added_cond, x):
    """The timestep embedding through ``module.time_embedding``, plus SDXL's
    text_time micro-conditioning through ``module.add_embedding``
    (reference diffusion_feature.py:324-354), for the batch of ``x`` in its
    dtype; shared by the U-Net and the ControlNet."""
    bsz, dtype = x.shape[0], x.dtype
    timesteps = torch.full((bsz,), float(timestep), dtype=torch.float32, device=x.device)
    t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                               flip_sin_to_cos=cfg.flip_sin_to_cos,
                               downscale_freq_shift=cfg.freq_shift).to(dtype)
    emb = module.time_embedding(t_emb)
    if cfg.addition_embed_type == 'text_time':
        time_embeds = timestep_embedding(
            added_cond['time_ids'].reshape(-1), cfg.addition_time_embed_dim,
            flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift)
        add_embeds = torch.cat([added_cond['text_embeds'].to(dtype),
                                time_embeds.reshape(bsz, -1).to(dtype)], dim=-1)
        emb = emb + module.add_embedding(add_embeds)
    return emb


class UNet2DConditionModel(nn.Module):
    """forward(sample NCHW, timestep, encoder_hidden_states, added_cond=None,
    feats=None) -> noise prediction NCHW; requested taps land in ``feats``.
    ``added_cond`` is SDXL's {'text_embeds', 'time_ids'} micro-conditioning.
    ``attn_store_sizes`` (min, max tokens per side) and ``attn_categories``
    ('{down|mid|up}_{self|cross}') register the attention store; its maps
    land in ``feats[layers.ATTN_STORE]``."""

    def __init__(self, cfg: UNetConfig, taps: TapSpec = EMPTY,
                 attn_store_sizes: Optional[Tuple[int, int]] = None,
                 attn_categories: Tuple[str, ...] = ()):
        super().__init__()

        def store(place):
            if attn_store_sizes is None:
                return None
            return AttnStoreCfg(place, *attn_store_sizes, frozenset(attn_categories))

        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, cfg.time_embed_dim)
        if cfg.addition_embed_type == 'text_time':
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim)
        elif cfg.addition_embed_type is not None:
            raise NotImplementedError(f'addition_embed_type {cfg.addition_embed_type!r}')

        self.down_blocks = nn.ModuleList([])
        ch = ch0
        n_levels = len(cfg.block_out_channels)
        for level, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[level]
            self.down_blocks.append(CrossAttnDownBlock2D(
                cfg, level, ch, out_ch, add_downsample=level != n_levels - 1,
                has_attn=btype == 'CrossAttnDownBlock2D', taps=taps, attn_store=store('down')))
            ch = out_ch

        self.mid_block = UNetMidBlock2DCrossAttn(cfg, cfg.block_out_channels[-1], taps,
                                                 store('mid'))

        rev = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(cfg.num_attention_heads))
        rev_depth = list(reversed(cfg.transformer_layers_per_block))
        self.up_blocks = nn.ModuleList([])
        prev = rev[0]
        for level, btype in enumerate(cfg.up_block_types):
            self.up_blocks.append(CrossAttnUpBlock2D(
                cfg, level, rev[min(level + 1, n_levels - 1)], prev, rev[level],
                add_upsample=level != len(cfg.up_block_types) - 1,
                has_attn=btype == 'CrossAttnUpBlock2D',
                heads=rev_heads[level], depth=rev_depth[level], taps=taps,
                attn_store=store('up')))
            prev = rev[level]

        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)
        self.tap_site = TapSite(taps, '', ('unet-in', 'unet-after-conv-in', 'unet-out'))

    def forward(self, sample, timestep, encoder_hidden_states, added_cond=None, feats=None,
                plain: bool = False, down_block_additional_residuals=None,
                mid_block_additional_residual=None):
        """``plain`` runs the JAX package's tap-free twin of the U-Net (DDIM
        inversion's forwards): no taps, no store, every attention on the
        fused path.  The additional residuals are a ControlNet's: one per
        skip, added to the skips (not to the mid block's input, as in
        diffusers), and one added to the mid block's output."""
        residuals = (down_block_additional_residuals, mid_block_additional_residual)
        if not plain:
            return self._forward(sample, timestep, encoder_hidden_states, added_cond, feats,
                                 *residuals)
        attns = [m for m in self.modules() if isinstance(m, Attention)]
        for m in attns:
            m.plain = True
        try:
            return self._forward(sample, timestep, encoder_hidden_states, added_cond, None,
                                 *residuals)
        finally:
            for m in attns:
                m.plain = False

    def _forward(self, sample, timestep, encoder_hidden_states, added_cond, feats,
                 down_residuals=None, mid_residual=None):
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        self.tap_site.put(feats, 'unet-in', sample)
        x = sample.to(dtype)
        emb = embed_time(self, cfg, timestep, added_cond, x)
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(x)
        self.tap_site.put(feats, 'unet-after-conv-in', x)
        skips = [x]
        for blk in self.down_blocks:
            x, outs = blk(x, emb, context, feats)
            skips.extend(outs)
        if down_residuals is not None:
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_residuals)]
        x = self.mid_block(x, emb, context, feats)
        if mid_residual is not None:
            x = x + mid_residual.to(x.dtype)
        n = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            block_skips, skips = skips[-n:], skips[:-n]
            x = blk(x, block_skips, emb, context, feats)
        out = self.conv_out(F.silu(self.conv_norm_out(x)))
        self.tap_site.put(feats, 'unet-out', out)
        return out
