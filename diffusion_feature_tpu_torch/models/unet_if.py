"""DeepFloyd IF stage-I U-Net with activation taps (port of
``diffusion_feature_tpu/models/unet_if.py``), NCHW throughout.

Pixel space, 3 channels in and 6 out (the noise prediction and the learned
variance), GELU (exact) everywhere, scale-shift timestep resnets whose
down- and up-samplers are resnets themselves, added-KV attention over
[text; image] keys, and T5 conditioning through ``encoder_hid_proj`` plus
an attention-pooled text embedding added to the timestep embedding.
Module and parameter names are the diffusers ``UNet2DConditionModel``
checkpoint keys of the IF configuration.

Taps, as in the JAX package:
  - the resnets': ``{down,up}-level{L}-repeat{R}-res-{increment,out}``,
    ``mid-repeat{R}-res-{increment,out}``;
  - the samplers': ``down-level{L}-downsampler-{increment,out}`` and
    ``up-level{L}-upsampler-{increment,out}``;
  - ``unet-in``, ``unet-after-conv-in``, ``unet-out`` (6 channels);
  - no attention tap: the reference's added-KV processor gathers nothing,
    so no ``-vit-``, ``-self-`` or ``-cross-`` id exists, and the
    attention store keeps no map.

Every attention has the text tokens plus the image's as keys, a count the
flash gate refuses (``sk % 256``), and the pooling head has one query: IF
runs the explicit attention path and launches no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_fused, merge_heads, split_heads
from ..parallel.mesh import cut_heads, linear_cuts, row_linear, span
from ..ops.resize import interpolate_nearest_nchw
from ..taps import EMPTY, TapSite, TapSpec, child_id
from .layers import TimestepEmbedding, timestep_embedding


@dataclasses.dataclass(frozen=True)
class IFUNetConfig:
    sample_size: int = 64
    in_channels: int = 3
    out_channels: int = 6                  # the learned-range variance
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 1024)
    down_block_types: Tuple[str, ...] = (
        'ResnetDownsampleBlock2D', 'SimpleCrossAttnDownBlock2D',
        'SimpleCrossAttnDownBlock2D', 'SimpleCrossAttnDownBlock2D')
    up_block_types: Tuple[str, ...] = (
        'SimpleCrossAttnUpBlock2D', 'SimpleCrossAttnUpBlock2D',
        'SimpleCrossAttnUpBlock2D', 'ResnetUpsampleBlock2D')
    layers_per_block: int = 3
    attention_head_dim: int = 64
    cross_attention_dim: int = 1024
    encoder_hid_dim: int = 4096            # T5-XXL's width
    norm_eps: float = 1e-5
    act_fn: str = 'gelu'
    addition_embed_type: Optional[str] = 'text'   # the attention-pooled text
    addition_embed_type_num_heads: int = 64

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def from_diffusers_config(d: dict) -> 'IFUNetConfig':
        """The fields of a diffusers unet/config.json that this config
        has, lists as tuples (the JAX ``from_diffusers_config``)."""
        names = {f.name for f in dataclasses.fields(IFUNetConfig)}
        return IFUNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in d.items() if k in names})

    def to_diffusers_config(self) -> dict:
        """The unet/config.json that ``from_diffusers_config`` reads back,
        with the diffusers fields that name IF's scale-shift resnets (the
        timestep activation applied before their projection) and its mid
        block."""
        d = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(self).items()}
        return {'_class_name': 'UNet2DConditionModel', **d,
                'resnet_time_scale_shift': 'scale_shift', 'resnet_skip_time_act': False,
                'mid_block_type': 'UNetMidBlock2DSimpleCrossAttn'}


#: The JAX package's best-effort IF-I-L preset (its exact hyperparameters
#: come only with the checkpoint's config.json).
IF_I_L = IFUNetConfig()


def tiny_if_config() -> IFUNetConfig:
    """The JAX package's ``test-if`` U-Net."""
    return IFUNetConfig(
        sample_size=32, block_out_channels=(32, 64),
        down_block_types=('ResnetDownsampleBlock2D', 'SimpleCrossAttnDownBlock2D'),
        up_block_types=('SimpleCrossAttnUpBlock2D', 'ResnetUpsampleBlock2D'),
        layers_per_block=1, attention_head_dim=16, cross_attention_dim=64, encoder_hid_dim=32,
        addition_embed_type_num_heads=4)


def _act(name: str):
    return F.gelu if name == 'gelu' else F.silu   # F.gelu is the exact (erf) GELU


class IFResnetBlock(nn.Module):
    """ResnetBlock2D with scale-shift timestep conditioning, norm2's output
    times (1 + scale) plus shift, and, for the samplers, a 2x average pool
    (``down``) or nearest upsample (``up``) of both the activation and the
    shortcut before conv1.  Taps 'increment' (before the residual) and
    'out'."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, eps: float = 1e-5,
                 act_fn: str = 'gelu', down: bool = False, up: bool = False,
                 taps: TapSpec = EMPTY, tap_name: str = ''):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch * 2)
        self.norm2 = nn.GroupNorm(32, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.act = _act(act_fn)
        self.down, self.up = down, up
        self.tap_site = TapSite(taps, tap_name, ('increment', 'out'))

    def forward(self, x, temb, feats=None):
        h = self.act(self.norm1(x))
        if self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        elif self.up:
            size = (x.shape[2] * 2, x.shape[3] * 2)
            h, x = interpolate_nearest_nchw(h, size), interpolate_nearest_nchw(x, size)
        h = self.conv1(h)
        scale, shift = self.time_emb_proj(self.act(temb))[:, :, None, None].chunk(2, dim=1)
        h = self.conv2(self.act(self.norm2(h) * (1 + scale) + shift))
        self.tap_site.put(feats, 'increment', h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        out = x + h
        self.tap_site.put(feats, 'out', out)
        return out


class AddedKVAttention(nn.Module):
    """Attention with added key/value projections of the text context (the
    AttnAddedKVProcessor math): GroupNorm over the image tokens, queries
    from them, keys and values [projected text; image], the output
    projection, then the residual."""

    def __init__(self, channels: int, head_dim: int, cross_attention_dim: int,
                 eps: float = 1e-5):
        super().__init__()
        self.heads = channels // head_dim
        self.group_norm = nn.GroupNorm(32, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.add_k_proj = nn.Linear(cross_attention_dim, channels)
        self.add_v_proj = nn.Linear(cross_attention_dim, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])
        self.heads_total, self.head_dim = self.heads, head_dim
        self.tp = None

    def parallelize(self, tp, seq):
        """This rank's heads of ``tp``: rows of the q/k/v and added k/v
        projections, to_out.0's columns; returns the cuts."""
        if tp is None:
            return {}
        return cut_heads(self, tp, ('to_q', 'to_k', 'to_v', 'add_k_proj', 'add_v_proj'),
                         ('to_out.0',))

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.group_norm(x.reshape(b, c, hh * ww)).transpose(1, 2)
        k = torch.cat([self.add_k_proj(context), self.to_k(h)], dim=1)
        v = torch.cat([self.add_v_proj(context), self.to_v(h)], dim=1)
        out = row_linear(self.to_out[0], attention_fused(self.to_q(h), k, v, self.heads),
                         self.tp)
        return out.transpose(1, 2).reshape(b, c, hh, ww) + x


class AttentionPooling(nn.Module):
    """diffusers' AttentionPooling: a class token (the mean token plus a
    positional embedding) in front of the sequence; its one query attends
    over [class; tokens] with q and k both scaled by head_dim ** -0.25;
    returns the class token's output (B, d)."""

    def __init__(self, num_heads: int, embed_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        class_token = x.mean(dim=1, keepdim=True) + self.positional_embedding[None].to(x.dtype)
        xc = torch.cat([class_token, x], dim=1)
        scale = (x.shape[-1] // self.num_heads) ** -0.25
        qh = split_heads(self.q_proj(class_token), self.num_heads) * scale
        kh = split_heads(self.k_proj(xc), self.num_heads) * scale
        vh = split_heads(self.v_proj(xc), self.num_heads)
        w = torch.matmul(qh.float(), kh.float().transpose(-1, -2)).softmax(dim=-1).to(vh.dtype)
        a = torch.matmul(w.float(), vh.float()).to(vh.dtype)
        return merge_heads(a)[:, 0]


class IFTextTimeEmbedding(nn.Module):
    """diffusers' TextTimeEmbedding (addition_embed_type='text'): LayerNorm,
    attention pooling, projection to the time-embedding width, LayerNorm;
    both LayerNorms with torch's eps 1e-5, as in the JAX package."""

    def __init__(self, embed_dim: int, time_embed_dim: int, num_heads: int = 64):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.pool = AttentionPooling(num_heads, embed_dim)
        self.proj = nn.Linear(embed_dim, time_embed_dim)
        self.norm2 = nn.LayerNorm(time_embed_dim, eps=1e-5)
        self.tp = None

    def parallelize(self, tp, seq):
        """``proj`` is column-parallel by JAX's name rule: under ``tp`` it
        keeps this rank's output rows, gathered before the norm."""
        if tp is None:
            return {}
        self.tp = tp
        return linear_cuts('proj', self.proj, 0, span(*tp.bounds(self.proj.out_features)))

    def forward(self, text_embeds):
        x = self.norm1(text_embeds.to(self.norm1.weight.dtype))
        h = self.proj(self.pool(x))
        return self.norm2(h if self.tp is None else self.tp.gather(h, -1))


class IFBlock(nn.Module):
    """One level of the U-Net as diffusers keys it: ``resnets``, the
    added-KV ``attentions`` of a SimpleCrossAttn block (None for a Resnet
    block), and the resnet ``downsamplers`` or ``upsamplers``."""

    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions is not None else None
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)


class IFUNet(nn.Module):
    """forward(sample NCHW pixels, timestep, encoder_hidden_states (T5),
    feats=None) -> (B, out_channels, H, W): the noise prediction and the
    learned variance.  Requested taps land in ``feats``.  The attention
    store arguments are taken for the facade's common build and unused: IF
    has no attention taps."""

    def __init__(self, cfg: IFUNetConfig, taps: TapSpec = EMPTY,
                 attn_store_sizes: Optional[Tuple[int, int]] = None,
                 attn_categories: Tuple[str, ...] = ()):
        super().__init__()
        del attn_store_sizes, attn_categories
        self.cfg = cfg
        ch0, temb = cfg.block_out_channels[0], cfg.time_embed_dim

        def resnet(name, in_ch, out_ch, **kw):
            return IFResnetBlock(in_ch, out_ch, temb, cfg.norm_eps, cfg.act_fn, taps=taps,
                                 tap_name=name, **kw)

        def attn(channels):
            return AddedKVAttention(channels, cfg.attention_head_dim, cfg.cross_attention_dim,
                                    cfg.norm_eps)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb, act_fn=cfg.act_fn)
        if cfg.addition_embed_type == 'text':
            self.add_embedding = IFTextTimeEmbedding(cfg.encoder_hid_dim, temb,
                                                     cfg.addition_embed_type_num_heads)
        elif cfg.addition_embed_type is not None:
            raise NotImplementedError(f'addition_embed_type {cfg.addition_embed_type!r}')
        self.encoder_hid_proj = nn.Linear(cfg.encoder_hid_dim, cfg.cross_attention_dim)

        n_levels, lpb = len(cfg.block_out_channels), cfg.layers_per_block
        self.down_blocks = nn.ModuleList([])
        ch = ch0
        for level, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[level]
            self.down_blocks.append(IFBlock(
                [resnet(child_id(f'down-level{level}-repeat{r}', 'res'), ch if r == 0 else out_ch,
                        out_ch) for r in range(lpb)],
                [attn(out_ch) for _ in range(lpb)]
                if btype == 'SimpleCrossAttnDownBlock2D' else None,
                downsamplers=[resnet(f'down-level{level}-downsampler', out_ch, out_ch, down=True)]
                if level != n_levels - 1 else None))
            ch = out_ch

        # UNetMidBlock2DSimpleCrossAttn: resnet, attention, resnet
        self.mid_block = IFBlock([resnet(f'mid-repeat{r}-res', ch, ch) for r in range(2)],
                                 [attn(ch)])

        rev = list(reversed(cfg.block_out_channels))
        prev = rev[0]
        self.up_blocks = nn.ModuleList([])
        n = lpb + 1
        for level, btype in enumerate(cfg.up_block_types):
            out_ch, in_ch = rev[level], rev[min(level + 1, n_levels - 1)]
            self.up_blocks.append(IFBlock(
                [resnet(child_id(f'up-level{level}-repeat{r}', 'res'),
                        (prev if r == 0 else out_ch) + (in_ch if r == n - 1 else out_ch), out_ch)
                 for r in range(n)],
                [attn(out_ch) for _ in range(n)] if btype == 'SimpleCrossAttnUpBlock2D' else None,
                upsamplers=[resnet(f'up-level{level}-upsampler', out_ch, out_ch, up=True)]
                if level != len(cfg.up_block_types) - 1 else None))
            prev = out_ch

        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)
        self.act = _act(cfg.act_fn)
        self.tap_site = TapSite(taps, '', ('unet-in', 'unet-after-conv-in', 'unet-out'))

    def forward(self, sample, timestep, encoder_hidden_states, feats=None):
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        self.tap_site.put(feats, 'unet-in', sample)
        x = sample.to(dtype)
        ts = torch.full((x.shape[0],), float(timestep), dtype=torch.float32, device=x.device)
        temb = self.time_embedding(timestep_embedding(ts, cfg.block_out_channels[0]).to(dtype))
        if cfg.addition_embed_type == 'text':
            temb = temb + self.add_embedding(encoder_hidden_states)
        context = self.encoder_hid_proj(encoder_hidden_states.to(dtype))

        x = self.conv_in(x)
        self.tap_site.put(feats, 'unet-after-conv-in', x)
        skips = [x]
        for blk in self.down_blocks:
            for r, res in enumerate(blk.resnets):
                x = res(x, temb, feats)
                if blk.attentions is not None:
                    x = blk.attentions[r](x, context)
                skips.append(x)
            if hasattr(blk, 'downsamplers'):
                x = blk.downsamplers[0](x, temb, feats)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb, feats), context), temb,
                           feats)

        for blk in self.up_blocks:
            for r, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb, feats)
                if blk.attentions is not None:
                    x = blk.attentions[r](x, context)
            if hasattr(blk, 'upsamplers'):
                x = blk.upsamplers[0](x, temb, feats)

        out = self.conv_out(self.act(self.conv_norm_out(x)))
        self.tap_site.put(feats, 'unet-out', out)
        return out
