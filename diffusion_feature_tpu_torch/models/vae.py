"""AutoencoderKL (port of ``diffusion_feature_tpu/models/vae.py``), NCHW,
diffusers key names: the encoder with the posterior sample, and the decoder
behind ``post_quant_conv`` that the facade's 'vae-out' pseudo-layer runs.
Flux's VAE (``FLUX_VAE``: 16 latent channels, a shift factor) has no
quant convs (``use_quant_conv=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_fused
from ..ops.resize import interpolate_nearest_nchw


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    # the 1x1 quant_conv and post_quant_conv around the latent bottleneck
    # (diffusers' default); Flux's VAE has neither
    use_quant_conv: bool = True

    @staticmethod
    def from_diffusers_config(d: dict) -> 'VAEConfig':
        """Adapt a diffusers vae/config.json, as the JAX package does."""
        return VAEConfig(
            in_channels=d.get('in_channels', 3),
            out_channels=d.get('out_channels', 3),
            latent_channels=d.get('latent_channels', 4),
            block_out_channels=tuple(d.get('block_out_channels', (128, 256, 512, 512))),
            layers_per_block=d.get('layers_per_block', 2),
            scaling_factor=d.get('scaling_factor', 0.18215),
            shift_factor=d.get('shift_factor') or 0.0,
            use_quant_conv=d.get('use_quant_conv', True),
        )

    def to_diffusers_config(self) -> dict:
        d = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(self).items()}
        return {'_class_name': 'AutoencoderKL', **d}


SD_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
FLUX_VAE = VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                     use_quant_conv=False)


def tiny_vae_config(latent_channels: int = 4) -> VAEConfig:
    return VAEConfig(block_out_channels=(32, 32), layers_per_block=1,
                     latent_channels=latent_channels)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial attention of the mid block.  At 1024^2 its d=512
    head over 16384 tokens passes the flash gate."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        out = attention_fused(self.to_q(y), self.to_k(y), self.to_v(y), heads=1)
        out = self.to_out[0](out)
        return out.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, eps),
                                      VAEResnetBlock(channels, channels, eps)])
        self.attentions = nn.ModuleList([VAEAttention(channels, eps)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEDownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, add_downsample: bool,
                 eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(in_ch if r == 0 else out_ch, out_ch, eps)
                                      for r in range(layers)])
        if add_downsample:
            ds = nn.Module()
            # diffusers VAE Downsample2D: no conv padding, (0, 1, 0, 1) pad first
            ds.conv = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=0)
            self.downsamplers = nn.ModuleList([ds])
        else:
            self.downsamplers = None

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([])
        ch = chans[0]
        for level, out_ch in enumerate(chans):
            self.down_blocks.append(VAEDownBlock(ch, out_ch, cfg.layers_per_block,
                                                 level != len(chans) - 1, cfg.norm_eps))
            ch = out_ch
        self.mid_block = VAEMidBlock(ch, cfg.norm_eps)
        self.conv_norm_out = nn.GroupNorm(32, ch, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch, cfg.latent_channels * 2, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEUpBlock(nn.Module):
    """Decoder level: ``layers`` resnets, then (but at the last level) a
    nearest x2 upsample and a 3x3 conv."""

    def __init__(self, in_ch: int, out_ch: int, layers: int, add_upsample: bool,
                 eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(in_ch if r == 0 else out_ch, out_ch, eps)
                                      for r in range(layers)])
        if add_upsample:
            us = nn.Module()
            us.conv = nn.Conv2d(out_ch, out_ch, 3, padding=1)
            self.upsamplers = nn.ModuleList([us])
        else:
            self.upsamplers = None

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(interpolate_nearest_nchw(
                x, (x.shape[2] * 2, x.shape[3] * 2)))
        return x


class Decoder(nn.Module):
    """conv_in -> mid block (the encoder's, whose d=512 head over 16384
    tokens takes B1 at 1024^2) -> up blocks of ``layers_per_block + 1``
    resnets -> GroupNorm, SiLU, conv_out."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = VAEMidBlock(chans[0], cfg.norm_eps)
        self.up_blocks = nn.ModuleList([])
        ch = chans[0]
        for level, out_ch in enumerate(chans):
            self.up_blocks.append(VAEUpBlock(ch, out_ch, cfg.layers_per_block + 1,
                                             level != len(chans) - 1, cfg.norm_eps))
            ch = out_ch
        self.conv_norm_out = nn.GroupNorm(32, ch, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """Encoder + quant_conv and post_quant_conv (where the config has
    them) + decoder;
    ``forward(images, posterior_noise)`` samples the diagonal Gaussian
    posterior and returns scaled latents (the pipelines'
    ``prepare_latents``), ``decode`` maps latents back to images."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.quant_conv = nn.Conv2d(cfg.latent_channels * 2, cfg.latent_channels * 2, 1)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def decode(self, latents):
        """Unscaled latents NCHW -> images NCHW (JAX ``AutoencoderKL.decode``)."""
        z = latents.to(self.decoder.conv_in.weight.dtype)
        return self.decoder(self.post_quant_conv(z) if self.cfg.use_quant_conv else z)

    def encode_moments(self, images):
        """images NCHW in [-1, 1] -> (mean, logvar) stacked on channels."""
        moments = self.encoder(images.to(self.encoder.conv_in.weight.dtype))
        return self.quant_conv(moments) if self.cfg.use_quant_conv else moments

    def forward(self, images, posterior_noise):
        """``posterior_noise`` is a standard normal draw of the latent shape,
        drawn in fp32 and cast here to the model dtype, so a seed gives one
        realisation across serving dtypes (JAX ``utils.normal_like``)."""
        mean, logvar = self.encode_moments(images).chunk(2, dim=1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        z = mean + std * posterior_noise.to(mean.dtype)
        return (z - self.cfg.shift_factor) * self.cfg.scaling_factor
