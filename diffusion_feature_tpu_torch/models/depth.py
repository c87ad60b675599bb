"""The DPT monocular depth estimator behind ``control=['depth']`` (port of
``diffusion_feature_tpu/models/depth.py``): a ViT backbone, the
reassemble/fusion neck and the depth head of transformers'
``DPTForDepthEstimation`` (``model_type='dpt'``, e.g. Intel/dpt-large).

Module and parameter names are that class's checkpoint keys, so a
``depth_estimator`` dir of transformers safetensors loads with no renames
(``DPTDepthEstimator``); the keys the forward never reads (the final
LayerNorm, the pooler, the deepest fusion layer's ``residual_layer1``) are
left unused.  Hybrid (ResNet-stem) checkpoints and other readouts are
refused, as in the JAX package.  The ViT's attention goes through the
port's attention op: at 577 tokens (384², patch 16) the flash gate sends it
to the explicit path, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_fused
from ..ops.resize import resize_bilinear_nchw


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 384
    num_channels: int = 3
    layer_norm_eps: float = 1e-12
    backbone_out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    readout_type: str = 'project'

    @staticmethod
    def from_diffusers_config(d: dict) -> 'DPTConfig':
        """From a transformers DPT config.json."""
        if d.get('is_hybrid', False) or d.get('backbone_config'):
            raise NotImplementedError(
                'DPT-hybrid (ResNet-stem) depth checkpoints are not supported; convert a '
                'plain-ViT DPT checkpoint (e.g. Intel/dpt-large layout) or pass a custom '
                'depth callable')
        if d.get('readout_type', 'project') != 'project':
            raise NotImplementedError('only readout_type=project is used by the MiDaS/DPT '
                                      'depth checkpoints')
        base = DPTConfig()
        return DPTConfig(**{f.name: tuple(d[f.name]) if isinstance(d.get(f.name), list)
                            else d.get(f.name, getattr(base, f.name))
                            for f in dataclasses.fields(DPTConfig)})

    def to_transformers_config(self) -> dict:
        """The config.json of a transformers ``DPTForDepthEstimation`` with
        this architecture, which ``from_diffusers_config`` reads back."""
        d = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(self).items()}
        return {'architectures': ['DPTForDepthEstimation'], 'model_type': 'dpt',
                'is_hybrid': False, 'hidden_act': 'gelu', 'qkv_bias': True, **d}


def tiny_dpt_config() -> DPTConfig:
    return DPTConfig(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
                     intermediate_size=64, patch_size=8, image_size=64,
                     backbone_out_indices=(0, 1, 2, 3), neck_hidden_sizes=(16, 24, 32, 32),
                     reassemble_factors=(4, 2, 1, 0.5), fusion_hidden_size=16)


def upsample_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW with align_corners=True (the JAX package's
    ``_upsample_align_corners``)."""
    return F.interpolate(x, size=(out_h, out_w), mode='bilinear', align_corners=True)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class _ViTAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.attention = _SelfAttention(hidden)
        self.output = _Dense(hidden, hidden)


class ViTBlock(nn.Module):
    """Pre-LN ViT encoder block (transformers ``DPTViTLayer``): exact GELU,
    LayerNorm eps from the config."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.attention = _ViTAttention(cfg.hidden_size)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size)
        self.layernorm_before = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        h = self.layernorm_before(x)
        sa = self.attention.attention
        attn = attention_fused(sa.query(h), sa.key(h), sa.value(h), self.heads)
        x = x + self.attention.output.dense(attn)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class PreActResidual(nn.Module):
    """relu -> conv -> relu -> conv, plus the input
    (``DPTPreActResidualLayer``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.convolution2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        grid = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, grid * grid + 1, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)


class _Encoder(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layer = nn.ModuleList([ViTBlock(cfg) for _ in range(cfg.num_hidden_layers)])


class _Backbone(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)


class _ReassembleLayer(nn.Module):
    def __init__(self, hidden: int, channels: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(hidden, channels, 1)
        if factor > 1:   # kernel == stride: the JAX package's einsum pixel-expand
            self.resize = nn.ConvTranspose2d(channels, channels, int(factor), stride=int(factor))
        elif factor < 1:
            self.resize = nn.Conv2d(channels, channels, 3, stride=int(1 / factor), padding=1)
        else:
            self.resize = nn.Identity()


class _ReassembleStage(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        n = len(cfg.neck_hidden_sizes)
        self.readout_projects = nn.ModuleList([
            nn.Sequential(nn.Linear(2 * cfg.hidden_size, cfg.hidden_size), nn.GELU())
            for _ in range(n)])
        self.layers = nn.ModuleList([
            _ReassembleLayer(cfg.hidden_size, ch, f)
            for ch, f in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors)])


class _FusionLayer(nn.Module):
    """The deepest layer (``first``) has no lateral input, so no
    ``residual_layer1`` (transformers builds one and never runs it)."""

    def __init__(self, channels: int, first: bool):
        super().__init__()
        self.projection = nn.Conv2d(channels, channels, 1)
        self.residual_layer1 = None if first else PreActResidual(channels)
        self.residual_layer2 = PreActResidual(channels)


class _FusionStage(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layers = nn.ModuleList([_FusionLayer(cfg.fusion_hidden_size, j == 0)
                                     for j in range(len(cfg.neck_hidden_sizes))])


class _Neck(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.reassemble_stage = _ReassembleStage(cfg)
        self.convs = nn.ModuleList([nn.Conv2d(ch, cfg.fusion_hidden_size, 3, padding=1,
                                              bias=False) for ch in cfg.neck_hidden_sizes])
        self.fusion_stage = _FusionStage(cfg)


class _Head(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.fusion_hidden_size
        # diffusers' Sequential indices: 1 is the 2x upsample, 3 and 5 ReLUs
        self.head = nn.ModuleDict({'0': nn.Conv2d(f, f // 2, 3, padding=1),
                                   '2': nn.Conv2d(f // 2, 32, 3, padding=1),
                                   '4': nn.Conv2d(32, 1, 1)})


class DPTDepthModel(nn.Module):
    """forward(pixel_values (B, 3, H, W), mean/std-normalised) -> inverse
    depth (B, H/2, W/2) at patch 16 (the neck emits at 4x the patch grid,
    the head doubles it)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        self.dpt = _Backbone(cfg)
        self.neck = _Neck(cfg)
        self.head = _Head(cfg)

    def forward(self, pixel_values):
        cfg = self.cfg
        emb = self.dpt.embeddings
        x = emb.patch_embeddings.projection(pixel_values.to(emb.cls_token.dtype))
        b, hidden, ph, pw = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        grid0 = cfg.image_size // cfg.patch_size
        pos = emb.position_embeddings
        pos_grid = pos[:, 1:].reshape(1, grid0, grid0, hidden).permute(0, 3, 1, 2)
        if (ph, pw) != (grid0, grid0):
            pos_grid = resize_bilinear_nchw(pos_grid, (ph, pw))
        pos_all = torch.cat([pos[:, :1], pos_grid.flatten(2).transpose(1, 2)], dim=1)
        tokens = torch.cat([emb.cls_token.expand(b, -1, -1), tokens], dim=1) + pos_all

        hooks, want = [], set(cfg.backbone_out_indices)
        for i, blk in enumerate(self.dpt.encoder.layer):
            tokens = blk(tokens)
            if i in want:
                hooks.append(tokens)

        stage, feats = self.neck.reassemble_stage, []
        for i, hs in enumerate(hooks):
            patches = hs[:, 1:]
            h = stage.readout_projects[i](
                torch.cat([patches, hs[:, :1].expand_as(patches)], dim=-1))
            h = h.transpose(1, 2).reshape(b, hidden, ph, pw)
            layer = stage.layers[i]
            feats.append(self.neck.convs[i](layer.resize(layer.projection(h))))

        fused = None
        for layer, h in zip(self.neck.fusion_stage.layers, reversed(feats)):
            if fused is not None:
                if h.shape[2:] != fused.shape[2:]:
                    # odd patch grids: the 2x carry overshoots the lateral
                    h = resize_bilinear_nchw(h, fused.shape[2:])
                fused = fused + layer.residual_layer1(h)
            else:
                fused = h
            fused = layer.residual_layer2(fused)
            fused = layer.projection(
                upsample_align_corners(fused, fused.shape[2] * 2, fused.shape[3] * 2))

        head = self.head.head
        h = head['0'](fused)
        h = upsample_align_corners(h, h.shape[2] * 2, h.shape[3] * 2)
        h = F.relu(head['4'](F.relu(head['2'](h))))
        return h[:, 0]


def jax_param_name(key: str) -> str:
    """The JAX ``DPTDepthModel``'s parameter for a port (transformers) key,
    in the dotted form ``convert.params_from_jax`` normalises: the JAX
    package's ``rename_dpt_keys``."""
    base, _, leaf = key.rpartition('.')
    parts = base.split('.')
    if base == 'dpt.embeddings':
        return leaf
    if base == 'dpt.embeddings.patch_embeddings.projection':
        return f'patch_proj.{leaf}'
    if base.startswith('dpt.encoder.layer.'):
        i, rest = parts[3], '.'.join(parts[4:])
        name = {'attention.attention.query': 'query', 'attention.attention.key': 'key',
                'attention.attention.value': 'value', 'attention.output.dense': 'attn_output',
                'intermediate.dense': 'intermediate', 'output.dense': 'output'}.get(rest, rest)
        return f'layer_{i}.{name}.{leaf}'
    if base.startswith('neck.reassemble_stage.readout_projects.'):
        return f'readout_{parts[3]}.{leaf}'
    if base.startswith('neck.reassemble_stage.layers.'):
        return f"reassemble_{'proj' if parts[4] == 'projection' else 'resize'}_{parts[3]}.{leaf}"
    if base.startswith('neck.convs.'):
        return f'neck_conv_{parts[2]}.{leaf}'
    if base.startswith('neck.fusion_stage.layers.'):
        j, rest = parts[3], parts[4:]
        if rest[0] == 'projection':
            return f'fusion_{j}_proj.{leaf}'
        res = 'res1' if rest[0] == 'residual_layer1' else 'res2'
        return f'fusion_{j}_{res}.{rest[1]}.{leaf}'
    if base.startswith('head.head.'):
        return f"{ {'0': 'head_conv1', '2': 'head_conv2', '4': 'head_conv3'}[parts[2]] }.{leaf}"
    raise KeyError(key)


class DPTDepthEstimator:
    """The MidasDetector stand-in: PIL -> (3, H, W) float32 in [0, 1], the
    inverse depth normalised by its min and max, replicated to 3 channels
    (controlnet_aux's post-processing).  Weights from a transformers
    ``DPTForDepthEstimation`` dir (config.json and safetensors); runs in
    fp32 on ``device``, as the JAX package runs it in fp32."""

    def __init__(self, model_dir: str, device='cuda'):
        from .convert import load_safetensors_dir, load_state_into
        with open(os.path.join(model_dir, 'config.json')) as f:
            self.cfg = DPTConfig.from_diffusers_config(json.load(f))
        self.device = torch.device(device)
        with torch.device('meta'):
            self.model = DPTDepthModel(self.cfg)
        load_state_into(self.model, load_safetensors_dir(model_dir), torch.float32, self.device)
        self.model.eval().requires_grad_(False)

    @torch.inference_mode()
    def __call__(self, pil_img) -> np.ndarray:
        from PIL import Image
        size = self.cfg.image_size
        out_w, out_h = pil_img.size
        img = pil_img.convert('RGB').resize((size, size), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 127.5 - 1.0     # mean/std 0.5
        x = torch.from_numpy(arr.transpose(2, 0, 1)[None].copy()).to(self.device)
        depth = self.model(x)[0].cpu().numpy()
        dmin, dmax = float(depth.min()), float(depth.max())
        depth = (depth - dmin) / max(dmax - dmin, 1e-8)
        depth = np.asarray(Image.fromarray((depth * 255).astype(np.uint8)).resize(
            (out_w, out_h), Image.BILINEAR), np.float32) / 255.0
        return np.stack([depth, depth, depth], axis=0)
