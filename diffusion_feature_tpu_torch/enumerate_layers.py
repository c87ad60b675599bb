"""Layer enumeration without weights or compute (port of
``diffusion_feature_tpu/enumerate_layers.py``).

``enumerate_layers(version, img_size)`` builds the version's U-Net (or
PixArt or HunyuanDiT DiT) with every tap requested on PyTorch's meta device and runs one
forward on meta tensors, which carry shapes and no data: the counterpart of
the JAX package's ``jax.eval_shape``.  The full-size architectures are
enumerated in seconds on any host, with no memory for weights or
activations.  The kernel wrappers take their plain twins on meta tensors,
so no kernel is built or launched.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .models.dit_pixart import PixArtTransformer2D
from .models.hunyuan import HunyuanDiT2D
from .models.registry import get_model_spec
from .models.unet2d import UNet2DConditionModel
from .taps import TapSpec


def enumerate_layers(version: str, img_size: int = None,
                     batch_size: int = 1) -> Dict[str, Tuple[int, ...]]:
    """{layer-id: reference-layout feature shape} for every tappable layer:
    token features (B, S, C) as (B, C, sqrt(S), sqrt(S)), the rest as
    tapped (NCHW maps, (B, H, Sq, Sk) attention maps)."""
    spec = get_model_spec(version)
    img_size = img_size or spec.default_img_size
    lat = img_size // 2 ** (len(spec.vae.block_out_channels) - 1)
    feats = {}
    with torch.device('meta'), torch.no_grad():
        if spec.family == 'pixart':
            dit = PixArtTransformer2D(spec.dit, TapSpec.all())
            dit(torch.empty(batch_size, spec.dit.in_channels, lat, lat), 50.0,
                torch.empty(batch_size, spec.prompt_max_length, spec.t5.d_model), feats=feats)
        elif spec.family == 'hunyuan':
            cfg = spec.dit
            dit = HunyuanDiT2D(cfg, TapSpec.all())
            dit(torch.empty(batch_size, cfg.in_channels, lat, lat), 50.0,
                torch.empty(batch_size, cfg.text_len, cfg.cross_attention_dim), None,
                torch.empty(batch_size, cfg.text_len_t5, cfg.cross_attention_dim_t5),
                feats=feats)
        else:
            unet = UNet2DConditionModel(spec.unet, TapSpec.all())
            added = None
            if spec.unet.addition_embed_type == 'text_time':
                last = spec.text_encoders[-1]
                pooled = last.projection_dim or last.hidden_size
                added = {'text_embeds': torch.empty(batch_size, pooled),
                         'time_ids': torch.empty(batch_size, 6)}
            unet(torch.empty(batch_size, spec.unet.in_channels, lat, lat), 50.0,
                 torch.empty(batch_size, 77, spec.unet.cross_attention_dim), added, feats=feats)
    out = {}
    for tap_id, val in feats.items():
        shape = tuple(val.shape)
        if len(shape) == 3:
            side = int(math.sqrt(shape[1]))
            shape = (shape[0], shape[2], side, side)
        out[tap_id] = shape
    return out
