"""Model registry: version string -> architecture and schedule (port of
the U-Net entries of ``diffusion_feature_tpu/models/registry.py``: ``1-5``,
``2-1``, ``xl``, ``pgv2``, ``test-sd`` and ``test-xl``).

Without a weights path models initialise deterministically at random, which
exercises every shape and the data flow at full width.  The JAX package's
other versions raise ``NotImplementedError`` naming the ROADMAP.md item
that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..roadmap import not_ported
from ..schedulers.diffusion import SchedulerConfig
from .clip_text import (CLIP_VIT_L, OPENCLIP_BIGG, OPENCLIP_VIT_H, CLIPTextConfig,
                        tiny_clip_config)
from .unet2d import SD15_UNET, SD21_UNET, SDXL_UNET, UNetConfig, tiny_unet_config
from .vae import SD_VAE, SDXL_VAE, VAEConfig, tiny_vae_config

SD_SCHED = SchedulerConfig(beta_start=0.00085, beta_end=0.012, steps_offset=1)
XL_SCHED = SchedulerConfig(beta_start=0.00085, beta_end=0.012, steps_offset=1,
                           timestep_spacing='leading')


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A U-Net model: its scheduler ('euler' | 'pndm'), U-Net, VAE, and CLIP
    encoders whose chosen hidden states are concatenated: 'final' (the
    final-layernormed output, no pooled embedding; SD-1.5, SD-2.1) or
    'penultimate' (hidden_states[-2], with the last encoder's pooled output;
    SDXL, Playground v2)."""
    version: str
    hf_id: str                         # provenance only; nothing is downloaded
    scheduler: str
    scheduler_config: SchedulerConfig
    unet: UNetConfig
    vae: VAEConfig
    text_encoders: Tuple[CLIPTextConfig, ...]
    default_img_size: int
    clip_layer: str = 'final'


_REGISTRY = {spec.version: spec for spec in (
    ModelSpec('1-5', 'stable-diffusion-v1-5/stable-diffusion-v1-5', 'pndm', SD_SCHED,
              SD15_UNET, SD_VAE, (CLIP_VIT_L,), 512),
    ModelSpec('2-1', 'stabilityai/stable-diffusion-2-1-base', 'euler', SD_SCHED, SD21_UNET,
              SD_VAE, (OPENCLIP_VIT_H,), 512),
    ModelSpec('xl', 'stabilityai/stable-diffusion-xl-base-1.0', 'euler', XL_SCHED, SDXL_UNET,
              SDXL_VAE, (CLIP_VIT_L, OPENCLIP_BIGG), 1024, clip_layer='penultimate'),
    ModelSpec('pgv2', 'playgroundai/playground-v2-1024px-aesthetic', 'euler', XL_SCHED,
              SDXL_UNET, SDXL_VAE, (CLIP_VIT_L, OPENCLIP_BIGG), 1024,
              clip_layer='penultimate'),
    ModelSpec('test-sd', '(random-init test model)', 'pndm', SD_SCHED,
              tiny_unet_config(cross_dim=32), tiny_vae_config(), (tiny_clip_config(32),), 64),
    ModelSpec('test-xl', '(random-init test model)', 'euler', XL_SCHED,
              tiny_unet_config(cross_dim=64, with_xl_embeds=True), tiny_vae_config(),
              (tiny_clip_config(32), tiny_clip_config(32, projection_dim=32)), 64,
              clip_layer='penultimate'),
)}


_UNPORTED = dict.fromkeys(('pixart-alpha', 'pixart-sigma', 'pixart-sigma-512', 'hunyuan',
                           'flux', 'if', 'test-pixart', 'test-hunyuan', 'test-flux', 'test-if'),
                          'DiT families')


def get_model_spec(version: str) -> ModelSpec:
    if version in _UNPORTED:
        raise not_ported(f'model version {version!r} (ported: {sorted(_REGISTRY)})',
                         _UNPORTED[version])
    if version not in _REGISTRY:
        raise KeyError(f'unknown model version {version!r}; known: '
                       f'{sorted([*_REGISTRY, *_UNPORTED])}')
    return _REGISTRY[version]
