"""Model registry: version string -> architecture and schedule (port of
``diffusion_feature_tpu/models/registry.py``: the U-Nets ``1-5``, ``2-1``,
``xl``, ``pgv2``, ``test-sd`` and ``test-xl``, the PixArt DiTs
``pixart-alpha``, ``pixart-sigma``, ``pixart-sigma-512`` and
``test-pixart``, and HunyuanDiT, ``hunyuan`` and ``test-hunyuan``).

Without a weights path models initialise deterministically at random, which
exercises every shape and the data flow at full width.  The JAX package's
other versions raise ``NotImplementedError`` naming the ROADMAP.md item
that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from ..roadmap import not_ported
from ..schedulers.diffusion import SchedulerConfig
from .bert_text import HUNYUAN_BERT, BertConfig, tiny_bert_config
from .clip_text import (CLIP_VIT_L, OPENCLIP_BIGG, OPENCLIP_VIT_H, CLIPTextConfig,
                        tiny_clip_config)
from .dit_pixart import (PIXART_ALPHA_512, PIXART_SIGMA_512, PIXART_SIGMA_1024, PixArtConfig,
                         tiny_pixart_config)
from .hunyuan import HUNYUAN_DIT, HunyuanConfig, tiny_hunyuan_config
from .t5 import T5_XXL, T5Config, tiny_t5_config
from .unet2d import SD15_UNET, SD21_UNET, SDXL_UNET, UNetConfig, tiny_unet_config
from .vae import SD_VAE, SDXL_VAE, VAEConfig, tiny_vae_config

SD_SCHED = SchedulerConfig(beta_start=0.00085, beta_end=0.012, steps_offset=1)
XL_SCHED = SchedulerConfig(beta_start=0.00085, beta_end=0.012, steps_offset=1,
                           timestep_spacing='leading')
PIXART_SCHED = SchedulerConfig(beta_start=0.0001, beta_end=0.02, beta_schedule='linear')
# HunyuanDiT-Diffusers' scheduler config: DDPM, scaled-linear 0.00085 to
# 0.03, v-prediction, steps_offset 1
HUNYUAN_SCHED = SchedulerConfig(beta_start=0.00085, beta_end=0.03,
                                prediction_type='v_prediction', steps_offset=1)
# HunyuanDiT's mT5 (text_encoder_2)
HUNYUAN_MT5 = T5Config(vocab_size=250112, d_model=2048, d_ff=5120, num_layers=24, num_heads=32,
                       d_kv=64)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A model: its family ('unet' | 'pixart' | 'hunyuan'), scheduler
    ('euler' | 'pndm' | 'dpmsolver' | 'ddpm') and VAE, and the family's
    denoiser and text encoders.
    U-Nets: ``unet`` and CLIP encoders whose chosen hidden states are
    concatenated: 'final' (the final-layernormed output, no pooled
    embedding; SD-1.5, SD-2.1) or 'penultimate' (hidden_states[-2], with
    the last encoder's pooled output; SDXL, Playground v2).  PixArt: the
    DiT ``dit`` and the T5 encoder ``t5`` over ``prompt_max_length``
    tokens.  HunyuanDiT: the DiT ``dit``, BERT ``bert`` over the DiT's
    ``text_len`` tokens and the mT5 ``t5`` over its ``text_len_t5``."""
    version: str
    family: str
    hf_id: str                         # provenance only; nothing is downloaded
    scheduler: str
    scheduler_config: SchedulerConfig
    default_img_size: int
    vae: VAEConfig
    unet: Optional[UNetConfig] = None
    text_encoders: Tuple[CLIPTextConfig, ...] = ()
    clip_layer: str = 'final'
    dit: Optional[Union[PixArtConfig, HunyuanConfig]] = None
    t5: Optional[T5Config] = None
    bert: Optional[BertConfig] = None
    prompt_max_length: int = 77


def _unet(version, hf_id, scheduler, sched_cfg, unet, vae, text_encoders, size, **kw):
    return ModelSpec(version, 'unet', hf_id, scheduler, sched_cfg, size, vae, unet,
                     text_encoders, **kw)


def _pixart(version, hf_id, dit, vae, size, prompt_max_length, t5=T5_XXL):
    return ModelSpec(version, 'pixart', hf_id, 'dpmsolver', PIXART_SCHED, size, vae, dit=dit,
                     t5=t5, prompt_max_length=prompt_max_length)


def _hunyuan(version, hf_id, dit, vae, bert, t5, size, prompt_max_length):
    return ModelSpec(version, 'hunyuan', hf_id, 'ddpm', HUNYUAN_SCHED, size, vae, dit=dit,
                     t5=t5, bert=bert, prompt_max_length=prompt_max_length)


_REGISTRY = {spec.version: spec for spec in (
    _unet('1-5', 'stable-diffusion-v1-5/stable-diffusion-v1-5', 'pndm', SD_SCHED, SD15_UNET,
          SD_VAE, (CLIP_VIT_L,), 512),
    _unet('2-1', 'stabilityai/stable-diffusion-2-1-base', 'euler', SD_SCHED, SD21_UNET, SD_VAE,
          (OPENCLIP_VIT_H,), 512),
    _unet('xl', 'stabilityai/stable-diffusion-xl-base-1.0', 'euler', XL_SCHED, SDXL_UNET,
          SDXL_VAE, (CLIP_VIT_L, OPENCLIP_BIGG), 1024, clip_layer='penultimate'),
    _unet('pgv2', 'playgroundai/playground-v2-1024px-aesthetic', 'euler', XL_SCHED, SDXL_UNET,
          SDXL_VAE, (CLIP_VIT_L, OPENCLIP_BIGG), 1024, clip_layer='penultimate'),
    _unet('test-sd', '(random-init test model)', 'pndm', SD_SCHED,
          tiny_unet_config(cross_dim=32), tiny_vae_config(), (tiny_clip_config(32),), 64),
    _unet('test-xl', '(random-init test model)', 'euler', XL_SCHED,
          tiny_unet_config(cross_dim=64, with_xl_embeds=True), tiny_vae_config(),
          (tiny_clip_config(32), tiny_clip_config(32, projection_dim=32)), 64,
          clip_layer='penultimate'),
    _pixart('pixart-alpha', 'PixArt-alpha/PixArt-XL-2-512x512', PIXART_ALPHA_512, SD_VAE, 512,
            120),
    _pixart('pixart-sigma', 'PixArt-alpha/PixArt-Sigma-XL-2-1024-MS', PIXART_SIGMA_1024,
            SDXL_VAE, 1024, 300),
    _pixart('pixart-sigma-512', 'PixArt-alpha/PixArt-Sigma-XL-2-512-MS', PIXART_SIGMA_512,
            SDXL_VAE, 512, 300),
    _pixart('test-pixart', '(random-init test model)', tiny_pixart_config(), tiny_vae_config(),
            64, 24, tiny_t5_config()),
    _hunyuan('hunyuan', 'Tencent-Hunyuan/HunyuanDiT-Diffusers', HUNYUAN_DIT, SDXL_VAE,
             HUNYUAN_BERT, HUNYUAN_MT5, 1024, 77),
    _hunyuan('test-hunyuan', '(random-init test model)', tiny_hunyuan_config(),
             tiny_vae_config(), tiny_bert_config(), tiny_t5_config(), 64, 8),
)}


_UNPORTED = dict.fromkeys(('flux', 'if', 'test-flux', 'test-if'), 'DiT families')


def get_model_spec(version: str) -> ModelSpec:
    if version in _UNPORTED:
        raise not_ported(f'model version {version!r} (ported: {sorted(_REGISTRY)})',
                         _UNPORTED[version])
    if version not in _REGISTRY:
        raise KeyError(f'unknown model version {version!r}; known: '
                       f'{sorted([*_REGISTRY, *_UNPORTED])}')
    return _REGISTRY[version]
