"""Model registry: version string -> architecture and schedule (port of
``diffusion_feature_tpu/models/registry.py``: the U-Nets ``1-5``, ``2-1``,
``xl``, ``pgv2``, ``test-sd`` and ``test-xl``, the PixArt DiTs
``pixart-alpha``, ``pixart-sigma``, ``pixart-sigma-512`` and
``test-pixart``, HunyuanDiT, ``hunyuan`` and ``test-hunyuan``, Flux,
``flux`` and ``test-flux``, and DeepFloyd IF, ``if`` and ``test-if``: every
version of the JAX registry).

Without a weights path models initialise deterministically at random, which
exercises every shape and the data flow at full width.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from ..schedulers.diffusion import SchedulerConfig
from ..schedulers.flow_match import FlowMatchConfig
from .bert_text import HUNYUAN_BERT, BertConfig, tiny_bert_config
from .clip_text import (CLIP_VIT_L, OPENCLIP_BIGG, OPENCLIP_VIT_H, CLIPTextConfig,
                        tiny_clip_config)
from .dit_pixart import (PIXART_ALPHA_512, PIXART_SIGMA_512, PIXART_SIGMA_1024, PixArtConfig,
                         tiny_pixart_config)
from .flux import FLUX_DEV, FluxConfig, tiny_flux_config
from .hunyuan import HUNYUAN_DIT, HunyuanConfig, tiny_hunyuan_config
from .t5 import T5_XXL, T5Config, tiny_t5_config
from .unet2d import SD15_UNET, SD21_UNET, SDXL_UNET, UNetConfig, tiny_unet_config
from .unet_if import IF_I_L, IFUNetConfig, tiny_if_config
from .vae import FLUX_VAE, SD_VAE, SDXL_VAE, VAEConfig, tiny_vae_config

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
# DeepFloyd IF-I-L's scheduler_config.json: the capped cosine betas, the
# learned-range variance and dynamic thresholding at ratio 0.95 and max 1.5
# (not diffusers' defaults 0.995 and 1.0)
IF_SCHED = SchedulerConfig(beta_start=0.0001, beta_end=0.02, beta_schedule='squaredcos_cap_v2',
                           variance_type='learned_range', thresholding=True,
                           dynamic_thresholding_ratio=0.95, sample_max_value=1.5)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A model: its family ('unet' | 'pixart' | 'hunyuan' | 'flux' | 'if'),
    scheduler ('euler' | 'pndm' | 'dpmsolver' | 'ddpm' | 'flowmatch') and
    VAE (None in pixel space), and the family's denoiser and text encoders.
    U-Nets: ``unet`` and CLIP encoders whose chosen hidden states are
    concatenated: 'final' (the final-layernormed output, no pooled
    embedding; SD-1.5, SD-2.1) or 'penultimate' (hidden_states[-2], with
    the last encoder's pooled output; SDXL, Playground v2).  PixArt: the
    DiT ``dit`` and the T5 encoder ``t5`` over ``prompt_max_length``
    tokens.  HunyuanDiT: the DiT ``dit``, BERT ``bert`` over the DiT's
    ``text_len`` tokens and the mT5 ``t5`` over its ``text_len_t5``.  Flux:
    the transformer ``dit``, CLIP-L (its pooled output) and the T5 ``t5``
    over ``prompt_max_length`` tokens.  DeepFloyd IF: the pixel-space
    U-Net ``unet`` (an ``IFUNetConfig``), no VAE, and the T5 encoder ``t5``
    over ``prompt_max_length`` tokens."""
    version: str
    family: str
    hf_id: str                         # provenance only; nothing is downloaded
    scheduler: str
    scheduler_config: Union[SchedulerConfig, FlowMatchConfig]
    default_img_size: int
    vae: Optional[VAEConfig]
    unet: Optional[Union[UNetConfig, IFUNetConfig]] = None
    text_encoders: Tuple[CLIPTextConfig, ...] = ()
    clip_layer: str = 'final'
    dit: Optional[Union[PixArtConfig, HunyuanConfig, FluxConfig]] = None
    t5: Optional[T5Config] = None
    bert: Optional[BertConfig] = None
    prompt_max_length: int = 77
    is_pixel_space: bool = False       # DeepFloyd IF: the denoiser sees the image


def _unet(version, hf_id, scheduler, sched_cfg, unet, vae, text_encoders, size, **kw):
    return ModelSpec(version, 'unet', hf_id, scheduler, sched_cfg, size, vae, unet,
                     text_encoders, **kw)


def _pixart(version, hf_id, dit, vae, size, prompt_max_length, t5=T5_XXL):
    return ModelSpec(version, 'pixart', hf_id, 'dpmsolver', PIXART_SCHED, size, vae, dit=dit,
                     t5=t5, prompt_max_length=prompt_max_length)


def _hunyuan(version, hf_id, dit, vae, bert, t5, size, prompt_max_length):
    return ModelSpec(version, 'hunyuan', hf_id, 'ddpm', HUNYUAN_SCHED, size, vae, dit=dit,
                     t5=t5, bert=bert, prompt_max_length=prompt_max_length)


def _flux(version, hf_id, dit, vae, clip, t5, size, prompt_max_length):
    return ModelSpec(version, 'flux', hf_id, 'flowmatch', FlowMatchConfig(), size, vae,
                     text_encoders=(clip,), dit=dit, t5=t5,
                     prompt_max_length=prompt_max_length)


def _if(version, hf_id, unet, t5, size, prompt_max_length):
    return ModelSpec(version, 'if', hf_id, 'ddpm', IF_SCHED, size, None, unet=unet, t5=t5,
                     prompt_max_length=prompt_max_length, is_pixel_space=True)


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
    _flux('flux', 'black-forest-labs/FLUX.1-dev', FLUX_DEV, FLUX_VAE, CLIP_VIT_L, T5_XXL, 1024,
          512),
    _flux('test-flux', '(random-init test model)', tiny_flux_config(),
          tiny_vae_config(latent_channels=4), tiny_clip_config(32), tiny_t5_config(), 64, 16),
    _if('if', 'DeepFloyd/IF-I-L-v1.0', IF_I_L, T5_XXL, 64, 77),
    _if('test-if', '(random-init test model)', tiny_if_config(), tiny_t5_config(), 32, 8),
)}


def get_model_spec(version: str) -> ModelSpec:
    if version not in _REGISTRY:
        raise KeyError(f'unknown model version {version!r}; known: {sorted(_REGISTRY)}')
    return _REGISTRY[version]
