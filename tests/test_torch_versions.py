"""The U-Net versions the PyTorch port adds, '2-1' (SD-2.1 base) and 'pgv2'
(Playground v2), and SD-2.1's ``upcast_attention``, against the JAX
package on the CPU.

Their full-size models are too large for a CPU test: their specs, img2img
kits and layer enumerations are compared whole, and ``upcast_attention``
with a linear projection runs on a tiny ``test-sd`` checkpoint whose
``unet/config.json`` asks for both, loaded by both facades with the
attention store on at img_size 64: JAX runs its flash and head-mean
kernels in interpret mode there, the port their twins.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.enumerate_layers import enumerate_layers as jax_enumerate_layers
from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.schedulers import make_scheduler as jax_make_scheduler
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
from diffusion_feature_tpu_torch.io.safetensors import load_file, save_file
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.ops import attention as attn_ops
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from diffusion_feature_tpu_torch.schedulers.diffusion import make_scheduler
from port_parity import jax_noise

NEW_VERSIONS = ['2-1', 'pgv2']


def _same_fields(ours, ref):
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize('version', NEW_VERSIONS)
def test_spec_equals_jax(version):
    """Architecture, schedule and text path field by field."""
    ours, ref = get_model_spec(version), jax_model_spec(version)
    for name in ('version', 'hf_id', 'scheduler', 'default_img_size', 'clip_layer'):
        assert getattr(ours, name) == getattr(ref, name), name
    _same_fields(ours.unet, ref.unet)
    _same_fields(ours.vae, ref.vae)
    _same_fields(ours.scheduler_config, ref.scheduler_config)
    assert len(ours.text_encoders) == len(ref.text_encoders)
    for a, b in zip(ours.text_encoders, ref.text_encoders):
        _same_fields(a, b)


@pytest.mark.parametrize('version', ['1-5', *NEW_VERSIONS, 'xl'])
def test_kit_equals_jax(version):
    """The facades' ``_img2img_kit`` on each shipped version's scheduler
    (2-1: Euler with linspace spacing, t=50 -> 49), nine scalars at several
    t."""
    ours = types.SimpleNamespace(scheduler=make_scheduler(
        get_model_spec(version).scheduler, get_model_spec(version).scheduler_config))
    ref = types.SimpleNamespace(scheduler=jax_make_scheduler(
        jax_model_spec(version).scheduler, jax_model_spec(version).scheduler_config))
    for t in (1, 50, 261, 999):
        assert (FeatureExtractor._img2img_kit(ours, t)
                == JaxFeatureExtractor._img2img_kit(ref, t)), t
    assert FeatureExtractor._img2img_kit(ours, 50)['T'] == {'1-5': 51.0, '2-1': 49.0}.get(
        version, 50.0)


@pytest.mark.parametrize('version,img_size,count', [('2-1', 512, 197), ('pgv2', 1024, 612)])
def test_enumeration_equals_jax(version, img_size, count):
    """Ids and reference-layout shapes; 2-1 has 1-5's ids, pgv2 xl's."""
    ours = enumerate_layers(version, img_size)
    assert ours == jax_enumerate_layers(version, img_size)
    assert len(ours) == count


# ------------------------------------------------------- upcast_attention
SIZE, BATCH, SEED = 64, 2, 0
STORE_CATS, STORE_BAND = ['up_cross', 'up_self'], (32, 32)
LAYERS = {'up-level1-repeat0-vit-block0-self-q': True, 'up-level1-repeat1-vit-block0-out': True,
          'mid-vit-block0-out': True, 'unet-out': True}


@pytest.fixture(scope='module')
def upcast_checkpoint(tmp_path_factory):
    """A test-sd checkpoint written by the port, its unet/config.json then
    set to upcast_attention and use_linear_projection (the proj_in/proj_out
    1x1 convs rewritten as the Linear weights they equal)."""
    root = tmp_path_factory.mktemp('upcast')
    FeatureExtractor({'unet-out': True}, 'test-sd', device='cpu', dtype='float32', img_size=SIZE,
                     seed=3).save_weights(str(root))
    unet = root / 'unet'
    cfg = json.loads((unet / 'config.json').read_text())
    cfg.update(upcast_attention=True, use_linear_projection=True)
    (unet / 'config.json').write_text(json.dumps(cfg))
    [name] = [f for f in os.listdir(unet) if f.endswith('.safetensors')]
    state = {k: (v[:, :, 0, 0] if k.endswith(('proj_in.weight', 'proj_out.weight')) else v)
             .clone() for k, v in load_file(str(unet / name)).items()}
    save_file(state, str(unet / name))
    return str(root)


def _store_extractors(root, dtype='float32'):
    return FeatureExtractor(LAYERS, 'test-sd', device='cpu', dtype=dtype, img_size=SIZE,
                            weights=root, attention=STORE_CATS, attn_store_sizes=STORE_BAND)


def test_upcast_checkpoint_with_store_matches_jax(upcast_checkpoint):
    """Both facades adapt the spec (upcast, linear projections) and load the
    same tensors; with the store on, taps and 'attn' agree (the store's
    1024-token self-attentions: JAX B2 + B3 in interpret mode on fp32 q, k
    and v, the port their twins)."""
    jfe = JaxFeatureExtractor(LAYERS, 'test-sd', img_size=SIZE, dtype='float32', seed=SEED,
                              train_unet=True, weights=upcast_checkpoint,
                              attention=STORE_CATS, attn_store_sizes=STORE_BAND)
    port = _store_extractors(upcast_checkpoint)
    assert port.spec.unet.upcast_attention and port.spec.unet.use_linear_projection
    _same_fields(port.spec.unet, jfe.spec.unet)
    image = np.random.RandomState(4).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1
    prompts = jfe.encode_prompt('a photo of a cat')
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=50)
    lat = SIZE // port.vae_scale
    posterior, noise = jax_noise(SEED, (BATCH, 4, lat, lat))
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    ours = port._step(torch.from_numpy(image), port._step_conditioning((pe, None, None, None),
                                                                       BATCH),
                      port._img2img_kit(50), posterior, noise, None)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)
    assert sorted(ours) == sorted(ref) == sorted([*LAYERS, 'attn'])
    assert ours['attn'].shape == (BATCH, 77 + 1024, SIZE // 8, SIZE // 8)
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=5e-4, rtol=1e-4,
                                   err_msg=key)


def test_upcast_hands_the_store_kernels_fp32(upcast_checkpoint, monkeypatch):
    """In bf16, upcast gives B2 and B3 fp32 q, k and v (on the card: the
    fp32 kernels); the fused path's B1 keeps bf16, as JAX's flash path
    ignores upcast; maps and outputs come back in bf16."""
    port = _store_extractors(upcast_checkpoint, 'bfloat16')
    seen = []
    for name in ('flash_attention', 'flash_attention_with_lse', 'headmean_probs'):
        wrapper = getattr(attn_ops, name)
        monkeypatch.setattr(attn_ops, name, lambda q, *a, _n=name, _w=wrapper, **k: (
            seen.append((_n, q.dtype, q.shape[2])) or _w(q, *a, **k)))
    image = np.random.RandomState(4).rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
    feats = port.extract(port.encode_prompt('a photo of a cat'), BATCH, image,
                         image_type='tensor', t=50)
    # test-sd at 64: the 1024-token attentions, the VAE encoder's mid block
    # and down-level0's self-attention fused, up-level1's two in the store
    assert sorted(seen) == sorted([('flash_attention', torch.bfloat16, 1024)] * 2 + [
        ('flash_attention_with_lse', torch.float32, 1024),
        ('headmean_probs', torch.float32, 1024)] * 2)
    assert feats['attn'].dtype == torch.bfloat16
    assert all(torch.isfinite(v.float()).all() for v in feats.values())
