"""The PyTorch port's framework-free pieces against the JAX package's:
package isolation from JAX, copied configs and tokenizers, taps and store,
the attention store's aggregation and routing, resizes, image
preprocessing, timestep embedding and the Euler and PNDM schedulers."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusion_feature_tpu import configs as jax_configs
from diffusion_feature_tpu import store as jax_store
from diffusion_feature_tpu.facade import _aggregate_attention as jax_aggregate_attention
from diffusion_feature_tpu import taps as jax_taps
from diffusion_feature_tpu.io import images as jax_images
from diffusion_feature_tpu.models import layers as jax_layers
from diffusion_feature_tpu.models.registry import SD_SCHED as JAX_SD_SCHED
from diffusion_feature_tpu.models.registry import XL_SCHED as JAX_XL_SCHED
from diffusion_feature_tpu.ops import resize as jax_resize
from diffusion_feature_tpu.schedulers import diffusion as jax_sched
from diffusion_feature_tpu.tokenizers import clip_bpe as jax_bpe
from diffusion_feature_tpu_torch import configs, store, taps
from diffusion_feature_tpu_torch.io import images
from diffusion_feature_tpu_torch.models import layers
from diffusion_feature_tpu_torch.models.registry import SD_SCHED, XL_SCHED
from diffusion_feature_tpu_torch.ops import attention as attn_ops
from diffusion_feature_tpu_torch.ops import resize
from diffusion_feature_tpu_torch.schedulers import diffusion as sched
from diffusion_feature_tpu_torch.tokenizers import clip_bpe

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import diffusion_feature_tpu_torch as p\n'
        'names = {m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")}\n'
        'for name in sorted(names):\n'
        '    importlib.import_module(name)\n'
        'want = {"diffusion_feature_tpu_torch." + n for n in ("extract_feature", '
        '"enumerate_layers", "io.dump", "io.prefetch", "native.build", "native.dump_writer", '
        '"ops.flash_attention", "facade", "io.safetensors", "models.lora", "ddim_inversion", '
        '"utils.prompt", "generate_with_extraction", "models.controlnet", "models.depth", '
        '"models.t5", "models.dit_pixart", "tokenizers.t5_tok")}\n'
        'assert want <= names, want - names\n'
        'bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "flax", '
        '"diffusion_feature_tpu", "safetensors", "transformers"))\n'
        'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True, timeout=120)


def test_builtin_configs_are_copies():
    assert configs.BUILTIN_CONFIGS == jax_configs.BUILTIN_CONFIGS
    assert configs.resolve_layer_config('xl-practical') == \
        jax_configs.resolve_layer_config('xl-practical')


@pytest.mark.parametrize('pad_with_eos', [True, False])
def test_hash_tokenizer_matches(pad_with_eos):
    prompts = ['a photo of a cat', '  Two   DOGS, running!  ', '']
    for vocab in (49408, 1000):
        ours = clip_bpe.load_clip_tokenizer(None, vocab_size=vocab, pad_with_eos=pad_with_eos)
        ref = jax_bpe.load_clip_tokenizer(None, vocab_size=vocab, pad_with_eos=pad_with_eos)
        assert ours(prompts) == ref(prompts)


@pytest.mark.parametrize('config', [
    None, {}, {'a-out': True, 'b-out': False}, ['x', 'y'], '{"mid-vit-out": true}',
], ids=['none', 'empty', 'dict', 'list', 'json'])
def test_tapspec_from_config_matches(config):
    ours, ref = taps.TapSpec.from_config(config), jax_taps.TapSpec.from_config(config)
    assert (ours.ids, ours.accept_all) == (ref.ids, ref.accept_all)
    for tap_id in ('a-out', 'b-out', 'x', 'mid-vit-out', 'up-level0-repeat0-vit-block0-cross-k'):
        assert ours.wants(tap_id) == ref.wants(tap_id)


def test_tap_site_writes_only_requested():
    spec = taps.TapSpec.from_config(['blk-q', 'blk-cross-k'])
    site = taps.TapSite(spec, 'blk', ('q', 'k', 'cross-k'))
    out = {}
    for feat in site.ids:
        site.put(out, feat, feat)
    assert out == {'blk-q': 'q'}
    assert site.ids == {'q': 'blk-q', 'k': 'blk-k', 'cross-k': 'blk-cross-k'}


@pytest.mark.parametrize('shape,ratio', [((2, 64, 12), 1), ((2, 36, 5), 4), ((2, 3, 10, 10), 3),
                                         ((1, 2, 16, 16), 2)],
                         ids=['tokens', 'tokens-uneven-pool', 'nchw-uneven', 'map'])
def test_postprocess_feature_matches(shape, ratio):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ours = store.postprocess_feature(torch.from_numpy(x), resize_ratio=ratio, out_dtype=None)
    ref = jax_store.postprocess_feature(jnp.asarray(x), resize_ratio=ratio, out_dtype=None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_postprocess_taps_filters_and_casts():
    x = torch.randn(1, 4, 8)
    out = store.postprocess_taps({'a-cross-q': x, 'a-cross-k': x, 'a-cross-v': x})
    assert list(out) == ['a-cross-q'] and out['a-cross-q'].dtype == torch.bfloat16
    assert out['a-cross-q'].shape == (1, 8, 2, 2)


@pytest.mark.parametrize('size', [(5, 7), (24, 40)], ids=['down', 'up'])
def test_resizes_match(size):
    x = np.random.RandomState(1).randn(2, 3, 12, 20).astype(np.float32)
    np.testing.assert_allclose(
        resize.interpolate_bilinear_nchw(torch.from_numpy(x), size).numpy(),
        np.asarray(jax_resize.interpolate_bilinear_nchw(x, size)), atol=1e-5, rtol=1e-5)
    if size == (24, 40):       # the U-Net's 2x nearest upsample
        np.testing.assert_array_equal(
            resize.interpolate_nearest_nchw(torch.from_numpy(x), size).numpy(),
            np.asarray(jax_resize.interpolate_nearest_nchw(x, size)))


def test_image_preprocessing_matches():
    from PIL import Image
    rng = np.random.RandomState(2)
    pil = [Image.fromarray(rng.randint(0, 256, (40, 30, 3), np.uint8)) for _ in range(2)]
    np.testing.assert_array_equal(images.preprocess_pil_batch(pil, 32),
                                  jax_images.preprocess_pil_batch(pil, 32))
    x = rng.rand(2, 3, 48, 48).astype(np.float32)
    np.testing.assert_allclose(images.resize_tensor_batch(x, 32).numpy(),
                               jax_images.resize_tensor_batch(x, 32), atol=1e-5, rtol=1e-5)
    assert images.resize_tensor_batch(x, 48).shape == (2, 3, 48, 48)


@pytest.mark.parametrize('dim,flip,shift', [(64, True, 0.0), (33, False, 1.0)])
def test_timestep_embedding_matches(dim, flip, shift):
    ts = np.array([0.0, 1.0, 49.0, 999.0, 1024.0], np.float32)
    ours = layers.timestep_embedding(torch.from_numpy(ts), dim, flip, shift)
    ref = jax_layers.timestep_embedding(jnp.asarray(ts), dim, flip, shift)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('config', [XL_SCHED, sched.SchedulerConfig()], ids=['xl', 'linspace'])
def test_euler_scheduler_matches(config):
    jax_config = JAX_XL_SCHED if config is XL_SCHED else jax_sched.SchedulerConfig()
    ours, ref = sched.EulerDiscreteScheduler(config), jax_sched.EulerDiscreteScheduler(jax_config)
    s_ours, s_ref = ours.set_timesteps(1000), ref.set_timesteps(1000)
    np.testing.assert_array_equal(s_ours.timesteps, s_ref.timesteps)
    np.testing.assert_array_equal(s_ours.sigmas, s_ref.sigmas)
    ts_ours, n_ours = ours.get_timesteps(s_ours, 1000, 0.05)
    ts_ref, n_ref = ref.get_timesteps(s_ref, 1000, 0.05)
    np.testing.assert_array_equal(ts_ours, ts_ref)
    assert n_ours == n_ref
    t = ts_ref[0]
    rng = np.random.RandomState(3)
    x, eps = rng.randn(1, 4, 8, 8).astype(np.float32), rng.randn(1, 4, 8, 8).astype(np.float32)
    np.testing.assert_allclose(
        ours.add_noise(s_ours, torch.from_numpy(x), torch.from_numpy(eps), t).numpy(),
        np.asarray(ref.add_noise(s_ref, jnp.asarray(x), jnp.asarray(eps), t)),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        ours.scale_model_input(s_ours, torch.from_numpy(x), t).numpy(),
        np.asarray(ref.scale_model_input(s_ref, jnp.asarray(x), t)), atol=1e-6, rtol=1e-6)


def test_pndm_scheduler_matches():
    ours, ref = sched.PNDMScheduler(SD_SCHED), jax_sched.PNDMScheduler(JAX_SD_SCHED)
    np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)
    s_ours, s_ref = ours.set_timesteps(1000), ref.set_timesteps(1000)
    np.testing.assert_array_equal(s_ours.timesteps, s_ref.timesteps)
    assert s_ours.timesteps.dtype == s_ref.timesteps.dtype
    for strength in (0.05, 0.5, 1.0):
        ts_ours, n_ours = ours.get_timesteps(s_ours, 1000, strength)
        ts_ref, n_ref = ref.get_timesteps(s_ref, 1000, strength)
        np.testing.assert_array_equal(ts_ours, ts_ref)
        assert n_ours == n_ref


def test_aggregate_attention_matches():
    """Category order, then ascending size; averaged per size and resized
    to img/8, against the JAX facade's ``_aggregate_attention``."""
    rng = np.random.RandomState(4)
    maps = {'up_cross': [rng.rand(2, 64, 7) for _ in range(2)] + [rng.rand(2, 16, 7)],
            'up_self': [rng.rand(2, 256, 256), rng.rand(2, 256, 256)]}
    maps = {k: [m.astype(np.float32) for m in v] for k, v in maps.items()}
    cats = ['up_self', 'mid_self', 'up_cross']
    ours = store.aggregate_attention({k: [torch.from_numpy(m) for m in v] for k, v in maps.items()},
                                     cats, 64, None)
    ref = jax_aggregate_attention({k: tuple(jnp.asarray(m) for m in v) for k, v in maps.items()},
                                  cats, 64, None)
    assert ours.shape == (2, 256 + 7 + 7, 8, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert store.aggregate_attention({}, cats, 64, None) is None


@pytest.mark.parametrize('case', ['store', 'map-and-store', 'masked', 'not-requested',
                                  'out-of-band'])
def test_attention_store_routing(case):
    """The store keeps a head-mean map only for a requested category whose
    query count is in the band; every branch computes the same output."""
    torch.manual_seed(0)
    taps_cfg = ['blk-self-map'] if case == 'map-and-store' else []
    cats = frozenset() if case == 'not-requested' else frozenset({'up_self'})
    band = (2, 3) if case == 'out-of-band' else (4, 4)
    module = layers.Attention(32, 2, 16, taps=taps.TapSpec.from_config(taps_cfg or ['x']),
                              tap_name='blk-self',
                              attn_store=layers.AttnStoreCfg('up', *band, cats)).eval()
    x = torch.randn(2, 16, 32)
    mask = torch.zeros(1, 1, 16, 16)
    mask[..., 3:] = -1e4
    mask = mask if case == 'masked' else None
    feats = {}
    with torch.no_grad():
        out = module(x, feats=feats, mask=mask)
        q, k, v = module.to_q(x), module.to_k(x), module.to_v(x)
        ref_out, probs = attn_ops.attention_with_probs(q, k, v, 2, mask=mask)
        ref_out = module.to_out[0](ref_out)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    kept = feats.pop(layers.ATTN_STORE, {})
    if case in ('not-requested', 'out-of-band'):
        assert kept == {}
    else:
        assert list(kept) == ['up_self'] and len(kept['up_self']) == 1
        torch.testing.assert_close(kept['up_self'][0], probs.mean(dim=1), atol=1e-6, rtol=1e-5)
    assert list(feats) == (['blk-self-map'] if case == 'map-and-store' else [])
