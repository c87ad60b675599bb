"""The PyTorch port's PixArt family against the JAX package, at the tiny
``test-pixart`` size on the CPU, at fp32: the DiT's taps at two timesteps
with the attention store and 'vae-out', a ``denoising_from`` walk, the T5
encoder and ``encode_prompt``'s (embeds, mask, negative embeds, negative
mask), DPM-Solver's ladder, step and img2img kit, the sin-cos positions,
a 3-step ``sample()``, layer enumeration (``pixart-sigma`` at full width
on the meta device), and both facades loading the same synthetic
checkpoint (``tests/synth_checkpoint.py::write_pixart_checkpoint``).

The port gets the JAX facade's parameters (numpy-drawn,
``port_parity.jax_facade``) and the noise of the JAX key chain.  At 64^2
the DiT has 256 tokens of 2 heads x 8: the JAX gates keep every attention
on the explicit path, so no Pallas kernel runs (the d=72 kernels' twins are
held to JAX's in tests/test_torch_attention.py).
"""

import dataclasses
import json
import types

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.enumerate_layers import enumerate_layers as jax_enumerate_layers
from diffusion_feature_tpu.models import dit_pixart as jax_dit
from diffusion_feature_tpu.models.convert import convert_torch_state, rename_t5_keys
from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.schedulers import make_scheduler as jax_make_scheduler
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
from diffusion_feature_tpu_torch.models import dit_pixart
from diffusion_feature_tpu_torch.models.convert import params_from_jax
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.models.t5 import jax_param_name
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from diffusion_feature_tpu_torch.schedulers.diffusion import make_scheduler
from port_parity import (assert_params_round_trip, jax_facade, jax_noise, jax_sample_noise,
                         load_jax_params)

VERSION, SIZE, BATCH, SEED = 'test-pixart', 64, 2, 0
LAYERS = {f'vit-block{i}-{n}': True for i in (0, 1)
          for n in ('out', 'self-q', 'self-k', 'self-v', 'cross-q', 'cross-map', 'ffn-inner')}
STORE = dict(attention=['up_cross', 'up_self'], attn_store_sizes=(2, 30))
PROMPT = 'a photo of a cat'
# the U-Net slices' tolerance for taps, 'attn' and multi-step outputs
ATOL, RTOL = 5e-4, 1e-4


@pytest.fixture(scope='module')
def pair():
    """The JAX facade (fp32 features, numpy-drawn parameters) with taps,
    'vae-out' and the store, and the port's with its parameters."""
    layers = {**LAYERS, 'vae-out': True}
    jfe = jax_facade(layers, VERSION, SIZE, SEED, **STORE)
    port = FeatureExtractor(layers, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                            **STORE)
    load_jax_params(jfe, port)
    return jfe, port


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


def _assert_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=ATOL,
                                   rtol=RTOL, err_msg=key)


def _jax_and_port(pair, image, t, **kwargs):
    """JAX ``extract`` from a fresh key chain, and the port's ``_step`` (or
    ``_multistep``) on the same noise, prompt embeddings and mask."""
    jfe, port = pair
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=t, **kwargs)
    lat = SIZE // port.vae_scale
    posterior, noise = jax_noise(SEED, (BATCH, 4, lat, lat))
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    mask = torch.from_numpy(np.array(prompts[1])).expand(BATCH, -1)
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    img = torch.from_numpy(image)
    if kwargs:
        ours = port._multistep(img, pe, None, t, kwargs['denoising_from'], False, posterior,
                               noise, None, mask=mask)
    else:
        ours = port._step(img, pe, None, port._img2img_kit(t), posterior, noise, None, mask=mask)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)
    return ours, ref


@pytest.mark.parametrize('t', [50, 500])
def test_extract_matches_jax(pair, image, t):
    """Every tap of both blocks, the store's 'attn' (self and cross maps of
    the 16^2 tokens, each block's, averaged) and 'vae-out'."""
    ours, ref = _jax_and_port(pair, image, t)
    assert ours['attn'].shape == (BATCH, 24 + 256, SIZE // 8, SIZE // 8)
    assert ours['vae-out'].shape == (BATCH, 3, SIZE, SIZE)
    assert ours['vit-block1-cross-map'].shape == (BATCH, 2, 256, 24)
    _assert_close(ours, ref)


def test_denoising_from_matches_jax(pair, image):
    """A 10-step DPM-Solver walk from timestep 60 (first order, then second
    order from the x0 history), the tapped forward at 50 and 'vae-out'
    from the fresh schedule's step; JAX walks in a scan over per-position
    rows, the port steps ``sched.step``."""
    _assert_close(*_jax_and_port(pair, image, 50, denoising_from=60))


def test_public_extract_refuses_inversion_and_takes_the_mask(pair, image):
    _, port = pair
    prompts = port.encode_prompt(PROMPT)
    with pytest.raises(NotImplementedError, match='use_ddim_inversion'):
        port.extract(prompts, 1, image[:1], image_type='tensor', use_ddim_inversion=True)
    feats = port.extract(prompts, BATCH, image, image_type='tensor', t=50)
    assert sorted(feats) == sorted([*LAYERS, 'vae-out', 'attn'])
    assert all(v.dtype == torch.bfloat16 for v in feats.values())


def test_control_is_refused_on_pixart():
    with pytest.raises(ValueError, match='U-Net'):
        FeatureExtractor({'vit-block0-out': True}, VERSION, device='cpu', img_size=SIZE,
                         control=['canny'])


def test_encode_prompt_matches_jax(pair):
    """(embeds, mask, negative embeds, negative mask): the hash tokenizer's
    ids padded to prompt_max_length, the masks' ones on the tokens and EOS."""
    jfe, port = pair
    ref, ours = jfe.encode_prompt(PROMPT), port.encode_prompt(PROMPT)
    assert len(ours) == 4
    for i in (1, 3):
        assert ours[i].dtype == torch.int32 and ours[i].shape == (1, 24)
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref[i]))
    assert int(ours[1].sum()) == len(PROMPT.split()) + 1 and int(ours[3].sum()) == 1
    for i in (0, 2):
        assert ours[i].shape == (1, 24, 32)
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[i]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('text,masked', [(PROMPT, True), (PROMPT, False),
                                         (' '.join(['word'] * 40), True)],
                         ids=['padded', 'no-mask', 'truncated'])
def test_t5_matches_jax(pair, text, masked):
    """The T5 encoder alone: a padded prompt with and without its mask
    (position bias over all 24 positions), and one cut to 24 tokens."""
    jfe, port = pair
    ids, mask = jfe.tokenizers[0]([text])
    assert port.tokenizers[0]([text]) == (ids, mask)
    ids, mask = np.asarray(ids, np.int32), np.asarray(mask, np.int32)
    ref = jfe.text_encoders[0].apply({'params': jfe.params['text'][0]}, ids,
                                     mask if masked else None)
    with torch.no_grad():
        ours = port.text_encoders[0](torch.from_numpy(ids).long(),
                                     torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_params_round_trip(pair):
    """The DiT's diffusers keys and T5's transformers keys, through the JAX
    loader's own renames (``rename_t5_keys``), give back the JAX trees."""
    jfe, port = pair
    assert_params_round_trip(jfe.params['unet'], port.unet)
    te = port.text_encoders[0]
    tree = jfe.params['text'][0]
    state = rename_t5_keys({k: v.numpy() for k, v in params_from_jax(tree, te,
                                                                     jax_param_name).items()})
    back, missing, unused = convert_torch_state(state, tree)
    assert not missing and not unused
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_spec_equals_jax():
    for version in ('pixart-alpha', 'pixart-sigma', 'pixart-sigma-512', VERSION):
        ours, ref = get_model_spec(version), jax_model_spec(version)
        for name in ('version', 'family', 'hf_id', 'scheduler', 'default_img_size',
                     'prompt_max_length'):
            assert getattr(ours, name) == getattr(ref, name), (version, name)
        for name in ('dit', 't5', 'vae', 'scheduler_config'):
            a, b = getattr(ours, name), getattr(ref, name)
            for f in dataclasses.fields(a):
                assert getattr(a, f.name) == getattr(b, f.name), (version, name, f.name)


# ------------------------------------------------------------- DPM-Solver
def _schedulers():
    spec = get_model_spec(VERSION)
    return (make_scheduler(spec.scheduler, spec.scheduler_config),
            jax_make_scheduler(spec.scheduler, jax_model_spec(VERSION).scheduler_config))


@pytest.mark.parametrize('steps', [1000, 100, 50, 7])
def test_dpm_ladder_equals_jax(steps):
    ours, ref = _schedulers()
    np.testing.assert_array_equal(ours.set_timesteps(steps).timesteps,
                                  ref.set_timesteps(steps).timesteps)
    np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)
    if steps == 1000:
        state = ours.set_timesteps(1000)
        assert ours.get_timesteps(state, 1000, 0.05)[0][0] == 50


def test_dpm_step_equals_jax():
    """Five steps of a 5-step ladder from numpy draws: the first is first
    order, the rest second order from the state's x0 history; the port's
    state is never mutated."""
    ours, ref = _schedulers()
    rs = np.random.RandomState(4)
    sample = rs.randn(2, 4, 8, 8).astype(np.float32)
    s_ours, s_ref = ours.set_timesteps(5), ref.set_timesteps(5)
    x_ours, x_ref = torch.from_numpy(sample), sample
    for t in s_ref.timesteps:
        out = rs.randn(2, 4, 8, 8).astype(np.float32)
        before = s_ours
        x_ours, s_ours = ours.step(s_ours, torch.from_numpy(out), t, x_ours)
        x_ref, s_ref = ref.step(s_ref, out, t, x_ref)
        assert before.ets is not s_ours.ets and len(s_ours.ets) == len(s_ref.ets)
        np.testing.assert_allclose(x_ours.numpy(), np.asarray(x_ref), atol=1e-5, rtol=1e-5)


def test_dpm_kit_equals_jax():
    """The img2img kit's nine scalars (noising, x0, one fresh-state step)."""
    ours, ref = (types.SimpleNamespace(scheduler=s) for s in _schedulers())
    for t in (1, 50, 261, 500, 999):
        assert FeatureExtractor._img2img_kit(ours, t) == JaxFeatureExtractor._img2img_kit(ref, t)
    assert FeatureExtractor._img2img_kit(ours, 50)['T'] == 50.0


@pytest.mark.parametrize('grid,base,scale', [(16, 4, 1), (64, 64, 2), (32, 32, 1)])
def test_sincos_pos_embed_equals_jax(grid, base, scale):
    ours = dit_pixart.sincos_2d_pos_embed(1152, grid, base, scale)
    np.testing.assert_array_equal(ours, jax_dit.sincos_2d_pos_embed(1152, grid, base, scale))


# ---------------------------------------------------------------- sample
def test_sample_matches_jax(pair):
    """A 3-step DPM-Solver sample at guidance 4.5: the CFG batch
    [negative; positive] with its masks in the same order, the learned
    sigma dropped, images and every tap encounter (the JAX side's unrolled
    loop, which its scan equals)."""
    jfe, port = pair
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref_images, ref = jfe.sample(prompts, batch_size=1, num_inference_steps=3,
                                 guidance_scale=4.5, unrolled=True)
    pe, mask, ne, nmask = (torch.from_numpy(np.array(x)) for x in prompts)
    lat = SIZE // port.vae_scale
    images, feats, _ = port._sample(pe, ne, None, None, jax_sample_noise(SEED, (1, 4, lat, lat)),
                                    3, 4.5, torch.cat([nmask, mask]))
    np.testing.assert_allclose(images.numpy(), np.asarray(ref_images), atol=ATOL, rtol=RTOL)
    assert sorted(feats) == sorted(ref) == sorted(LAYERS)
    for key, encounters in ref.items():
        assert len(feats[key]) == len(encounters) == 3
        for a, b in zip(feats[key], encounters):
            assert a.shape[0] == 2
            # the random DiT's latents grow over the CFG steps, and its taps
            # with them (to ~350 by the third call); fp32 rounding grows with
            # the values, so the absolute tolerance follows the tap's largest
            # value where that is far above 1 (here 1e-5 of it, 3.5e-3)
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, atol=max(ATOL, 1e-5 * np.abs(b).max()),
                                       rtol=RTOL, err_msg=key)


def test_public_sample_and_background(pair):
    _, port = pair
    port.set_background_extraction([2])
    try:
        images, feats = port.sample(port.encode_prompt(PROMPT), 1, 2, 4.5)
        assert images.shape == (1, 3, SIZE, SIZE) and sorted(feats) == sorted(LAYERS)
        kept = port.get_background_extraction()
        assert all(sorted(v) == [2] and v[2] is feats[k][1] for k, v in kept.items())
    finally:
        port.store_idx, port._background_feats = None, {}


# ---------------------------------------------------------- enumeration
@pytest.mark.parametrize('version,img_size,count', [(VERSION, SIZE, 16),
                                                    ('pixart-sigma', 1024, 224)])
def test_show_all_layers_matches_jax(version, img_size, count):
    """Ids and shapes: test-pixart through ``show_all_layers``, PixArt-Sigma
    at full width on the meta device (JAX: ``eval_shape``); 8 ids a block,
    no 'vit-out'."""
    if version == VERSION:
        ours = FeatureExtractor({'vit-block0-out': True}, VERSION, device='cpu',
                                img_size=SIZE).show_all_layers()
    else:
        ours = enumerate_layers(version, img_size)
    assert ours == jax_enumerate_layers(version, img_size)
    assert len(ours) == count and 'vit-out' not in ours


# ------------------------------------------------------------ checkpoints
@pytest.fixture(scope='module')
def synth_tree(tmp_path_factory):
    """``write_pixart_checkpoint``'s tree.  Its values are numpy draws; the
    Flax ``init`` it calls gives only the parameter shapes, so it traces
    them (``jax.eval_shape``) instead of running the init eagerly, which
    takes ~25 s on the CPU: the files are the same."""
    from synth_checkpoint import write_pixart_checkpoint
    root = tmp_path_factory.mktemp('pixart')
    init = flax_nn.Module.init

    def shapes_only(self, *args, **kwargs):
        return jax.eval_shape(lambda: init(self, *args, **kwargs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Module, 'init', shapes_only)
        write_pixart_checkpoint(root)
    return str(root)


def test_synth_checkpoint_loads_as_in_jax(synth_tree, image):
    """Both facades load the same tree (DiT and VAE in the JAX package's
    normalised names, T5 in its own): every feature of the same extract
    within the tolerance, the configs adapted from its config.json files."""
    layers = {'vit-block0-out': True, 'vit-block1-cross-q': True, 'vit-block1-self-k': True}
    jfe = JaxFeatureExtractor(layers, VERSION, img_size=SIZE, dtype='float32', seed=SEED,
                              weights=synth_tree, train_unet=True)
    port = FeatureExtractor(layers, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                            seed=SEED, weights=synth_tree)
    assert set(port.load_stats) == {'transformer', 'vae', 'text_encoder'}
    assert port.spec.dit == get_model_spec(VERSION).dit
    for a, b in zip(port.encode_prompt(PROMPT), jfe.encode_prompt(PROMPT)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    ours, ref = _jax_and_port((jfe, port), image, 50)
    _assert_close(ours, ref)


def test_save_weights_round_trip(pair, tmp_path, image):
    """``save_weights`` writes transformer/, vae/ and text_encoder/ (T5 in
    two shards); ``weights=`` loads them back to the same parameters and
    features."""
    _, port = pair
    stats = port.save_weights(str(tmp_path), text_shards=2)
    assert set(stats) == {'transformer', 'vae', 'text_encoder'}
    assert sorted((tmp_path / 'text_encoder').iterdir())[0].name == 'config.json'
    assert len(list((tmp_path / 'text_encoder').glob('model-0000?-of-00002.safetensors'))) == 2
    loaded = FeatureExtractor({**LAYERS, 'vae-out': True}, VERSION, device='cpu', img_size=SIZE,
                              dtype='float32', weights=str(tmp_path), **STORE)
    for a, b in ((port.unet, loaded.unet), (port.vae, loaded.vae),
                 (port.text_encoders[0], loaded.text_encoders[0])):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    prompts = port.encode_prompt(PROMPT)
    kit = port._img2img_kit(50)
    noise = jax_noise(SEED, (BATCH, 4, SIZE // port.vae_scale, SIZE // port.vae_scale))
    img, pe, mask = torch.from_numpy(image), prompts[0].expand(BATCH, -1, -1), prompts[1]
    a = port._step(img, pe, None, kit, *noise, None, mask=mask.expand(BATCH, -1))
    b = loaded._step(img, pe, None, kit, *noise, None, mask=mask.expand(BATCH, -1))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_unported_parts_name_their_items():
    """The int8 T5 is Queue B's; the DiT families' message names what of
    item 9 remains (Flux and DeepFloyd-IF, HunyuanDiT being ported)."""
    from diffusion_feature_tpu_torch.models.t5 import T5EncoderModel, tiny_t5_config
    cfg = dataclasses.replace(tiny_t5_config(), quantize_int8=True)
    with pytest.raises(NotImplementedError, match="Queue B item 3: 'Int8 weight-only dense'"):
        T5EncoderModel(cfg)
    with pytest.raises(NotImplementedError, match='Flux and DeepFloyd-IF'):
        get_model_spec('flux')


def test_generation_cli_on_test_pixart(tmp_path):
    """generate_with_extraction with --version test-pixart: a 2-step
    DPM-Solver sample writes the image and keeps the DiT taps of calls 1
    and 2 over the CFG-doubled batch."""
    from diffusion_feature_tpu_torch import generate_with_extraction
    layer = {'vit-block1-out': True, 'vit-block0-cross-q': True}
    fe = generate_with_extraction.main([
        '--device', 'cpu', '--version', 'test-pixart', '--img_size', str(SIZE), '--dtype',
        'float32', '--steps', '2', '--store_steps', '1', '2', '--layer', json.dumps(layer),
        '--output', str(tmp_path / 'g.png')])
    assert (tmp_path / 'g.png').exists()
    kept = fe.get_background_extraction()
    assert sorted(kept) == sorted(layer)
    assert all(sorted(v) == [1, 2] and v[1].shape == (2, 256, 16) for v in kept.values())


@pytest.mark.parametrize('kind', ['gelu-approximate', 'gelu', 'timestep-gelu'])
def test_gelu_layers_match_jax(kind):
    """The DiTs' FeedForward activations (tanh-approximate, and exact) and
    the TimestepEmbedding's exact-GELU switch, with the same parameters."""
    import jax.numpy as jnp
    from diffusion_feature_tpu.models import layers as jax_layers
    from diffusion_feature_tpu_torch.models import layers
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5, 16).astype(np.float32)
    if kind == 'timestep-gelu':
        ref_mod = jax_layers.TimestepEmbedding(24, act_fn='gelu')
        ours = layers.TimestepEmbedding(16, 24, act_fn='gelu')
        x = x[:, 0]
    else:
        ref_mod = jax_layers.FeedForward(16, activation_fn=kind)
        ours = layers.FeedForward(16, activation_fn=kind)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rs.randn(*s.shape).astype(np.float32) * 0.3),
        jax.eval_shape(lambda: ref_mod.init(jax.random.PRNGKey(0), x)['params']))
    ours.load_state_dict(params_from_jax(params, ours))
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_mod.apply({'params': params}, x)),
                               atol=1e-5, rtol=1e-5)
