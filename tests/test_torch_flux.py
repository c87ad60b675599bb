"""The PyTorch port's Flux against the JAX package, at the tiny ``test-flux``
size on the CPU, at fp32: the flow-match scheduler and the img2img kit,
packing and position ids, the VAE without quant convs, every transformer
tap and the output with and without a guidance value, the facade's step
with the attention store, ``encode_prompt``, a 3-step ``sample()``, layer
enumeration, a synthetic diffusers tree loaded by both facades, a
``save_weights`` round trip, the CLI's dumps and the refusals.

The port gets the JAX facade's parameters (numpy-drawn,
``port_parity.jax_facade``) and the noise of the JAX key chain.  At 64^2
the tiny VAE halves the image and the packing halves it again: 256 image
tokens and 16 T5 tokens of 2 heads x 8, so the JAX gate keeps every
attention on the explicit path and no Pallas kernel runs (B1 at d=128 is
held on the card, tests/test_torch_cuda.py).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import extract_feature as jax_cli
from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.enumerate_layers import enumerate_layers as jax_enumerate_layers
from diffusion_feature_tpu.models import flux as jax_flux
from diffusion_feature_tpu.models import vae as jax_vae
from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.schedulers.flow_match import (
    FlowMatchEulerDiscreteScheduler as JaxFlowMatch, calculate_shift as jax_calculate_shift)
from diffusion_feature_tpu.taps import flatten_taps
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch import extract_feature as port_cli
from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
from diffusion_feature_tpu_torch.models import flux, vae
from diffusion_feature_tpu_torch.models.convert import params_from_jax
from diffusion_feature_tpu_torch.models.layers import ATTN_STORE
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from diffusion_feature_tpu_torch.schedulers.flow_match import (
    FlowMatchEulerDiscreteScheduler, calculate_shift)
from diffusion_feature_tpu_torch.taps import TapSpec
from port_parity import (_draw, assert_params_round_trip, jax_facade, jax_noise,
                         jax_sample_noise, load_jax_params)
from synth_checkpoint import write_flux_checkpoint

VERSION, SIZE, BATCH, SEED = 'test-flux', 64, 2, 0
DUAL = ('q', 'k', 'v', 'norm-out', 'out', 'attn-out', 'ffn-inner', 'cross-map', 'self-map')
SINGLE = ('q', 'k', 'v', 'out', 'attn-out', 'cross-map', 'self-map')
# every tap kind of both dual blocks (0, 1) and both single blocks (2, 3)
LAYERS = {**{f'vit-block{i}-{n}': True for i in (0, 1) for n in DUAL},
          **{f'vit-block{i}-{n}': True for i in (2, 3) for n in SINGLE}}
STORE = dict(attention=['up_cross', 'up_self'], attn_store_sizes=(2, 30))
PROMPT = 'a photo of a cat'
LAT = SIZE // 2
# fp32 on both sides: the other slices' tolerance for facade taps and
# 'attn', and 1e-4 relative L2 for the transformer's own taps
ATOL, RTOL, REL = 5e-4, 1e-4, 1e-4


@pytest.fixture(scope='module')
def pair():
    """The JAX facade (fp32 features, numpy-drawn parameters) with taps and
    the store, and the port's with its parameters."""
    jfe = jax_facade(LAYERS, VERSION, SIZE, SEED, **STORE)
    port = FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                            **STORE)
    load_jax_params(jfe, port)
    return jfe, port


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


def _torch(prompts):
    return tuple(None if x is None else torch.from_numpy(np.array(x)) for x in prompts)


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol, rtol=RTOL)


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(ours.double().numpy() - ref) / np.linalg.norm(ref)


def _jax_and_port(pair, image, t, port=None, jfe=None):
    """JAX ``extract`` from a fresh key chain, and the port's step (of
    ``port``, else the pair's) on the same noise and prompts."""
    jfe = jfe or pair[0]
    port = port or pair[1]
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=t)
    posterior, noise = jax_noise(SEED, (BATCH, 4, LAT, LAT))
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    ours = port._step(torch.from_numpy(image), port._step_conditioning(_torch(prompts), BATCH),
                      port._step_kit(t), posterior, noise, None)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)
    return ours, ref


# --------------------------------------------------------------- scheduler
def test_flow_match_scheduler_equals_jax():
    """The ladders (default, mu-shifted with the pipeline's sigmas, and the
    fixed shift), the img2img tail, ``scale_noise`` and a 4-step Euler walk
    from numpy draws."""
    spec = get_model_spec(VERSION)
    ours, ref = FlowMatchEulerDiscreteScheduler(spec.scheduler_config), JaxFlowMatch()
    for seq in (256, 1024, 4096):
        assert calculate_shift(seq, ours.config) == jax_calculate_shift(seq, ref.config)
    for steps, mu in ((28, None), (28, 1.15), (4, 0.6), (50, 0.8)):
        sigmas = None if mu is None else np.linspace(1.0, 1.0 / steps, steps)
        a, b = ours.set_timesteps(steps, mu=mu, sigmas=sigmas), ref.set_timesteps(
            steps, mu=mu, sigmas=sigmas)
        np.testing.assert_array_equal(a.timesteps, b.timesteps)
        np.testing.assert_array_equal(a.sigmas, b.sigmas)
        for strength in (0.05, 0.5, 1.0):
            np.testing.assert_array_equal(ours.get_timesteps(a, steps, strength)[0],
                                          ref.get_timesteps(b, steps, strength)[0])
    fixed = FlowMatchEulerDiscreteScheduler(
        type(ours.config)(use_dynamic_shifting=False))
    np.testing.assert_array_equal(fixed.set_timesteps(10).sigmas, JaxFlowMatch(
        type(ref.config)(use_dynamic_shifting=False)).set_timesteps(10).sigmas)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    a, b = ours.set_timesteps(4, mu=0.9), ref.set_timesteps(4, mu=0.9)
    noise = rs.randn(*x.shape).astype(np.float32)
    np.testing.assert_allclose(
        ours.scale_noise(a, torch.from_numpy(x), torch.from_numpy(noise), a.timesteps[1]).numpy(),
        np.asarray(ref.scale_noise(b, jnp.asarray(x), jnp.asarray(noise), b.timesteps[1])),
        atol=1e-6, rtol=0)
    x_ours, x_ref = torch.from_numpy(x), jnp.asarray(x)
    for t in b.timesteps:
        out = rs.randn(*x.shape).astype(np.float32)
        x_ours, _ = ours.step(a, torch.from_numpy(out), t, x_ours)
        x_ref, _ = ref.step(b, jnp.asarray(out), t, x_ref)
        np.testing.assert_allclose(x_ours.numpy(), np.asarray(x_ref), atol=1e-6, rtol=1e-6)
    assert a.init_noise_sigma == ref.init_noise_sigma == 1.0


@pytest.mark.parametrize('img_size', [64, 1024])
def test_flux_kit_equals_jax(img_size):
    """T, A and B of the resolution-shifted 28-step ladder at several t,
    at the tiny size and at 1024^2 (4096 packed tokens)."""
    def host(scheduler):
        """What the facades' kits read: the scheduler and the latent size."""
        obj = types.SimpleNamespace(scheduler=scheduler, img_size=img_size,
                                    vae_scale=2 if img_size == 64 else 8)
        obj._set_timesteps = lambda n: FeatureExtractor._set_timesteps(obj, n)
        return obj
    ours, ref = host(FlowMatchEulerDiscreteScheduler()), host(JaxFlowMatch())
    for t in (1, 50, 261, 500, 999):
        kit = FeatureExtractor._flux_kit(ours, t)
        assert kit == JaxFeatureExtractor._flux_kit(ref, t), t
        assert kit['A'] + kit['B'] == 1.0
    # the shifted ladder's first timestep >= 50 lies above 50
    assert FeatureExtractor._flux_kit(ours, 50)['T'] > 50


# ------------------------------------------------------- packing and the VAE
def test_packing_and_img_ids_equal_jax():
    x = np.random.RandomState(0).randn(2, 4, 8, 6).astype(np.float32)
    packed = flux.pack_latents(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_flux.pack_latents(x)))
    assert torch.equal(flux.unpack_latents(packed, 8, 6), torch.from_numpy(x))
    np.testing.assert_array_equal(flux.make_img_ids(8, 6), jax_flux.make_img_ids(8, 6))
    ids = np.concatenate([np.zeros((4, 3), np.float32), flux.make_img_ids(8, 8)])
    model = flux.FluxTransformer2D(flux.tiny_flux_config())
    cos, sin = model.rope((4, 4), 4, torch.device('cpu'))
    ref_cos, ref_sin = jax_flux.rope_cos_sin(ids, (2, 2, 4))
    np.testing.assert_array_equal(cos.numpy(), ref_cos)
    np.testing.assert_array_equal(sin.numpy(), ref_sin)


def test_vae_without_quant_convs_equals_jax():
    """A Flux-shaped VAE (16 latent channels, shift and scale, no quant
    convs) at a tiny width: the posterior sample and the decode within
    1e-5 relative L2 of JAX's, and no quant conv parameters."""
    cfg = vae.VAEConfig(block_out_channels=(32, 32), layers_per_block=1, latent_channels=16,
                        scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False)
    jcfg = jax_vae.VAEConfig(block_out_channels=(32, 32), layers_per_block=1,
                             latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                             use_quant_conv=False)
    assert vae.FLUX_VAE.to_diffusers_config() == {
        '_class_name': 'AutoencoderKL', **{k: list(v) if isinstance(v, tuple) else v
                                           for k, v in vars(jax_vae.FLUX_VAE).items()}}
    ref = jax_vae.AutoencoderKL(cfg=jcfg)
    params = _draw(jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 3, 16, 16)),
                                                   method=jax_vae.AutoencoderKL.full_pass)),
                   7)['params']
    ours = vae.AutoencoderKL(cfg)
    assert not any('quant_conv' in k for k in ours.state_dict())
    ours.load_state_dict(params_from_jax(params, ours))
    rs = np.random.RandomState(2)
    img = rs.rand(2, 3, 32, 32).astype(np.float32) * 2 - 1
    noise = rs.randn(2, 16, 16, 16).astype(np.float32)
    # JAX's posterior draw: its own key, replayed as the port's noise
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, x, k: ref.apply({'params': p}, x, k))(params, img, key)
    draw = jax.random.normal(key, (2, 16, 16, 16), jnp.float32)
    with torch.no_grad():
        got = ours(torch.from_numpy(img), torch.from_numpy(np.array(draw)))
        dec = ours.decode(torch.from_numpy(noise))
    assert _rel(got, want) < 1e-5
    want_dec = jax.jit(lambda p, z: ref.apply({'params': p}, z,
                                              method=jax_vae.AutoencoderKL.decode))(params, noise)
    assert _rel(dec, want_dec) < 1e-5
    assert vae.VAEConfig.from_diffusers_config(vae.FLUX_VAE.to_diffusers_config()) == vae.FLUX_VAE


# ------------------------------------------------------------- transformer
_JITTED = {}


def _jax_transformer(jfe):
    if 'unet' not in _JITTED:
        _JITTED['unet'] = jax.jit(lambda p, x, pe, pooled, g: jfe.unet.apply(
            {'params': p}, x, 300.0, pe, pooled, guidance=g, mutable=['taps', 'attn_store']))
    return _JITTED['unet']


@pytest.mark.parametrize('guidance', [None, 3500.0])
def test_transformer_taps_equal_jax(pair, guidance):
    """Every tap of both dual and both single blocks and the packed output
    of one transformer forward (guidance None, i.e. 1000, and 3500) within
    1e-4 relative L2 of JAX's."""
    jfe, port = pair
    rs = np.random.RandomState(4)
    x = rs.randn(BATCH, 256, 16).astype(np.float32)
    pe = rs.randn(BATCH, 16, 32).astype(np.float32)
    pooled = rs.randn(BATCH, 32).astype(np.float32)
    # one jitted JAX forward serves both cases: its guidance None is 1000.0
    # (jax flux.py:467), so the port's None is held against JAX's 1000
    out, state = _jax_transformer(jfe)(jfe.params['unet'], x, pe, pooled,
                                       1000.0 if guidance is None else guidance)
    ref = flatten_taps(state['taps'])
    feats = {}
    with torch.no_grad():
        ours = port.unet(torch.from_numpy(x), 300.0, torch.from_numpy(pe),
                         torch.from_numpy(pooled), guidance, (16, 16), feats=feats)
    feats.pop(ATTN_STORE)   # the pair's store; 'attn' is held in the step's test
    assert sorted(feats) == sorted(ref) == sorted(LAYERS)
    for key, val in ref.items():
        assert _rel(feats[key], val) < REL, key
    assert _rel(ours, out) < REL
    assert torch.equal(feats['vit-block0-out'], feats['vit-block0-norm-out'])


def test_extract_step_equals_jax(pair, image):
    """Every tap and the store's 'attn' (each block's cross and self maps
    of the 16^2 image tokens, averaged: 16 T5 + 256 image keys) at t=500
    and t=50, through the facade's step on JAX's noise."""
    for t in (500, 50):
        ours, ref = _jax_and_port(pair, image, t)
        assert sorted(ours) == sorted(ref) == sorted([*LAYERS, 'attn'])
        assert ours['attn'].shape == (BATCH, 16 + 256, SIZE // 8, SIZE // 8)
        assert ours['vit-block2-cross-map'].shape == (BATCH, 2, 256, 16)
        for key in ref:
            _close(ours[key], ref[key])


def test_encode_prompt_matches_jax(pair):
    """(T5 embeddings (1, 16, 32), None, CLIP pooled (1, 32), None)."""
    jfe, port = pair
    ours, ref = port.encode_prompt(PROMPT), jfe.encode_prompt(PROMPT)
    assert ours[1] is None and ours[3] is None and ref[1] is None and ref[3] is None
    assert ours[0].shape == (1, 16, 32) and ours[2].shape == (1, 32)
    _close(ours[0], ref[0], atol=1e-5)
    _close(ours[2], ref[2], atol=1e-5)


def test_public_extract_takes_a_string_and_refuses_what_jax_lacks(pair, image):
    """A raw prompt string, bf16 features; no denoising_from, no DDIM
    inversion, no 'vae-out', no ControlNet, no int8 on Flux."""
    _, port = pair
    feats = port.extract(PROMPT, BATCH, image, image_type='tensor', t=50)
    assert sorted(feats) == sorted([*LAYERS, 'attn'])
    assert all(v.dtype == torch.bfloat16 for v in feats.values())
    with pytest.raises(ValueError, match='denoising_from is unavailable for the pipeline-driven '
                                         'flux path'):
        port.extract(PROMPT, 1, image[:1], image_type='tensor', denoising_from=60)
    with pytest.raises(NotImplementedError, match='use_ddim_inversion'):
        port.extract(PROMPT, 1, image[:1], image_type='tensor', use_ddim_inversion=True)
    with pytest.raises(ValueError, match="'vae-out' is unavailable for the pipeline-driven flux"):
        FeatureExtractor({'vae-out': True}, VERSION, device='cpu', img_size=SIZE)
    with pytest.raises(ValueError, match='U-Net'):
        FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, control=['canny'])
    # int8 is ported (tests/test_torch_quant.py); as in JAX it needs weights
    for kw in ('transformer_8bit', 't5_8bit'):
        with pytest.raises(ValueError, match=f'{kw}=True requires real weights'):
            FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, **{kw: True})
    with pytest.raises(ValueError, match='transformer_8bit=True requires real weights'):
        port_cli.main(['--version', VERSION, '--device', 'cpu', '--prompt', 'a',
                       '--transformer_8bit', 'true', '--input_dir', 'none', '--output_dir',
                       'none', '--layer', '{"vit-block0-q": true}'])


# ------------------------------------------------------------------ sample
def test_sample_matches_jax(pair):
    """A 3-step flow-match sample at guidance 3.5: no CFG batch (the
    guidance embedding takes 3500), the schedule shifted for 256 packed
    tokens, the Euler step on the unpacked latents (packing commutes with
    it); images and every tap encounter (the JAX side's default scanned
    loop, which equals its unrolled one)."""
    jfe, port = pair
    jfe._rng = jax.random.PRNGKey(SEED)
    ref_images, ref = jfe.sample(PROMPT, batch_size=1, num_inference_steps=3,
                                 guidance_scale=3.5)
    cond, neg = port._sample_conditioning(PROMPT, 1, 3.5)
    assert neg is None and cond.guidance == 3500.0
    images, feats, _ = port._sample(cond, neg, jax_sample_noise(SEED, (1, 4, LAT, LAT)), 3, 3.5)
    _close(images, ref_images)
    assert sorted(feats) == sorted(ref) == sorted(LAYERS)
    for key, encounters in ref.items():
        assert len(feats[key]) == len(encounters) == 3
        for a, b in zip(feats[key], encounters):
            assert a.shape[0] == 1
            _close(a, b)
    public, taps = port.sample(PROMPT, 1, 2, 3.5)
    assert public.shape == (1, 3, SIZE, SIZE) and all(len(v) == 2 for v in taps.values())


# --------------------------------------------------------------- structure
def test_spec_and_params_equal_jax(pair):
    """The registry's Flux specs equal JAX's (transformer, VAE, text
    lengths), and the parameter trees round-trip through both converters."""
    for version in ('flux', VERSION):
        ours, ref = get_model_spec(version), jax_model_spec(version)
        assert (ours.scheduler, ours.prompt_max_length, ours.default_img_size) == (
            ref.scheduler, ref.prompt_max_length, ref.default_img_size)
        assert vars(ref.dit) == vars(ours.dit)   # quantize_int8 too (off in the registry)
        assert vars(ref.vae) == vars(ours.vae)
        assert vars(ref.scheduler_config) == vars(ours.scheduler_config)
    jfe, port = pair
    assert_params_round_trip(jfe.params['unet'], port.unet)
    assert flux.FluxConfig.from_diffusers_config(flux.FLUX_DEV.to_diffusers_config()) == \
        flux.FLUX_DEV


def test_full_size_transformer_parameter_count():
    """Flux.1-dev on the meta device: 11,901,408,320 parameters, the JAX
    preset's count from its ``jax.eval_shape`` init (pinned here: that
    trace of the full model takes seconds on this CPU)."""
    with torch.device('meta'):
        model = flux.FluxTransformer2D(flux.FLUX_DEV)
    assert sum(p.numel() for p in model.parameters()) == 11_901_408_320


def test_show_all_layers_matches_jax():
    """test-flux's ids and shapes through ``show_all_layers`` equal JAX's
    ``eval_shape``; 'flux' at 1024^2 on the meta device has JAX's 437 ids
    (9 of each of 19 dual blocks, 7 of each of 38 single blocks; JAX's
    trace of the full model takes ~11 s, so its count and shapes are
    pinned here, computed once from it)."""
    ours = FeatureExtractor({'vit-block0-q': True}, VERSION, device='cpu',
                            img_size=SIZE).show_all_layers()
    assert ours == jax_enumerate_layers(VERSION, SIZE) and len(ours) == 2 * 9 + 2 * 7
    full = enumerate_layers('flux', 1024)
    assert len(full) == 19 * 9 + 38 * 7 == 437
    assert full['vit-block0-q'] == full['vit-block56-out'] == (1, 3072, 64, 64)
    assert full['vit-block18-cross-map'] == (1, 24, 4096, 512)
    assert full['vit-block56-self-map'] == (1, 24, 4096, 4096)
    assert full['vit-block18-ffn-inner'] == (1, 12288, 64, 64)
    assert 'vit-block19-ffn-inner' not in full and 'vit-block19-norm-out' not in full


# ------------------------------------------------------------- checkpoints
def test_synthetic_tree_loads_in_both_facades(pair, image, tmp_path):
    """``synth_checkpoint.write_flux_checkpoint``'s tree (transformer, a
    VAE with Flux's factors, CLIP, T5), loaded by the JAX facade and the
    port with int8 off on both sides (the auto int8 load is
    tests/test_torch_quant.py's): equal taps."""
    root = write_flux_checkpoint(str(tmp_path / 'tree'))
    layers = {'vit-block1-q': True, 'vit-block3-out': True, 'vit-block0-cross-map': True}
    jfe = JaxFeatureExtractor(layers, VERSION, img_size=SIZE, dtype='float32', weights=root,
                              train_unet=True, transformer_8bit=False, t5_8bit=False)
    port = FeatureExtractor(layers, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                            weights=root, transformer_8bit=False, t5_8bit=False)
    assert port.spec.vae.shift_factor == 0.1159
    assert set(port.load_stats) == {'transformer', 'vae', 'text_encoder', 'text_encoder_2'}
    ours, ref = _jax_and_port(pair, image, 500, port=port, jfe=jfe)
    assert sorted(ours) == sorted(ref) == sorted(layers)
    for key in ref:
        _close(ours[key], ref[key])


def test_save_weights_round_trip(pair, tmp_path, image):
    """``save_weights`` writes transformer/ (two shards), vae/ (no quant
    convs' tensors where the config has none), text_encoder/ (CLIP) and
    text_encoder_2/ (T5); ``weights=`` loads them back, int8 off, to the
    same parameters, prompts and features."""
    _, port = pair
    stats = port.save_weights(str(tmp_path), unet_shards=2)
    assert set(stats) == {'transformer', 'vae', 'text_encoder', 'text_encoder_2'}
    assert len(list((tmp_path / 'transformer').glob('*-0000?-of-00002.safetensors'))) == 2
    cfg = json.loads((tmp_path / 'transformer' / 'config.json').read_text())
    assert cfg['_class_name'] == 'FluxTransformer2DModel' and cfg['axes_dims_rope'] == [2, 2, 4]
    loaded = FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                              weights=str(tmp_path), transformer_8bit=False, t5_8bit=False,
                              **STORE)
    assert loaded.spec == port.spec
    for a, b in ((port.unet, loaded.unet), (port.vae, loaded.vae),
                 *zip(port.text_encoders, loaded.text_encoders)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in zip(port.encode_prompt(PROMPT), loaded.encode_prompt(PROMPT)):
        assert (a is None and b is None) or torch.equal(a, b)
    ours, ref = _jax_and_port(pair, image, 50, port=loaded)
    for key in ref:
        _close(ours[key], ref[key])


def test_cli_matches_jax_cli(pair, monkeypatch, tmp_path):
    """Both CLIs on test-flux over 3 PNGs (batches of 2 and 1), each
    extract on the JAX key chain's noise of its call: the same dump tree,
    values within a bf16-then-fp16 cast; the generation CLI runs a 2-step
    sample with no CFG batch."""
    from diffusion_feature_tpu_torch import generate_with_extraction
    jfe, port = pair
    layers = {'vit-block1-q': True, 'vit-block3-out': True}
    rs = np.random.RandomState(6)
    (tmp_path / 'imgs').mkdir()
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (SIZE, SIZE, 3), np.uint8)).save(
            tmp_path / 'imgs' / f'img{i}.png')
    calls = []

    def jax_factory(layer, version, **kwargs):
        ref = jax_facade(layer, version, SIZE, SEED)
        ref.params = jfe.params
        return ref

    def port_factory(layer, version, **kwargs):
        ours = FeatureExtractor(layer, version, device='cpu', dtype='float32', img_size=SIZE)
        for a, b in ((port.unet, ours.unet), (port.vae, ours.vae),
                     *zip(port.text_encoders, ours.text_encoders)):
            b.load_state_dict(a.state_dict())
        step = ours._step

        def with_jax_noise(img, cond, kit, posterior, noise, out_dtype, **kw):
            n = img.shape[0]
            posterior, noise = (x[:n] for x in jax_noise(SEED, (BATCH, 4, LAT, LAT), len(calls)))
            calls.append(n)
            return step(img, cond, kit, posterior, noise, out_dtype, **kw)
        monkeypatch.setattr(ours, '_step', with_jax_noise)
        return ours

    monkeypatch.setattr(jax_cli, 'FeatureExtractor', jax_factory)
    monkeypatch.setattr(port_cli, 'FeatureExtractor', port_factory)
    common = ['--version', VERSION, '--img_size', str(SIZE), '--dtype', 'float32',
              '--batch_size', str(BATCH), '--layer', json.dumps(layers), '--prompt', PROMPT,
              '--input_dir', str(tmp_path / 'imgs' / '*.png')]
    jax_cli.main([*common, '--output_dir', str(tmp_path / 'jax')])
    port_cli.main([*common, '--output_dir', str(tmp_path / 'port'), '--device', 'cpu'])
    assert calls == [2, 1]
    files = sorted(p.relative_to(tmp_path / 'jax') for p in (tmp_path / 'jax').rglob('*.npy'))
    assert files == sorted(p.relative_to(tmp_path / 'port')
                           for p in (tmp_path / 'port').rglob('*.npy'))
    assert len(files) == 2 * 3
    for f in files:
        ref, ours = np.load(tmp_path / 'jax' / f), np.load(tmp_path / 'port' / f)
        assert ours.dtype == ref.dtype == np.float16 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.astype(np.float32), ref.astype(np.float32), rtol=1e-2,
                                   atol=1e-2 * np.abs(ref).max())
    monkeypatch.undo()
    fe = generate_with_extraction.main([
        '--device', 'cpu', '--version', VERSION, '--img_size', str(SIZE), '--dtype', 'float32',
        '--layer', json.dumps(layers), '--steps', '2', '--guidance_scale', '3.5',
        '--store_steps', '1', '2', '--output', str(tmp_path / 'g.png')])
    assert (tmp_path / 'g.png').exists()
    kept = fe.get_background_extraction()
    assert sorted(kept) == sorted(layers)
    assert all(sorted(v) == [1, 2] and v[1].shape == (1, 256, 16) for v in kept.values())


def test_tap_spec_declares_every_enumerated_id():
    """The ids a full-width build declares (layer validation) are the
    enumerated ones."""
    from diffusion_feature_tpu_torch.taps import declared_ids
    with torch.device('meta'):
        model = flux.FluxTransformer2D(flux.tiny_flux_config(), TapSpec.all())
    assert declared_ids(model) == set(enumerate_layers(VERSION, SIZE))
