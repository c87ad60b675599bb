"""The PyTorch port's DeepFloyd IF against the JAX package, at the tiny
``test-if`` size on the CPU, at fp32: every tap of the pixel-space U-Net
(its resnets and samplers, ``unet-in`` and the 6-channel ``unet-out``) at
two timesteps, the text-time embedding and the added-KV attention alone,
the capped-cosine betas, DDPM's learned-range and thresholded steps with
and without noise (the quantile on ties and odd sizes too), the img2img
kit, a 3-step ``sample()`` with CFG, a ``denoising_from`` walk, layer
enumeration, ``encode_prompt``, the CLI's dumps, and a ``save_weights``
tree loaded by both facades.

The port gets the JAX facade's parameters (numpy-drawn,
``port_parity.jax_facade``) and the noise of the JAX key chain.  Every IF
attention has the 8 T5 tokens beside the image's as keys, which the JAX
gate refuses, and the pooling head has one query: no kernel runs, on
either side.  Taps are held within 1e-4 relative L2 (fp32 on both sides).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import extract_feature as jax_cli
from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.enumerate_layers import enumerate_layers as jax_enumerate_layers
from diffusion_feature_tpu.models import unet_if as jax_unet_if
from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.schedulers import make_scheduler as jax_make_scheduler
from diffusion_feature_tpu.schedulers.diffusion import make_betas as jax_make_betas
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch import extract_feature as port_cli
from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from diffusion_feature_tpu_torch.schedulers.diffusion import (DDPMScheduler, make_betas,
                                                              make_scheduler)
from port_parity import (assert_params_round_trip, jax_ddpm_sample_noise, jax_facade, jax_noise,
                         load_jax_params)

VERSION, SIZE, BATCH, SEED = 'test-if', 32, 2, 0
# every id the test-if U-Net declares at 32^2 (resnets, samplers, root taps)
LAYERS = dict.fromkeys(jax_enumerate_layers(VERSION, SIZE), True)
PROMPT = 'a photo of a cat'
SHAPE = (BATCH, 3, SIZE, SIZE)   # pixel space: the noise is the image's shape
# fp32 on both sides: relative L2 per tap
REL = 1e-4


@pytest.fixture(scope='module')
def pair():
    """The JAX facade (fp32 features, numpy-drawn parameters) with every
    tap, and the port's with its parameters."""
    jfe = jax_facade(LAYERS, VERSION, SIZE, SEED)
    port = FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, dtype='float32')
    load_jax_params(jfe, port)
    return jfe, port


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


def _torch(prompts):
    return tuple(None if x is None else torch.from_numpy(np.array(x)) for x in prompts)


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(ours.double().numpy() - ref) / np.linalg.norm(ref)


def _assert_feats(ours, ref, keys=None):
    assert sorted(ours) == sorted(ref) == sorted(keys or LAYERS)
    for key in ref:
        assert tuple(ours[key].shape) == tuple(np.shape(ref[key])), key
        assert _rel(ours[key], ref[key]) < REL, (key, _rel(ours[key], ref[key]))


def _jax_and_port(pair, image, t, denoising_from=None, port=None, jfe=None):
    """JAX ``extract`` from a fresh key chain, and the port's step (or
    multi-step walk) on the same noise and prompts."""
    jfe = jfe or pair[0]
    port = port or pair[1]
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=t,
                      denoising_from=denoising_from)
    posterior, noise = jax_noise(SEED, SHAPE)
    cond = port._step_conditioning(_torch(prompts), BATCH)
    img = torch.from_numpy(image)
    fa.launches = fa.lse_launches = fa.headmean_launches = fa.short_launches = 0
    if denoising_from is None:
        ours = port._step(img, cond, port._step_kit(t), posterior, noise, None)
    else:
        ours = port._multistep(img, cond, t, denoising_from, False, posterior, noise, None)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches, fa.short_launches) == (0,) * 4
    return ours, ref


# ------------------------------------------------------------------- U-Net
@pytest.mark.parametrize('t', [50, 500])
def test_extract_matches_jax(pair, image, t):
    """Every tap of the single step: the image noised at the DDPM img2img
    timestep of ``t`` (no VAE), the U-Net on T5's context."""
    ours, ref = _jax_and_port(pair, image, t)
    assert ours['unet-out'].shape == (BATCH, 6, SIZE, SIZE)
    assert ours['down-level0-downsampler-out'].shape == (BATCH, 32, SIZE // 2, SIZE // 2)
    assert ours['up-level0-upsampler-increment'].shape == (BATCH, 64, SIZE, SIZE)
    _assert_feats(ours, ref)


def test_denoising_from_matches_jax(pair, image):
    """``denoising_from=60``: 10 walk steps of the 1000-step ladder (59 to
    50), each x0 thresholded with no noise added, then the tapped forward
    at 49."""
    ours, ref = _jax_and_port(pair, image, 50, denoising_from=60)
    _assert_feats(ours, ref)


def test_text_time_embedding_and_added_kv_attention_match_jax(pair):
    """The two IF blocks alone: the attention-pooled text embedding (mean
    class token, q and k scaled by head_dim ** -0.25, LayerNorms at eps
    1e-5) and the added-KV attention (keys [text; image], residual)."""
    jfe, port = pair
    spec = jax_model_spec(VERSION).unet
    rs = np.random.RandomState(3)
    text = rs.randn(2, 8, spec.encoder_hid_dim).astype(np.float32)
    ref = jax_unet_if.IFTextTimeEmbedding(
        embed_dim=spec.encoder_hid_dim, time_embed_dim=spec.time_embed_dim,
        num_heads=spec.addition_embed_type_num_heads).apply(
        {'params': jfe.params['unet']['add_embedding']}, jnp.asarray(text))
    with torch.no_grad():
        ours = port.unet.add_embedding(torch.from_numpy(text))
    assert _rel(ours, ref) < REL
    x = rs.randn(2, 64, 16, 16).astype(np.float32)
    ctx = rs.randn(2, 8, spec.cross_attention_dim).astype(np.float32)
    ref = jax_unet_if.AddedKVAttention(
        channels=0, head_dim=spec.attention_head_dim,
        cross_attention_dim=spec.cross_attention_dim).apply(
        {'params': jfe.params['unet']['down_blocks_1_attentions_0']},
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(ctx))
    with torch.no_grad():
        ours = port.unet.down_blocks[1].attentions[0](torch.from_numpy(x), torch.from_numpy(ctx))
    assert _rel(ours, np.asarray(ref).transpose(0, 3, 1, 2)) < REL


def test_encode_prompt_and_params_equal_jax(pair):
    """(T5 embeddings, negative T5 embeddings, None, None) over 8 tokens,
    and the U-Net's diffusers keys back to the JAX tree."""
    jfe, port = pair
    ours, ref = port.encode_prompt(PROMPT), jfe.encode_prompt(PROMPT)
    assert ours[2] is ours[3] is ref[2] is ref[3] is None
    for a, b in zip(ours[:2], ref[:2]):
        assert a.shape == (1, 8, 32) and _rel(a, b) < REL
    assert_params_round_trip(jfe.params['unet'], port.unet)


# --------------------------------------------------------------- scheduler
def test_make_betas_squaredcos_cap_v2():
    """IF's capped cosine betas, the cumulative alphas and the ladders."""
    ours = make_betas('squaredcos_cap_v2', 0.0001, 0.02, 1000)
    np.testing.assert_array_equal(ours, jax_make_betas('squaredcos_cap_v2', 0.0001, 0.02, 1000))
    assert ours.max() == 0.999 and ours.dtype == np.float64
    sched = make_scheduler('ddpm', get_model_spec(VERSION).scheduler_config)
    ref = jax_make_scheduler('ddpm', jax_model_spec(VERSION).scheduler_config)
    np.testing.assert_array_equal(sched.alphas_cumprod, ref.alphas_cumprod)
    for steps in (50, 7):
        np.testing.assert_array_equal(sched.set_timesteps(steps).timesteps,
                                      ref.set_timesteps(steps).timesteps)
    with pytest.raises(ValueError, match='unknown beta schedule'):
        make_betas('cosine', 0.0001, 0.02, 10)


@pytest.mark.parametrize('with_noise', [True, False], ids=['noise', 'no-noise'])
def test_ddpm_learned_range_and_thresholding_steps_equal_jax(with_noise):
    """IF's DDPM (learned range, thresholding at 0.95 and 1.5): a 5-step
    walk from numpy draws with 6-channel model outputs, large enough that
    the threshold s falls between 1 and 1.5 for some samples and clips at
    1.5 for others; the noise scaled by the learned variance at every
    step but the last (t=0)."""
    cfg = get_model_spec(VERSION).scheduler_config
    ours, ref = DDPMScheduler(cfg), jax_make_scheduler('ddpm', jax_model_spec(VERSION)
                                                       .scheduler_config)
    rs = np.random.RandomState(4)
    x = rs.randn(3, 3, 8, 8).astype(np.float32)
    x_ours, x_ref = torch.from_numpy(x), x
    s_ours, s_ref = ours.set_timesteps(5), ref.set_timesteps(5)
    assert s_ref.timesteps[-1] == 0
    for t in s_ref.timesteps:
        out = rs.randn(3, 6, 8, 8).astype(np.float32) * np.array([0.3, 1.0, 3.0],
                                                                 np.float32)[:, None, None, None]
        noise = rs.randn(3, 3, 8, 8).astype(np.float32) if with_noise else None
        x_ours, _ = ours.step(s_ours, torch.from_numpy(out), t, x_ours,
                              None if noise is None else torch.from_numpy(noise))
        x_ref, _ = ref.step(s_ref, out, t, x_ref, noise)
        np.testing.assert_allclose(x_ours.numpy(), np.asarray(x_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('shape,ties', [((2, 3, 5, 7), False), ((3, 1, 1, 19), True),
                                        ((1, 3, 8, 8), True)], ids=['odd', 'ties-odd', 'ties'])
def test_threshold_quantile_equals_jax(shape, ties):
    """The 95% quantile of |x0| interpolates linearly between order
    statistics as ``jnp.quantile`` does, on odd sizes and on ties (values
    on a grid of 0.25)."""
    cfg = get_model_spec(VERSION).scheduler_config
    ours, ref = DDPMScheduler(cfg), jax_make_scheduler('ddpm', jax_model_spec(VERSION)
                                                       .scheduler_config)
    x0 = np.random.RandomState(5).randn(*shape).astype(np.float32) * 1.3
    if ties:
        x0 = np.round(x0 * 4) / 4
    np.testing.assert_allclose(ours._threshold(torch.from_numpy(x0)).numpy(),
                               np.asarray(ref._threshold(jnp.asarray(x0))), atol=1e-7, rtol=1e-6)


def test_img2img_kit_equals_jax(pair):
    """The nine scalars of DDPM's kit (the IF branch): T, A, B, S and the
    x0 and posterior-mean coefficients, at the ends of the ladder too."""
    jfe, port = pair
    for t in (1, 50, 200, 500, 999, 1000):
        assert port._img2img_kit(t) == pytest.approx(jfe._img2img_kit(t), rel=1e-12), t
    assert port._img2img_kit(50)['T'] == 49.0


# ------------------------------------------------------------------ sample
def test_sample_matches_jax(pair):
    """A 3-step DDPM sample at guidance 4.0: CFG on the noise prediction of
    the [negative; positive] batch, the positive's variance, thresholding,
    JAX's per-step noise; the pixels in [0, 1] and every tap encounter
    (the JAX side's scanned loop)."""
    jfe, port = pair
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref_images, ref = jfe.sample(prompts, batch_size=1, num_inference_steps=3, guidance_scale=4.0)
    init, steps = jax_ddpm_sample_noise(SEED, (1, 3, SIZE, SIZE), 3)
    images, feats, _ = port._sample(*port._sample_conditioning(_torch(prompts), 1, 4.0), init, 3,
                                    4.0, steps)
    assert images.shape == (1, 3, SIZE, SIZE) and 0 <= images.min() <= images.max() <= 1
    assert _rel(images, ref_images) < REL
    assert sorted(feats) == sorted(ref) == sorted(LAYERS)
    for key, encounters in ref.items():
        assert len(feats[key]) == len(encounters) == 3
        for a, b in zip(feats[key], encounters):
            assert a.shape[0] == 2 and _rel(a, b) < REL, key


def test_public_paths_and_refusals(pair, image):
    """The public extract (bf16 features), ``extract_ensemble`` and sample;
    ``attention=`` builds and adds no 'attn' (IF's attention is untapped,
    as in JAX); no 'vae-out', no DDIM inversion, no ControlNet."""
    _, port = pair
    feats = port.extract(port.encode_prompt(PROMPT), BATCH, image, image_type='tensor', t=50)
    assert sorted(feats) == sorted(LAYERS) and feats['unet-out'].dtype == torch.bfloat16
    both = port.extract_ensemble(port.encode_prompt(PROMPT), 1, image[:1], image_type='tensor',
                                 ts=(50, 200))
    assert both['unet-out'].shape == (1, 12, SIZE, SIZE)
    images, _ = port.sample(port.encode_prompt(PROMPT), 1, 2, 4.0)
    assert images.shape == (1, 3, SIZE, SIZE)
    stored = FeatureExtractor({'unet-out': True}, VERSION, device='cpu', img_size=SIZE,
                              dtype='float32', attention=['up_cross', 'up_self'],
                              external_model=port)
    assert sorted(stored.extract(stored.encode_prompt(PROMPT), 1, image[:1],
                                 image_type='tensor')) == ['unet-out']
    with pytest.raises(NotImplementedError, match='use_ddim_inversion'):
        port.extract(port.encode_prompt(PROMPT), 1, image[:1], image_type='tensor',
                     use_ddim_inversion=True)
    with pytest.raises(ValueError, match="(?s)unknown/unavailable layer id.*'vae-out'"):
        FeatureExtractor({'vae-out': True}, VERSION, device='cpu', img_size=SIZE)
    with pytest.raises(ValueError, match='control= needs a U-Net version'):
        FeatureExtractor({'unet-out': True}, VERSION, device='cpu', img_size=SIZE,
                         control=['canny'])


# ------------------------------------------------------------- enumeration
@pytest.mark.parametrize('version,size', [(VERSION, SIZE), ('if', 64)])
def test_enumeration_equals_jax(version, size):
    """The ids and shapes at pixel resolution; no attention id ('-vit-',
    '-self-', '-cross-'), as the reference's untapped added-KV attention."""
    ours = enumerate_layers(version, size, batch_size=2)
    assert ours == jax_enumerate_layers(version, size, batch_size=2)
    assert not any(s in k for k in ours for s in ('-vit-', '-self-', '-cross-'))
    assert ours['unet-out'] == (2, 6, size, size)
    assert len(ours) == {VERSION: 23, 'if': 75}[version]


# ------------------------------------------------------------- checkpoints
def test_if_tree_loads_in_both_facades(pair, image, tmp_path):
    """``save_weights`` writes unet/ (IF's config) and text_encoder/ (T5 in
    transformers' keys), no vae/; the port loads it back to the same
    parameters and prompts, and the JAX facade loads it too: equal taps."""
    _, port = pair
    root = str(tmp_path / 'tree')
    stats = port.save_weights(root)
    assert set(stats) == {'unet', 'text_encoder'}
    cfg = json.loads((tmp_path / 'tree' / 'unet' / 'config.json').read_text())
    assert cfg['down_block_types'][0] == 'ResnetDownsampleBlock2D' and cfg['out_channels'] == 6
    (tmp_path / 'tree' / 'tokenizer').mkdir()
    (tmp_path / 'tree' / 'tokenizer' / 'marker.txt').write_text('kept')
    loaded = FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                              weights=root)
    assert loaded.spec == port.spec and loaded.vae is None
    for a, b in ((port.unet, loaded.unet), (port.text_encoders[0], loaded.text_encoders[0])):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(port.encode_prompt(PROMPT)[0], loaded.encode_prompt(PROMPT)[0])
    loaded.save_weights(str(tmp_path / 'again'))
    assert (tmp_path / 'again' / 'tokenizer' / 'marker.txt').read_text() == 'kept'
    jfe = JaxFeatureExtractor(LAYERS, VERSION, img_size=SIZE, dtype='float32', weights=root,
                              train_unet=True)
    ours, ref = _jax_and_port(pair, image, 50, port=loaded, jfe=jfe)
    _assert_feats(ours, ref)


def test_sd_unet_version_refuses_an_if_tree(tmp_path):
    """An IF U-Net's config.json goes to the IF config; under a U-Net
    version it stops the build, naming the version that loads it."""
    from diffusion_feature_tpu_torch.models.unet2d import UNetConfig
    from diffusion_feature_tpu_torch.models.unet_if import IFUNetConfig
    cfg = get_model_spec(VERSION).unet.to_diffusers_config()
    assert UNetConfig.from_diffusers_config(cfg) == IFUNetConfig.from_diffusers_config(cfg)
    (tmp_path / 'unet').mkdir()
    (tmp_path / 'unet' / 'config.json').write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="DeepFloyd IF U-Net; load it with version='if'"):
        FeatureExtractor({'mid-vit-out': True}, 'test-sd', device='cpu', img_size=64,
                         weights=str(tmp_path))


# --------------------------------------------------------------------- CLI
def test_cli_matches_jax_cli(pair, monkeypatch, tmp_path):
    """Both CLIs on test-if over 3 PNGs (batches of 2 and 1), each extract
    on the JAX key chain's noise of its call: the same dump tree, values
    within a bf16-then-fp16 cast; the generation CLI runs a 2-step IF
    sample with CFG and keeps both calls."""
    from diffusion_feature_tpu_torch import generate_with_extraction
    jfe, port = pair
    layers = {'down-level1-repeat0-res-out': True, 'down-level0-downsampler-out': True,
              'unet-out': True}
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
        for a, b in ((port.unet, ours.unet), (port.text_encoders[0], ours.text_encoders[0])):
            b.load_state_dict(a.state_dict())
        step = ours._step

        def with_jax_noise(img, cond, kit, posterior, noise, out_dtype, **kw):
            n = img.shape[0]
            posterior, noise = (x[:n] for x in jax_noise(SEED, SHAPE, len(calls)))
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
    assert len(files) == 3 * 3
    for f in files:
        ref, ours = np.load(tmp_path / 'jax' / f), np.load(tmp_path / 'port' / f)
        assert ours.dtype == ref.dtype == np.float16 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.astype(np.float32), ref.astype(np.float32), rtol=1e-2,
                                   atol=1e-2 * np.abs(ref).max())
    monkeypatch.undo()
    fe = generate_with_extraction.main([
        '--device', 'cpu', '--version', VERSION, '--img_size', str(SIZE), '--dtype', 'float32',
        '--layer', json.dumps(layers), '--steps', '2', '--guidance_scale', '4.0',
        '--store_steps', '1', '2', '--output', str(tmp_path / 'g.png')])
    assert Image.open(tmp_path / 'g.png').size == (SIZE, SIZE)
    kept = fe.get_background_extraction()
    assert sorted(kept) == sorted(layers)
    assert all(sorted(v) == [1, 2] and v[1].shape[0] == 2 for v in kept.values())
