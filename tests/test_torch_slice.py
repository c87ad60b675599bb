"""The SDXL single-step slice of the PyTorch port against the JAX facade,
at the tiny ``test-xl`` size on the CPU.

The port is loaded with the JAX facade's random parameters through
``params_from_jax``, and its step is fed the noise the JAX facade draws from
its key chain (torch cannot replay JAX's generator).  img_size 32 keeps the
JAX side off the Pallas kernels.  The attention-store slice runs at 64,
where test-xl's two-level VAE leaves a 32x32 latent: its 1024-token
self-attentions pass the JAX gates, so JAX runs the flash and head-mean
kernels in interpret mode and the port runs their twins.
"""

import numpy as np
import pytest
import torch

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from port_parity import assert_params_round_trip, jax_facade, jax_noise, load_jax_params

SIZE, BATCH, SEED = 32, 2, 0
LAYERS = {
    'down-level0-repeat0-res-out': True,
    'down-level0-repeat0-vit-block0-self-q': True,
    'down-level0-downsampler-out': True,
    'mid-vit-block0-out': True,
    'up-level1-repeat0-vit-block0-cross-q': True,
    'up-level1-repeat0-vit-block0-cross-k': True,     # filtered at store time
    'up-level1-repeat0-vit-block0-ffn-inner': True,
    'up-level1-repeat1-vit-block0-self-map': True,
    'unet-out': True,
}
PROMPT = 'a photo of a cat'


@pytest.fixture(scope='module')
def pair():
    """(JAX facade with fp32 features, port facade with its parameters)."""
    jfe = jax_facade(LAYERS, 'test-xl', SIZE, SEED)
    port = FeatureExtractor(LAYERS, 'test-xl', device='cpu', img_size=SIZE, dtype='float32')
    load_jax_params(jfe, port)
    return jfe, port


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


def test_encode_prompt_matches_jax(pair):
    jfe, port = pair
    for ours, ref in zip(port.encode_prompt(PROMPT), jfe.encode_prompt(PROMPT)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_extract_step_matches_jax(pair, image):
    """Every requested tap of the port's step against JAX ``extract`` (t=50),
    at the tolerance of TestFullExtractStep (tests/test_golden_parity.py)."""
    jfe, port = pair
    prompts = jfe.encode_prompt(PROMPT)
    posterior, noise = jax_noise(SEED, (BATCH, 4, SIZE // port.vae_scale, SIZE // port.vae_scale))
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=50)

    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    pooled = torch.from_numpy(np.array(prompts[2])).expand(BATCH, -1)
    fa.launches = 0
    ours = port._step(torch.from_numpy(image), pe, pooled, port._img2img_kit(50),
                      posterior, noise, None)
    assert fa.launches == 0
    kit, ref_kit = port._img2img_kit(50), jfe._img2img_kit(50)
    assert kit == {k: ref_kit[k] for k in kit}
    assert sorted(ours) == sorted(ref) == sorted(
        k for k in LAYERS if 'cross-k' not in k)
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=5e-4, rtol=1e-4,
                                   err_msg=key)


STORE_SIZE, STORE_BAND, STORE_CATS = 64, (32, 32), ['up_cross', 'up_self']


def test_attention_store_step_matches_jax(pair):
    """The attention store at img_size 64 (band 32..32 tokens a side): taps
    and 'attn' against JAX.  up-level1-repeat0's self-attention takes the
    head-mean kernels' path (JAX: B2 + B3 in interpret mode; the port: their
    twins), repeat1's the requested map plus its head mean, the cross
    attentions the explicit head mean."""
    jfe, port = pair
    jstore = JaxFeatureExtractor(LAYERS, 'test-xl', img_size=STORE_SIZE, dtype='float32',
                                 seed=SEED, train_unet=True, external_model=jfe,
                                 attention=STORE_CATS, attn_store_sizes=STORE_BAND,
                                 validate_layers=False)
    ours_fe = FeatureExtractor(LAYERS, 'test-xl', device='cpu', img_size=STORE_SIZE,
                               dtype='float32', attention=STORE_CATS,
                               attn_store_sizes=STORE_BAND)
    ours_fe.unet.load_state_dict(port.unet.state_dict())
    ours_fe.vae.load_state_dict(port.vae.state_dict())
    image = np.random.RandomState(2).rand(BATCH, 3, STORE_SIZE, STORE_SIZE).astype(np.float32)
    prompts = jfe.encode_prompt(PROMPT)
    ref = jstore.extract(prompts, BATCH, image * 2 - 1, image_type='tensor', t=50)

    lat = STORE_SIZE // ours_fe.vae_scale
    posterior, noise = jax_noise(SEED, (BATCH, 4, lat, lat))
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    pooled = torch.from_numpy(np.array(prompts[2])).expand(BATCH, -1)
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    ours = ours_fe._step(torch.from_numpy(image * 2 - 1), pe, pooled, ours_fe._img2img_kit(50),
                         posterior, noise, None)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)
    assert sorted(ours) == sorted(ref)
    # two 1024-token levels' cross maps (77 keys) then self maps (1024 keys)
    assert ours['attn'].shape == (BATCH, 77 + 1024, STORE_SIZE // 8, STORE_SIZE // 8)
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=5e-4, rtol=1e-4,
                                   err_msg=key)


def test_public_extract_shapes(pair, image):
    _, port = pair
    fa.launches = 0
    feats = port.extract(port.encode_prompt(PROMPT), BATCH, image, image_type='tensor', t=50)
    assert fa.launches == 0
    assert feats['up-level1-repeat0-vit-block0-cross-q'].shape == (BATCH, 32, 16, 16)
    assert feats['up-level1-repeat1-vit-block0-self-map'].shape == (BATCH, 2, 256, 256)
    assert feats['mid-vit-block0-out'].shape == (BATCH, 64, 8, 8)
    for val in feats.values():
        assert val.dtype == torch.bfloat16 and torch.isfinite(val.float()).all()


@pytest.mark.parametrize('component', ['unet', 'vae', 'text0', 'text1'])
def test_params_round_trip(pair, component):
    """params_from_jax then convert_torch_state reproduces the JAX tree."""
    jfe, port = pair
    if component.startswith('text'):
        i = int(component[-1])
        tree, module = jfe.params['text'][i], port.text_encoders[i]
    elif component == 'vae':
        tree, module = jfe.params['vae'], port.vae
    else:
        tree, module = jfe.params['unet'], port.unet
    assert_params_round_trip(tree, module)


def test_offload_prompt_encoder(pair):
    _, port = pair
    pe = port.encode_prompt(PROMPT)[0]
    port.offload_prompt_encoder()
    assert torch.equal(port.encode_prompt(PROMPT)[0], pe)


def test_layer_validation_suggests_near_miss():
    with pytest.raises(ValueError, match='did you mean: up-level1-repeat0-vit-block0-cross-q'):
        FeatureExtractor({'up-level1-repeat0-vit-block0-crosq': True}, 'test-xl',
                         device='cpu', img_size=SIZE)


@pytest.mark.parametrize('kwargs,item', [
    # ControlNet, PixArt and HunyuanDiT are ported; on an unported DiT family
    # the version raises
    ({'weights': 'use_quant_conv'}, 'A item 9'),
    ({'control': ['canny'], 'version': 'test-flux'}, 'A item 9'),
    ({'attention': ['up_cross'], 'version': 'flux'}, 'A item 9'), ({'version': 'if'}, 'A item 9'),
    # the JAX facade's keywords at other values than their defaults
    ({'train_unet': True}, 'A item 10'), ({'external_model': object()}, 'A item 15'),
    ({'mesh': object()}, 'A item 11'), ({'t5_8bit': True}, 'B item 3'),
    ({'transformer_8bit': True}, 'B item 3'),
], ids=['weights', 'control', 'attention', 'version', 'train_unet', 'external_model', 'mesh',
        't5_8bit', 'transformer_8bit'])
def test_unported_options_raise(tmp_path, kwargs, item):
    args = dict(layer={'mid-vit-out': True}, version='test-xl', device='cpu', img_size=SIZE)
    args.update(kwargs)
    if 'weights' in kwargs:
        # a checkpoint whose VAE has no quant convs, as Flux's (Queue A item 9)
        (tmp_path / 'vae').mkdir()
        (tmp_path / 'vae' / 'config.json').write_text('{"use_quant_conv": false}')
        args['weights'] = str(tmp_path)
    with pytest.raises(NotImplementedError, match=f'ROADMAP.md, Queue {item}:'):
        FeatureExtractor(**args)


def test_jax_keywords_at_their_defaults_pass():
    """train_unet, external_model, mesh, t5_8bit and transformer_8bit at the
    JAX facade's defaults build the extractor."""
    fe = FeatureExtractor({'mid-vit-out': True}, 'test-sd', device='cpu', img_size=SIZE,
                          train_unet=False, external_model=None, mesh=None, t5_8bit=None,
                          transformer_8bit=None)
    assert fe.feature_dtype == torch.bfloat16
