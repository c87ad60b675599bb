"""The SDXL single-step slice of the PyTorch port against the JAX facade,
at the tiny ``test-xl`` size on the CPU.

The port is loaded with the JAX facade's random parameters through
``params_from_jax``, and its step is fed the noise the JAX facade draws from
its key chain (torch cannot replay JAX's generator).  img_size 32 keeps the
JAX side off the Pallas kernel: at 64, test-xl's two-level VAE leaves a
32x32 latent whose 1024-token self-attention passes the JAX flash gate.
"""

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.models.convert import convert_torch_state
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.models.convert import params_from_jax
from diffusion_feature_tpu_torch.ops import flash_attention as fa

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
    """(JAX facade, port facade with the JAX parameters).  The JAX facade
    keeps fp32 features (train_unet=True only drops its bf16 feature cast)
    so taps compare at fp32."""
    jfe = JaxFeatureExtractor(LAYERS, 'test-xl', img_size=SIZE, dtype='float32',
                              seed=SEED, train_unet=True)
    port = FeatureExtractor(LAYERS, 'test-xl', device='cpu', img_size=SIZE, dtype='float32')
    port.unet.load_state_dict(params_from_jax(jfe.params['unet'], port.unet))
    port.vae.load_state_dict(params_from_jax(jfe.params['vae'], port.vae))
    for te, p in zip(port.text_encoders, jfe.params['text']):
        te.load_state_dict(params_from_jax(p, te))
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
    # the facade's key chain: split(PRNGKey(seed)) -> split(step_rng) -> draws
    _, step_rng = jax.random.split(jax.random.PRNGKey(SEED))
    rng_vae, rng_noise = jax.random.split(step_rng)
    lat = (BATCH, 4, SIZE // port.vae_scale, SIZE // port.vae_scale)
    posterior = np.array(jax.random.normal(rng_vae, lat, np.float32))
    noise = np.array(jax.random.normal(rng_noise, lat, np.float32))
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=50)

    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    pooled = torch.from_numpy(np.array(prompts[2])).expand(BATCH, -1)
    fa.launches = 0
    ours = port._step(torch.from_numpy(image), pe, pooled, port._img2img_kit(50),
                      torch.from_numpy(posterior), torch.from_numpy(noise), None)
    assert fa.launches == 0
    kit, ref_kit = port._img2img_kit(50), jfe._img2img_kit(50)
    assert kit == {k: ref_kit[k] for k in kit}
    assert sorted(ours) == sorted(ref) == sorted(
        k for k in LAYERS if 'cross-k' not in k)
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
        # the port has the encoder half only
        tree = {k: jfe.params['vae'][k] for k in ('encoder', 'quant_conv')}
        module = port.vae
    else:
        tree, module = jfe.params['unet'], port.unet
    state = {k: v.numpy() for k, v in params_from_jax(tree, module).items()}
    back, missing, unused = convert_torch_state(state, tree)
    assert not missing and not unused
    want = traverse_util.flatten_dict(tree)
    got = traverse_util.flatten_dict(back)
    assert got.keys() == want.keys()
    for path, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(val), err_msg=str(path))


def test_offload_prompt_encoder(pair):
    _, port = pair
    pe = port.encode_prompt(PROMPT)[0]
    port.offload_prompt_encoder()
    assert torch.equal(port.encode_prompt(PROMPT)[0], pe)


def test_layer_validation_suggests_near_miss():
    with pytest.raises(ValueError, match='did you mean: up-level1-repeat0-vit-block0-cross-q'):
        FeatureExtractor({'up-level1-repeat0-vit-block0-crosq': True}, 'test-xl',
                         device='cpu', img_size=SIZE)


@pytest.mark.parametrize('kwargs', [
    {'offline_lora': 'lora.safetensors'}, {'weights': 'ckpt'}, {'control': ['canny']},
    {'attention': ['up_cross']}, {'version': '1-5'}, {'layer': {'vae-out': True}},
], ids=['lora', 'weights', 'control', 'attention', 'version', 'vae-out'])
def test_unported_options_raise(kwargs):
    args = dict(layer={'mid-vit-out': True}, version='test-xl', device='cpu', img_size=SIZE)
    args.update(kwargs)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        FeatureExtractor(**args)


@pytest.mark.parametrize('kwargs', [{'denoising_from': 100}, {'use_ddim_inversion': True}],
                         ids=['denoising_from', 'ddim_inversion'])
def test_unported_extract_paths_raise(pair, image, kwargs):
    _, port = pair
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        port.extract(None, BATCH, image, image_type='tensor', **kwargs)
