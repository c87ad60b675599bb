"""The SD-1.5 single-step slice of the PyTorch port against the JAX facade,
at the tiny ``test-sd`` size on the CPU: CLIP final-layer prompts without a
pooled embedding, the PNDM img2img kit, the taps of a 15-amalgamation-shaped
layer set and the attention store's 'attn' for ['up_cross', 'up_self'].

As in tests/test_torch_slice.py the port takes the JAX facade's random
parameters (drawn by tests/port_parity.py) through ``params_from_jax`` and
the noise of its key chain.
img_size 32 keeps the JAX side off the Pallas kernels (tests/test_torch_slice.py
covers the store through them); the store band 8..16 tokens a side holds the
U-Net's 256-token up level, so its maps take the explicit head mean.
"""

import numpy as np
import pytest
import torch

from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from port_parity import assert_params_round_trip, jax_facade, jax_noise, load_jax_params

SIZE, BATCH, SEED = 32, 2, 0
# test-sd has two U-Net levels; the ids follow '15-amalgamation': cross-q of
# the attention up levels, an upsampler, a self-k
LAYERS = {
    'up-level1-repeat1-vit-block0-cross-q': True,
    'up-level1-repeat0-vit-block0-cross-q': True,
    'up-level0-upsampler-out': True,
    'up-level1-repeat0-vit-block0-self-k': True,
}
CATEGORIES, BAND = ['up_cross', 'up_self'], (8, 16)
PROMPT = 'a photo of a cat'


@pytest.fixture(scope='module')
def pair():
    """(JAX test-sd facade with fp32 features, port facade with its
    parameters)."""
    jfe = jax_facade(LAYERS, 'test-sd', SIZE, SEED, attention=CATEGORIES,
                     attn_store_sizes=BAND, validate_layers=False)
    port = FeatureExtractor(LAYERS, 'test-sd', device='cpu', img_size=SIZE, dtype='float32',
                            attention=CATEGORIES, attn_store_sizes=BAND)
    load_jax_params(jfe, port)
    return jfe, port


def test_encode_prompt_final_layer_matches_jax(pair):
    jfe, port = pair
    ours, ref = port.encode_prompt(PROMPT), jfe.encode_prompt(PROMPT)
    assert ours[2] is None and ours[3] is None and ref[2] is None and ref[3] is None
    assert ours[0].shape == (1, 77, 32)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize('t', [50, 261, 999])
def test_pndm_kit_matches_jax(pair, t):
    jfe, port = pair
    assert port._img2img_kit(t) == jfe._img2img_kit(t)


def test_extract_step_matches_jax(pair):
    """Every tap and 'attn' of the port's step against JAX ``extract``
    (t=50), with the noise of the JAX key chain."""
    jfe, port = pair
    image = np.random.RandomState(3).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1
    prompts = jfe.encode_prompt(PROMPT)
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=50)

    posterior, noise = jax_noise(SEED, (BATCH, 4, SIZE // port.vae_scale, SIZE // port.vae_scale))
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    ours = port._step(torch.from_numpy(image), port._step_conditioning((pe, None, None, None),
                                                                       BATCH),
                      port._img2img_kit(50), posterior, noise, None)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)
    assert sorted(ours) == sorted(ref) == sorted([*LAYERS, 'attn'])
    # the 256-token up level's cross maps (77 keys), then its self maps
    assert ours['attn'].shape == (BATCH, 77 + 256, SIZE // 8, SIZE // 8)
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=5e-4, rtol=1e-4,
                                   err_msg=key)


def test_public_extract_is_bf16(pair):
    _, port = pair
    image = np.random.RandomState(4).rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
    feats = port.extract(port.encode_prompt(PROMPT), BATCH, image, image_type='tensor', t=50)
    assert feats['up-level0-upsampler-out'].shape == (BATCH, 64, 16, 16)
    for val in feats.values():
        assert val.dtype == torch.bfloat16 and torch.isfinite(val.float()).all()


@pytest.mark.parametrize('component', ['unet', 'vae', 'text0'])
def test_params_round_trip(pair, component):
    """params_from_jax then convert_torch_state reproduces the JAX tree."""
    jfe, port = pair
    if component == 'text0':
        tree, module = jfe.params['text'][0], port.text_encoders[0]
    elif component == 'vae':
        tree, module = jfe.params['vae'], port.vae
    else:
        tree, module = jfe.params['unet'], port.unet
    assert_params_round_trip(tree, module)


def test_attn_layer_needs_attention():
    with pytest.raises(ValueError, match="'attn' needs the attention= argument"):
        FeatureExtractor({'attn': True}, 'test-sd', device='cpu', img_size=SIZE)
    FeatureExtractor({'attn': True}, 'test-sd', device='cpu', img_size=SIZE,
                     attention=['up_cross'])
