"""The VAE decoder and the 'vae-out' pseudo-layer of the PyTorch port
against the JAX facade, at the tiny ``test-sd`` (PNDM) and ``test-xl``
(Euler) sizes on the CPU, at fp32.

The port gets the JAX facade's parameters (the decoder's too) and the noise
of its key chain.  img_size 32 leaves a 16x16 latent, so every attention,
the decoder's mid block included, takes the explicit path on both sides.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from port_parity import jax_facade, jax_noise, load_jax_params

SIZE, BATCH, SEED = 32, 2, 0
LAYERS = {'vae-out': True, 'mid-vit-block0-out': True, 'unet-out': True}
PROMPT = 'a photo of a cat'
ATOL, RTOL = 5e-4, 1e-4
VERSIONS = ['test-sd', 'test-xl']


@pytest.fixture(scope='module')
def pairs():
    """{version: (JAX facade with fp32 features, port facade with its
    parameters)}."""
    out = {}
    for version in VERSIONS:
        jfe = jax_facade(LAYERS, version, SIZE, SEED)
        port = FeatureExtractor(LAYERS, version, device='cpu', img_size=SIZE, dtype='float32')
        load_jax_params(jfe, port)
        out[version] = jfe, port
    return out


@pytest.mark.parametrize('version', VERSIONS)
def test_kit_equals_jax(pairs, version):
    """All nine scalars of ``_img2img_kit`` (T, A, B, S, X1, X2, C1-C3) at
    several t, the prediction-type folds included."""
    jfe, port = pairs[version]
    for t in (1, 50, 261, 999):
        kit, ref = port._img2img_kit(t), jfe._img2img_kit(t)
        assert sorted(kit) == sorted(ref) == sorted(
            ['T', 'A', 'B', 'S', 'X1', 'X2', 'C1', 'C2', 'C3'])
        assert kit == ref, t
    scheds = (port.scheduler, jfe.scheduler)
    try:
        for pred in ('v_prediction', 'sample'):
            for sched in scheds:
                sched.config = dataclasses.replace(sched.config, prediction_type=pred)
            jfe._kit_cache = {}
            if version == 'test-sd' and pred == 'sample':
                for fe in (port, jfe):
                    with pytest.raises(NotImplementedError, match="'sample' with PNDM"):
                        fe._img2img_kit(50)
            else:
                assert port._img2img_kit(50) == jfe._img2img_kit(50), pred
    finally:
        for sched in scheds:
            sched.config = dataclasses.replace(sched.config, prediction_type='epsilon')
        jfe._kit_cache = {}


@pytest.mark.parametrize('version', VERSIONS)
def test_vae_out_matches_jax(pairs, version):
    """The single step's taps and its 'vae-out' (the kit's fresh-state step
    decoded) against JAX ``extract`` at t=50."""
    jfe, port = pairs[version]
    jfe._rng = jax.random.PRNGKey(SEED)
    image = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1
    prompts = jfe.encode_prompt(PROMPT)
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=50)
    lat = SIZE // port.vae_scale
    posterior, noise = jax_noise(SEED, (BATCH, 4, lat, lat))
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    pooled = None if prompts[2] is None else torch.from_numpy(np.array(prompts[2])).expand(
        BATCH, -1)
    fa.launches = 0
    ours = port._step(torch.from_numpy(image), port._step_conditioning((pe, None, pooled, None),
                                                                       BATCH),
                      port._img2img_kit(50), posterior, noise, None)
    assert fa.launches == 0
    assert sorted(ours) == sorted(ref) == sorted(LAYERS)
    assert ours['vae-out'].shape == (BATCH, 3, SIZE, SIZE)
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


def test_decode_matches_jax(pairs):
    """``AutoencoderKL.decode`` (post_quant_conv, the decoder) on the same
    latents as the JAX module's."""
    from diffusion_feature_tpu.models.vae import AutoencoderKL as JaxVAE
    jfe, port = pairs['test-sd']
    z = np.random.RandomState(2).randn(BATCH, 4, 16, 16).astype(np.float32)
    ref = jfe.vae.apply({'params': jfe.params['vae']}, z, method=JaxVAE.decode)
    with torch.inference_mode():
        ours = port.vae.decode(torch.from_numpy(z))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_public_vae_out_has_feature_dtype_and_no_resize():
    """'vae-out' comes back in the feature dtype at the image size, with no
    ``feature_resize`` (the taps are resized), as in the JAX facade; it is
    a valid layer id."""
    port = FeatureExtractor(LAYERS, 'test-sd', device='cpu', img_size=SIZE, feature_resize=2)
    image = np.random.RandomState(3).rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
    feats = port.extract(port.encode_prompt(PROMPT), BATCH, image, image_type='tensor', t=50)
    assert feats['vae-out'].shape == (BATCH, 3, SIZE, SIZE)
    assert feats['unet-out'].shape == (BATCH, 4, SIZE // 4, SIZE // 4)
    for val in feats.values():
        assert val.dtype == torch.bfloat16 and torch.isfinite(val.float()).all()
    with pytest.raises(ValueError, match='vae-ot'):
        FeatureExtractor({'vae-ot': True}, 'test-sd', device='cpu', img_size=SIZE)
