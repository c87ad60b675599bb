"""``external_model`` in the PyTorch port against the JAX package's, on the
CPU at fp32: a second extractor over the first's tensors (the same
``data_ptr`` for every parameter, no new parameter memory) with other taps
and the attention store, equal to JAX's second extractor built with
``external_model`` on ``test-sd`` and ``test-pixart``; the first keeps its
own taps; and the refusals (another version, device or dtype; weights or a
LoRA beside it).
"""

import jax
import numpy as np
import pytest
import torch

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu_torch import FeatureExtractor
from port_parity import jax_facade, jax_noise, load_jax_params

SEED, BATCH, SIZE, PROMPT = 0, 2, 64, 'a photo of a cat'
# (first extractor's taps, second's taps, second's store arguments)
CASES = {
    'test-sd': ({'mid-vit-block0-cross-q': True, 'up-level1-repeat0-vit-block0-out': True},
                {'down-level0-repeat0-res-out': True, 'up-level1-repeat1-vit-block0-self-q': True,
                 'unet-out': True},
                dict(attention=['up_cross', 'up_self'], attn_store_sizes=(32, 32))),
    'test-pixart': ({'vit-block0-out': True},
                    {'vit-block1-self-q': True, 'vit-block1-cross-map': True},
                    dict(attention=['up_cross', 'up_self'], attn_store_sizes=(2, 30))),
}
# fp32 on both sides: the slices' tolerance for taps and 'attn'
ATOL, RTOL = 5e-4, 1e-4


def _step(fe, prompts, image):
    """The port extractor's step on the first extract's JAX noise."""
    posterior, noise = jax_noise(SEED, fe.latent_shape(BATCH))
    cond = fe._step_conditioning(
        tuple(None if x is None else torch.from_numpy(np.array(x)) for x in prompts), BATCH)
    return fe._step(torch.from_numpy(image), cond, fe._step_kit(50), posterior, noise, None)


@pytest.mark.parametrize('version', sorted(CASES))
def test_shared_tensors_other_taps_equal_jax(version):
    """The second extractor shares every tensor of the first (denoiser,
    VAE, text encoders) and allocates none; its taps and 'attn' equal
    those of JAX's second extractor on the same parameters and noise; the
    first still returns only its own taps."""
    first_taps, taps, store = CASES[version]
    jfe = jax_facade(first_taps, version, SIZE, SEED)
    jfe2 = JaxFeatureExtractor(taps, version, img_size=SIZE, dtype='float32', seed=SEED,
                               train_unet=True, external_model=jfe, **store)
    first = FeatureExtractor(first_taps, version, device='cpu', img_size=SIZE, dtype='float32')
    load_jax_params(jfe, first)
    second = FeatureExtractor(taps, version, device='cpu', img_size=SIZE, dtype='float32',
                              external_model=first, **store)
    for a, b in ((first.unet, second.unet), (first.vae, second.vae),
                 *zip(first.text_encoders, second.text_encoders)):
        pa, pb = a.state_dict(), b.state_dict()
        assert pa.keys() == pb.keys()
        assert all(pa[k].data_ptr() == pb[k].data_ptr() for k in pa)
    assert second.vae is first.vae and second.tokenizers is first.tokenizers
    assert second.unet is not first.unet and not second.unet.training
    assert not any(p.requires_grad for p in second.unet.parameters())

    image = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1
    jfe2._rng = jax.random.PRNGKey(SEED)
    prompts = jfe2.encode_prompt(PROMPT)
    ref = jfe2.extract(prompts, BATCH, image, image_type='tensor', t=50)
    ours = _step(second, prompts, image)
    assert sorted(ours) == sorted(ref) == sorted([*taps, 'attn'])
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=ATOL,
                                   rtol=RTOL, err_msg=key)
    assert sorted(_step(first, prompts, image)) == sorted(first_taps)
    assert sorted(first.extract(first.encode_prompt(PROMPT), 1, image[:1],
                                image_type='tensor')) == sorted(first_taps)


@pytest.mark.parametrize('kwargs,match', [
    (dict(version='test-xl'), "external_model's version is test-sd, this extractor's test-xl"),
    (dict(dtype='bfloat16'), "external_model's dtype is torch.float32"),
    (dict(device='meta'), "external_model's device is cpu, this extractor's meta"),
    (dict(weights='/nonexistent'), 'pass no weights= or offline_lora'),
    (dict(offline_lora='lora.safetensors'), 'pass no weights= or offline_lora'),
    (dict(external_model=object()), 'external_model must be a FeatureExtractor'),
], ids=['version', 'dtype', 'device', 'weights', 'offline_lora', 'not-an-extractor'])
def test_refusals(kwargs, match):
    """What the source's modules cannot serve as they are stops the build
    (the JAX facade checks none of these; torch cannot mix dtypes or
    devices silently, and a LoRA merge would change the source)."""
    source = FeatureExtractor({'unet-out': True}, 'test-sd', device='cpu', img_size=SIZE,
                              dtype='float32')
    args = dict(layer={'unet-out': True}, version='test-sd', device='cpu', img_size=SIZE,
                dtype='float32', external_model=source)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        FeatureExtractor(**args)
