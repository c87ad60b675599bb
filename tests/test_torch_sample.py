"""The PyTorch port's generation against the JAX package, at the tiny
``test-sd`` (PNDM) and ``test-xl`` (Euler, text_time) sizes on the CPU, at
fp32: ``sample()`` with and without classifier-free guidance (images and
every tap encounter), background extraction after ``sample`` and after
``extract``, the schedules' ``init_noise_sigma`` and the port's
``generate_with_extraction`` CLI.

The port gets the JAX facade's parameters and the initial latents of the
JAX key chain (``port_parity.jax_sample_noise``).  The JAX side runs its
unrolled loop (``unrolled=True``), which the port's loop is; its scanned
loop equals it (tests/test_extras.py).  img_size 32 keeps both sides off
the flash kernels.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_feature_tpu import store as jax_store
from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.schedulers import diffusion as jsched
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch import generate_with_extraction as port_gen
from diffusion_feature_tpu_torch import store
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from diffusion_feature_tpu_torch.schedulers import diffusion as sched_mod
from port_parity import jax_facade, jax_noise, jax_sample_noise, load_jax_params

SIZE, SEED = 32, 0
LAYERS = {'mid-vit-block0-self-q': True, 'up-level1-repeat0-res-out': True,
          'up-level1-repeat1-vit-block0-out': True, 'unet-out': True}
PROMPT = 'a photo of a cat'
ATOL, RTOL = 5e-4, 1e-4


@pytest.fixture(scope='module')
def pairs():
    """{version: (JAX facade, port facade with its parameters)}."""
    out = {}
    for version in ('test-sd', 'test-xl'):
        jfe = jax_facade(LAYERS, version, SIZE, SEED)
        port = FeatureExtractor(LAYERS, version, device='cpu', img_size=SIZE, dtype='float32')
        load_jax_params(jfe, port)
        out[version] = jfe, port
    return out


def _prompts(jfe, batch):
    """The JAX facade's encoded prompt as the port's ``_sample`` takes it:
    (pe, ne, pooled, neg_pooled) broadcast to ``batch``, pooled None for a
    'final'-layer model."""
    def bcast(x):
        return None if x is None else torch.from_numpy(np.array(x)).expand(batch, *x.shape[1:])
    prompts = jfe.encode_prompt(PROMPT)
    out = [bcast(x) for x in prompts]
    if jfe.spec.clip_layer != 'penultimate':
        out[2] = out[3] = None
    return prompts, out


def _run_both(pairs, version, batch, steps, guidance):
    jfe, port = pairs[version]
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts, port_prompts = _prompts(jfe, batch)
    ref_images, ref = jfe.sample(prompts, batch_size=batch, num_inference_steps=steps,
                                 guidance_scale=guidance, unrolled=True)
    lat = SIZE // port.vae_scale
    noise = jax_sample_noise(SEED, (batch, 4, lat, lat))
    fa.launches = 0
    images, feats, _ = port._sample(*port_prompts, noise, steps, guidance)
    assert fa.launches == 0
    return (images, feats), (ref_images, ref)


@pytest.mark.parametrize('version,batch,steps,guidance', [
    ('test-sd', 1, 4, 7.5), ('test-sd', 2, 2, 1.0),
    ('test-xl', 1, 3, 5.0), ('test-xl', 2, 2, 1.0),
], ids=['sd-cfg', 'sd-nocfg', 'xl-cfg', 'xl-nocfg'])
def test_sample_matches_jax(pairs, version, batch, steps, guidance):
    """Images and every tap encounter: one per U-Net call (PNDM's 4 steps
    make 5), step-major, over the CFG-doubled batch."""
    (images, feats), (ref_images, ref) = _run_both(pairs, version, batch, steps, guidance)
    assert images.shape == (batch, 3, SIZE, SIZE)
    np.testing.assert_allclose(images.numpy(), np.asarray(ref_images), atol=ATOL, rtol=RTOL)
    assert float(images.min()) >= 0.0 and float(images.max()) <= 1.0
    calls = len(pairs[version][1].scheduler.set_timesteps(steps).timesteps)
    assert calls == steps + (version == 'test-sd')
    assert sorted(feats) == sorted(ref) == sorted(LAYERS)
    for key, encounters in ref.items():
        assert len(feats[key]) == len(encounters) == calls, key
        for i, (a, b) in enumerate(zip(feats[key], encounters)):
            assert a.shape[0] == batch * (2 if guidance > 1 else 1)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                       err_msg=f'{key} call {i + 1}')


def test_background_after_sample_matches_jax(pairs):
    jfe, port = pairs['test-sd']
    for fe in (jfe, port):
        fe.set_background_extraction([1, 3])
    try:
        (_, feats), _ = _run_both(pairs, 'test-sd', 1, 4, 7.5)
        # the internal entry leaves the selection to the public one
        port._keep_background(feats)
        ours, ref = port.get_background_extraction(), jfe.get_background_extraction()
        assert sorted(ours) == sorted(ref) == sorted(LAYERS)
        for key in ref:
            assert sorted(ours[key]) == sorted(ref[key]) == [1, 3]
            for i in (1, 3):
                assert ours[key][i] is feats[key][i - 1]
                np.testing.assert_allclose(ours[key][i].numpy(), np.asarray(ref[key][i]),
                                           atol=ATOL, rtol=RTOL)
        assert {k: v['count'] for k, v in port._background_feats.items()} == \
            {k: v['count'] for k, v in jfe._background_feats.items()} == dict.fromkeys(LAYERS, 5)
    finally:
        for fe in (jfe, port):
            fe.store_idx = None


def test_background_after_extract_matches_jax(pairs):
    """A single step keeps its features as encounter 1."""
    jfe, port = pairs['test-xl']
    image = np.random.RandomState(1).rand(2, 3, SIZE, SIZE).astype(np.float32) * 2 - 1
    for fe in (jfe, port):
        fe.set_background_extraction([1, 2])
    try:
        jfe._rng = jax.random.PRNGKey(SEED)
        prompts = jfe.encode_prompt(PROMPT)
        jfe.extract(prompts, 2, image, image_type='tensor', t=50)
        _, (pe, _, pooled, _) = _prompts(jfe, 2)
        posterior, noise = jax_noise(SEED, (2, 4, SIZE // 2, SIZE // 2))
        feats = port._step(torch.from_numpy(image), pe, pooled, port._img2img_kit(50),
                           posterior, noise, None)
        port._keep_background(feats)
        ours, ref = port.get_background_extraction(), jfe.get_background_extraction()
        assert sorted(ours) == sorted(ref) == sorted(LAYERS)
        for key in ref:
            assert list(ours[key]) == list(ref[key]) == [1]
            np.testing.assert_allclose(ours[key][1].numpy(), np.asarray(ref[key][1]),
                                       atol=ATOL, rtol=RTOL, err_msg=key)
    finally:
        for fe in (jfe, port):
            fe.store_idx = None


def test_public_sample_and_extract_keep_background(pairs):
    """``sample`` and ``extract`` through the public entries: the noise
    stream, ``return_features=False``, and the selection each leaves."""
    _, port = pairs['test-sd']
    port.set_background_extraction([2])
    try:
        port._noise_gen.manual_seed(3)
        images, feats = port.sample(port.encode_prompt(PROMPT), batch_size=2,
                                    num_inference_steps=2, guidance_scale=7.5)
        assert images.shape == (2, 3, SIZE, SIZE) and images.dtype == torch.float32
        assert all(len(v) == 3 and v[0].shape[0] == 4 for v in feats.values())
        kept = port.get_background_extraction()
        assert all(list(v) == [2] and v[2] is feats[k][1] for k, v in kept.items())
        port._noise_gen.manual_seed(3)
        again, none = port.sample(port.encode_prompt(PROMPT), batch_size=2,
                                  num_inference_steps=2, guidance_scale=7.5,
                                  return_features=False, unrolled=True)
        assert none is None and torch.equal(again, images)
        port.set_background_extraction([1])
        img = [Image.fromarray(np.random.RandomState(2).randint(0, 256, (40, 40, 3), np.uint8))]
        out = port.extract(port.encode_prompt(PROMPT), 1, img, t=50)
        assert {k: list(v) for k, v in port.get_background_extraction().items()} == \
            {k: [1] for k in out}
    finally:
        port.store_idx = None


def test_select_background_encounters_equals_jax():
    rs = np.random.RandomState(0)
    taps = {'a': tuple(rs.randn(2, 3).astype(np.float32) for _ in range(4)),
            'b': rs.randn(2, 3).astype(np.float32)}
    ref = jax_store.select_background_encounters(taps, [2, 4, 7])
    ours = store.select_background_encounters(taps, [2, 4, 7])
    assert {k: (sorted(v['feat']), v['count']) for k, v in ours.items()} == \
        {k: (sorted(v['feat']), v['count']) for k, v in ref.items()} == \
        {'a': ([2, 4], 4), 'b': ([], 1)}


@pytest.mark.parametrize('version,steps', [('1-5', 50), ('2-1', 50), ('xl', 50), ('xl', 7)])
def test_init_noise_sigma_equals_jax(version, steps):
    """PNDM's 1.0, Euler's largest sigma (linspace, SD-2.1) or
    sqrt(sigma^2 + 1) (leading, SDXL) of the inference schedule."""
    spec, jspec = get_model_spec(version), jax_model_spec(version)
    ours = sched_mod.make_scheduler(spec.scheduler, spec.scheduler_config).set_timesteps(steps)
    ref = jsched.make_scheduler(jspec.scheduler, jspec.scheduler_config).set_timesteps(steps)
    assert ours.init_noise_sigma == ref.init_noise_sigma
    assert (ours.init_noise_sigma == 1.0) == (spec.scheduler == 'pndm')


def test_generate_with_extraction_cli(tmp_path, capsys):
    """The port's CLI at test-sd 64^2: the default '15-practical' layers
    that test-sd has (one of four; the others are named on stderr), the
    PNG, and a line per kept step."""
    out = tmp_path / 'gen.png'
    port_gen.main(['--version', 'test-sd', '--img_size', '64', '--steps', '3',
                   '--store_steps', '1', '3', '--device', 'cpu', '--output', str(out)])
    lines = capsys.readouterr()
    assert Image.open(out).size == (64, 64)
    assert lines.out.splitlines() == [
        f'saved {out}',
        'up-level1-repeat1-vit-block0-cross-q step=1 (2, 1024, 32)',
        'up-level1-repeat1-vit-block0-cross-q step=3 (2, 1024, 32)']
    assert 'up-level1-repeat2-res-out' in lines.err
    assert os.listdir(tmp_path) == ['gen.png']
