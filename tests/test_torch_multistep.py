"""The PyTorch port's multi-step paths against the JAX package, at the tiny
``test-sd`` (PNDM) and ``test-xl`` (Euler) sizes on the CPU, at fp32: the
schedulers' ``step``, the ``denoising_from`` walk on the 1000-step and
100-step schedules with 'vae-out' after it, DDIM inversion, long prompts
and ``extract_ensemble``.

The port gets the JAX facade's parameters and, per extract, the noise of
the JAX key chain (``port_parity.jax_noise``).  img_size 32 keeps both
sides off the flash kernels.  The JAX facade walks with ``lax.scan`` and
per-position coefficient rows, the port with ``sched.step``: the same
arithmetic in another order, inside the stated tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.schedulers import diffusion as jsched
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from diffusion_feature_tpu_torch.schedulers import diffusion as sched_mod
from port_parity import jax_facade, jax_noise, load_jax_params

SIZE, BATCH, SEED = 32, 2, 0
LAYERS = {'vae-out': True, 'mid-vit-block0-out': True, 'up-level1-repeat0-vit-block0-self-q': True,
          'unet-out': True}
PROMPT = 'a photo of a cat'
ATOL, RTOL = 5e-4, 1e-4


@pytest.fixture(scope='module')
def pairs():
    """{version: (JAX facade with fp32 features, port facade with its
    parameters)}."""
    out = {}
    for version in ('test-sd', 'test-xl'):
        jfe = jax_facade(LAYERS, version, SIZE, SEED)
        port = FeatureExtractor(LAYERS, version, device='cpu', img_size=SIZE, dtype='float32')
        load_jax_params(jfe, port)
        out[version] = jfe, port
    return out


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


def _inputs(jfe, prompts):
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    pooled = None
    if jfe.spec.clip_layer == 'penultimate':
        pooled = torch.from_numpy(np.array(prompts[2])).expand(BATCH, -1)
    return pe, pooled


def _jax_and_port(pairs, version, image, prompt=PROMPT, **kwargs):
    """JAX ``extract`` at t=50 from a fresh key chain, and the port's
    ``_multistep`` (or ``_step``) on the same noise."""
    jfe, port = pairs[version]
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(prompt)
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=50, **kwargs)
    lat = SIZE // port.vae_scale
    posterior, noise = jax_noise(SEED, (BATCH, 4, lat, lat))
    pe, pooled = _inputs(jfe, prompts)
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    if kwargs:
        ours = port._multistep(torch.from_numpy(image), pe, pooled, 50,
                               kwargs.get('denoising_from'),
                               kwargs.get('use_ddim_inversion', False), posterior, noise, None)
    else:
        ours = port._step(torch.from_numpy(image), pe, pooled, port._img2img_kit(50),
                          posterior, noise, None)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)
    assert sorted(ours) == sorted(ref)
    return ours, ref


def _assert_close(ours, ref):
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


# --------------------------------------------------------------- schedulers
def _twins(kind, steps):
    """(port scheduler, JAX scheduler, port state, JAX state) of ``kind``
    with the configs of the versions that use it."""
    cfg = {'pndm': '1-5', 'euler': 'xl', 'ddim': '1-5'}[kind]
    ours = sched_mod.make_scheduler(kind, get_model_spec(cfg).scheduler_config)
    ref = jsched.make_scheduler(kind, jax_model_spec(cfg).scheduler_config)
    return ours, ref, ours.set_timesteps(steps), ref.set_timesteps(steps)


@pytest.mark.parametrize('steps', [1000, 100])
@pytest.mark.parametrize('kind', ['pndm', 'euler', 'ddim'])
def test_scheduler_steps_equal_jax(kind, steps):
    """Seven consecutive ``step`` calls from timestep 61 (1000 steps) or
    591 (100 steps) on the same model outputs: every PLMS branch (counter 0,
    counter 1, two, three and four stored outputs) and the states' history;
    PNDM's add_noise and scale_model_input too."""
    ours, ref, st, jst = _twins(kind, steps)
    np.testing.assert_array_equal(st.timesteps, jst.timesteps)
    if kind == 'euler':
        np.testing.assert_array_equal(st.sigmas, jst.sigmas)
    start = {1000: 61, 100: 591}[steps]
    ts = [t for t in st.timesteps if t <= start][:7]
    rs = np.random.RandomState(5)
    sample = rs.randn(2, 4, 8, 8).astype(np.float32)
    a, b = torch.from_numpy(sample), jax.numpy.asarray(sample)
    for t in ts:
        out = rs.randn(2, 4, 8, 8).astype(np.float32)
        a, st = ours.step(st, torch.from_numpy(out), t, a)
        b, jst = ref.step(jst, jax.numpy.asarray(out), t, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)
    if kind == 'pndm':
        assert st.counter == jst.counter == 7 and len(st.ets) == len(jst.ets) == 4
        noise = rs.randn(2, 4, 8, 8).astype(np.float32)
        np.testing.assert_allclose(
            ours.add_noise(st, torch.from_numpy(sample), torch.from_numpy(noise), ts[0]).numpy(),
            np.asarray(ref.add_noise(jst, jax.numpy.asarray(sample), jax.numpy.asarray(noise),
                                     ts[0])), atol=1e-6, rtol=1e-6)
        assert ours.scale_model_input(st, a, ts[0]) is a


def test_ddim_final_alpha_cumprod_equals_jax():
    ours, ref, st, jst = _twins('ddim', 100)
    assert ours.final_alpha_cumprod == ref.final_alpha_cumprod
    np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)


# ---------------------------------------------------------- denoising_from
@pytest.mark.parametrize('version,denoising_from', [
    ('test-xl', 53), ('test-sd', 56),
], ids=['xl-53', 'sd-56'])
def test_denoising_from_matches_jax(pairs, image, version, denoising_from):
    """A walk on the 1000-step schedule to t=50 with 'vae-out' decoded
    after it: Euler from 53 (3 walk forwards), PNDM from 57 (7: every PLMS
    branch), every tap at the single step's tolerance."""
    ours, ref = _jax_and_port(pairs, version, image, denoising_from=denoising_from)
    _assert_close(ours, ref)


def test_long_walk_on_100_step_schedule_matches_jax(pairs, image):
    """denoising_from - t > 50: the 100-step schedule at strength
    denoising_from / 100 (JAX's quirk: 200 starts the walk at 991), 95
    PLMS forwards on test-sd, then 'vae-out' from the fresh 100-step state,
    at the single step's tolerance."""
    _assert_close(*_jax_and_port(pairs, 'test-sd', image, denoising_from=200))


@pytest.mark.parametrize('version,denoising_from,forwards,last_t', [
    ('test-xl', 60, 10, 50.0), ('test-sd', 60, 11, 50.0), ('test-xl', 200, 94, 51.0),
    ('test-sd', 200, 95, 51.0),
])
def test_walk_length_follows_jax_schedule(pairs, image, monkeypatch, version, denoising_from,
                                          forwards, last_t):
    """U-Net forwards per extract at t=50: the walk's, then the last one at
    ``last_t`` (test-xl and test-sd have xl's and 1-5's schedules; PNDM's
    duplicated timestep adds one)."""
    _, port = pairs[version]
    calls = []
    forward = port.unet.forward
    monkeypatch.setattr(port.unet, 'forward',
                        lambda *a, **k: calls.append(a[1]) or forward(*a, **k))
    feats = port.extract(port.encode_prompt(PROMPT), BATCH, image, image_type='tensor', t=50,
                         denoising_from=denoising_from)
    assert len(calls) == forwards + 1
    assert calls[-1] == last_t
    assert feats['vae-out'].shape == (BATCH, 3, SIZE, SIZE)


def test_walk_forwards_record_nothing(pairs, image, monkeypatch):
    """Only the last forward's taps reach the features: the walk's forwards
    run with no feature dict."""
    _, port = pairs['test-sd']
    seen = []
    forward = port.unet.forward
    monkeypatch.setattr(port.unet, 'forward',
                        lambda *a, **k: seen.append(k.get('feats')) or forward(*a, **k))
    port.extract(port.encode_prompt(PROMPT), BATCH, image, image_type='tensor', t=50,
                 denoising_from=53)
    assert all(f is None for f in seen[:-1]) and isinstance(seen[-1], dict)


# ------------------------------------------------------------ DDIM inversion
def test_ddim_inversion_matches_jax(pairs, image):
    """Five inverted DDIM steps (timesteps 11 to 51) through the plain
    U-Net, then the final forward at 51 with no added noise."""
    ours, ref = _jax_and_port(pairs, 'test-sd', image, use_ddim_inversion=True)
    _assert_close(ours, ref)


def test_ddim_inversion_refused_where_jax_refuses(pairs, image):
    jfe, port = pairs['test-xl']
    with pytest.raises(NotImplementedError) as ref:
        jfe.extract(jfe.encode_prompt(PROMPT), BATCH, image, image_type='tensor',
                    use_ddim_inversion=True)
    with pytest.raises(NotImplementedError) as ours:
        port.extract(port.encode_prompt(PROMPT), BATCH, image, image_type='tensor',
                     use_ddim_inversion=True)
    assert str(ours.value) == str(ref.value)


def test_plain_forward_takes_no_taps_and_no_store():
    """``forward(plain=True)`` (inversion's forwards): every attention on
    the fused path, the map tap and the store unused, the same output."""
    fe = FeatureExtractor({'up-level1-repeat0-vit-block0-self-map': True}, 'test-sd',
                          device='cpu', img_size=64, dtype='float32',
                          attention=['up_self'], attn_store_sizes=(32, 32))
    x = torch.randn(1, 4, 32, 32)
    pe = torch.randn(1, 77, 32)
    feats = {}
    with torch.inference_mode():
        a = fe.unet(x, 51.0, pe, feats=feats)
        b = fe.unet(x, 51.0, pe, plain=True)
    assert set(feats) == {'up-level1-repeat0-vit-block0-self-map', 'attn_store'}
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert not any(m.plain for m in fe.unet.modules() if hasattr(m, 'plain'))


# ------------------------------------------------------------- long prompts
def _words(n):
    return ' '.join(f'word{i % 37}' for i in range(n))


@pytest.mark.parametrize('words', [71, 160], ids=['71-words', '160-words'])
def test_long_prompt_matches_jax(pairs, image, words):
    """More than 70 words: chunks of 77 tokens through the first encoder
    (71 hash-tokenizer words fill one chunk, 160 three), then the step."""
    jfe, port = pairs['test-sd']
    prompt = _words(words)
    ours, ref = port.encode_prompt(prompt), jfe.encode_prompt(prompt)
    assert ours[2:] == ref[2:] == (None, None)
    assert ours[0].shape == (1, 77 * -(-(words + 2) // 77), 32)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    _assert_close(*_jax_and_port(pairs, 'test-sd', image, prompt=prompt))


def test_long_prompt_on_xl_raises_before_compute(pairs, image):
    """test-xl's U-Net wants 64-wide context and a pooled embedding, and a
    long prompt carries 32-wide context and none: JAX fails inside its step
    (AttributeError on the missing pooled embedding), the port raises
    ValueError naming the cause before any forward."""
    jfe, port = pairs['test-xl']
    prompt = _words(71)
    with pytest.raises(AttributeError):
        jfe.extract(jfe.encode_prompt(prompt), BATCH, image, image_type='tensor', t=50)
    prompts = port.encode_prompt(prompt)
    assert prompts[0].shape == (1, 77, 32) and prompts[2] is None
    with pytest.raises(ValueError, match='32 wide.*64-wide context.*first text encoder'):
        port.extract(prompts, BATCH, image, image_type='tensor', t=50)
    full = port.encode_prompt(PROMPT)
    with pytest.raises(ValueError, match='pooled prompt embedding'):
        port.extract((full[0], full[1], None, None), BATCH, image, image_type='tensor', t=50)


# --------------------------------------------------------- extract_ensemble
@pytest.mark.parametrize('concat', [True, False], ids=['concat', 'dict'])
def test_extract_ensemble_matches_jax(pairs, image, monkeypatch, concat):
    """Two timesteps crossed with two prompt sets, each extract on the
    noise of the JAX key chain's call of the same index."""
    jfe, port = pairs['test-sd']
    jfe._rng = jax.random.PRNGKey(SEED)
    sets = [jfe.encode_prompt(PROMPT), jfe.encode_prompt('two dogs on grass')]
    ref = jfe.extract_ensemble(None, BATCH, image, image_type='tensor', ts=(50, 261),
                               prompt_list=sets, concat=concat)
    step, calls = port._step, []

    def jax_noise_step(img, pe, pooled, kit, posterior, noise, out_dtype, **kwargs):
        posterior, noise = jax_noise(SEED, posterior.shape, len(calls))
        calls.append(kit['T'])
        return step(img, pe, pooled, kit, posterior, noise, out_dtype, **kwargs)

    monkeypatch.setattr(port, '_step', jax_noise_step)
    monkeypatch.setattr(port, 'feature_dtype', None)
    ours = port.extract_ensemble(None, BATCH, image, image_type='tensor', ts=(50, 261),
                                 prompt_list=[tuple(torch.from_numpy(np.array(x))
                                                    if x is not None else None for x in p)
                                              for p in sets], concat=concat)
    assert calls == [51.0, 262.0, 51.0, 262.0]
    if concat:
        assert ours['unet-out'].shape == (BATCH, 4 * 4, 16, 16)
        _assert_close(ours, ref)
    else:
        assert sorted(ours) == sorted(ref) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        for key in ref:
            _assert_close(ours[key], ref[key])
