"""The PyTorch port's ControlNet against the JAX package, at the tiny
``test-sd`` and ``test-xl`` sizes on the CPU, at fp32: ``extract`` with
``use_control=True`` on the single step and with ``denoising_from``, one
net and the sum of two, PIL and tensor images; the Canny preprocessor;
the ControlNet's parameters and checkpoint dir; the errors.

Both sides' ControlNets carry the same numpy-drawn parameters, their zero
convs drawn non-zero as a trained checkpoint's are
(``port_parity.jax_control``), so the residuals reach the features.  The
port gets the JAX key chain's noise (``port_parity.jax_noise``); img_size
32 keeps both sides off the flash kernels.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_feature_tpu.models.controlnet import canny_edges as jax_canny_edges
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.models import controlnet
from diffusion_feature_tpu_torch.models.convert import params_from_jax
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from port_parity import (assert_params_round_trip, jax_control, jax_facade, jax_noise,
                         load_jax_params)

SIZE, BATCH, SEED = 32, 2, 0
LAYERS = {'mid-vit-block0-out': True, 'up-level1-repeat0-vit-block0-self-q': True,
          'up-level0-repeat0-res-out': True, 'unet-out': True}
PROMPT = 'a photo of a cat'
ATOL, RTOL = 5e-4, 1e-4
# (version, number of canny nets)
SETUPS = {'sd-1net': ('test-sd', 1), 'sd-2nets': ('test-sd', 2), 'xl-1net': ('test-xl', 1)}


def _pil_images(n=BATCH, size=40):
    rs = np.random.RandomState(3)
    out = []
    for _ in range(n):
        # blocks of flat colour: Canny finds their borders
        arr = np.kron(rs.randint(0, 256, (5, 5, 3)), np.ones((size // 5, size // 5, 1)))
        out.append(Image.fromarray(arr.astype(np.uint8)))
    return out


@pytest.fixture(scope='module')
def setups():
    """{name: (JAX facade with its ControlNets, port facade with the same
    parameters)}, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            version, n = SETUPS[name]
            jfe = jax_facade(LAYERS, version, SIZE, SEED)
            jax_control(jfe, [('canny', None)] * n, seed=SEED + 10)
            port = FeatureExtractor(LAYERS, version, device='cpu', img_size=SIZE,
                                    dtype='float32', control=['canny'] * n)
            load_jax_params(jfe, port)
            for net, tree in zip(port.control_pipe.nets, jfe.params['controlnet']):
                net.model.load_state_dict(params_from_jax(tree, net.model))
            cache[name] = jfe, port
        return cache[name]
    return get


def _jax_and_port(jfe, port, image, image_type, use_control=True, **kwargs):
    """JAX ``extract`` at t=50 from a fresh key chain, and the port's
    ``_step`` (or ``_multistep``) on the same noise and control images."""
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref = jfe.extract(prompts, BATCH, image, image_type=image_type, t=50,
                      use_control=use_control, **kwargs)
    if image_type == 'image':
        img = torch.from_numpy(port.preprocess_image(image[0]))
        img = torch.cat([img, torch.from_numpy(port.preprocess_image(image[1]))])
        raw = image
    else:
        img = torch.from_numpy(image)
        raw = port.control_pipe.tensors_to_pil(img)
    control = port.control_pipe.prepare_control_images(raw, BATCH) if use_control else None
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    pooled = None
    if port.spec.clip_layer == 'penultimate':
        pooled = torch.from_numpy(np.array(prompts[2])).expand(BATCH, -1)
    posterior, noise = jax_noise(SEED, (BATCH, 4, SIZE // 2, SIZE // 2))
    fa.launches = 0
    if kwargs:
        ours = port._multistep(img, port._step_conditioning((pe, None, pooled, None), BATCH), 50,
                               kwargs['denoising_from'], False, posterior, noise, None, control)
    else:
        ours = port._step(img, port._step_conditioning((pe, None, pooled, None), BATCH),
                          port._img2img_kit(50), posterior, noise, None, control)
    assert fa.launches == 0
    assert sorted(ours) == sorted(ref)
    return ours, ref


def _assert_close(ours, ref):
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


@pytest.mark.parametrize('name', list(SETUPS))
def test_control_extract_matches_jax(setups, name):
    """The single step on PIL images; the residuals move the features."""
    jfe, port = setups(name)
    ours, ref = _jax_and_port(jfe, port, _pil_images(), 'image')
    _assert_close(ours, ref)
    plain, _ = _jax_and_port(jfe, port, _pil_images(), 'image', use_control=False)
    assert not torch.allclose(plain['unet-out'], ours['unet-out'], atol=1e-3)


def test_control_on_tensor_images_matches_jax(setups):
    """Tensor images in [-1, 1] go back to PIL images for Canny, rounded as
    the JAX facade rounds them."""
    jfe, port = setups('sd-2nets')
    image = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1
    ours, ref = _jax_and_port(jfe, port, image, 'tensor')
    _assert_close(ours, ref)
    conds = port.control_pipe.prepare_control_images(
        port.control_pipe.tensors_to_pil(torch.from_numpy(image)), BATCH)
    ref_conds = jfe.control_pipe.prepare_control_images(
        jfe.control_pipe.tensors_to_pil(jax.numpy.asarray(image)), BATCH)
    for a, b in zip(conds, ref_conds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_control_denoising_from_matches_jax(setups):
    """The ControlNets join the last, tapped forward of the walk only."""
    jfe, port = setups('sd-2nets')
    ours, ref = _jax_and_port(jfe, port, _pil_images(), 'image', denoising_from=56)
    _assert_close(ours, ref)


def test_public_extract_with_control(setups):
    """``use_control`` through the public entry: the residuals change the
    features, and without it the ControlNets stay out."""
    _, port = setups('sd-1net')
    prompts = port.encode_prompt(PROMPT)
    feats = {}
    for use in (True, False, True):
        port._noise_gen.manual_seed(4)
        feats.setdefault(use, []).append(port.extract(prompts, 1, _pil_images(1), t=50,
                                                      use_control=use))
    assert torch.equal(feats[True][0]['unet-out'], feats[True][1]['unet-out'])
    assert not torch.equal(feats[True][0]['unet-out'], feats[False][0]['unet-out'])


@pytest.mark.parametrize('shape,seed', [((40, 40, 3), 0), ((64, 48, 3), 1), ((33, 57, 3), 2)])
def test_canny_edges_equal_jax(shape, seed):
    rs = np.random.RandomState(seed)
    img = np.kron(rs.randint(0, 256, (shape[0] // 4 + 1, shape[1] // 4 + 1, 3)),
                  np.ones((4, 4, 1)))[:shape[0], :shape[1]]
    img = np.clip(img + rs.randint(-20, 20, img.shape), 0, 255).astype(np.uint8)
    ours = controlnet.canny_edges(img)
    np.testing.assert_array_equal(ours, jax_canny_edges(img))
    assert ours.dtype == np.uint8 and set(np.unique(ours)) == {0, 255}


def test_controlnet_params_round_trip(setups):
    """params_from_jax covers every ControlNet parameter, and the JAX
    converter takes the port's names back to the same tree."""
    jfe, port = setups('xl-1net')
    assert_params_round_trip(jfe.params['controlnet'][0], port.control_pipe.nets[0].model)


def test_random_controlnet_starts_at_zero():
    """Without weights a ControlNet's zero convs are zero, as diffusers and
    the JAX package initialise them: its residuals are zero."""
    fe = FeatureExtractor(LAYERS, 'test-sd', device='cpu', img_size=SIZE, dtype='float32',
                          control=['canny'])
    model = fe.control_pipe.nets[0].model
    assert all(not conv.weight.any() for conv in model.zero_convs())
    assert controlnet.cond_embed_channels(fe.vae_scale) == (16, 32)
    assert controlnet.cond_embed_channels(8) == (16, 32, 96, 256)
    assert model.controlnet_cond_embedding.conv_out.weight.shape[1] == 32


def test_controlnet_dir_loads(tmp_path):
    """``{weights}/controlnet_{kind}`` (diffusers keys, written by
    ``save_component``) loads beside the rest of the tree."""
    from diffusion_feature_tpu_torch.models.convert import save_component
    src = FeatureExtractor(LAYERS, 'test-sd', device='cpu', img_size=SIZE, dtype='float32')
    src.save_weights(str(tmp_path))
    model = controlnet.ControlNetModel(src.spec.unet, (16, 32))
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    save_component(str(tmp_path), 'controlnet_canny', model.state_dict(),
                   model.to_diffusers_config())
    fe = FeatureExtractor(LAYERS, 'test-sd', device='cpu', img_size=SIZE, dtype='float32',
                          weights=str(tmp_path), control=['canny'])
    loaded = fe.control_pipe.nets[0].model.state_dict()
    assert loaded.keys() == model.state_dict().keys()
    assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
    assert sorted(p.name for p in (tmp_path / 'controlnet_canny').iterdir()) == \
        ['config.json', 'diffusion_pytorch_model.safetensors']


@pytest.mark.parametrize('control,error,match', [
    ([('canny', '/some/dir')], ValueError, 'takes a callable preprocessor'),
    (['depth'], FileNotFoundError, 'depth estimator'),
    (['segmentation'], NotImplementedError, "controlnet kind 'segmentation'"),
], ids=['path-on-canny', 'missing-depth-dir', 'unknown-kind'])
def test_control_errors(control, error, match):
    with pytest.raises(error, match=match):
        FeatureExtractor(LAYERS, 'test-sd', device='cpu', img_size=SIZE, dtype='float32',
                         control=control)
