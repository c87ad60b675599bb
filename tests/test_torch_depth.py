"""The PyTorch port's DPT depth estimator (the preprocessor of
``control=['depth']``) against the JAX package's and transformers', at the
tiny config of tests/test_depth.py on the CPU, at fp32: the model at its
native input size and off it (the position embeddings resized, an odd
patch grid), a transformers-layout ``depth_estimator`` dir, the estimator's
pre- and post-processing, the depth ControlNet through the facade, and the
config's refusals.  transformers is used here as the reference for the
checkpoint layout; the port never imports it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_feature_tpu.models import depth as jax_depth
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.models import depth
from diffusion_feature_tpu_torch.models.convert import params_from_jax
from port_parity import _draw, jax_control, jax_facade, jax_noise, load_jax_params

ATOL, RTOL = 5e-4, 1e-4
# transformers against the port: its attention and resizes sum in another
# order (tests/test_depth.py holds the JAX model to the same tolerance)
HF_ATOL, HF_RTOL = 2e-4, 1e-3
TINY = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2, intermediate_size=64,
            patch_size=8, image_size=64, backbone_out_indices=[0, 1, 2, 3],
            neck_hidden_sizes=[16, 24, 32, 32], reassemble_factors=[4, 2, 1, 0.5],
            fusion_hidden_size=16, is_hybrid=False, readout_type='project')


@pytest.fixture(scope='module')
def jax_pair():
    """(JAX model, its numpy-drawn parameters, the port model with them)."""
    model = jax_depth.DPTDepthModel(cfg=jax_depth.tiny_dpt_config())
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 3, 64, 64)))['params'])
    params = _draw(shapes, 3)
    port = depth.DPTDepthModel(depth.tiny_dpt_config())
    port.load_state_dict(params_from_jax(params, port, depth.jax_param_name))
    return model, params, port.eval()


@pytest.fixture(scope='module')
def hf_dir(tmp_path_factory):
    """A transformers ``DPTForDepthEstimation`` (seeded, weights nudged off
    their init so the head's ReLUs pass values) saved as a
    ``depth_estimator`` dir; returns (dir, the transformers model)."""
    import safetensors.numpy
    from transformers import DPTConfig as HFDPTConfig
    from transformers import DPTForDepthEstimation
    torch.manual_seed(0)
    model = DPTForDepthEstimation(HFDPTConfig(**TINY)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    d = tmp_path_factory.mktemp('tree') / 'depth_estimator'
    d.mkdir()
    (d / 'config.json').write_text(json.dumps(dict(TINY, model_type='dpt')))
    safetensors.numpy.save_file({k: v.numpy().copy() for k, v in model.state_dict().items()},
                                str(d / 'model.safetensors'))
    return str(d), model


@pytest.mark.parametrize('size', [64, 48, 40], ids=['native', 'pos-embed-shrunk', 'odd-grid'])
def test_dpt_matches_jax(jax_pair, size):
    """At 48² the 8x8 position grid shrinks to 6x6 (JAX's resize
    antialiases there); at 40² the 5x5 patch grid makes the fusion resize
    its laterals."""
    model, params, port = jax_pair
    x = np.random.RandomState(size).randn(2, 3, size, size).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('size', [64, 96])
def test_estimator_dir_matches_transformers(hf_dir, size):
    """The dir loads with transformers' keys (the unused ones are the final
    LayerNorm and the deepest fusion layer's residual_layer1) and the
    model's depth equals ``DPTForDepthEstimation``'s."""
    path, hf = hf_dir
    est = depth.DPTDepthEstimator(path, device='cpu')
    x = np.random.RandomState(1).randn(1, 3, size, size).astype(np.float32)
    with torch.no_grad():
        ours = est.model(torch.from_numpy(x)).numpy()
        want = hf(torch.from_numpy(x)).predicted_depth.numpy()
    np.testing.assert_allclose(ours, want, atol=HF_ATOL, rtol=HF_RTOL)
    unused = set(hf.state_dict()) - set(est.model.state_dict())
    assert unused and all(k.startswith(('dpt.layernorm.', 'neck.fusion_stage.layers.0.'
                                        'residual_layer1.')) for k in unused), unused


def _jax_estimator(path):
    """The JAX package's ``DPTDepthEstimator`` on ``path``, its template
    traced rather than initialised eagerly."""
    est = jax_depth.DPTDepthEstimator.__new__(jax_depth.DPTDepthEstimator)
    with open(f'{path}/config.json') as f:
        est.cfg = jax_depth.DPTConfig.from_diffusers_config(json.load(f))
    est.model = jax_depth.DPTDepthModel(cfg=est.cfg)
    from diffusion_feature_tpu.models.convert import load_safetensors_dir
    size = est.cfg.image_size
    template = jax.eval_shape(lambda: est.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, size, size)))['params'])
    est.params, _ = jax_depth.convert_dpt_state(load_safetensors_dir(path), template)
    est._jitted = jax.jit(lambda p, x: est.model.apply({'params': p}, x))
    return est


def test_estimator_matches_jax(hf_dir):
    """PIL in, (3, H, W) float32 in [0, 1] out: resize to the model's size,
    normalise, depth, min/max scale, uint8 resize back."""
    path, _ = hf_dir
    img = Image.fromarray((np.random.RandomState(2).rand(80, 72, 3) * 255).astype(np.uint8))
    ours = depth.DPTDepthEstimator(path, device='cpu')(img)
    ref = _jax_estimator(path)(img)
    assert ours.shape == ref.shape == (3, 80, 72) and ours.dtype == np.float32
    # one uint8 level where a depth value falls on a rounding boundary
    np.testing.assert_allclose(ours, ref, atol=1 / 255 + 1e-6)
    assert (ours != ref).mean() < 0.01
    assert ours.min() >= 0.0 and ours.max() <= 1.0 and np.array_equal(ours[0], ours[2])


def test_depth_control_extract_matches_jax(hf_dir):
    """``control=[('depth', dir)]`` through the single step: the port's
    estimator and ControlNet against the JAX package's."""
    path, _ = hf_dir
    layers = {'up-level1-repeat0-res-out': True, 'unet-out': True}
    jfe = jax_facade(layers, 'test-sd', 32)
    jax_control(jfe, [('depth', _jax_estimator(path))], seed=20)
    port = FeatureExtractor(layers, 'test-sd', device='cpu', img_size=32, dtype='float32',
                            control=[('depth', path)])
    load_jax_params(jfe, port)
    net = port.control_pipe.nets[0].model
    net.load_state_dict(params_from_jax(jfe.params['controlnet'][0], net))
    images = [Image.fromarray((np.random.RandomState(5).rand(48, 48, 3) * 255).astype(np.uint8))]
    jfe._rng = jax.random.PRNGKey(0)
    prompts = jfe.encode_prompt('a cat')
    ref = jfe.extract(prompts, 1, images, t=50, use_control=True)
    control = port.control_pipe.prepare_control_images(images, 1)
    ref_control = jfe.control_pipe.prepare_control_images(images, 1)
    np.testing.assert_allclose(control[0].numpy(), np.asarray(ref_control[0]),
                               atol=1 / 255 + 1e-6)
    # the same condition on both sides: a uint8 level apart moves the
    # features by more than the tolerance
    posterior, noise = jax_noise(0, (1, 4, 16, 16))
    ours = port._step(torch.from_numpy(port.preprocess_image(images[0])),
                      torch.from_numpy(np.array(prompts[0])), None, port._img2img_kit(50),
                      posterior, noise, None,
                      tuple(torch.from_numpy(np.array(c)) for c in ref_control))
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


def test_depth_estimator_found_under_weights(tmp_path, hf_dir):
    """Without a path, 'depth' takes ``{weights}/depth_estimator``."""
    import shutil
    path, _ = hf_dir
    src = FeatureExtractor({'unet-out': True}, 'test-sd', device='cpu', img_size=32,
                           dtype='float32')
    src.save_weights(str(tmp_path))
    shutil.copytree(path, tmp_path / 'depth_estimator')
    fe = FeatureExtractor({'unet-out': True}, 'test-sd', device='cpu', img_size=32,
                          dtype='float32', weights=str(tmp_path), control=['depth'])
    est = fe.control_pipe.nets[0].preprocess
    assert isinstance(est, depth.DPTDepthEstimator) and est.cfg == depth.tiny_dpt_config()


def test_config_round_trip_and_refusals():
    cfg = depth.DPTConfig()
    assert depth.DPTConfig.from_diffusers_config(cfg.to_transformers_config()) == cfg
    assert depth.DPTConfig.from_diffusers_config(TINY) == depth.tiny_dpt_config()
    assert depth.tiny_dpt_config() == depth.DPTConfig(**{
        k: getattr(jax_depth.tiny_dpt_config(), k) for k in TINY if k != 'is_hybrid'})
    with pytest.raises(NotImplementedError, match='hybrid'):
        depth.DPTConfig.from_diffusers_config(dict(TINY, is_hybrid=True))
    with pytest.raises(NotImplementedError, match='readout_type=project'):
        depth.DPTConfig.from_diffusers_config(dict(TINY, readout_type='add'))
