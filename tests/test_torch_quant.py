"""The port's int8 weight-only dense (``diffusion_feature_tpu_torch/ops/quant.py``)
against the JAX package's (``diffusion_feature_tpu/ops/quant.py``), on the CPU
at fp32: the quantizer bit for bit, ``Int8Linear``'s twin and its input
gradient against ``Int8Dense``, ``params_from_jax`` on a quantized tree, a
tiny synthetic Flux tree loaded by both facades under the auto int8 rule
(every tap, and the int8 bits themselves), int8 against the full-precision
load of the same tree, ``t5_8bit`` on a tiny PixArt tree, the refusals
JAX shares and the port's own, ``external_model`` over an int8 extractor,
and the int8 Flux on the meta device.  The W8A16 kernel itself runs on the
card only (tests/test_torch_cuda.py); here the twin stands for it.
"""

import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.models import t5 as jax_t5
from diffusion_feature_tpu.models.convert import convert_torch_state
from diffusion_feature_tpu.ops import quant as jax_quant
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.models import t5 as port_t5
from diffusion_feature_tpu_torch.models.convert import params_from_jax, random_module
from diffusion_feature_tpu_torch.models.flux import FluxTransformer2D, tiny_flux_config
from diffusion_feature_tpu_torch.ops import quant
from port_parity import jax_noise, text_jax_name
from synth_checkpoint import write_flux_checkpoint

SEED, BATCH, SIZE, PROMPT = 0, 2, 64, 'a photo of a cat'
# taps of both dual blocks and both single blocks of the tiny Flux, the
# projections JAX quantizes feeding each of them
LAYERS = {'vit-block0-q': True, 'vit-block0-attn-out': True, 'vit-block1-ffn-inner': True,
          'vit-block1-out': True, 'vit-block2-k': True, 'vit-block3-out': True}
# fp32 on both sides: the slices' 1e-4 relative L2 for the transformer's
# taps; the JAX package's own bound for int8 against full precision
# (tests/test_quant.py:225)
REL, COS = 1e-4, 0.98


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(ours.double().numpy() - ref) / np.linalg.norm(ref)


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


# ---------------------------------------------------------------- quantizer
@pytest.mark.parametrize('kind', ['random', 'all-zero', 'ragged'])
def test_quantize_int8_equals_jax_bit_for_bit(kind):
    """The port's (out, in) quantizer against JAX's numpy one on the
    transpose: the same int8 values and the same fp32 scale bits, with
    all-zero channels (scale 1) and values on the rounding ties."""
    rs = np.random.RandomState(3)
    shape = {'random': (64, 48), 'all-zero': (8, 5), 'ragged': (333, 1000)}[kind]
    w = (rs.randn(*shape) * rs.rand(shape[0], 1) * 4).astype(np.float32)
    if kind == 'all-zero':
        w[:] = 0
    if kind == 'ragged':
        w[::7] = 0
        # values at k + 1/2 quantization steps: round half to even decides
        w[1, :254] = np.arange(-127, 127, dtype=np.float32) + 0.5
        w[1, 254] = 127.0
    q, scale = quant.quantize_int8(torch.from_numpy(w))
    jq, js = jax_quant.quantize_int8(w.T)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq.T)
    np.testing.assert_array_equal(scale.numpy().view(np.int32), js.view(np.int32))
    back = quant.dequantize_int8(q, scale)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_quant.dequantize_int8(jq, js)).T)


# --------------------------------------------------------------- the layer
@pytest.fixture(scope='module')
def dense():
    """A JAX ``Int8Dense`` (16 -> 24, with a bias) from quantized numpy
    weights, the port's ``Int8Linear`` given the same tree, and an input."""
    rs = np.random.RandomState(1)
    q, s = jax_quant.quantize_int8(rs.randn(16, 24).astype(np.float32))
    tree = {'kernel_q': jnp.asarray(q), 'scale': jnp.asarray(s),
            'bias': jnp.asarray(rs.randn(24).astype(np.float32))}
    layer = quant.Int8Linear(16, 24)
    layer.load_state_dict(params_from_jax(tree, layer))
    x = rs.randn(2, 5, 16).astype(np.float32)
    return jax_quant.Int8Dense(24, use_bias=True), tree, layer, x


def test_int8_linear_twin_matches_jax_int8_dense(dense):
    """``Int8Linear`` (its Function, on the twin) and the twin itself
    against ``Int8Dense.apply`` at fp32: within 1e-6 relative L2; the
    module's buffers are JAX's kernel_q transposed and its scale."""
    jlayer, tree, layer, x = dense
    ref = np.asarray(jlayer.apply({'params': tree}, jnp.asarray(x)))
    assert layer.weight_q.dtype == torch.int8 and layer.scale.dtype == torch.float32
    np.testing.assert_array_equal(layer.weight_q.numpy(), np.asarray(tree['kernel_q']).T)
    ours = layer(torch.from_numpy(x))
    twin = quant.int8_linear_reference(torch.from_numpy(x), layer.weight_q, layer.scale,
                                       layer.bias.detach())
    assert ours.shape == (2, 5, 24)
    assert _rel(ours.detach(), ref) <= 1e-6 and _rel(twin, ref) <= 1e-6


def test_int8_linear_input_gradient_matches_jax_grad(dense):
    """The Function's backward (grad @ deq(W), a plain product) against
    ``jax.grad`` of the same loss; the int8 weight takes no gradient."""
    jlayer, tree, layer, x = dense
    cot = np.random.RandomState(2).randn(2, 5, 24).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jlayer.apply({'params': tree}, v) * cot))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt) * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad, ref) <= 1e-6
    assert layer.weight_q.grad is None and layer.scale.grad is None
    assert _rel(layer.bias.grad, cot.sum(axis=(0, 1))) <= 1e-6


def test_int8_linear_keeps_fp32_scale_through_casts_and_runs_on_meta():
    """``module.to(dtype)`` and ``to_empty`` keep the scale fp32 (the
    loader's meta-built path); under inference mode and on the meta device
    the layer runs its twin."""
    with torch.device('meta'):
        layer = quant.Int8Linear(8, 4, bias=False)
    layer = layer.to(dtype=torch.bfloat16).to_empty(device='cpu')
    assert (layer.weight_q.dtype, layer.scale.dtype) == (torch.int8, torch.float32)
    assert layer.bias is None
    layer.weight_q.copy_(torch.arange(32, dtype=torch.int8).reshape(4, 8) - 16)
    layer.scale.fill_(0.5)
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    with torch.inference_mode():
        out = layer(x)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, x @ (layer.weight_q.to(torch.bfloat16) * 0.5).T)
    meta = quant.Int8Linear(8, 4).to('meta')
    assert meta(torch.empty(2, 3, 8, device='meta')).shape == (2, 3, 4)


def test_params_from_jax_on_a_quantized_t5_tree():
    """A JAX int8 T5 tree (``convert_torch_state`` quantizing a full-precision
    state) into the port's int8 T5: weight_q is kernel_q transposed, the
    scale JAX's, and the encoders agree; a full-precision port T5 refuses
    the tree instead of taking a per-channel scale for a weight."""
    cfg = dataclasses.replace(jax_t5.tiny_t5_config(), quantize_int8=True)
    jmodel = jax_t5.T5EncoderModel(cfg=cfg)
    ids = jnp.asarray(np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 16)))
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), ids))['params']
    rs = np.random.RandomState(5)
    state = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(template)[0]:
        names = [p.key for p in path]
        if names[-1] == 'scale':
            continue    # the int8 layers' scales come from their weights
        shape = leaf.shape[::-1] if names[-1] == 'kernel_q' else leaf.shape
        state['.'.join(names[:-1] + ['weight'])] = (
            np.ones(shape, np.float32) if names[-1] == 'weight'
            else rs.randn(*shape).astype(np.float32) * 0.3)
    tree, missing, _ = convert_torch_state(state, template)
    assert not missing
    ours = port_t5.T5EncoderModel(dataclasses.replace(port_t5.tiny_t5_config(),
                                                      quantize_int8=True))
    params = params_from_jax(tree, ours, port_t5.jax_param_name)
    q = params['encoder.block.1.layer.1.DenseReluDense.wo.weight_q']
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(tree['block_1']['wo']['kernel_q']).T)
    ours.load_state_dict(params)
    ref = jmodel.apply({'params': tree}, ids)
    with torch.inference_mode():
        out = ours(torch.from_numpy(np.array(ids)).long())
    assert _rel(out, ref) <= REL
    with pytest.raises(ValueError, match='is int8'):
        params_from_jax(tree, port_t5.T5EncoderModel(port_t5.tiny_t5_config()),
                        port_t5.jax_param_name)


# ------------------------------------------------- a tiny Flux tree, auto rule
@pytest.fixture(scope='module')
def flux_tree(tmp_path_factory):
    return write_flux_checkpoint(str(tmp_path_factory.mktemp('flux_tree')))


@pytest.fixture(scope='module')
def flux_pair(flux_tree):
    """The JAX facade and the port on the tree with their defaults (the auto
    rule: int8 transformer and T5), fp32 features on both sides."""
    jfe = JaxFeatureExtractor(LAYERS, 'test-flux', img_size=SIZE, dtype='float32',
                              weights=flux_tree, train_unet=True)
    port = FeatureExtractor(LAYERS, 'test-flux', device='cpu', img_size=SIZE, dtype='float32',
                            weights=flux_tree)
    return jfe, port


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


def _port_step(port, prompts, image, t=500):
    posterior, noise = jax_noise(SEED, port.latent_shape(BATCH))
    cond = port._step_conditioning(
        tuple(None if p is None else torch.as_tensor(np.array(p)) for p in prompts), BATCH)
    return port._step(torch.from_numpy(image), cond, port._step_kit(t), posterior, noise, None)


def test_auto_int8_flux_tree_matches_jax(flux_pair, image):
    """Both facades on the tree's defaults: int8 transformer and T5 on
    both sides, the same int8 bits and scales for the same checkpoint
    tensors, the prompt and every tap of the step within 1e-4 relative
    L2 on the JAX key chain's noise."""
    jfe, port = flux_pair
    assert jfe.spec.dit.quantize_int8 and jfe.spec.t5.quantize_int8
    assert port.spec.dit.quantize_int8 and port.spec.t5.quantize_int8
    for ours, ref in (
            (port.unet.transformer_blocks[0].attn.to_q,
             jfe.params['unet']['transformer_blocks_0']['attn']['to_q']),
            (port.unet.single_transformer_blocks[1].norm.linear,
             jfe.params['unet']['single_transformer_blocks_1']['norm_linear']),
            (port.unet.context_embedder, jfe.params['unet']['context_embedder']),
            (port.text_encoders[1].encoder.block[0].layer[1].DenseReluDense.wi_0,
             jfe.params['text'][1]['block_0']['wi_0'])):
        assert isinstance(ours, quant.Int8Linear)
        np.testing.assert_array_equal(ours.weight_q.numpy(), np.asarray(ref['kernel_q']).T)
        np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref['scale']))
    # what JAX leaves full precision stays so
    assert isinstance(port.unet.proj_out, torch.nn.Linear)
    assert isinstance(port.unet.x_embedder, torch.nn.Linear)
    assert isinstance(port.text_encoders[0].text_model.encoder.layers[0].self_attn.q_proj,
                      torch.nn.Linear)
    assert port.load_stats['transformer'][0] > 0
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    for ours, ref in zip(port.encode_prompt(PROMPT), prompts):
        assert (ours is None) == (ref is None)
        if ours is not None:
            assert _rel(ours, ref) <= REL
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=500)
    ours = _port_step(port, prompts, image)
    assert sorted(ours) == sorted(ref) == sorted(LAYERS)
    for key in ref:
        assert _rel(ours[key], ref[key]) <= REL, key


def test_int8_against_full_precision_on_the_same_tree(flux_pair, flux_tree, image):
    """The port's int8 load against its full-precision load of the same
    tree (transformer_8bit=False, t5_8bit=False): every tap's cosine above
    0.98, as JAX holds its own; the two differ (the int8 path is taken)."""
    _, port = flux_pair
    fp = FeatureExtractor(LAYERS, 'test-flux', device='cpu', img_size=SIZE, dtype='float32',
                          weights=flux_tree, transformer_8bit=False, t5_8bit=False)
    assert not fp.spec.dit.quantize_int8 and not fp.spec.t5.quantize_int8
    assert not quant.has_int8(fp.unet) and not quant.has_int8(fp.text_encoders[1])
    a = _port_step(port, port.encode_prompt(PROMPT), image)
    b = _port_step(fp, fp.encode_prompt(PROMPT), image)
    for key in LAYERS:
        assert _cos(a[key], b[key]) > COS, key
    assert not torch.equal(a['vit-block3-out'], b['vit-block3-out'])


def test_prompt_tuning_through_int8_flux_gets_input_gradients(flux_pair, image):
    """A T5 embedding that requires grad (prompt tuning) through the int8
    transformer: autograd reaches it through the Function's input gradient,
    finite and non-zero; the int8 layers take none."""
    _, port = flux_pair
    pe, _, pooled, _ = port.encode_prompt(PROMPT)
    pe = pe.clone().requires_grad_()
    posterior, noise = jax_noise(SEED, port.latent_shape(BATCH))
    cond = port._step_conditioning((pe, None, pooled, None), BATCH)
    feats = port._step(torch.from_numpy(image), cond, port._step_kit(500), posterior, noise,
                       None)
    sum((v.float() ** 2).mean() for v in feats.values()).backward()
    assert pe.grad is not None and torch.isfinite(pe.grad).all() and pe.grad.abs().max() > 0
    assert all(m.weight_q.grad is None for m in port.unet.modules()
               if isinstance(m, quant.Int8Linear))


def test_external_model_shares_the_int8_tensors(flux_pair, image):
    """A second extractor over the int8 one: its denoiser's weight_q, scale
    and biases are the source's storage, its text encoders the source's
    objects, and its step equals the source's on the same draws."""
    _, port = flux_pair
    other = FeatureExtractor({'vit-block2-out': True}, 'test-flux', device='cpu', img_size=SIZE,
                             dtype='float32', external_model=port)
    assert other.spec.dit.quantize_int8 and other.text_encoders is port.text_encoders
    src, ours = port.unet.state_dict(), other.unet.state_dict()
    assert src.keys() == ours.keys()
    assert all(ours[k].data_ptr() == src[k].data_ptr() for k in src)
    assert other.unet.transformer_blocks[0].attn.to_q.weight_q.dtype == torch.int8
    prompts = port.encode_prompt(PROMPT)
    a = _port_step(other, prompts, image)['vit-block2-out']
    b = _port_step(port, prompts, image)
    assert 'vit-block2-out' not in b
    ref = _port_step(FeatureExtractor({'vit-block2-out': True}, 'test-flux', device='cpu',
                                      img_size=SIZE, dtype='float32', external_model=port),
                     prompts, image)['vit-block2-out']
    assert torch.equal(a, ref)


def test_int8_flux_runs_on_the_meta_device():
    """The int8 transformer built and run on the meta device (layer
    enumeration's path): the taps' shapes, and no launch counted."""
    from diffusion_feature_tpu_torch.taps import TapSpec
    cfg = dataclasses.replace(tiny_flux_config(), quantize_int8=True)
    with torch.device('meta'):
        model = FluxTransformer2D(cfg, TapSpec.from_config({'vit-block1-ffn-inner': True}))
        feats = {}
        out = model(torch.empty(1, 64, 16), 500, torch.empty(1, 8, 32), torch.empty(1, 32),
                    feats=feats)
    assert out.shape == (1, 64, 16) and quant.int8_launches == 0
    assert [tuple(t.shape) for t in feats['vit-block1-ffn-inner']] == [(64, 64)]
    assert quant.has_int8(model) and isinstance(model.proj_out, torch.nn.Linear)


# ------------------------------------------------------------ t5_8bit, PixArt
def test_t5_8bit_on_a_pixart_tree_matches_jax(tmp_path):
    """``t5_8bit=True`` on a tiny PixArt tree in both facades: only the T5
    is int8 (the DiT is not Flux), and ``encode_prompt`` agrees."""
    from synth_checkpoint import write_pixart_checkpoint
    init = flax_nn.Module.init

    def shapes_only(self, *args, **kwargs):
        return jax.eval_shape(lambda: init(self, *args, **kwargs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Module, 'init', shapes_only)
        root = write_pixart_checkpoint(tmp_path)
    layers = {'vit-block0-out': True}
    jfe = JaxFeatureExtractor(layers, 'test-pixart', img_size=SIZE, dtype='float32',
                              weights=root, t5_8bit=True, train_unet=True)
    port = FeatureExtractor(layers, 'test-pixart', device='cpu', img_size=SIZE,
                            dtype='float32', weights=root, t5_8bit=True)
    assert jfe.spec.t5.quantize_int8 and port.spec.t5.quantize_int8
    assert quant.has_int8(port.text_encoders[0]) and not quant.has_int8(port.unet)
    wo = port.text_encoders[0].encoder.block[1].layer[1].DenseReluDense.wo
    np.testing.assert_array_equal(wo.weight_q.numpy(),
                                  np.asarray(jfe.params['text'][0]['block_1']['wo']['kernel_q']).T)
    for ours, ref in zip(port.encode_prompt(PROMPT), jfe.encode_prompt(PROMPT)):
        if ours.is_floating_point():
            assert _rel(ours, ref) <= REL
        else:
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert text_jax_name(port.text_encoders[0]) is not None


# ----------------------------------------------------------------- refusals
JAX_REFUSALS = {
    'transformer_8bit-without-weights': (dict(version='test-flux', transformer_8bit=True),
                                         'requires real weights'),
    't5_8bit-without-weights': (dict(version='test-flux', t5_8bit=True),
                                'requires real weights'),
    'transformer_8bit-not-flux': (dict(version='test-sd', transformer_8bit=True),
                                  'only supported for flux'),
    'transformer_8bit-with-lora': (dict(version='test-flux', transformer_8bit=True,
                                        offline_lora='lora.safetensors'), 'offline_lora'),
}


@pytest.mark.parametrize('case', list(JAX_REFUSALS))
def test_int8_refusals_are_jax_s(case):
    """Each int8 keyword the JAX facade refuses, the port refuses with a
    ValueError too (both raise before any model is built)."""
    kwargs, match = JAX_REFUSALS[case]
    layer = {'unet-out': True} if kwargs['version'] == 'test-sd' else {'vit-block0-out': True}
    with pytest.raises(ValueError, match=match):
        JaxFeatureExtractor(layer, img_size=32, dtype='float32', **kwargs)
    with pytest.raises(ValueError, match=match):
        FeatureExtractor(layer, device='cpu', img_size=32, dtype='float32', **kwargs)


def test_the_auto_rule_keeps_random_and_lora_builds_full_precision():
    """Where JAX builds full precision (random weights, or a LoRA to merge),
    so does the port: the auto rule needs ``weights=``, and t5_8bit on a
    family without a T5 is no refusal."""
    fe = FeatureExtractor({'vit-block0-out': True}, 'test-flux', device='cpu', img_size=32,
                          dtype='float32')
    assert not fe.spec.dit.quantize_int8 and not fe.spec.t5.quantize_int8
    assert not quant.has_int8(fe.unet)
    sd = FeatureExtractor({'unet-out': True}, 'test-sd', device='cpu', img_size=32,
                          dtype='float32', t5_8bit=True, transformer_8bit=False)
    assert sd.spec.t5 is None


def test_port_refusals_of_an_int8_extractor(flux_pair, flux_tree, tmp_path):
    """train_unet on an int8 denoiser (no gradient reaches int8 weights),
    save_weights of an int8 extractor (a diffusers tree holds full
    precision) and a random init of an int8 module raise ValueError."""
    _, port = flux_pair
    with pytest.raises(ValueError, match='train_unet=True needs a full-precision denoiser'):
        FeatureExtractor(LAYERS, 'test-flux', device='cpu', img_size=SIZE, dtype='float32',
                         weights=flux_tree, train_unet=True)
    with pytest.raises(ValueError, match='int8 weight-only layers'):
        port.save_weights(str(tmp_path))
    assert not list(tmp_path.iterdir())
    cfg = dataclasses.replace(tiny_flux_config(), quantize_int8=True)
    with pytest.raises(ValueError, match='a random init has none to quantize'):
        random_module(lambda: FluxTransformer2D(cfg), 'cpu', torch.float32,
                      torch.Generator().manual_seed(0))
