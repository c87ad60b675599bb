"""Set-up shared by the PyTorch port's parity tests (tests/test_torch_*.py):
a JAX facade whose random parameters are drawn with numpy, the port loaded
with them, and the noise of the JAX facade's key chain.

The JAX facade's own random init runs Flax's ``init`` eagerly, which
compiles every op of the model on the CPU: ~25 s for each tiny ``test-*``
model, jitted or not.  Tracing the parameter shapes takes ~3 s.  A parity
test needs only that both sides share the parameters, so they are drawn here
from a seed with the distributions Flax's initialisers use (kernels and
embeddings N(0, 1/fan_in), norm scales 1, biases 0) and handed to the facade
through its ``external_model`` argument.
"""

import types

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.models.clip_text import CLIPTextModel
from diffusion_feature_tpu.models.convert import convert_torch_state
from diffusion_feature_tpu.models.registry import get_model_spec
from diffusion_feature_tpu.models.unet2d import UNet2DConditionModel
from diffusion_feature_tpu.models.vae import AutoencoderKL
from diffusion_feature_tpu.tokenizers.clip_bpe import load_clip_tokenizer
from diffusion_feature_tpu_torch.models.convert import params_from_jax


def _param_shapes(spec, unet, vae, text_encoders):
    def init():
        rng = jax.random.PRNGKey(0)
        added = None
        if spec.unet.addition_embed_type == 'text_time':
            last = spec.text_encoders[-1]
            added = {'text_embeds': jnp.zeros((1, last.projection_dim or last.hidden_size)),
                     'time_ids': jnp.zeros((1, 6))}
        sample = jnp.zeros((1, spec.unet.in_channels, 8, 8))
        ctx = jnp.zeros((1, 77, spec.unet.cross_attention_dim))
        return {
            'unet': unet.init(rng, sample, 50, ctx, added)['params'],
            'vae': vae.init(rng, jnp.zeros((1, 3, 16, 16)),
                            method=AutoencoderKL.full_pass)['params'],
            'text': [te.init(rng, jnp.zeros((1, 77), jnp.int32))['params']
                     for te in text_encoders],
        }
    return jax.eval_shape(init)


def _draw(shapes, seed):
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'bias':
            return jnp.zeros(s.shape, s.dtype)
        if name == 'scale':
            return jnp.ones(s.shape, s.dtype)
        if name == 'kernel':
            fan_in = int(np.prod(s.shape[:-1]))
        elif name == 'embedding':
            fan_in = s.shape[-1]
        else:
            raise KeyError(f'no initialiser for parameter {jax.tree_util.keystr(path)}')
        return jnp.asarray(rs.randn(*s.shape).astype(np.float32) * fan_in ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_facade(layer, version: str, img_size: int, seed: int = 0, **kwargs):
    """The JAX facade of a U-Net ``version`` at fp32 with fp32 features
    (``train_unet=True`` only drops its bf16 feature cast), random
    parameters drawn from ``seed``.  ``kwargs`` go to the facade (e.g.
    ``attention=``, ``attn_store_sizes=``, ``validate_layers=``)."""
    spec = get_model_spec(version)
    unet = UNet2DConditionModel(cfg=spec.unet, dtype=jnp.float32)
    vae = AutoencoderKL(cfg=spec.vae, dtype=jnp.float32)
    text_encoders = tuple(CLIPTextModel(cfg=c, dtype=jnp.float32) for c in spec.text_encoders)
    models = types.SimpleNamespace(
        unet=unet, vae=vae, text_encoders=text_encoders,
        # the first tokenizer pads with EOS, OpenCLIP's with id 0, as the facade builds them
        tokenizers=tuple(load_clip_tokenizer(None, vocab_size=c.vocab_size, pad_with_eos=i == 0)
                         for i, c in enumerate(spec.text_encoders)),
        params=_draw(_param_shapes(spec, unet, vae, text_encoders), seed))
    return JaxFeatureExtractor(layer, version, img_size=img_size, dtype='float32', seed=seed,
                               train_unet=True, external_model=models, **kwargs)


def load_jax_params(jfe, port):
    """Load the JAX facade's parameters into the port facade's modules."""
    port.unet.load_state_dict(params_from_jax(jfe.params['unet'], port.unet))
    port.vae.load_state_dict(params_from_jax(jfe.params['vae'], port.vae))
    for te, tree in zip(port.text_encoders, jfe.params['text']):
        te.load_state_dict(params_from_jax(tree, te))


def jax_noise(seed: int, lat_shape, call: int = 0):
    """The posterior and forward noise of a facade's extract number
    ``call`` (0 is the first), as torch tensors: its key chain, one
    split(rng) -> (rng, step_rng) per extract (facade.py:815), then
    split(step_rng) -> fp32 draws (torch cannot replay JAX's generator)."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(call + 1):
        rng, step_rng = jax.random.split(rng)
    return tuple(torch.from_numpy(np.array(jax.random.normal(r, lat_shape, np.float32)))
                 for r in jax.random.split(step_rng))


def assert_params_round_trip(tree, module):
    """params_from_jax then convert_torch_state reproduces the JAX tree."""
    state = {k: v.numpy() for k, v in params_from_jax(tree, module).items()}
    back, missing, unused = convert_torch_state(state, tree)
    assert not missing and not unused
    want, got = traverse_util.flatten_dict(tree), traverse_util.flatten_dict(back)
    assert got.keys() == want.keys()
    for path, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(val), err_msg=str(path))

