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

Importing this module also sets PyTorch to one intra-op thread.  The suite
runs several workers on the host's cores, and each worker's default pool
(one thread per core) then oversubscribes them; the tiny models' forwards
are thousands of small operators, each of which waits for every thread of
the pool: under such load a 95-forward walk of test-sd took 112 s with the
default pool and 2 s with one thread.
"""

import types

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.models.bert_text import BertTextModel
from diffusion_feature_tpu.models.clip_text import CLIPTextModel
from diffusion_feature_tpu.models.convert import convert_torch_state
from diffusion_feature_tpu.models.dit_pixart import PixArtTransformer2D
from diffusion_feature_tpu.models.flux import FluxTransformer2D
from diffusion_feature_tpu.models.hunyuan import HunyuanDiT2D
from diffusion_feature_tpu.models.registry import get_model_spec
from diffusion_feature_tpu.models.t5 import T5EncoderModel
from diffusion_feature_tpu.models.unet2d import UNet2DConditionModel
from diffusion_feature_tpu.models.unet_if import IFUNet
from diffusion_feature_tpu.models.vae import AutoencoderKL
from diffusion_feature_tpu.tokenizers.clip_bpe import load_clip_tokenizer
from diffusion_feature_tpu.tokenizers.t5_tok import load_t5_tokenizer
from diffusion_feature_tpu.tokenizers.wordpiece import load_bert_tokenizer
from diffusion_feature_tpu_torch.models.convert import params_from_jax, text_jax_name

torch.set_num_threads(1)


def _param_shapes(spec, unet, vae, text_encoders):
    def init():
        rng = jax.random.PRNGKey(0)
        if spec.family == 'if':
            # pixel space: no VAE
            ctx = jnp.zeros((1, spec.prompt_max_length, spec.t5.d_model))
            ids = jnp.zeros((1, spec.prompt_max_length), jnp.int32)
            return {'unet': unet.init(rng, jnp.zeros((1, spec.unet.in_channels, 8, 8)), 50,
                                      ctx)['params'],
                    'text': [text_encoders[0].init(rng, ids)['params']]}
        if spec.family == 'hunyuan':
            cfg = spec.dit
            ids = jnp.zeros((1, cfg.text_len), jnp.int32)
            denoiser = unet.init(rng, jnp.zeros((1, cfg.in_channels, 8, 8)), 50.0,
                                 jnp.zeros((1, cfg.text_len, cfg.cross_attention_dim)), None,
                                 jnp.zeros((1, cfg.text_len_t5, cfg.cross_attention_dim_t5)),
                                 None)['params']
            t5_ids = jnp.zeros((1, cfg.text_len_t5), jnp.int32)
            text = [text_encoders[0].init(rng, ids)['params'],
                    text_encoders[1].init(rng, t5_ids)['params']]
            return {'unet': denoiser, 'text': text,
                    'vae': vae.init(rng, jnp.zeros((1, 3, 16, 16)),
                                    method=AutoencoderKL.full_pass)['params']}
        if spec.family == 'flux':
            # the token count must match the transformer's RoPE grid
            gh, gw = unet.grid_hw
            denoiser = unet.init(rng, jnp.zeros((1, gh * gw, spec.dit.in_channels)), 50.0,
                                 jnp.zeros((1, spec.prompt_max_length, spec.t5.d_model)),
                                 jnp.zeros((1, spec.dit.pooled_projection_dim)))['params']
            text = [text_encoders[0].init(rng, jnp.zeros((1, 77), jnp.int32))['params'],
                    text_encoders[1].init(
                        rng, jnp.zeros((1, spec.prompt_max_length), jnp.int32))['params']]
            return {'unet': denoiser, 'text': text,
                    'vae': vae.init(rng, jnp.zeros((1, 3, 16, 16)),
                                    method=AutoencoderKL.full_pass)['params']}
        if spec.family == 'pixart':
            ids = jnp.zeros((1, spec.prompt_max_length), jnp.int32)
            ctx = jnp.zeros((1, spec.prompt_max_length, spec.t5.d_model))
            denoiser = unet.init(rng, jnp.zeros((1, spec.dit.in_channels, 8, 8)), 50, ctx,
                                 jnp.ones_like(ids))['params']
        else:
            ids = jnp.zeros((1, 77), jnp.int32)
            added = None
            if spec.unet.addition_embed_type == 'text_time':
                last = spec.text_encoders[-1]
                added = {'text_embeds': jnp.zeros((1, last.projection_dim or last.hidden_size)),
                         'time_ids': jnp.zeros((1, 6))}
            sample = jnp.zeros((1, spec.unet.in_channels, 8, 8))
            ctx = jnp.zeros((1, 77, spec.unet.cross_attention_dim))
            denoiser = unet.init(rng, sample, 50, ctx, added)['params']
        return {
            'unet': denoiser,
            'vae': vae.init(rng, jnp.zeros((1, 3, 16, 16)),
                            method=AutoencoderKL.full_pass)['params'],
            'text': [te.init(rng, ids)['params'] for te in text_encoders],
        }
    return jax.eval_shape(init)


def _draw(shapes, seed):
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'bias':
            return jnp.zeros(s.shape, s.dtype)
        if name in ('scale', 'weight'):       # norm scales (T5's RMS norm: 'weight')
            return jnp.ones(s.shape, s.dtype)
        if name == 'kernel' or name.endswith('_kernel'):
            fan_in = int(np.prod(s.shape[:-1]))
        elif name in ('embedding', 'scale_shift_table'):   # the DiT's: N(0, 1/dim)
            fan_in = s.shape[-1]
        elif name.endswith('_bias'):
            return jnp.zeros(s.shape, s.dtype)
        elif name in ('cls_token', 'position_embeddings'):   # the DPT's, ViT-sized
            fan_in = 2500
        elif name in ('positional_embedding',         # HunyuanDiT's T5 pool: N(0, 1/dim)
                      'pool_positional_embedding'):   # IF's text pool, the same
            fan_in = s.shape[-1]
        elif name == 'text_embedding_padding':        # HunyuanDiT's: N(0, 0.02^2)
            fan_in = 2500
        else:
            raise KeyError(f'no initialiser for parameter {jax.tree_util.keystr(path)}')
        return jnp.asarray(rs.randn(*s.shape).astype(np.float32) * fan_in ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_facade(layer, version: str, img_size: int, seed: int = 0, **kwargs):
    """The JAX facade of a U-Net, PixArt, HunyuanDiT, Flux or IF ``version`` at fp32
    with fp32 features (``train_unet=True`` only drops its bf16 feature cast), random
    parameters drawn from ``seed``.  ``kwargs`` go to the facade (e.g.
    ``attention=``, ``attn_store_sizes=``, ``validate_layers=``)."""
    spec = get_model_spec(version)
    vae = None if spec.vae is None else AutoencoderKL(cfg=spec.vae, dtype=jnp.float32)
    if spec.family == 'if':
        unet = IFUNet(cfg=spec.unet, dtype=jnp.float32)
        text_encoders = (T5EncoderModel(cfg=spec.t5, dtype=jnp.float32),)
        tokenizers = (load_t5_tokenizer(None, model_max_length=spec.prompt_max_length,
                                        vocab_size=spec.t5.vocab_size),)
    elif spec.family == 'hunyuan':
        unet = HunyuanDiT2D(cfg=spec.dit, dtype=jnp.float32)
        text_encoders = (BertTextModel(cfg=spec.bert, dtype=jnp.float32),
                         T5EncoderModel(cfg=spec.t5, dtype=jnp.float32))
        tokenizers = (load_bert_tokenizer(None, model_max_length=spec.dit.text_len,
                                          vocab_size=spec.bert.vocab_size),
                      load_t5_tokenizer(None, model_max_length=spec.dit.text_len_t5,
                                        vocab_size=spec.t5.vocab_size))
    elif spec.family == 'flux':
        # the facade's build (facade.py:351-372): the packed grid of img_size
        grid = img_size // 2 ** (len(spec.vae.block_out_channels) - 1) // 2
        unet = FluxTransformer2D(cfg=spec.dit, grid_hw=(grid, grid),
                                 text_len=spec.prompt_max_length, dtype=jnp.float32)
        text_encoders = (CLIPTextModel(cfg=spec.text_encoders[0], dtype=jnp.float32),
                         T5EncoderModel(cfg=spec.t5, dtype=jnp.float32))
        tokenizers = (load_clip_tokenizer(None, vocab_size=spec.text_encoders[0].vocab_size),
                      load_t5_tokenizer(None, model_max_length=spec.prompt_max_length,
                                        vocab_size=spec.t5.vocab_size))
    elif spec.family == 'pixart':
        unet = PixArtTransformer2D(cfg=spec.dit, dtype=jnp.float32)
        text_encoders = (T5EncoderModel(cfg=spec.t5, dtype=jnp.float32),)
        tokenizers = (load_t5_tokenizer(None, model_max_length=spec.prompt_max_length,
                                        vocab_size=spec.t5.vocab_size),)
    else:
        unet = UNet2DConditionModel(cfg=spec.unet, dtype=jnp.float32)
        text_encoders = tuple(CLIPTextModel(cfg=c, dtype=jnp.float32)
                              for c in spec.text_encoders)
        # the first tokenizer pads with EOS, OpenCLIP's with id 0, as the facade builds them
        tokenizers = tuple(load_clip_tokenizer(None, vocab_size=c.vocab_size,
                                               pad_with_eos=i == 0)
                           for i, c in enumerate(spec.text_encoders))
    models = types.SimpleNamespace(
        unet=unet, vae=vae, text_encoders=text_encoders, tokenizers=tokenizers,
        params=_draw(_param_shapes(spec, unet, vae, text_encoders), seed))
    return JaxFeatureExtractor(layer, version, img_size=img_size, dtype='float32', seed=seed,
                               train_unet=True, external_model=models, **kwargs)


def load_jax_params(jfe, port):
    """Load the JAX facade's parameters into the port facade's modules."""
    port.unet.load_state_dict(params_from_jax(jfe.params['unet'], port.unet))
    if port.vae is not None:
        port.vae.load_state_dict(params_from_jax(jfe.params['vae'], port.vae))
    for te, tree in zip(port.text_encoders, jfe.params['text']):
        te.load_state_dict(params_from_jax(tree, te, text_jax_name(te)))


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


def jax_sample_noise(seed: int, lat_shape, call: int = 0):
    """The initial latents' draw of a facade's ``sample`` number ``call``
    (0 is the first, with no extract before it), as a torch tensor: one
    split(rng) -> (rng, sample_rng) per call (facade.py:1551), then
    split(sample_rng) -> (rng, r0) and an fp32 normal from r0 (:1761)."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(call + 1):
        rng, sample_rng = jax.random.split(rng)
    _, r0 = jax.random.split(sample_rng)
    return torch.from_numpy(np.array(jax.random.normal(r0, lat_shape, np.float32)))


def jax_ddpm_sample_noise(seed: int, lat_shape, steps: int, call: int = 0):
    """``jax_sample_noise`` and the per-step draws of a DDPM sample (the
    JAX facade's unrolled loop splits its key once per step, facade.py:1788):
    (initial latents' draw, [one standard-normal draw per step])."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(call + 1):
        rng, sample_rng = jax.random.split(rng)
    rng, r0 = jax.random.split(sample_rng)
    draws = []
    for _ in range(steps):
        rng, rn = jax.random.split(rng)
        draws.append(torch.from_numpy(np.array(jax.random.normal(rn, lat_shape, np.float32))))
    return torch.from_numpy(np.array(jax.random.normal(r0, lat_shape, np.float32))), draws


def jax_control(jfe, nets, seed: int = 0):
    """Give the JAX facade ``jfe`` ControlNets, as ``control=`` builds them
    (``ControlNetPipeline``), but with parameters drawn by ``_draw`` (zero
    convs non-zero, as a trained checkpoint's) instead of the eager Flax
    init: ``nets`` are (kind, preprocessor or None) pairs, net ``i``'s
    parameters drawn from ``seed + i``."""
    from diffusion_feature_tpu.models.controlnet import ControlNetPipeline, ControlNetSpec
    spec = jfe.spec
    pipe = ControlNetPipeline.__new__(ControlNetPipeline)
    pipe.dtype, pipe.img_size = jfe.dtype, jfe.img_size
    n_stages = max(1, (jfe.vae_scale - 1).bit_length())
    cond_ch = ((16, 32, 96, 256) if n_stages == 3
               else tuple([16] + [32 * 2 ** i for i in range(n_stages)]))
    pipe.nets = [ControlNetSpec(kind, spec.unet, jfe.dtype, pre, cond_embed_channels=cond_ch)
                 for kind, pre in nets]
    lat = jfe.img_size // jfe.vae_scale
    added = None
    if spec.unet.addition_embed_type == 'text_time':
        last = spec.text_encoders[-1]
        added = {'text_embeds': jnp.zeros((1, last.projection_dim or last.hidden_size)),
                 'time_ids': jnp.zeros((1, 6))}
    args = (jnp.zeros((1, spec.unet.in_channels, lat, lat)), 50,
            jnp.zeros((1, 77, spec.unet.cross_attention_dim)),
            jnp.zeros((1, 3, jfe.img_size, jfe.img_size)), 1.0, added)
    jfe.params['controlnet'] = [
        _draw(jax.eval_shape(lambda n=net: n.model.init(jax.random.PRNGKey(0), *args)['params']),
              seed + i)
        for i, net in enumerate(pipe.nets)]
    jfe.control_pipe = pipe
    return pipe


def assert_params_round_trip(tree, module):
    """params_from_jax then convert_torch_state reproduces the JAX tree."""
    state = {k: v.numpy() for k, v in params_from_jax(tree, module).items()}
    back, missing, unused = convert_torch_state(state, tree)
    assert not missing and not unused
    want, got = traverse_util.flatten_dict(tree), traverse_util.flatten_dict(back)
    assert got.keys() == want.keys()
    for path, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(val), err_msg=str(path))

