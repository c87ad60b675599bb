"""The port's attention ops against the JAX package's.

On the CPU the flash wrapper routes to its plain twin; the JAX flash
kernel runs in Pallas interpret mode, as tests/test_flash.py runs it.  The
Hopper kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusion_feature_tpu.ops import attention as jax_attn
from diffusion_feature_tpu.ops import flash_attention as jax_fa
from diffusion_feature_tpu_torch.ops import attention as attn
from diffusion_feature_tpu_torch.ops import flash_attention as fa


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(ours, ref, atol, rtol):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# fp32 on both sides; 1e-4 covers summation order (online vs one-shot softmax)
@pytest.mark.parametrize('shape', [(1, 2, 512, 512, 64), (1, 1, 512, 512, 512)],
                         ids=['d64', 'd512'])
def test_flash_twin_matches_jax_kernel(shape):
    b, h, sq, sk, d = shape
    q, k, v = _rand(0, b, h, sq, d), _rand(1, b, h, sk, d), _rand(2, b, h, sk, d)
    fa.launches = 0
    ours = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              scale=d ** -0.5)
    ref = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 scale=d ** -0.5)
    _close(ours, ref, atol=1e-4, rtol=1e-4)
    assert fa.launches == 0


@pytest.mark.parametrize('q_shape,k_shape,expect', [
    ((2, 10, 4096, 64), (2, 10, 4096, 64), True),     # U-Net level 1 @1024^2
    ((2, 20, 1024, 64), (2, 20, 1024, 64), True),     # U-Net level 2 @1024^2
    ((2, 1, 16384, 512), (2, 1, 16384, 512), True),   # VAE mid @1024^2
    ((2, 10, 4096, 64), (2, 10, 77, 64), False),      # cross-attention
    ((2, 1, 4096, 512), (2, 1, 4096, 512), False),    # VAE mid @512^2
    ((2, 2, 1024, 16), (2, 2, 1024, 16), False),      # head dim the kernel lacks
    ((2, 5, 1000, 64), (2, 5, 1000, 64), False),      # not 256-aligned
])
def test_gate(q_shape, k_shape, expect):
    assert fa.is_flash_compatible(q_shape, k_shape) is expect
    # the port's gate is the JAX gate plus the head-dim condition
    assert jax_fa.is_flash_compatible(q_shape, k_shape) or not expect


@pytest.mark.parametrize('sk', [1024, 7], ids=['gate-pass', 'cross-7-keys'])
def test_attention_fused_matches_jax(sk):
    heads, d = 2, 64
    q, k, v = _rand(3, 1, 1024, heads * d), _rand(4, 1, sk, heads * d), _rand(5, 1, sk, heads * d)
    fa.launches = 0
    ours = attn.attention_fused(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                heads)
    if sk == 1024:
        # the JAX gate would send this shape to the Pallas kernel; its
        # explicit twin keeps this file at two interpret-mode calls
        ref, _ = jax_attn.attention_with_probs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               heads)
    else:
        ref = jax_attn.attention_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    _close(ours, ref, atol=1e-5, rtol=1e-4)
    assert fa.launches == 0


def test_attention_with_probs_mask_matches_jax():
    heads, s = 2, 9
    q, k, v = _rand(6, 2, s, 32), _rand(7, 2, s, 32), _rand(8, 2, s, 32)
    mask = np.triu(np.full((s, s), -3.4e38, np.float32), k=1)[None, None]
    out, probs = attn.attention_with_probs(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), heads,
                                           mask=torch.from_numpy(mask))
    r_out, r_probs = jax_attn.attention_with_probs(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), heads,
                                                   mask=jnp.asarray(mask))
    _close(out, r_out, atol=1e-5, rtol=1e-4)
    _close(probs, r_probs, atol=1e-6, rtol=1e-4)
    qh, kh, vh = (attn.split_heads(torch.from_numpy(x), heads) for x in (q, k, v))
    assert torch.equal(attn.merge_heads(qh), torch.from_numpy(q))
    fused = attn.attention_fused_heads(qh, kh, vh)
    r_fused = jax_attn.attention_fused_heads(*(jax_attn.split_heads(jnp.asarray(x), heads)
                                               for x in (q, k, v)))
    _close(fused, r_fused, atol=1e-5, rtol=1e-4)


def test_twin_casts_to_input_dtype():
    q = torch.randn(1, 1, 8, 64, dtype=torch.bfloat16)
    out = fa.flash_attention(q, q, q, scale=0.125)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
