"""B4, the short-sequence attention of the PyTorch port, against the JAX
package's ``short_attention`` (its Pallas kernel in interpret mode, as
tests/test_flash.py runs it on the CPU).

On the CPU the port's wrapper runs the plain twin; the Hopper kernel itself
is held to the twin on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_feature_tpu.ops import flash_attention as jax_fa
from diffusion_feature_tpu_torch.ops import flash_attention as fa


def _qkv(seed, b, h, sq, sk, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk))


# fp32 on both sides: 1e-4 covers summation order, as tests/test_flash.py
# holds the JAX kernel to the explicit path
@pytest.mark.parametrize('shape', [(2, 4, 256, 256, 32), (2, 4, 256, 77, 32),
                                   (3, 2, 128, 128, 16)], ids=['self', 'padded-cross', 'group'])
def test_twin_matches_jax_kernel(shape):
    b, h, sq, sk, d = shape
    q, k, v = _qkv(sum(shape), *shape)
    fa.short_launches = 0
    ours = fa.short_attention(*(torch.from_numpy(x) for x in (q, k, v)), scale=d ** -0.5)
    ref = jax_fa.short_attention(*(jnp.asarray(x) for x in (q, k, v)), scale=d ** -0.5)
    assert fa.short_launches == 0
    assert ours.dtype == torch.float32 and ours.shape == (b, h, sq, d)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_diff_gradients_match_jax_vjp():
    """short_attention_diff's gradients against JAX's custom VJP at
    test_flash.py's shape and tolerance."""
    q, k, v = _qkv(4, 1, 2, 128, 128, 16)
    scale = 16 ** -0.5
    g = np.random.RandomState(5).randn(1, 2, 128, 16).astype(np.float32)
    ours_in = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.short_attention_diff(*ours_in, scale=scale)
    out.backward(torch.from_numpy(g))
    ref_out, vjp = jax.vjp(lambda a, b, c: jax_fa.short_attention_diff(a, b, c, scale=scale),
                           *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=1e-4, atol=1e-4)
    for ours, ref in zip(ours_in, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-3)


# test_flash.py's gate cases, and a grid around every bound of the gate
_GATE_CASES = [((16, 20, 256, 64), (16, 20, 256, 64)), ((16, 20, 256, 64), (16, 20, 77, 64)),
               ((16, 10, 1024, 64), (16, 10, 1024, 64)), ((1, 2, 64, 32), (1, 2, 64, 32))]
_GATE_CASES += [((2, 4, sq, d), (2, 4, sk, d)) for sq, sk, d in itertools.product(
    (8, 64, 128, 200, 256, 384, 512, 640), (1, 77, 256, 512, 513), (16, 40, 64, 160, 256, 320))]


def test_gate_equals_jax():
    for q_shape, k_shape in _GATE_CASES:
        want = jax_fa.is_short_attn_compatible(q_shape, k_shape)
        assert fa.is_short_attn_compatible(q_shape, k_shape, head_dims=None) is want, q_shape
        # the kernel's head widths bind where it runs
        assert fa.is_short_attn_compatible(q_shape, k_shape) is (
            want and q_shape[-1] in fa.HEADMEAN_HEAD_DIMS), q_shape
        assert jax_fa.is_short_attn_compatible(q_shape, k_shape, max_seq=256) is \
            fa.is_short_attn_compatible(q_shape, k_shape, max_seq=256, head_dims=None)


def test_cpu_and_meta_calls_launch_nothing():
    """CPU tensors take the twin, meta tensors too (shapes only), and the
    port's attention dispatch never routes to B4, as in the JAX package."""
    from diffusion_feature_tpu_torch.ops import attention as attn
    fa.short_launches = fa.launches = 0
    q, k, v = (torch.randn(2, 256, 64) for _ in range(3))
    out = attn.attention_fused(q, k, v, 2)
    meta = torch.empty(2, 8, 256, 160, device='meta')
    assert fa.short_attention(meta, meta, meta, scale=1.0).shape == meta.shape
    diff = fa.short_attention_diff(*(x.reshape(2, 256, 2, 32).transpose(1, 2) for x in (q, k, v)),
                                   scale=32 ** -0.5)
    assert (fa.short_launches, fa.launches) == (0, 0)
    torch.testing.assert_close(diff.transpose(1, 2).reshape(2, 256, 64), out, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('layout', ['head-split', 'row-stride'])
def test_twin_takes_strided_views(layout):
    """B4's wrapper on strided CPU views (the layouts the card's kernel
    reads in place) gives what it gives on contiguous copies."""
    from diffusion_feature_tpu_torch.ops import attention as attn
    b, h, sq, sk, d = 2, 3, 128, 77, 16
    rs = np.random.RandomState(51)
    if layout == 'head-split':
        q, k, v = (attn.split_heads(torch.from_numpy(rs.randn(b, s, h * d).astype(np.float32)), h)
                   for s in (sq, sk, sk))
    else:
        q, k, v = (torch.from_numpy(rs.randn(b, h, 2 * s, d).astype(np.float32))[:, :, ::2]
                   for s in (sq, sk, sk))
    assert not any(x.is_contiguous() for x in (q, k, v))
    fa.short_launches = 0
    ours = fa.short_attention(q, k, v, scale=d ** -0.5)
    ref = fa.short_attention(*(x.contiguous() for x in (q, k, v)), scale=d ** -0.5)
    assert fa.short_launches == 0 and ours.shape == (b, h, sq, d)
    torch.testing.assert_close(ours, ref, atol=1e-6, rtol=1e-5)
