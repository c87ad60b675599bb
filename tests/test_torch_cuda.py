"""The Hopper attention kernels (flash B1, flash with logsumexp B2, head-mean
B3, short attention B4) against their plain twins, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU mode).  The file imports torch and the port only, so it
also runs where the JAX package's dependencies are missing:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from diffusion_feature_tpu_torch.ops import attention as attn
from diffusion_feature_tpu_torch.ops import flash_attention as fa

# bf16: output rounded to bf16, sums in another order; fp16: 3 more
# mantissa bits; fp32: summation order alone
_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_TOL), ids=str)
@pytest.mark.parametrize('shape', [(1, 2, 1000, 333, 64), (2, 3, 130, 77, 128),
                                   (1, 1, 300, 700, 512), (1, 2, 1000, 333, 40),
                                   (2, 2, 200, 600, 80), (1, 3, 130, 77, 160)],
                         ids=['d64', 'd128', 'd512', 'd40', 'd80', 'd160'])
def test_kernel_matches_twin(cuda, dtype, shape):
    b, h, sq, sk, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    fa.launches = 0
    out = fa.flash_attention(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches == 1 and out.dtype == dtype
    ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=_TOL[dtype], rtol=_TOL[dtype])


def _qkv(cuda, dtype, b, h, sq, sk, d, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
                 for s in (sq, sk, sk))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_TOL), ids=str)
@pytest.mark.parametrize('shape', [(1, 2, 1000, 333, 64), (2, 2, 300, 77, 40),
                                   (1, 3, 130, 700, 160)], ids=['d64', 'd40', 'd160'])
def test_lse_and_headmean_kernels_match_twins(cuda, dtype, shape):
    """B2's output and logsumexp, then B3 on B2's logsumexp, at ragged
    lengths (odd Sk: scalar stores)."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda, dtype, *shape)
    fa.lse_launches = fa.headmean_launches = 0
    out, lse = fa.flash_attention_with_lse(q, k, v, scale=d ** -0.5)
    mean_p = fa.headmean_probs(q, k, lse, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.lse_launches, fa.headmean_launches) == (1, 1)
    assert lse.dtype == torch.float32 and mean_p.dtype == dtype and mean_p.shape == (b, sq, sk)
    r_out, r_lse = fa.flash_attention_with_lse_reference(q, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), r_out.float(), atol=_TOL[dtype], rtol=_TOL[dtype])
    # both sides take fp32 scores from the same inputs
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    r_mean = fa.headmean_probs_reference(q, k, lse, d ** -0.5)
    # the map's entries average 1/Sk: its absolute tolerance scales with them
    torch.testing.assert_close(mean_p.float(), r_mean.float(), atol=_TOL[dtype] / sk,
                               rtol=_TOL[dtype])
    torch.testing.assert_close(mean_p.float().sum(-1), torch.ones(b, sq, device=cuda),
                               atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('sq,launches', [(1024, 1), (256, 0)], ids=['kernels', 'explicit'])
def test_headmean_routes_on_card(cuda, sq, launches):
    """The store path launches B2 and B3 once each where the gate passes
    (SD-1.5's 1024-token d=80 level), and neither below 512 tokens."""
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 8, sq, sq, 80, seed=2)
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    out, mean_p = attn.attention_with_headmean_heads(q, k, v)
    torch.cuda.synchronize()
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, launches, launches)
    r_out, probs = attn.attention_with_probs_heads(q, k, v)
    torch.testing.assert_close(out.float(), r_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(mean_p.float(), probs.float().mean(1), atol=2e-2 / sq, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize('sk,launches', [(1024, 1), (77, 0)], ids=['gate-pass', 'cross'])
def test_attention_fused_routes_on_card(cuda, sk, launches):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 1024, 640, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, sk, 640, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    fa.launches = fa.short_launches = 0
    out = attn.attention_fused(q, k, v, 10)
    torch.cuda.synchronize()
    assert (fa.launches, fa.short_launches) == (launches, 0)
    ref, _ = attn.attention_with_probs(q, k, v, 10)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_kernel_raises_on_unsupported_input(cuda):
    q = torch.randn(1, 2, 64, 32, device=cuda)
    with pytest.raises(ValueError, match='head dim'):
        fa.flash_attention(q, q, q, scale=1.0)
    q = torch.randn(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_attention(q[:, :, ::2], q[:, :, ::2], q[:, :, ::2], scale=1.0)
    with pytest.raises(ValueError, match='dtype'):
        fa.flash_attention(q.double(), q.double(), q.double(), scale=1.0)
    q = torch.randn(1, 1, 64, 512, device=cuda)
    with pytest.raises(ValueError, match='head dim'):
        fa.flash_attention_with_lse(q, q, q, scale=1.0)
    with pytest.raises(ValueError, match='head dim'):
        fa.headmean_probs(q, q, torch.zeros(1, 1, 64, device=cuda), scale=1.0)
    q = torch.randn(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match='lse'):
        fa.headmean_probs(q, q, torch.zeros(1, 2, 64, device=cuda, dtype=torch.float16),
                          scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_TOL), ids=str)
@pytest.mark.parametrize('shape', [(1, 2, 200, 333, 64), (2, 3, 256, 77, 40),
                                   (2, 2, 128, 512, 160), (1, 3, 130, 1, 80),
                                   (2, 2, 256, 256, 128)],
                         ids=['ragged-d64', 'cross-d40', 'sk512-d160', 'one-key-d80', 'd128'])
def test_short_kernel_matches_twin(cuda, dtype, shape):
    """B4 at ragged Sq and Sk (masked key padding, zero-filled rows), the
    most keys it takes, and a single key."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda, dtype, *shape, seed=3)
    fa.short_launches = 0
    out = fa.short_attention(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.short_launches == 1 and out.dtype == dtype and out.shape == q.shape
    ref = fa.short_attention_reference(q, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=_TOL[dtype], rtol=_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=str)
def test_short_attention_diff_grads_match_twin(cuda, dtype):
    """The kernel's forward and the twin's backward against the twin's
    autograd end to end; a loss linear in the output gives both sides the
    same output gradient."""
    shape = (2, 4, 256, 77, 64)
    inputs = [x.requires_grad_() for x in _qkv(cuda, dtype, *shape, seed=4)]
    twin_inputs = [x.detach().clone().requires_grad_() for x in inputs]
    weight = torch.randn(shape[:3] + shape[4:], device=cuda)
    fa.short_launches = 0
    out = fa.short_attention_diff(*inputs, scale=0.125)
    (out.float() * weight).sum().backward()
    ref = fa.short_attention_reference(*twin_inputs, 0.125)
    (ref.float() * weight).sum().backward()
    torch.cuda.synchronize()
    assert fa.short_launches == 1
    torch.testing.assert_close(out.float(), ref.float(), atol=_TOL[dtype], rtol=_TOL[dtype])
    for ours, theirs in zip(inputs, twin_inputs):
        assert ours.grad.dtype == dtype
        torch.testing.assert_close(ours.grad.float(), theirs.grad.float(), atol=_TOL[dtype],
                                   rtol=_TOL[dtype])


@pytest.mark.cuda
def test_short_kernel_raises_on_unsupported_input(cuda):
    q = torch.randn(1, 2, 128, 64, device=cuda)
    k = torch.randn(1, 2, 513, 64, device=cuda)
    with pytest.raises(ValueError, match='at most 512'):
        fa.short_attention(q, k, k, scale=1.0)
    q = torch.randn(1, 2, 128, 32, device=cuda)
    with pytest.raises(ValueError, match='head dim'):
        fa.short_attention(q, q, q, scale=1.0)
