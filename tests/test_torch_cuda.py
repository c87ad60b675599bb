"""The Hopper attention kernels (flash B1, flash with logsumexp B2, head-mean
B3, short attention B4) and the W8A16 int8 dense kernel against their plain
twins, on the card; the
checkpoint loader and both kinds of deployment bundle filling modules on
the card; and generation and a
ControlNet extract at a small size with their kernels against the twins;
and a label-scarce member trained from a host-resident matrix.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU mode).  The file imports torch and the port only, so it
also runs where the JAX package's dependencies are missing:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import contextlib

import numpy as np
import pytest
import torch

from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.io.safetensors import load_file, save_file
from diffusion_feature_tpu_torch.models.convert import load_state_into
from diffusion_feature_tpu_torch.ops import attention as attn
from diffusion_feature_tpu_torch.ops import flash_attention as fa

# bf16: output rounded to bf16, sums in another order; fp16: 3 more
# mantissa bits; fp32: summation order alone
_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


def _assert_matches(out, ref, dtype):
    """The elementwise rule, and the error's L2 norm over the reference's
    within the same tolerance: an attention output averages Sk values, so
    its entries are ~Sk^-1/2 and the elementwise rule alone would admit an
    output wrong by a share of every value."""
    out, ref = out.float(), ref.float()
    torch.testing.assert_close(out, ref, atol=_TOL[dtype], rtol=_TOL[dtype])
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel <= _TOL[dtype], f'relative L2 error {rel:.3e} above {_TOL[dtype]:g}'


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
                                   (2, 2, 200, 600, 80), (1, 3, 130, 77, 160),
                                   (2, 3, 1000, 333, 72), (2, 3, 1000, 333, 88)],
                         ids=['d64', 'd128', 'd512', 'd40', 'd80', 'd160', 'd72', 'd88'])
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
    _assert_matches(out, ref, dtype)


def _qkv(cuda, dtype, b, h, sq, sk, d, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
                 for s in (sq, sk, sk))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_TOL), ids=str)
@pytest.mark.parametrize('shape', [(1, 2, 1000, 333, 64), (2, 2, 300, 77, 40),
                                   (1, 3, 130, 700, 160), (2, 3, 300, 333, 72),
                                   (2, 3, 300, 333, 88)],
                         ids=['d64', 'd40', 'd160', 'd72', 'd88'])
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
    _assert_matches(out, r_out, dtype)
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
    # strided views pass (TMA reads them), but D must have unit stride
    with pytest.raises(ValueError, match='contiguous along D'):
        fa.flash_attention(q.transpose(2, 3), q, q, scale=1.0)
    # and row strides must be multiples of 16 bytes (76 bf16 = 152 bytes)
    odd = torch.randn(1, 2, 64, 76, device=cuda).to(torch.bfloat16)[..., :40]
    with pytest.raises(ValueError, match='16 bytes'):
        fa.flash_attention(odd, odd, odd, scale=1.0)
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
                                   (2, 2, 256, 256, 128), (2, 3, 200, 300, 72),
                                   (2, 3, 200, 300, 88)],
                         ids=['ragged-d64', 'cross-d40', 'sk512-d160', 'one-key-d80', 'd128',
                              'ragged-d72', 'ragged-d88'])
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


def _split(cuda, dtype, b, h, s, d, gen):
    """The (B, H, S, D) head-split view of a (B, S, H*D) projection."""
    x = torch.randn(b, s, h * d, generator=gen, device=cuda).to(dtype)
    return attn.split_heads(x, h)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16, torch.float32], ids=str)
@pytest.mark.parametrize('lse,shape', [
    *((lse, shape) for lse in (False, True)
      for shape in [(2, 10, 1024, 1024, 64), (2, 8, 1000, 333, 40), (1, 3, 300, 700, 160),
                    (2, 2, 130, 77, 80), (2, 16, 1024, 1024, 72), (1, 16, 1000, 333, 72),
                    (2, 16, 1024, 1024, 88), (1, 16, 1000, 333, 88)]),
    (False, (1, 1, 1000, 1000, 512)),   # B2 has no d=512 instance: the VAE never feeds the store
], ids=[f'{k}-{d}' for k in ('b1', 'b2') for d in ('d64', 'ragged-d40', 'ragged-d160',
                                                   'ragged-d80', 'd72', 'ragged-d72', 'd88',
                                                   'ragged-d88')]
    + ['b1-ragged-d512'])
def test_kernel_reads_head_split_views(cuda, dtype, lse, shape):
    """B1 and B2 on the head-split views of (B, S, H*D) projections, read
    in place (no copy), at ragged lengths (HunyuanDiT's d=88: 176-byte
    head and 2816-byte token strides); the output is (B, S, H, D) memory,
    so merge_heads of it is a view."""
    b, h, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_split(cuda, dtype, b, h, s, d, gen) for s in (sq, sk, sk))
    assert h == 1 or not q.is_contiguous()   # one head: the view is contiguous
    fa.launches = fa.lse_launches = 0
    if lse:
        out, got_lse = fa.flash_attention_with_lse(q, k, v, scale=d ** -0.5)
        ref, ref_lse = fa.flash_attention_with_lse_reference(q, k, v, d ** -0.5)
    else:
        out = fa.flash_attention(q, k, v, scale=d ** -0.5)
        ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.launches, fa.lse_launches) == ((0, 1) if lse else (1, 0))
    assert out.shape == q.shape and out.stride() == (sq * h * d, d, h * d, 1)
    assert attn.merge_heads(out).data_ptr() == out.data_ptr()
    _assert_matches(out, ref, dtype)
    if lse:
        torch.testing.assert_close(got_lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize('shape', [(2, 8, 4096, 4096, 40), (2, 1, 4096, 4096, 512),
                                   (2, 20, 1024, 1024, 64), (2, 16, 4096, 4096, 72),
                                   (2, 16, 4096, 4096, 88)],
                         ids=['d40', 'd512', 'd64', 'd72', 'd88'])
def test_kernel_matches_twin_at_path_widths(cuda, dtype, shape):
    """B1 at SD-1.5's d=40 level and at the VAE's d=512 head (4096 tokens:
    the one-pass score tiles over many key tiles), SDXL's d=64 level and
    PixArt-Sigma's d=72 and HunyuanDiT's d=88 self-attention at 1024^2, on
    contiguous inputs."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda, dtype, *shape, seed=6)
    out = fa.flash_attention(q, k, v, scale=d ** -0.5)
    ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
    _assert_matches(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16, torch.float32], ids=str)
@pytest.mark.parametrize('lse,layout', [(False, 'row-stride'), (True, 'split-v')])
def test_kernel_reads_other_strided_views(cuda, dtype, lse, layout):
    """The other layouts the stride contract admits: B1 on every second
    row of (B, H, 2S, D) tensors, and B2 on contiguous q and k with a
    head-split v."""
    b, h, sq, sk, d = 2, 4, 300, 333, 64
    gen = torch.Generator(device=cuda).manual_seed(7)
    if layout == 'row-stride':
        q, k, v = (torch.randn(b, h, 2 * s, d, generator=gen, device=cuda).to(dtype)[:, :, ::2]
                   for s in (sq, sk, sk))
        assert q.stride() == (h * 2 * sq * d, 2 * sq * d, 2 * d, 1)
    else:
        q, k = _qkv(cuda, dtype, b, h, sq, sk, d, seed=7)[:2]
        v = _split(cuda, dtype, b, h, sk, d, gen)
        assert q.is_contiguous() and k.is_contiguous() and not v.is_contiguous()
    fa.launches = fa.lse_launches = 0
    if lse:
        out, got_lse = fa.flash_attention_with_lse(q, k, v, scale=d ** -0.5)
        ref, ref_lse = fa.flash_attention_with_lse_reference(q, k, v, d ** -0.5)
    else:
        out = fa.flash_attention(q, k, v, scale=d ** -0.5)
        ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.launches, fa.lse_launches) == ((0, 1) if lse else (1, 0))
    _assert_matches(out, ref, dtype)
    if lse:
        torch.testing.assert_close(got_lse, ref_lse, atol=1e-3, rtol=0)


def _layout(cuda, dtype, layout, b, h, s, d, gen):
    """(B, H, S, D) q-like input in one of the layouts B3 and B4 take."""
    if layout == 'head-split':
        return _split(cuda, dtype, b, h, s, d, gen)
    return torch.randn(b, h, s, d, generator=gen, device=cuda).to(dtype)


def _assert_map_matches(mean_p, ref, dtype, sk):
    """B3's rule: a map's entries average 1/Sk, so its absolute tolerance
    scales with them, and the error's relative L2 norm stays within the
    dtype's tolerance."""
    mean_p, ref = mean_p.float(), ref.float()
    torch.testing.assert_close(mean_p, ref, atol=_TOL[dtype] / sk, rtol=_TOL[dtype])
    rel = ((mean_p - ref).norm() / ref.norm()).item()
    assert rel <= _TOL[dtype], f'relative L2 error {rel:.3e} above {_TOL[dtype]:g}'


_HEADMEAN_CASES = [(2, 3, 1000, 333, 40), (1, 4, 300, 640, 64), (2, 2, 130, 77, 80),
                   (1, 3, 256, 256, 128), (1, 3, 130, 700, 160), (2, 16, 1024, 1024, 72),
                   (2, 16, 1024, 1024, 88)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_TOL), ids=str)
@pytest.mark.parametrize('layout', ['contiguous', 'head-split'])
@pytest.mark.parametrize('shape', _HEADMEAN_CASES, ids=[f'd{s[-1]}' for s in _HEADMEAN_CASES])
def test_headmean_kernel_layouts_and_widths(cuda, dtype, layout, shape):
    """B3 against its twin at every built width, on contiguous tensors and
    on head-split views read in place, at ragged Sq and Sk (Sk a multiple
    of 8: 16-byte row stores; otherwise element stores)."""
    b, h, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k = (_layout(cuda, dtype, layout, b, h, s, d, gen) for s in (sq, sk))
    assert q.is_contiguous() is (layout == 'contiguous')
    _, lse = fa.flash_attention_with_lse(q, k, k, scale=d ** -0.5)
    fa.headmean_launches = 0
    mean_p = fa.headmean_probs(q, k, lse, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.headmean_launches == 1
    assert mean_p.dtype == dtype and mean_p.shape == (b, sq, sk) and mean_p.is_contiguous()
    _assert_map_matches(mean_p, fa.headmean_probs_reference(q, k, lse, d ** -0.5), dtype, sk)


_SHORT_CASES = [(2, 3, 200, 333, 40), (1, 4, 256, 512, 64), (2, 2, 130, 300, 80),
                (1, 3, 256, 256, 128), (1, 3, 130, 512, 160), (2, 16, 256, 300, 72),
                (2, 16, 256, 300, 88)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_TOL), ids=str)
@pytest.mark.parametrize('layout', ['contiguous', 'head-split'])
@pytest.mark.parametrize('shape', _SHORT_CASES, ids=[f'd{s[-1]}' for s in _SHORT_CASES])
def test_short_kernel_layouts_and_widths(cuda, dtype, layout, shape):
    """B4 against its twin at every built width, on contiguous tensors and
    on head-split views, at ragged lengths, with the key tiles kept for the
    second pass (d=40, d=64 up to 512 keys) and reloaded (d=72, d=80 at 300 keys,
    d=128 at 256, d=160 at 512); the output is (B, S, H, D) memory."""
    b, h, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (_layout(cuda, dtype, layout, b, h, s, d, gen) for s in (sq, sk, sk))
    fa.short_launches = 0
    out = fa.short_attention(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.short_launches == 1
    assert out.dtype == dtype and out.shape == q.shape
    assert out.stride() == (sq * h * d, d, h * d, 1)
    _assert_matches(out, fa.short_attention_reference(q, k, v, d ** -0.5), dtype)


# fp32 B3's edges: one head (the staging's prologue alone) and 20 heads
# (more heads than stages), at each staging choice (two stages up to d=88,
# one at d=128 and 160), ragged Sq and Sk, odd Sk among them
_F32_HEADMEAN_EDGES = [(1, 1, 1000, 333, 64), (2, 20, 130, 77, 64), (1, 20, 257, 333, 88),
                       (1, 1, 65, 1001, 128), (2, 20, 127, 129, 160), (1, 20, 1000, 7, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', _F32_HEADMEAN_EDGES,
                         ids=[f'h{s[1]}-sk{s[3]}-d{s[4]}' for s in _F32_HEADMEAN_EDGES])
def test_fp32_headmean_kernel_edges(cuda, shape):
    """fp32 B3 on head-split views against its twin at H=1 and H=20, ragged
    lengths and odd Sk (element stores)."""
    b, h, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k = (_split(cuda, torch.float32, b, h, s, d, gen) for s in (sq, sk))
    _, lse = fa.flash_attention_with_lse(q, k, k, scale=d ** -0.5)
    fa.headmean_launches = 0
    mean_p = fa.headmean_probs(q, k, lse, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.headmean_launches == 1
    assert mean_p.shape == (b, sq, sk) and mean_p.is_contiguous()
    _assert_map_matches(mean_p, fa.headmean_probs_reference(q, k, lse, d ** -0.5),
                        torch.float32, sk)


# fp32 B4's edges: Sk = 1, 77 and 512 at d=160 (two K slots, then at 512
# keys one, V's second slot in Q's space: 217 KB of shared memory), and 512
# keys at d=128 (one slot) and d=88 (two slots, 204 KB); 65 keys (a last
# tile of one key; one slot, three blocks an SM)
_F32_SHORT_EDGES = [(2, 3, 130, 1, 160), (1, 4, 200, 77, 160), (2, 3, 256, 512, 160),
                    (1, 2, 65, 512, 128), (1, 2, 64, 512, 88), (2, 5, 129, 65, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', _F32_SHORT_EDGES,
                         ids=[f'sk{s[3]}-d{s[4]}' for s in _F32_SHORT_EDGES])
def test_fp32_short_kernel_edges(cuda, shape):
    """fp32 B4 on head-split views against its twin at the shared-memory
    limit and the shortest key sequences; the output is (B, S, H, D)
    memory."""
    b, h, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (_split(cuda, torch.float32, b, h, s, d, gen) for s in (sq, sk, sk))
    fa.short_launches = 0
    out = fa.short_attention(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.short_launches == 1
    assert out.stride() == (sq * h * d, d, h * d, 1)
    _assert_matches(out, fa.short_attention_reference(q, k, v, d ** -0.5), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('op', ['headmean_probs', 'short_attention'])
def test_headmean_and_short_raise_on_strides_tma_cannot_take(cuda, op):
    q = torch.randn(1, 2, 64, 64, device=cuda).to(torch.bfloat16)
    # 76 bf16 = 152 bytes between rows: TMA takes multiples of 16 only
    odd = torch.randn(1, 2, 64, 76, device=cuda).to(torch.bfloat16)[..., :40]
    if op == 'headmean_probs':
        lse = torch.zeros(1, 2, 64, device=cuda)
        call = lambda x, y: fa.headmean_probs(x, y, lse, scale=1.0)      # noqa: E731
    else:
        call = lambda x, y: fa.short_attention(x, y, y, scale=1.0)       # noqa: E731
    fa.headmean_launches = fa.short_launches = 0
    with pytest.raises(ValueError, match='contiguous along D'):
        call(q, q.transpose(2, 3))
    with pytest.raises(ValueError, match='16 bytes'):
        call(odd, odd)
    assert (fa.headmean_launches, fa.short_launches) == (0, 0)


@pytest.mark.cuda
def test_store_path_hands_b2_and_b3_the_views_without_copies(cuda, monkeypatch):
    """attention_with_headmean_heads on the card: B2 and B3 get the same
    head-split views the caller passed (same data pointers and strides, so
    no copy kernel runs between them), and the results equal the explicit
    path's."""
    b, h, s, d = 2, 8, 1024, 80
    gen = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (_split(cuda, torch.bfloat16, b, h, s, d, gen) for _ in range(3))
    seen = []

    def recorder(name, real):
        def call(*args, **kwargs):
            seen.append((name, [(x.data_ptr(), x.stride()) for x in args[:2]]))
            return real(*args, **kwargs)
        return call

    for name in ('flash_attention_with_lse', 'headmean_probs'):
        monkeypatch.setattr(attn, name, recorder(name, getattr(attn, name)))
    fa.lse_launches = fa.headmean_launches = 0
    out, mean_p = attn.attention_with_headmean_heads(q, k, v)
    torch.cuda.synchronize()
    assert (fa.lse_launches, fa.headmean_launches) == (1, 1)
    want = [(q.data_ptr(), q.stride()), (k.data_ptr(), k.stride())]
    assert seen == [('flash_attention_with_lse', want), ('headmean_probs', want)]
    assert not q.is_contiguous()
    r_out, probs = attn.attention_with_probs_heads(q, k, v)
    torch.testing.assert_close(out.float(), r_out.float(), atol=2e-2, rtol=2e-2)
    _assert_map_matches(mean_p, probs.float().mean(1), torch.bfloat16, s)


@pytest.mark.cuda
def test_checkpoint_loads_on_card_as_on_cpu(cuda, tmp_path):
    """A test-xl tree (bf16 variant, sharded U-Net, two text encoders)
    loads on the card to the parameters it loads to on the CPU."""
    layer = {'unet-out': True}
    src = FeatureExtractor(layer, 'test-xl', device='cpu', img_size=64, seed=3)
    src.save_weights(str(tmp_path), variant='bf16', unet_shards=2)
    kw = dict(img_size=64, weights=str(tmp_path), weights_variant='bf16')
    on_cpu = FeatureExtractor(layer, 'test-xl', device='cpu', **kw)
    on_card = FeatureExtractor(layer, 'test-xl', device=cuda, **kw)
    for a, b in ((on_cpu.unet, on_card.unet), (on_cpu.vae, on_card.vae),
                 *zip(on_cpu.text_encoders, on_card.text_encoders)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for key in sa:
            assert sb[key].is_cuda and sb[key].dtype == torch.bfloat16
            assert torch.equal(sa[key], sb[key].cpu()), key


@pytest.mark.cuda
def test_bundles_load_on_card_as_on_cpu(cuda, tmp_path):
    """A tiny test-flux tree (the port's random init written by
    ``save_weights``, its VAE's last level 64 wide, so that the encoder's
    mid-block attention over 32^2 latents takes B1) loaded at bf16 with
    the int8 auto rule on the CPU, then written as the port's deployment
    bundle and, with numpy, in the JAX package's layout
    (tests/jax_layout.py: the transposes inverted, bf16 stored as uint16):
    each bundle loads on the card torch.equal to its load on the CPU and to
    the tree's, and an extract from it launches B1 once and W8A16 once per
    int8 projection the transformer calls."""
    import dataclasses
    from PIL import Image
    from jax_layout import write_jax_bundle
    from diffusion_feature_tpu_torch.models.convert import random_module, save_component
    from diffusion_feature_tpu_torch.models.vae import AutoencoderKL
    from diffusion_feature_tpu_torch.ops import quant
    layer = {'vit-block0-out': True, 'vit-block3-out': True}
    tree = str(tmp_path / 'tree')
    FeatureExtractor(layer, 'test-flux', device='cpu', dtype='float32', img_size=64,
                     seed=4).save_weights(tree)
    vae_cfg = dataclasses.replace(FeatureExtractor(layer, 'test-flux', device='cpu', img_size=64,
                                                   weights=tree).spec.vae,
                                  block_out_channels=(32, 64))
    vae = random_module(lambda: AutoencoderKL(vae_cfg), 'cpu', torch.float32,
                        torch.Generator().manual_seed(5))
    save_component(tree, 'vae', vae.state_dict(), vae_cfg.to_diffusers_config())
    source = FeatureExtractor(layer, 'test-flux', device='cpu', img_size=64, weights=tree)
    assert source._int8_denoiser and source.spec.t5.quantize_int8 and source.vae_scale == 2
    bundles = {'port': source.save_converted(str(tmp_path / 'port')),
               'jax': write_jax_bundle(source, str(tmp_path / 'jax'), tree)}
    rs = np.random.RandomState(6)
    images = [Image.fromarray((rs.rand(64, 64, 3) * 255).astype(np.uint8)) for _ in range(2)]

    def modules(fe):
        return (fe.unet, fe.vae, *fe.text_encoders)
    for kind, root in bundles.items():
        on_cpu = FeatureExtractor(layer, 'test-flux', device='cpu', img_size=64, weights=root)
        on_card = FeatureExtractor(layer, 'test-flux', device=cuda, img_size=64, weights=root)
        for a, b, c in zip(modules(source), modules(on_cpu), modules(on_card), strict=True):
            sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
            assert sa.keys() == sb.keys() == sc.keys()
            for key in sa:
                assert sc[key].is_cuda and sc[key].dtype == sa[key].dtype, (kind, key)
                assert torch.equal(sa[key], sb[key]) and torch.equal(sb[key], sc[key].cpu()), key
        prompts = on_card.encode_prompt('a photo of a cat')
        calls = []
        hooks = [m.register_forward_hook(lambda *_: calls.append(1))
                 for m in on_card.unet.modules() if isinstance(m, quant.Int8Linear)]
        fa.launches = quant.int8_launches = 0
        feats = on_card.extract(prompts, 2, images, t=500)
        torch.cuda.synchronize()
        for hook in hooks:
            hook.remove()
        assert fa.launches == 1 and quant.int8_launches == len(calls) > 0, kind
        assert sorted(feats) == sorted(layer)
        assert all(torch.isfinite(v.float()).all() for v in feats.values())


@pytest.mark.cuda
def test_bf16_file_lands_in_bf16_without_fp32_copy(cuda, tmp_path):
    """A 64 MiB BF16 tensor fills a meta-built Linear on the card with at
    most its own bytes (+5%) allocated: no fp32 staging copy."""
    weight = torch.randn(4096, 8192, generator=torch.Generator().manual_seed(0)).bfloat16()
    save_file({'weight': weight}, str(tmp_path / 'w.safetensors'))
    with torch.device('meta'):
        linear = torch.nn.Linear(8192, 4096, bias=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    assert load_state_into(linear, load_file(str(tmp_path / 'w.safetensors')), torch.bfloat16,
                           cuda) == []
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert linear.weight.is_cuda and linear.weight.dtype == torch.bfloat16
    assert torch.equal(linear.weight.cpu(), weight)
    assert peak <= 1.05 * weight.numel() * 2, peak


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['contiguous', 'head-split'])
def test_fp32_store_kernels_at_sd21_store_shape(cuda, layout):
    """SD-2.1's upcast store at 512^2 hands B2 and B3 fp32 q, k and v of
    (2, 10, 1024, 1024, 64): the fp32 kernels against their twins there."""
    b, h, s, d = 2, 10, 1024, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (_layout(cuda, torch.float32, layout, b, h, s, d, gen) for _ in range(3))
    fa.lse_launches = fa.headmean_launches = 0
    out, lse = fa.flash_attention_with_lse(q, k, v, scale=d ** -0.5)
    mean_p = fa.headmean_probs(q, k, lse, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.lse_launches, fa.headmean_launches) == (1, 1)
    assert out.dtype == mean_p.dtype == torch.float32
    r_out, r_lse = fa.flash_attention_with_lse_reference(q, k, v, d ** -0.5)
    _assert_matches(out, r_out, torch.float32)
    torch.testing.assert_close(lse, r_lse, atol=1e-4, rtol=1e-5)
    _assert_map_matches(mean_p, fa.headmean_probs_reference(q, k, lse, d ** -0.5),
                        torch.float32, s)


@pytest.mark.cuda
def test_upcast_store_attention_runs_fp32_kernels(cuda, monkeypatch):
    """A bf16 U-Net attention with upcast and the store: B2 and B3 get fp32
    q, k and v (one launch each), the output and map come back in bf16 and
    agree with the explicit path."""
    from diffusion_feature_tpu_torch.models.layers import ATTN_STORE, Attention, AttnStoreCfg
    torch.manual_seed(12)
    layer = Attention(640, 10, 64, attn_store=AttnStoreCfg('up', 32, 32, frozenset({'up_self'})),
                      upcast=True).to(cuda, torch.bfloat16)
    x = torch.randn(2, 1024, 640, device=cuda).bfloat16()
    seen = []
    for name in ('flash_attention_with_lse', 'headmean_probs'):
        real = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda q, *a, _n=name, _r=real, **kw: (
            seen.append((_n, q.dtype)) or _r(q, *a, **kw)))
    feats = {}
    fa.lse_launches = fa.headmean_launches = 0
    with torch.inference_mode():
        out = layer(x, feats=feats)
        torch.cuda.synchronize()
        assert (fa.lse_launches, fa.headmean_launches) == (1, 1)
        assert seen == [('flash_attention_with_lse', torch.float32),
                        ('headmean_probs', torch.float32)]
        [mean_p] = feats[ATTN_STORE]['up_self']
        assert out.dtype == mean_p.dtype == torch.bfloat16
        q, k, v = (attn.split_heads(p(x), 10).float()
                   for p in (layer.to_q, layer.to_k, layer.to_v))
        r_out, probs = attn.attention_with_probs_heads(q, k, v)
        _assert_matches(out, layer.to_out[0](attn.merge_heads(r_out).bfloat16()), torch.bfloat16)
        _assert_map_matches(mean_p, probs.mean(1), torch.bfloat16, 1024)


@pytest.mark.cuda
def test_vae_decoder_mid_attention_routes_to_b1(cuda, monkeypatch):
    """The decoder's mid block at a 128^2 latent (SDXL's at 1024^2): one
    head of d=512 over 16384 tokens, one B1 launch per decode, the decode
    within the bf16 tolerance of the same decode on B1's twin."""
    from diffusion_feature_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    torch.manual_seed(13)
    vae = AutoencoderKL(VAEConfig(block_out_channels=(32, 512), layers_per_block=1))
    vae = vae.to(cuda, torch.bfloat16).eval()
    z = torch.randn(1, 4, 128, 128, device=cuda)
    with torch.inference_mode():
        fa.launches = 0
        img = vae.decode(z)
        torch.cuda.synchronize()
        assert fa.launches == 1 and img.shape == (1, 3, 256, 256)
        monkeypatch.setattr(attn, 'flash_attention',
                            lambda q, k, v, scale: fa.flash_attention_reference(q, k, v, scale))
        ref = vae.decode(z)
    rel = ((img.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= _TOL[torch.bfloat16], rel


@contextlib.contextmanager
def _on_twins():
    """Every kernel call of the attention ops on its plain twin."""
    twins = {'flash_attention': fa.flash_attention_reference,
             'flash_attention_with_lse': fa.flash_attention_with_lse_reference,
             'headmean_probs': fa.headmean_probs_reference}
    real = {name: getattr(attn, name) for name in twins}
    for name, twin in twins.items():
        setattr(attn, name, lambda *args, scale, _twin=twin: _twin(*args, scale))
    try:
        yield
    finally:
        for name, wrapper in real.items():
            setattr(attn, name, wrapper)


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
def test_sample_on_card_matches_twins(cuda):
    """A 2-step SD-1.5 sample at 256² (3 PNDM calls, CFG batch 2): each
    U-Net call launches B1 at the 1024-token level-0 self-attentions (2
    down, 3 up; the VAE's d=512 head at 1024 tokens stays explicit), and the
    images and every tap encounter agree with the same sample on the
    twins (5e-2 relative L2: three forwards, as the multi-step tolerance)."""
    layer = {'up-level3-repeat0-vit-block0-self-q': True, 'mid-vit-block0-out': True}
    fe = FeatureExtractor(layer, '1-5', device=cuda, img_size=256, seed=0)
    pe, ne, _, _ = fe.encode_prompt('a photo of a cat')
    noise = torch.randn((1, 4, 32, 32), generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    fa.launches = 0
    images, feats, _ = fe._sample(*fe._sample_conditioning((pe, ne, None, None), 1, 7.5),
                                  noise, 2, 7.5)
    torch.cuda.synchronize()
    assert fa.launches == 3 * 5
    with _on_twins():
        ref_images, ref, _ = fe._sample(*fe._sample_conditioning((pe, ne, None, None), 1, 7.5),
                                        noise, 2, 7.5)
    assert images.shape == (1, 3, 256, 256) and torch.isfinite(images.float()).all()
    assert _rel_l2(images, ref_images) <= 5e-2
    for key, encounters in ref.items():
        assert len(feats[key]) == len(encounters) == 3
        for a, b in zip(feats[key], encounters):
            assert a.shape[0] == 2 and _rel_l2(a, b) <= 5e-2, key


@pytest.mark.cuda
def test_control_extract_on_card_matches_twins(cuda):
    """control=['canny'] on SD-1.5 at 256², zero convs drawn non-zero: the
    U-Net's 5 B1 launches and the ControlNet's 2 (its level-0 copy), and
    the features within 2e-2 relative L2 of the same step on the twins."""
    from PIL import Image
    layer = {'up-level3-repeat0-vit-block0-self-q': True, 'unet-out': True}
    fe = FeatureExtractor(layer, '1-5', device=cuda, img_size=256, seed=0, control=['canny'])
    gen = torch.Generator(device=cuda).manual_seed(2)
    with torch.no_grad():
        for conv in fe.control_pipe.nets[0].model.zero_convs():
            conv.weight.normal_(0.0, 0.02, generator=gen)
    arr = np.kron(np.random.RandomState(3).randint(0, 256, (8, 8, 3)), np.ones((32, 32, 1)))
    images = [Image.fromarray(arr.astype(np.uint8))]
    img = torch.from_numpy(fe.preprocess_image(images[0])).to(cuda, fe.dtype)
    control = fe.control_pipe.prepare_control_images(images, 1)
    pe = fe.encode_prompt('a photo of a cat')[0]
    posterior, noise = (torch.randn((1, 4, 32, 32), generator=gen, device=cuda) for _ in range(2))

    def step():
        return fe._step(img, fe._step_conditioning((pe, None, None, None), 1),
                        fe._img2img_kit(50), posterior, noise, torch.bfloat16, control)
    fa.launches = 0
    feats = step()
    torch.cuda.synchronize()
    assert fa.launches == 5 + 2
    with _on_twins():
        ref = step()
    plain = fe._step(img, fe._step_conditioning((pe, None, None, None), 1), fe._img2img_kit(50),
                     posterior, noise, torch.bfloat16)
    for key in layer:
        assert torch.isfinite(feats[key].float()).all()
        assert _rel_l2(feats[key], ref[key]) <= 2e-2, key
    assert _rel_l2(plain['unet-out'], feats['unet-out']) > 2e-2


@pytest.mark.cuda
def test_pixart_step_routes_self_attention_to_b1(cuda):
    """PixArt-alpha's DiT at full width (28 blocks of 16 heads x 72) on a
    512^2 image's 64^2 latent, batch 2: one forward launches B1 once per
    block (1024 tokens; cross-attention carries the T5 mask and stays
    explicit), and its prediction is within the bf16 tolerance, in relative
    L2, of the same forward on B1's twin."""
    from diffusion_feature_tpu_torch.models.convert import random_module
    from diffusion_feature_tpu_torch.models.dit_pixart import (PIXART_ALPHA_512,
                                                                 PixArtTransformer2D)
    gen = torch.Generator(device=cuda).manual_seed(14)
    dit = random_module(lambda: PixArtTransformer2D(PIXART_ALPHA_512), cuda, torch.bfloat16, gen)
    x = torch.randn(2, 4, 64, 64, generator=gen, device=cuda)
    ctx = torch.randn(2, 120, 4096, generator=gen, device=cuda).bfloat16()
    mask = torch.zeros(2, 120, dtype=torch.int32, device=cuda)
    mask[:, :10] = 1
    with torch.inference_mode():
        fa.launches = fa.lse_launches = fa.headmean_launches = 0
        out = dit(x, 500.0, ctx, mask)
        torch.cuda.synchronize()
        assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (28, 0, 0)
        with _on_twins():
            ref = dit(x, 500.0, ctx, mask)
    assert out.shape == (2, 8, 64, 64) and torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) <= _TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize('taps,launches', [({}, 2), ({'vit-block0-self-map': True}, 1)],
                         ids=['fused', 'self-map'])
def test_hunyuan_step_routes_self_attention_to_b1(cuda, taps, launches):
    """HunyuanDiT's DiT at full width (16 heads x 88, the BERT and T5
    widths) cut to 2 blocks, on a 512^2 image's 64^2 latent, batch 2: each
    block's self-attention over 1024 tokens launches B1 (a '-map' tap keeps
    its block explicit, as in JAX), cross-attention (333 keys) and the T5
    pool stay explicit, and the prediction is within the bf16 tolerance,
    in relative L2, of the same forward on B1's twin."""
    import dataclasses
    from diffusion_feature_tpu_torch.models.convert import random_module
    from diffusion_feature_tpu_torch.models.hunyuan import HUNYUAN_DIT, HunyuanDiT2D
    from diffusion_feature_tpu_torch.taps import TapSpec
    cfg = dataclasses.replace(HUNYUAN_DIT, num_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(15)
    dit = random_module(lambda: HunyuanDiT2D(cfg, TapSpec.from_config(taps) if taps
                                             else TapSpec()), cuda, torch.bfloat16, gen)
    x = torch.randn(2, 4, 64, 64, generator=gen, device=cuda)
    bert = torch.randn(2, 77, 1024, generator=gen, device=cuda).bfloat16()
    t5 = torch.randn(2, 256, 2048, generator=gen, device=cuda).bfloat16()
    bmask = torch.zeros(2, 77, dtype=torch.int32, device=cuda)
    tmask = torch.zeros(2, 256, dtype=torch.int32, device=cuda)
    bmask[:, :9], tmask[:, :12] = 1, 1
    with torch.inference_mode():
        fa.launches = fa.lse_launches = fa.headmean_launches = fa.short_launches = 0
        feats = {}
        out = dit(x, 500.0, bert, bmask, t5, tmask, feats=feats)
        torch.cuda.synchronize()
        assert (fa.launches, fa.lse_launches, fa.headmean_launches,
                fa.short_launches) == (launches, 0, 0, 0)
        assert sorted(feats) == sorted(taps)
        with _on_twins():
            ref = dit(x, 500.0, bert, bmask, t5, tmask)
    assert out.shape == (2, 8, 64, 64) and torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) <= _TOL[torch.bfloat16]


_FLUX_B1 = [(2, 24, 4608, 4608, 128), (1, 24, 4608, 4608, 128), (2, 24, 1536, 1536, 128),
            (1, 24, 1536, 1536, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', _FLUX_B1, ids=['1024-b2', '1024-b1', '512-b2', '512-b1'])
def test_kernel_matches_twin_at_flux_shapes(cuda, shape):
    """B1 at Flux's joint attention in bf16: 512 T5 + 4096 image tokens at
    1024^2 (18 x 256, 36 query and 72 key tiles) and 512 + 1024 at 512^2,
    24 heads x 128, on the contiguous q/k/v that the concatenation and
    RoPE leave; elementwise and in relative L2."""
    d = shape[-1]
    q, k, v = _qkv(cuda, torch.bfloat16, *shape, seed=16)
    fa.launches = 0
    out = fa.flash_attention(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches == 1
    _assert_matches(out, fa.flash_attention_reference(q, k, v, d ** -0.5), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('taps,launches', [({}, 2), ({'vit-block1-self-map': True}, 1)],
                         ids=['fused', 'self-map'])
def test_flux_step_routes_joint_attention_to_b1(cuda, taps, launches):
    """Flux.1-dev's transformer at full width (24 heads x 128, the T5 and
    CLIP widths) cut to one dual and one single block, on a 512^2 image's
    packed 32^2 grid, batch 2: each block's joint attention over 512 + 1024
    tokens launches B1 (a '-map' tap keeps its block explicit, as in JAX),
    and the prediction is within the bf16 tolerance, in relative L2, of the
    same forward on B1's twin."""
    import dataclasses
    from diffusion_feature_tpu_torch.models.convert import random_module
    from diffusion_feature_tpu_torch.models.flux import FLUX_DEV, FluxTransformer2D
    from diffusion_feature_tpu_torch.taps import TapSpec
    cfg = dataclasses.replace(FLUX_DEV, num_layers=1, num_single_layers=1)
    gen = torch.Generator(device=cuda).manual_seed(17)
    dit = random_module(lambda: FluxTransformer2D(cfg, TapSpec.from_config(taps) if taps
                                                  else TapSpec()), cuda, torch.bfloat16, gen)
    x = torch.randn(2, 1024, 64, generator=gen, device=cuda)
    t5 = torch.randn(2, 512, 4096, generator=gen, device=cuda).bfloat16()
    pooled = torch.randn(2, 768, generator=gen, device=cuda).bfloat16()
    with torch.inference_mode():
        fa.launches = fa.lse_launches = fa.headmean_launches = fa.short_launches = 0
        feats = {}
        out = dit(x, 500.0, t5, pooled, 3500.0, (32, 32), feats=feats)
        torch.cuda.synchronize()
        assert (fa.launches, fa.lse_launches, fa.headmean_launches,
                fa.short_launches) == (launches, 0, 0, 0)
        assert sorted(feats) == sorted(taps)
        with _on_twins():
            ref = dit(x, 500.0, t5, pooled, 3500.0, (32, 32))
    assert out.shape == (2, 1024, 64) and torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) <= _TOL[torch.bfloat16]



# ------------------------------------------------------------ W8A16 (int8 dense)
def _w8a16_inputs(cuda, dtype, m, k, n, bias=True, seed=0):
    """x (m, k) in ``dtype``, a (n, k) weight of N(0, 1/k) quantized on the
    card, and a bias in ``dtype`` (or None)."""
    from diffusion_feature_tpu_torch.ops import quant
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    q, scale = quant.quantize_int8(torch.randn(n, k, generator=g, device=cuda) * k ** -0.5)
    b = torch.randn(n, generator=g, device=cuda).to(dtype) if bias else None
    return x, q, scale, b


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_TOL), ids=str)
@pytest.mark.parametrize('mkn,bias,route', [
    ((37, 1000, 333), True, 'staged'),     # ragged M, K (not a multiple of 16), N (odd)
    ((2, 3072, 1000), True, 'streaming'),  # the adaLN projections' two rows
    ((300, 256, 128), False, 'tma128'),    # whole tiles in N and K, no bias (T5's)
    ((5, 100, 50), True, 'staged'),        # K not a multiple of 8: x staged by element
    ((1, 3072, 1000), True, 'streaming'),  # one row
    ((16, 512, 1000), True, 'streaming'),  # the streaming kernel's last M (two n8 tiles)
    ((17, 512, 1000), True, 'tma128'),     # the first M of the TMA kernel
    ((4, 400, 256), True, 'streaming'),    # K not a multiple of 64: a ragged last chunk
    ((1279, 256, 3072), True, 'tma256'),   # 256-row tiles up to one wave of 132 SMs ...
    ((1280, 256, 3072), True, 'tma256'),
    ((1281, 256, 3072), True, 'tma128'),   # ... then 128-row ones
    ((600, 512, 1000), True, 'tma128'),    # N not a multiple of 128 (or 256)
    ((40, 256, 333), True, 'tma128'),      # odd N: a column tile of a cluster past N
    ((200, 15360, 384), True, 'tma128'),   # Flux's longest K
], ids=['ragged', 'm2', 'nobias', 'k100', 'm1', 'm16', 'm17', 'k400', 'm1279', 'm1280',
        'm1281', 'n1000', 'n333', 'k15360'])
def test_w8a16_matches_twin(cuda, dtype, mkn, bias, route):
    """The W8A16 kernels against their twin (the dequantize rounded as the
    kernels round it; only the order of the fp32 sums differs), elementwise
    and in relative L2, with one launch counted, at the edges of each
    kernel; ``route``: the kernel ``quant.int8_route`` gives the shape in
    bf16 and fp16 on a card of 132 SMs (fp32 takes the cp.async kernel)."""
    from diffusion_feature_tpu_torch.ops import quant
    x, q, scale, b = _w8a16_inputs(cuda, dtype, *mkn, bias=bias)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        m, k, n = mkn
        chosen = quant.ROUTES[quant.int8_route(m, n, k, dtype, True, 132)]
        assert chosen == ('staged' if dtype == torch.float32 else route)
    quant.int8_launches = 0
    out = quant.int8_linear(x, q, scale, b)
    torch.cuda.synchronize()
    assert quant.int8_launches == 1 and out.dtype == dtype and out.shape == (mkn[0], mkn[2])
    _assert_matches(out, quant.int8_linear_reference(x, q, scale, b), dtype)


@pytest.mark.cuda
def test_w8a16_takes_batched_and_strided_x_and_refuses_bad_inputs(cuda):
    """A (B, S, K) x and a strided slice of one (copied first) give the
    twin's result in (B, S, N); a weight that is not int8, a scale that is
    not fp32 and a bias of another dtype raise ValueError."""
    from diffusion_feature_tpu_torch.ops import quant
    x, q, scale, b = _w8a16_inputs(cuda, torch.bfloat16, 2 * 96, 512, 384, seed=1)
    x3 = x.reshape(2, 96, 512)[:, 16:]
    out = quant.int8_linear(x3, q, scale, b)
    assert out.shape == (2, 80, 384) and out.is_contiguous()
    _assert_matches(out, quant.int8_linear_reference(x3, q, scale, b), torch.bfloat16)
    for args, match in (((x, q.float(), scale, b), 'int8'), ((x, q, scale.half(), b), 'float32'),
                        ((x, q, scale, b.float()), 'bias')):
        with pytest.raises(ValueError, match=match):
            quant.int8_linear(*args)


@pytest.mark.cuda
def test_quantize_on_card_equals_host_and_int8_linear_trains_its_input(cuda):
    """``quantize_int8`` on the card equals the host's bit for bit (as the
    loader quantizes checkpoint tensors there); ``Int8Linear``'s input
    gradient on the card equals the twin's product on the same cotangent."""
    from diffusion_feature_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(2)
    w = torch.randn(1536, 1000, generator=g) * torch.rand(1536, 1, generator=g)
    w[7] = 0
    q_host, s_host = quant.quantize_int8(w)
    q_card, s_card = quant.quantize_int8(w.to(cuda).bfloat16().float())
    q_ref, s_ref = quant.quantize_int8(w.bfloat16().float())
    assert torch.equal(q_card.cpu(), q_ref) and torch.equal(s_card.cpu(), s_ref)
    assert q_host.dtype == torch.int8 and torch.equal(s_host[7], torch.tensor(1.0))
    layer = quant.Int8Linear(1000, 1536).to(cuda)
    layer.weight_q.copy_(q_card)
    layer.scale.copy_(s_card)
    x = torch.randn(64, 1000, device=cuda, requires_grad=True)
    cot = torch.randn(64, 1536, device=cuda)
    (layer(x) * cot).sum().backward()
    _assert_matches(x.grad, cot @ quant.dequantize_int8(q_card, s_card), torch.float32)


@pytest.mark.cuda
def test_int8_flux_step_routes_projections_to_w8a16(cuda):
    """Flux.1-dev at full width cut to one dual and one single block, loaded
    int8 from a bf16 state on the card (each weight quantized there): 21
    W8A16 launches per forward (14 in the dual block, 6 in the single, the
    context embedder), the scales fp32, and the prediction within the bf16
    tolerance of the same forward on the W8A16 twin."""
    import dataclasses
    from diffusion_feature_tpu_torch.models.convert import random_module
    from diffusion_feature_tpu_torch.models.flux import FLUX_DEV, FluxTransformer2D
    from diffusion_feature_tpu_torch.ops import quant
    cfg = dataclasses.replace(FLUX_DEV, num_layers=1, num_single_layers=1)
    gen = torch.Generator(device=cuda).manual_seed(18)
    state = random_module(lambda: FluxTransformer2D(cfg), cuda, torch.bfloat16, gen).state_dict()
    with torch.device('meta'):
        dit = FluxTransformer2D(dataclasses.replace(cfg, quantize_int8=True))
    load_state_into(dit, state, torch.bfloat16, cuda)
    to_q = dit.transformer_blocks[0].attn.to_q
    assert (to_q.weight_q.dtype, to_q.scale.dtype, to_q.bias.dtype) == (
        torch.int8, torch.float32, torch.bfloat16)
    q, s = quant.quantize_int8(state['transformer_blocks.0.attn.to_q.weight'])
    assert torch.equal(q, to_q.weight_q) and torch.equal(s, to_q.scale)
    x = torch.randn(2, 1024, 64, generator=gen, device=cuda)
    t5 = torch.randn(2, 512, 4096, generator=gen, device=cuda).bfloat16()
    pooled = torch.randn(2, 768, generator=gen, device=cuda).bfloat16()
    with torch.inference_mode():
        quant.int8_launches = 0
        out = dit(x, 500.0, t5, pooled, 3500.0, (32, 32))
        torch.cuda.synchronize()
        assert quant.int8_launches == 21
        real = quant.int8_linear
        quant.int8_linear = quant.int8_linear_reference
        try:
            ref = dit(x, 500.0, t5, pooled, 3500.0, (32, 32))
        finally:
            quant.int8_linear = real
    assert out.shape == (2, 1024, 64) and torch.isfinite(out.float()).all()
    assert _rel_l2(out, ref) <= _TOL[torch.bfloat16]

# ------------------------------------------------------------ the backward
_BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


def _bwd_inputs(cuda, dtype, b, h, sq, sk, d, split, seed=0):
    """q, k, v and an output gradient: (B, H, S, D) tensors, or with
    ``split`` the head-split views of (B, S, H*D) projections."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if split:
        return tuple(torch.randn(b, s, h * d, generator=g, device=cuda).to(dtype)
                     .reshape(b, s, h, d).transpose(1, 2) for s in (sq, sk, sk, sq))
    return tuple(torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
                 for s in (sq, sk, sk, sq))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_BWD_TOL), ids=str)
@pytest.mark.parametrize('split', [False, True], ids=['contiguous', 'head-split'])
@pytest.mark.parametrize('d', fa.BWD_HEAD_DIMS, ids=[f'd{d}' for d in fa.BWD_HEAD_DIMS])
def test_backward_kernel_matches_twin(cuda, dtype, split, d):
    """dq, dk and dv of the backward kernel against the twin (JAX's VJP),
    ragged lengths, at every built width and type: relative L2 and the
    elementwise rule scaled by each gradient's largest entry."""
    q, k, v, grad = _bwd_inputs(cuda, dtype, 1, 2, 1000, 333, d, split)
    scale = d ** -0.5
    out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
    fa.bwd_launches = 0
    got = fa.flash_attention_bwd(q, k, v, out, lse, grad, scale=scale)
    torch.cuda.synchronize()
    assert fa.bwd_launches == 1
    ref = fa.flash_attention_bwd_reference(q, k, v, grad, scale)
    tol = _BWD_TOL[dtype]
    for name, a, r in zip(('dq', 'dk', 'dv'), got, ref):
        assert a.shape == r.shape and a.dtype == dtype, name
        a, r = a.float(), r.float()
        rel = ((a - r).norm() / r.norm()).item()
        worst = ((a - r).abs().max() / r.abs().max()).item()
        assert rel <= tol and worst <= 5 * tol, f'{name}: rel_l2 {rel:.3e}, worst {worst:.3e}'


@pytest.mark.cuda
def test_backward_raises_at_unbuilt_widths(cuda):
    """d=512 (the VAE's head) and any width outside BWD_HEAD_DIMS raise
    ValueError, in the backward and in the differentiable forward; no twin
    runs in their place."""
    for d in (512, 96):
        q = torch.randn(1, 1, 256, d, device=cuda)
        lse = torch.zeros(1, 1, 256, device=cuda)
        with pytest.raises(ValueError, match='head dim'):
            fa.flash_attention_bwd(q, q, q, q, lse, q, scale=0.1)
        with pytest.raises(ValueError, match='head dim'):
            fa.flash_attention_diff(q.requires_grad_(), q, q, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=str)
def test_grad_paths_carry_graphs_on_card(cuda, dtype):
    """With an input that requires grad, the gate-passing attention runs
    B2 and the backward kernel, and its gradients match the explicit
    path's; the store's B2 + B3 pair has a backward too.  B1 and B2
    outputs made without grad carry no graph."""
    b, s, heads, d = 1, 1024, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, w = (torch.randn(b, s, heads * d, generator=gen, device=cuda).to(dtype)
                  for _ in range(4))
    fa.launches = fa.lse_launches = fa.bwd_launches = fa.headmean_launches = 0
    assert attn.attention_fused(q, k, v, heads).grad_fn is None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attn.attention_fused(*leaves, heads)
    assert out.grad_fn is not None and (fa.launches, fa.lse_launches) == (1, 1)
    (out.float() * w.float()).sum().backward()
    assert fa.bwd_launches == 1
    twin = [x.clone().requires_grad_() for x in (q, k, v)]
    ref, _ = attn.attention_with_probs(*twin, heads)
    (ref.float() * w.float()).sum().backward()
    for a, r in zip(leaves, twin):
        assert a.grad.abs().max() > 0
        _assert_matches(a.grad, r.grad, dtype)
    heads_in = [attn.split_heads(x.clone().requires_grad_(), heads) for x in (q, k, v)]
    out, mean_p = attn.attention_with_headmean_heads(*heads_in)
    assert out.grad_fn is not None and mean_p.grad_fn is not None
    assert fa.headmean_launches == 1
    (out.float().sum() + mean_p.float().sum() * 10).backward()


def _assert_bwd_matches(got, ref, dtype):
    """dq, dk, dv against the twin's: relative L2 within the tolerance and
    the worst element within five times it of each gradient's largest."""
    tol = _BWD_TOL[dtype]
    for name, a, r in zip(('dq', 'dk', 'dv'), got, ref):
        assert a.shape == r.shape and a.dtype == dtype, name
        a, r = a.float(), r.float()
        rel = ((a - r).norm() / r.norm()).item()
        worst = ((a - r).abs().max() / r.abs().max()).item()
        assert rel <= tol and worst <= 5 * tol, f'{name}: rel_l2 {rel:.3e}, worst {worst:.3e}'


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_BWD_TOL), ids=str)
@pytest.mark.parametrize('sq,sk', [(1025, 1023), (193, 383), (127, 65)],
                         ids=['1025x1023', '193x383', '127x65'])
@pytest.mark.parametrize('d', [64, 80], ids=['d64', 'd80'])
def test_backward_unequal_lengths_match_twin(cuda, dtype, sq, sk, d):
    """Sq != Sk at 64 n +- 1 in every type: the ragged edges of the key
    blocks, of the query tiles and of the dq accumulator's rows (d=64 and
    d=80: both bf16/fp16 dq layouts, both fp32 thread layouts)."""
    q, k, v, grad = _bwd_inputs(cuda, dtype, 1, 2, sq, sk, d, True, seed=1)
    scale = d ** -0.5
    out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
    got = fa.flash_attention_bwd(q, k, v, out, lse, grad, scale=scale)
    torch.cuda.synchronize()
    _assert_bwd_matches(got, fa.flash_attention_bwd_reference(q, k, v, grad, scale), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', list(_BWD_TOL), ids=str)
def test_backward_calls_agree(cuda, dtype):
    """Two calls on the same inputs: dk and dv bitwise (each is one block's
    registers), dq within the type's tolerance (the key blocks add into it
    in no fixed order)."""
    q, k, v, grad = _bwd_inputs(cuda, dtype, 2, 3, 1000, 1000, 64, True, seed=2)
    scale = 0.125
    out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
    first = fa.flash_attention_bwd(q, k, v, out, lse, grad, scale=scale)
    second = fa.flash_attention_bwd(q, k, v, out, lse, grad, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    _assert_matches(second[0], first[0], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,with_lse', [
    ((1, 1, 1000, 777, 512), False), ((2, 1, 1025, 1023, 512), False),
    ((1, 2, 1025, 1023, 40), True), ((1, 2, 193, 383, 64), True), ((2, 3, 1023, 65, 80), True),
    ((1, 2, 1025, 129, 128), True), ((1, 2, 127, 1025, 160), True)],
    ids=['d512', 'd512-b2', 'd40', 'd64', 'd80', 'd128', 'd160'])
def test_fp32_forward_matches_twin(cuda, shape, with_lse):
    """fp32 B1 (d=512: four 128-column slices) and B2 at ragged lengths
    against their twins, and B2's logsumexp."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda, torch.float32, b, h, sq, sk, d, seed=4)
    scale = d ** -0.5
    if with_lse:
        out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
        ref, ref_lse = fa.flash_attention_with_lse_reference(q, k, v, scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    else:
        out = fa.flash_attention(q, k, v, scale=scale)
        ref = fa.flash_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
    _assert_matches(out, ref, torch.float32)


@pytest.mark.cuda
def test_pixel_member_trains_alike_from_a_host_matrix(cuda):
    """``train_one`` on a training matrix left in host memory (one too large
    for the card) copies each batch over and trains the member it trains
    from the same matrix on the card."""
    from diffusion_feature_tpu_torch.tasks.scarce.pixel_classifier import train_one
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1000, 48).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 21, 1000))
    kw = dict(num_classes=21, seed=5, batch_size=64, max_epochs=2, device=cuda)
    on_host = train_one(x, y, **kw).state_dict()
    on_card = train_one(x.to(cuda), y.to(cuda), **kw).state_dict()
    torch.testing.assert_close(on_host, on_card, rtol=0, atol=0)


# The DiT widths' kernels: B1/B2's persistent ping-pong kernel in clusters of
# two query tiles sharing K and V (d=72, 88, 128; 192 keys a tile at d=128)
# and B3's 2 x 2 cluster kernel (d=72, 88).  Ragged key counts (not a
# multiple of 64, 128 or 192; one key), ragged query counts (a cluster's
# second tile past Sq), a single tile, and query-tile counts just below and
# above one and two rounds of a 132-SM card.
_PINGPONG_CASES = [(2, 3, 257, 4600, 128), (1, 4, 300, 130, 128), (1, 2, 200, 1, 128),
                   (1, 1, 100, 100, 128), (1, 131, 128, 300, 128), (1, 133, 128, 300, 128),
                   (1, 2, 128 * 131, 256, 88), (1, 2, 128 * 133, 256, 72),
                   (2, 3, 1000, 4097, 72), (1, 5, 129, 700, 88)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize('lse', [False, True], ids=['b1', 'b2'])
@pytest.mark.parametrize('shape', _PINGPONG_CASES,
                         ids=[f'{s[1]}x{s[2]}x{s[3]}-d{s[4]}' for s in _PINGPONG_CASES])
def test_pingpong_kernel_ragged_and_tile_counts(cuda, dtype, lse, shape):
    """B1 and B2 at the ping-pong widths against their twins, with the
    grid ``flash_grid`` picks for the card, at ragged lengths and at tile
    counts around the card's rounds."""
    b, h, sq, sk, d = shape
    assert d in fa.FLASH_CLUSTER_WIDTHS
    q, k, v = _qkv(cuda, dtype, *shape, seed=11)
    fa.launches = fa.lse_launches = 0
    if lse:
        out, got_lse = fa.flash_attention_with_lse(q, k, v, scale=d ** -0.5)
        ref, ref_lse = fa.flash_attention_with_lse_reference(q, k, v, d ** -0.5)
    else:
        out = fa.flash_attention(q, k, v, scale=d ** -0.5)
        ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.launches, fa.lse_launches) == ((0, 1) if lse else (1, 0))
    _assert_matches(out, ref, dtype)
    if lse:
        torch.testing.assert_close(got_lse, ref_lse, atol=1e-3, rtol=0)


_FLUX_SHAPES = [(2, 24, 4608, 4608, 128), (1, 24, 1536, 1536, 128), (2, 12, 4608, 4608, 128),
                (2, 24, 2560, 4608, 128), (2, 24, 2304, 4608, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', _FLUX_SHAPES, ids=[f'{s[1]}x{s[2]}x{s[3]}' for s in _FLUX_SHAPES])
def test_pingpong_kernel_at_flux_shapes(cuda, shape):
    """B1 at Flux's joint attention (4608 and 1536 tokens) and at phase 22's
    head (tp=2) and token (sp=2) shards, contiguous as Flux hands them."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(cuda, torch.bfloat16, *shape, seed=12)
    out = fa.flash_attention(q, k, v, scale=d ** -0.5)
    _assert_matches(out, fa.flash_attention_reference(q, k, v, d ** -0.5), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize('lse', [False, True], ids=['b1', 'b2'])
@pytest.mark.parametrize('shape', [(2, 16, 4096, 4096, 72), (2, 16, 4096, 4096, 88),
                                   (2, 16, 2048, 4096, 72), (1, 16, 4000, 4097, 88)],
                         ids=['d72', 'd88', 'd72-sp', 'ragged-d88'])
def test_pingpong_kernel_reads_head_split_views(cuda, dtype, lse, shape):
    """B1 and B2 on PixArt's (144-byte heads) and HunyuanDiT's (176-byte
    heads) head-split views at 4096 tokens, PixArt's sp=2 token shard and a
    ragged shape: the multicast halves of each K and V tile read in place."""
    b, h, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (_split(cuda, dtype, b, h, s, d, gen) for s in (sq, sk, sk))
    if lse:
        out, got_lse = fa.flash_attention_with_lse(q, k, v, scale=d ** -0.5)
        ref, ref_lse = fa.flash_attention_with_lse_reference(q, k, v, d ** -0.5)
        torch.testing.assert_close(got_lse, ref_lse, atol=1e-3, rtol=0)
    else:
        out = fa.flash_attention(q, k, v, scale=d ** -0.5)
        ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
    _assert_matches(out, ref, dtype)


_CLUSTER_CASES = [(2, 4, 2000, 2050, 72), (1, 16, 2600, 1000, 88), (2, 16, 4096, 4096, 72),
                  (1, 3, 2000, 2048, 88), (2, 1, 1900, 4000, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize('layout', ['contiguous', 'head-split'])
@pytest.mark.parametrize('shape', _CLUSTER_CASES,
                         ids=[f'{s[1]}x{s[2]}x{s[3]}-d{s[4]}' for s in _CLUSTER_CASES])
def test_headmean_cluster_kernel_matches_twin(cuda, dtype, layout, shape):
    """B3's 2 x 2 cluster kernel (the choice of ``headmean_clusters`` at
    these shapes) against its twin and against the lone kernel called
    through the same entry point, at ragged lengths (odd tile counts: a
    cluster's tiles past Sq or Sk; Sk not a multiple of 8: element
    stores)."""
    b, h, sq, sk, d = shape
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k = (_layout(cuda, dtype, layout, b, h, s, d, gen) for s in (sq, sk))
    _, lse = fa.flash_attention_with_lse(q, k, k, scale=d ** -0.5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    clusters = fa.headmean_clusters(b, sq, sk, d, sms,
                                    fa._cluster_slots('headmean', dtype, d, q.device))
    assert clusters > 0
    fa.headmean_launches = 0
    mean_p = fa.headmean_probs(q, k, lse, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.headmean_launches == 1
    _assert_map_matches(mean_p, fa.headmean_probs_reference(q, k, lse, d ** -0.5), dtype, sk)
    lone = torch.empty_like(mean_p)
    err = fa._lib('headmean', dtype).dft_headmean_probs(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(), lone.data_ptr(), b, h, sq, sk, d,
        fa._DTYPE_CODES[dtype], d ** -0.5, fa._tma_stride_array('t', (('q', q), ('k', k))), 0,
        fa._stream(q))
    torch.cuda.synchronize()
    assert err == 0
    _assert_map_matches(mean_p, lone, dtype, sk)
