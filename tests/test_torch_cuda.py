"""The Hopper flash-attention kernel against its plain twin, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernel has no CPU mode).  The file imports torch and the port only, so it
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
                                   (1, 1, 300, 700, 512)], ids=['d64', 'd128', 'd512'])
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


@pytest.mark.cuda
@pytest.mark.parametrize('sk,launches', [(1024, 1), (77, 0)], ids=['gate-pass', 'cross'])
def test_attention_fused_routes_on_card(cuda, sk, launches):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 1024, 640, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, sk, 640, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    fa.launches = 0
    out = attn.attention_fused(q, k, v, 10)
    torch.cuda.synchronize()
    assert fa.launches == launches
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
