"""The port's attention ops against the JAX package's.

On the CPU the kernel wrappers route to their plain twins; the JAX kernels
run in Pallas interpret mode, as tests/test_flash.py runs them.  The Hopper
kernels themselves are tested on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.ops import attention as jax_attn
from diffusion_feature_tpu.ops import flash_attention as jax_fa
from diffusion_feature_tpu_torch.models import registry
from diffusion_feature_tpu_torch.ops import attention as attn
from diffusion_feature_tpu_torch.ops import flash_attention as fa


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(ours, ref, atol, rtol):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


# fp32 on both sides; 1e-4 covers summation order (online vs one-shot softmax)
@pytest.mark.parametrize('shape', [(1, 2, 512, 512, 64), (1, 1, 512, 512, 512),
                                   (1, 2, 512, 512, 72), (1, 2, 512, 512, 88)],
                         ids=['d64', 'd512', 'd72', 'd88'])
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
    ((2, 8, 4096, 40), (2, 8, 4096, 40), True),       # SD-1.5 level 0 @512^2
    ((2, 8, 1024, 80), (2, 8, 1024, 80), True),       # SD-1.5 level 1 @512^2
    ((2, 16, 4096, 88), (2, 16, 4096, 88), True),     # HunyuanDiT @1024^2
    ((2, 16, 4096, 72), (2, 16, 4096, 72), True),     # PixArt-Sigma @1024^2
    ((2, 16, 1024, 72), (2, 16, 300, 72), False),     # PixArt cross-attention (masked)
    ((2, 16, 1024, 88), (2, 16, 333, 88), False),     # HunyuanDiT cross-attention
])
def test_gate(q_shape, k_shape, expect):
    assert fa.is_flash_compatible(q_shape, k_shape) is expect
    # the port's gate is the JAX gate plus the head-dim condition
    assert jax_fa.is_flash_compatible(q_shape, k_shape) or not expect
    # without the head-dim condition (the CPU twins) it is the JAX gate
    assert fa.is_flash_compatible(q_shape, k_shape, head_dims=None) is \
        jax_fa.is_flash_compatible(q_shape, k_shape)


SHIPPED = ('1-5', '2-1', 'xl', 'pgv2', 'pixart-alpha', 'pixart-sigma', 'pixart-sigma-512',
           'hunyuan')


def _attention_shapes(spec, img):
    """Every attention shape of one model (the JAX package's spec) and its
    VAE at ``img``^2, batch 2: the U-Net's self- and cross-attention per
    level or the DiT's over its patch tokens (cross over the T5 tokens;
    HunyuanDiT's over BERT's and T5's, and its T5 pool's one query over
    the mean and T5 tokens), and the VAE's mid-block head."""
    lat = img // 2 ** (len(spec.vae.block_out_channels) - 1)
    if spec.family == 'hunyuan':
        cfg = spec.dit
        h, d, s = cfg.num_attention_heads, cfg.head_dim, (lat // cfg.patch_size) ** 2
        yield (2, h, s, d), (2, h, s, d)
        yield (2, h, s, d), (2, h, cfg.text_len + cfg.text_len_t5, d)
        pool = (2, 8, 1, cfg.cross_attention_dim_t5 // 8)
        yield pool, (2, 8, cfg.text_len_t5 + 1, cfg.cross_attention_dim_t5 // 8)
    elif spec.family == 'pixart':
        cfg = spec.dit
        h, d, s = cfg.num_attention_heads, cfg.attention_head_dim, (lat // cfg.patch_size) ** 2
        yield (2, h, s, d), (2, h, s, d)
        yield (2, h, s, d), (2, h, spec.prompt_max_length, d)
    else:
        cfg = spec.unet
        for level, ch in enumerate(cfg.block_out_channels):
            h, s = cfg.num_attention_heads[level], (lat >> level) ** 2
            d = ch // h
            yield (2, h, s, d), (2, h, s, d)
            yield (2, h, s, d), (2, h, 77, d)
    d = spec.vae.block_out_channels[-1]
    yield (2, 1, lat * lat, d), (2, 1, lat * lat, d)


def _shipped_attention_shapes():
    """Every attention shape of the shipped U-Nets and DiTs and their VAEs
    at 512^2 and 1024^2, batch 2."""
    for version in SHIPPED:
        for img in (512, 1024):
            yield from _attention_shapes(jax_model_spec(version), img)


@pytest.mark.parametrize('min_seq', [1024, 512], ids=['flash', 'headmean'])
def test_gate_equals_jax_on_shipped_unets(min_seq):
    """With the widened head dims the port's gate, head-dim condition
    included, is the JAX gate on every shipped U-Net, DiT and VAE shape
    (the PixArt DiTs' d=72 and HunyuanDiT's d=88 too)."""
    dims = fa.SUPPORTED_HEAD_DIMS if min_seq == 1024 else fa.HEADMEAN_HEAD_DIMS
    shapes = list(_shipped_attention_shapes())
    for q_shape, k_shape in shapes:
        want = jax_fa.is_flash_compatible(q_shape, k_shape, min_seq=min_seq)
        if min_seq == 512 and q_shape[-1] == 512:
            want = False    # the VAE head never feeds the attention store
        assert fa.is_flash_compatible(q_shape, k_shape, min_seq, dims) is want, q_shape
    assert sum(jax_fa.is_flash_compatible(q, k, min_seq=min_seq) for q, k in shapes) > 10


@pytest.mark.parametrize('min_seq', [1024, 512], ids=['flash', 'headmean'])
def test_every_gate_passing_width_is_built(min_seq):
    """Every attention of every published version the port registers, at
    512^2 and 1024^2, that JAX's gate sends to a kernel has its head width
    among the widths that kernel is built for, so none goes to the explicit
    path on the card where JAX takes the kernel.  (The test-* models are
    CPU test models: their d=8 and d=16 heads are built for no kernel.)"""
    dims = fa.SUPPORTED_HEAD_DIMS if min_seq == 1024 else fa.HEADMEAN_HEAD_DIMS
    versions = [v for v, s in registry._REGISTRY.items() if not v.startswith('test-')]
    assert set(SHIPPED) <= set(versions)
    for version in versions:
        for img in (512, 1024):
            for q_shape, k_shape in _attention_shapes(jax_model_spec(version), img):
                if min_seq == 512 and q_shape[-1] == 512:
                    continue    # the VAE head never feeds the attention store
                if jax_fa.is_flash_compatible(q_shape, k_shape, min_seq=min_seq):
                    assert q_shape[-1] in dims, (version, img, q_shape)


_LSE_SHAPE = (1, 2, 512, 512, 64)     # the smallest shape the head-mean gate passes


def test_flash_lse_twin_matches_jax_kernel():
    b, h, sq, sk, d = _LSE_SHAPE
    q, k, v = _rand(10, b, h, sq, d), _rand(11, b, h, sk, d), _rand(12, b, h, sk, d)
    fa.lse_launches = 0
    out, lse = fa.flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), scale=d ** -0.5)
    r_out, r_lse = jax_fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), scale=d ** -0.5)
    _close(out, r_out, atol=1e-4, rtol=1e-4)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    _close(lse, r_lse, atol=1e-5, rtol=1e-5)
    assert fa.lse_launches == 0


def test_flash_lse_twin_matches_jax_kernel_d72():
    """B2's twin at PixArt's head width, at the smallest shape the
    head-mean gate passes."""
    b, h, sq, sk, d = (1, 2, 512, 512, 72)
    q, k, v = _rand(15, b, h, sq, d), _rand(16, b, h, sk, d), _rand(17, b, h, sk, d)
    out, lse = fa.flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), scale=d ** -0.5)
    r_out, r_lse = jax_fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), scale=d ** -0.5)
    _close(out, r_out, atol=1e-4, rtol=1e-4)
    _close(lse, r_lse, atol=1e-5, rtol=1e-5)


def test_flash_lse_twin_matches_jax_kernel_d88():
    """B2's twin at HunyuanDiT's head width (88, QK^T depth 96 on the
    card), at the smallest shape the head-mean gate passes."""
    b, h, sq, sk, d = (1, 2, 512, 512, 88)
    q, k, v = _rand(20, b, h, sq, d), _rand(21, b, h, sk, d), _rand(22, b, h, sk, d)
    out, lse = fa.flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), scale=d ** -0.5)
    r_out, r_lse = jax_fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), scale=d ** -0.5)
    _close(out, r_out, atol=1e-4, rtol=1e-4)
    _close(lse, r_lse, atol=1e-5, rtol=1e-5)


def test_headmean_twin_matches_jax_kernel_d88():
    """B3's twin at HunyuanDiT's head width, on the JAX kernel's logsumexp."""
    b, h, sq, sk, d = (1, 2, 512, 512, 88)
    q, k = _rand(23, b, h, sq, d), _rand(24, b, h, sk, d)
    _, lse = jax_fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                             scale=d ** -0.5)
    ours = fa.headmean_probs(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(np.array(lse)), scale=d ** -0.5)
    ref = jax_fa.headmean_probs(jnp.asarray(q), jnp.asarray(k), lse, scale=d ** -0.5,
                                out_dtype=jnp.float32)
    _close(ours, ref, atol=1e-6, rtol=1e-4)


def test_headmean_twin_matches_jax_kernel_d72():
    """B3's twin at PixArt's head width, on the JAX kernel's logsumexp."""
    b, h, sq, sk, d = (1, 2, 512, 512, 72)
    q, k = _rand(18, b, h, sq, d), _rand(19, b, h, sk, d)
    _, lse = jax_fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                             scale=d ** -0.5)
    ours = fa.headmean_probs(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(np.array(lse)), scale=d ** -0.5)
    ref = jax_fa.headmean_probs(jnp.asarray(q), jnp.asarray(k), lse, scale=d ** -0.5,
                                out_dtype=jnp.float32)
    _close(ours, ref, atol=1e-6, rtol=1e-4)


def test_headmean_twin_matches_jax_kernel():
    b, h, sq, sk, d = _LSE_SHAPE
    q, k = _rand(13, b, h, sq, d), _rand(14, b, h, sk, d)
    # both sides take the same logsumexp: the JAX kernel's
    _, lse = jax_fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                             scale=d ** -0.5)
    fa.headmean_launches = 0
    ours = fa.headmean_probs(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(np.array(lse)), scale=d ** -0.5)
    ref = jax_fa.headmean_probs(jnp.asarray(q), jnp.asarray(k), lse, scale=d ** -0.5,
                                out_dtype=jnp.float32)
    assert ours.shape == (b, sq, sk) and ours.dtype == torch.float32
    _close(ours, ref, atol=1e-6, rtol=1e-4)
    assert fa.headmean_launches == 0


@pytest.mark.parametrize('sq', [512, 256], ids=['kernels', 'explicit'])
def test_attention_with_headmean_matches_jax(sq):
    """The head-mean op on both branches: at 512 tokens JAX runs B2 + B3 in
    interpret mode and the port their twins; at 256 both are explicit."""
    h, d = 2, 64
    q, k, v = _rand(15, 1, h, sq, d), _rand(16, 1, h, sq, d), _rand(17, 1, h, sq, d)
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    out, mean_p = attn.attention_with_headmean_heads(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    r_out, r_mean = jax_attn.attention_with_headmean_heads(jnp.asarray(q), jnp.asarray(k),
                                                           jnp.asarray(v))
    _close(out, r_out, atol=1e-4, rtol=1e-4)
    _close(mean_p, r_mean, atol=1e-6, rtol=1e-4)
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)


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


def _recording_wrapper(monkeypatch, calls):
    """Replace the B1 wrapper the attention ops call by one that records
    the layout of what it is handed, then runs the real wrapper (on the
    CPU: its twin)."""
    real = attn.flash_attention

    def record(q, k, v, *, scale):
        calls.append([(x.is_contiguous(), x.stride()) for x in (q, k, v)])
        return real(q, k, v, scale=scale)

    monkeypatch.setattr(attn, 'flash_attention', record)


def _head_split_strides(b, s, heads, d):
    """The strides of ``split_heads`` of a contiguous (b, s, heads*d)."""
    return (s * heads * d, d, heads * d, 1)


@pytest.mark.parametrize('op', ['attention_fused', 'attention_fused_heads'])
def test_fused_ops_hand_the_kernel_head_split_views(monkeypatch, op):
    """The flash wrapper gets the (B, H, S, D) views of the projections,
    not copies (the kernel reads them in place), and the result still
    equals the JAX package's at fp32."""
    heads, d, s = 2, 64, 1024
    q, k, v = (_rand(20 + i, 1, s, heads * d) for i in range(3))
    calls = []
    _recording_wrapper(monkeypatch, calls)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if op == 'attention_fused':
        ours = attn.attention_fused(tq, tk, tv, heads)
    else:
        ours = attn.merge_heads(attn.attention_fused_heads(
            *(attn.split_heads(x, heads) for x in (tq, tk, tv))))
    assert calls == [[(False, _head_split_strides(1, s, heads, d))] * 3]
    # the JAX gate would send this shape to the Pallas kernel; its explicit
    # twin keeps this file at two interpret-mode calls
    ref, _ = jax_attn.attention_with_probs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    _close(ours, ref, atol=1e-5, rtol=1e-4)


def test_unet_attention_hands_the_kernel_head_split_views(monkeypatch):
    """The U-Net's Attention module on its fused path: the wrapper gets the
    head-split views of the module's own projections, and the output equals
    the JAX attention on the same projections followed by to_out."""
    from diffusion_feature_tpu_torch.models.layers import Attention
    heads, d, s = 2, 64, 1024
    torch.manual_seed(0)
    mod = Attention(heads * d, heads, d).eval()
    x = torch.from_numpy(_rand(30, 1, s, heads * d))
    calls = []
    _recording_wrapper(monkeypatch, calls)
    with torch.no_grad():
        ours = mod(x)
        q, k, v = (lin(x).numpy() for lin in (mod.to_q, mod.to_k, mod.to_v))
    assert calls == [[(False, _head_split_strides(1, s, heads, d))] * 3]
    ref, _ = jax_attn.attention_with_probs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    with torch.no_grad():
        ref = mod.to_out[0](torch.from_numpy(np.array(ref, np.float32)))
    _close(ours, ref.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('layout,shape,dtype,want', [
    ('contiguous', (2, 10, 4096, 64), torch.bfloat16, (10 * 4096 * 64, 4096 * 64, 64)),
    ('head-split', (2, 10, 4096, 64), torch.bfloat16, (4096 * 640, 64, 640)),
    ('head-split', (2, 8, 1000, 40), torch.bfloat16, (1000 * 320, 40, 320)),
    ('contiguous', (1, 2, 333, 40), torch.float16, (2 * 333 * 40, 333 * 40, 40)),
    ('head-split', (1, 1, 16384, 512), torch.bfloat16, (16384 * 512, 16384 * 512, 512)),
    ('head-split', (2, 2, 300, 80), torch.float32, (300 * 160, 80, 160)),
], ids=['contiguous', 'head-split', 'd40-head-split', 'd40-fp16', 'vae-one-head', 'fp32'])
def test_tma_strides(layout, shape, dtype, want):
    """The element strides the flash kernels' tensor maps take: head-split
    views pass as they are; a size-1 dimension gets a packed stride."""
    b, h, s, d = shape
    if layout == 'contiguous':
        x = torch.empty(shape, dtype=dtype)
    else:
        x = attn.split_heads(torch.empty(b, s, h * d, dtype=dtype), h)
    assert fa.tma_strides(x) == want


def test_tma_strides_raise():
    x = torch.empty(1, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='contiguous along D'):
        fa.tma_strides(x.transpose(2, 3))
    # 36 bf16 = 72 bytes between rows: TMA takes multiples of 16 only
    with pytest.raises(ValueError, match='16 bytes'):
        fa.tma_strides(torch.empty(1, 2, 64, 36, dtype=torch.bfloat16))
    # every second row: a 256-byte stride, which TMA takes
    assert fa.tma_strides(x[:, :, ::2]) == (2 * 64 * 64, 64 * 64, 128)


def test_flash_output_layout():
    """B1/B2's output on the card: (B, S, H, D) memory as the (B, H, S, D)
    view, so merge_heads of it is a view and its strides pass tma_strides."""
    q = attn.split_heads(torch.empty(2, 100, 4 * 40), 4).contiguous()
    out = fa.flash_output(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.stride() == (100 * 160, 40, 160, 1)
    assert attn.merge_heads(out).data_ptr() == out.data_ptr()
    assert attn.merge_heads(out)._base is out._base
    assert fa.tma_strides(out) == (100 * 160, 40, 160)


def test_headmean_op_hands_the_kernels_head_split_views(monkeypatch):
    """The store's op passes the head-split views themselves, not copies,
    to B2 and B3 (both read them in place on the card), and still equals
    the JAX op at fp32 (there B2 + B3 in interpret mode)."""
    heads, d, s = 2, 64, 512
    q, k, v = (_rand(40 + i, 1, s, heads * d) for i in range(3))
    qh, kh, vh = (attn.split_heads(torch.from_numpy(x), heads) for x in (q, k, v))
    calls = []
    for name in ('flash_attention_with_lse', 'headmean_probs'):
        real = getattr(attn, name)

        def record(*args, _name=name, _real=real, **kwargs):
            calls.append((_name, args[:2]))
            return _real(*args, **kwargs)

        monkeypatch.setattr(attn, name, record)
    out, mean_p = attn.attention_with_headmean_heads(qh, kh, vh)
    assert [name for name, _ in calls] == ['flash_attention_with_lse', 'headmean_probs']
    for _, (cq, ck) in calls:
        assert cq is qh and ck is kh
        assert cq.stride() == _head_split_strides(1, s, heads, d) and not cq.is_contiguous()
    r_out, r_mean = jax_attn.attention_with_headmean_heads(
        *(jax_attn.split_heads(jnp.asarray(x), heads) for x in (q, k, v)))
    _close(out, r_out, atol=1e-4, rtol=1e-4)
    _close(mean_p, r_mean, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize('layout', ['head-split', 'row-stride'])
def test_headmean_twin_takes_strided_views(layout):
    """B3's wrapper on strided CPU views (the layouts the card's kernel
    reads in place) gives what it gives on contiguous copies."""
    b, h, sq, sk, d = 2, 3, 40, 24, 16
    rs = np.random.RandomState(50)
    if layout == 'head-split':
        q, k = (attn.split_heads(torch.from_numpy(rs.randn(b, s, h * d).astype(np.float32)), h)
                for s in (sq, sk))
    else:
        q, k = (torch.from_numpy(rs.randn(b, h, 2 * s, d).astype(np.float32))[:, :, ::2]
                for s in (sq, sk))
    assert not q.is_contiguous() and not k.is_contiguous()
    _, lse = fa.flash_attention_with_lse(q, k, k, scale=d ** -0.5)
    fa.headmean_launches = 0
    ours = fa.headmean_probs(q, k, lse, scale=d ** -0.5)
    ref = fa.headmean_probs(q.contiguous(), k.contiguous(), lse, scale=d ** -0.5)
    assert fa.headmean_launches == 0 and ours.shape == (b, sq, sk)
    torch.testing.assert_close(ours, ref, atol=1e-7, rtol=1e-5)
