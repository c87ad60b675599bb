"""Gradients through the PyTorch port's extractor against the JAX package,
at fp32 on the CPU: the flash attention Function's twin backward against
JAX's custom VJP (``_flash_diff_bwd``: the einsum-softmax VJP and the
q-chunked ``_chunked_attention_bwd``, called directly at small shapes, no
Pallas run), the attention store's head-mean backward against JAX's
``_headmean_bwd``, and ``train_unet``'s U-Net parameter gradients of a
loss on ``test-sd`` taps against ``jax.grad`` through the JAX facade's
step program.

Tolerances: 1e-4 relative L2 for values, and the two-tier rule of
tests/test_grad_parity.py for gradients: a tensor with signal (|g|max at
least 1e-4 of the largest gradient G) within 1e-3 max-relative error, a
cancellation-dominated one (biases feeding a GroupNorm) within 1e-6 G
absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusion_feature_tpu.ops import attention as jax_attn
from diffusion_feature_tpu.ops import flash_attention as jax_fa
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.models.convert import params_from_jax
from diffusion_feature_tpu_torch.ops import attention as attn
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from port_parity import jax_facade, jax_noise, load_jax_params

VALUE_TOL = 1e-4
REL_TOL, NOISE_FLOOR, ABS_NOISE = 1e-3, 1e-4, 1e-6


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def assert_grads_close(ours: dict, ref: dict, label: str):
    """The two-tier rule of tests/test_grad_parity.py over {name: array}."""
    assert ours.keys() == ref.keys()
    g_max = max(float(np.abs(v).max()) for v in ref.values())
    assert g_max > 0, f'{label}: every reference gradient is zero'
    for name, r in ref.items():
        o = np.asarray(ours[name], np.float32)
        r = np.asarray(r, np.float32)
        assert o.shape == r.shape, (name, o.shape, r.shape)
        if np.abs(r).max() >= NOISE_FLOOR * g_max:
            err = float(np.abs(o - r).max() / np.abs(r).max())
            assert err < REL_TOL, f'{label} {name}: max-rel-err {err:.2e}'
        else:
            d = float(np.abs(o - r).max())
            assert d < ABS_NOISE * g_max, f'{label} {name}: noise-level |dg| {d:.2e}'


def _qkvg(b, h, sq, sk, d, seed=0):
    return (_rand(seed, b, h, sq, d), _rand(seed + 1, b, h, sk, d), _rand(seed + 2, b, h, sk, d),
            _rand(seed + 3, b, h, sq, d))


@pytest.mark.parametrize('branch', ['einsum', 'chunked', 'switch'])
def test_flash_function_backward_matches_jax_vjp(monkeypatch, branch):
    """The port's flash Function (B2 forward, the backward's twin on the
    host) against JAX's ``_flash_diff_bwd``: below the chunk threshold the
    einsum VJP, ``_chunked_attention_bwd`` on a ragged last chunk, and both
    dispatchers with the threshold lowered so the chunked branch engages
    (JAX pads q to its 512-row chunks, the port slices a ragged one)."""
    b, h, sq, sk, d = {'einsum': (2, 3, 40, 24, 16), 'chunked': (1, 2, 50, 24, 8),
                       'switch': (1, 2, 600, 40, 8)}[branch]
    q, k, v, g = _qkvg(b, h, sq, sk, d)
    scale = d ** -0.5
    if branch == 'chunked':
        ref = jax_fa._chunked_attention_bwd(*map(jnp.asarray, (q, k, v)), scale, jnp.asarray(g),
                                            chunk=16)
        ours = fa.chunked_attention_bwd(*map(torch.from_numpy, (q, k, v)), scale,
                                        torch.from_numpy(g), chunk=16)
    else:
        if branch == 'switch':
            monkeypatch.setattr(jax_fa, '_CHUNKED_BWD_ELEMS', 1000)
            monkeypatch.setattr(fa, 'CHUNKED_BWD_ELEMS', 1000)
        ref = jax_fa._flash_diff_bwd(scale, None, None, tuple(map(jnp.asarray, (q, k, v))),
                                     jnp.asarray(g))
        inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention_diff(*inputs, scale=scale)
        assert type(out.grad_fn).__name__ == '_FlashAttentionBackward'
        # the forward is B1's function
        np.testing.assert_allclose(
            out.detach().numpy(),
            np.asarray(jax_fa._reference_attention(*map(jnp.asarray, (q, k, v)), scale)),
            atol=1e-5, rtol=1e-5)
        out.backward(torch.from_numpy(g))
        ours = [x.grad for x in inputs]
    for name, o, r in zip(('dq', 'dk', 'dv'), ours, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        assert _rel_l2(o.numpy(), r) < VALUE_TOL, name


def test_attention_dispatch_takes_the_function_with_grad():
    """With inputs that require grad, a shape the gate admits (1024 tokens)
    goes through the flash Function, whose gradients are the explicit
    path's; without grad it stays on B1 (no graph)."""
    b, s, heads, d = 1, 1024, 2, 8
    q, k, v = (torch.from_numpy(_rand(i, b, s, heads * d)) for i in (20, 21, 22))
    out = attn.attention_fused(q, k, v, heads)
    assert out.grad_fn is None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attn.attention_fused(*leaves, heads)
    assert any(type(f).__name__ == '_FlashAttentionBackward' for f in _walk(out.grad_fn))
    weight = torch.from_numpy(_rand(23, b, s, heads * d))
    (out * weight).sum().backward()
    twin = [x.clone().requires_grad_() for x in (q, k, v)]
    ref, _ = attn.attention_with_probs(*twin, heads)
    (ref * weight).sum().backward()
    for a, r in zip(leaves, twin):
        assert _rel_l2(a.grad.numpy(), r.grad.numpy()) < VALUE_TOL


def _walk(fn, depth=4):
    """``fn`` and the autograd nodes within ``depth`` steps of it."""
    out = frontier = [fn]
    for _ in range(depth):
        frontier = [f for node in frontier for f, _ in node.next_functions if f is not None]
        out = out + frontier
    return out


def test_headmean_backward_matches_jax():
    """The store's B2 + B3 Function (twins forward on the host) and its
    backward through the explicit path against JAX's ``_headmean_bwd``, at
    the smallest shape the head-mean gate admits."""
    b, h, s, d = 1, 2, 512, 8
    q, k, v, g_out = _qkvg(b, h, s, s, d, seed=30)
    g_mean = _rand(40, b, s, s)
    scale = d ** -0.5
    inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, mean_p = attn.attention_with_headmean_heads(*inputs, scale=scale)
    assert type(out.grad_fn).__name__ == '_HeadmeanKernelPathBackward'
    r_out, r_mean = jax_attn._headmean_explicit(*map(jnp.asarray, (q, k, v)), scale)
    assert _rel_l2(out.detach().numpy(), r_out) < VALUE_TOL
    assert _rel_l2(mean_p.detach().numpy(), r_mean) < VALUE_TOL
    torch.autograd.backward((out, mean_p), (torch.from_numpy(g_out), torch.from_numpy(g_mean)))
    ref = jax_attn._headmean_bwd(scale, tuple(map(jnp.asarray, (q, k, v))),
                                 (jnp.asarray(g_out), jnp.asarray(g_mean)))
    for name, x, r in zip(('dq', 'dk', 'dv'), inputs, ref):
        assert _rel_l2(x.grad.numpy(), r) < VALUE_TOL, name


def test_every_grad_width_is_built_for_the_backward():
    """Every attention of every published version at 512^2 and 1024^2 that
    the gate sends to B1 has a head width the backward is built for, so a
    gradient through it (train_unet, prompt tuning) never meets an unbuilt
    width on the card; the VAE's d=512 head is the exception, and it never
    records a gradient (the VAE runs without one)."""
    from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
    from diffusion_feature_tpu_torch.models import registry
    from test_torch_attention import SHIPPED, _attention_shapes
    versions = [v for v in registry._REGISTRY if not v.startswith('test-')]
    assert set(SHIPPED) <= set(versions)
    widths = set()
    for version in versions:
        for img in (512, 1024):
            for q_shape, k_shape in _attention_shapes(jax_model_spec(version), img):
                if q_shape[-1] != 512 and jax_fa.is_flash_compatible(q_shape, k_shape):
                    assert q_shape[-1] in fa.BWD_HEAD_DIMS, (version, img, q_shape)
                    widths.add(q_shape[-1])
    assert widths <= set(fa.BWD_HEAD_DIMS) and 512 not in fa.BWD_HEAD_DIMS


# ------------------------------------------------------------ train_unet
SIZE, BATCH, SEED, T = 64, 2, 0, 50
LOSS_TAPS = {'down-level0-repeat0-vit-block0-out': True, 'mid-vit-block0-self-map': True,
             'up-level1-repeat0-res-out': True, 'unet-out': True}


def _tap_loss(feats):
    return sum(((feats[k].float()) ** 2).mean() for k in sorted(LOSS_TAPS))


def test_train_unet_param_grads_match_jax():
    """dL/dθ over every U-Net parameter for a loss on test-sd taps (a
    transformer block's output, a softmax map, a resnet, the U-Net's
    output) through the port's train_unet step against jax.grad through the
    JAX facade's t-generic step program, on the same parameters and noise."""
    jfe = jax_facade(LOSS_TAPS, 'test-sd', SIZE, SEED)
    port = FeatureExtractor(LOSS_TAPS, 'test-sd', device='cpu', img_size=SIZE, dtype='float32',
                            train_unet=True)
    load_jax_params(jfe, port)
    assert port.feature_dtype is None
    assert all(p.requires_grad for p in port.unet.parameters())
    img = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1
    pe = jfe.encode_prompt('a photo of a cat')

    kit = {k: jnp.float32(v) for k, v in jfe._img2img_kit(T).items()}
    _, step_rng = jax.random.split(jax.random.PRNGKey(SEED))
    step = jfe._get_step_fn_generic(False)
    ctx = jnp.broadcast_to(jnp.asarray(pe[0]), (BATCH,) + pe[0].shape[1:])

    def jax_loss(unet_params):
        feats = step({**jfe.params, 'unet': unet_params}, jnp.asarray(img), ctx, None, None,
                     step_rng, kit)
        return sum(jnp.mean(feats[k].astype(jnp.float32) ** 2) for k in sorted(LOSS_TAPS))

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(jfe.params['unet'])

    lat = SIZE // port.vae_scale
    posterior, noise = jax_noise(SEED, (BATCH, port.spec.vae.latent_channels, lat, lat))
    cond = port._step_conditioning(tuple(torch.from_numpy(np.array(p)) if p is not None
                                         else None for p in pe), BATCH)
    feats = port._step(torch.from_numpy(img), cond, port._step_kit(T), posterior, noise,
                       port.feature_dtype)
    assert all(v.dtype == torch.float32 and v.requires_grad for v in feats.values())
    loss = _tap_loss(feats)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) < VALUE_TOL * abs(float(ref_loss))
    ref = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, ref_grads), port.unet).items()}
    ours = {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy())
            for k, p in port.unet.named_parameters()}
    assert_grads_close(ours, ref, 'train_unet dL/dθ')
    assert sum(float(np.abs(g).max()) > 0 for g in ours.values()) > 0.9 * len(ours)
