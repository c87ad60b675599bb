"""Segmentation in the PyTorch port against the JAX package, at fp32 on the
CPU: the heads (UPerHead, FCNHead, SegHead with one model and with the
two-model wiring) through ``seg_head_from_jax``, the losses with their
gradients, one ``head_loss`` training step with the BN statistics and the
AdamW + PolyLR update against optax, slide inference and ``compute_iou``,
and the trainer CLI on ``--device cpu``; the segmentor's prompt-tuning
loss and its ``meta_prompt`` gradient are in tests/test_torch_segmentor.py.

Tolerances: 1e-4 relative L2 for values (a BN statistic, a loss, an
optimiser update), and the two-tier rule of tests/test_grad_parity.py for
gradients (``test_torch_grad.assert_grads_close``): 1e-3 max-relative error
for a tensor with signal, 1e-6 of the largest gradient absolute for a
cancellation-dominated one (a conv bias feeding a training-mode BN).
"""

import json
import random
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

import train_segmentation as jax_trainer
from diffusion_feature_tpu.tasks.scarce import compute_iou as jax_compute_iou
from diffusion_feature_tpu.tasks.segmentation import heads as jax_heads
from diffusion_feature_tpu.tasks.segmentation import losses as jax_losses
from diffusion_feature_tpu.tasks.segmentation import segmentor as jax_segmentor
from diffusion_feature_tpu_torch import train_segmentation as trainer
from diffusion_feature_tpu_torch.tasks.scarce import compute_iou
from diffusion_feature_tpu_torch.tasks.segmentation import (
    FCNHead, SegHead, UPerHead, cross_entropy_loss, lovasz_softmax_loss, segmentation_loss,
    seg_head_from_jax,
)
from diffusion_feature_tpu_torch.tasks.segmentation.segmentor import DiffusionSegmentor
from test_torch_grad import _rand, _rel_l2, assert_grads_close

VALUE_TOL, GRAD_TOL = 1e-4, 1e-3
CLASSES, CHANNELS = 5, 16


def _randomise(tree, seed, scale=0.3):
    """Every leaf of a Flax tree redrawn (zero inits too, so the adapters
    and BN scales carry signal); BN variances positive."""
    rs = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))
    out = {}
    for path, v in flat.items():
        x = rs.randn(*v.shape).astype(np.float32) * scale
        out[path] = np.abs(x) + 0.5 if path[-1] == 'var' else x
    return traverse_util.unflatten_dict(out)


def _close_tree(ours: dict, ref: dict, tol, label):
    assert set(ours) == set(ref), (set(ours) ^ set(ref))
    for k in ref:
        r = np.asarray(ref[k])
        o = ours[k].detach().numpy() if isinstance(ours[k], torch.Tensor) else ours[k]
        err = float(np.abs(o - r).max() / max(np.abs(r).max(), 1e-12))
        assert err < tol, f'{label} {k}: {err:.2e}'


# two levels, the second (deeper) at the higher resolution as SDXL's taps
# are, so both the upsampling and the antialiased downsampling resizes run
LAYERS_ONE = [[('a', 8), ('b', 8)], [('c', 12)]]
LAYERS_TWO = [[[('a', 8)], [('c', 12)]], [[('b', 6)], [('d', 4)]]]
HW = {'a': 8, 'b': 8, 'c': 16, 'd': 16}


def _features(keys, seed=0, batch=2):
    return {k: _rand(seed + i, batch, ch, HW[k.split(':')[-1]], HW[k.split(':')[-1]])
            for i, (k, ch) in enumerate(keys)}


def _build(kind):
    """(JAX module, apply inputs, port module, its inputs)."""
    if kind == 'uper':
        feats = [_rand(1, 2, 8, 8, 8), _rand(2, 2, 12, 16, 16)]
        jm = jax_heads.UPerHead(in_channels=(8, 12), channels=CHANNELS, pool_scales=(1, 2, 3),
                                num_classes=CLASSES)
        pm = UPerHead((8, 12), CHANNELS, (1, 2, 3), CLASSES)
        return jm, ([jnp.asarray(f) for f in feats],), pm, ([torch.from_numpy(f) for f in feats],)
    if kind == 'fcn':
        x = _rand(3, 2, 12, 16, 16)
        jm = jax_heads.FCNHead(channels=CHANNELS, num_classes=CLASSES)
        return jm, (jnp.asarray(x),), FCNHead(12, CHANNELS, num_classes=CLASSES), \
            (torch.from_numpy(x),)
    layers = LAYERS_ONE if kind == 'seghead' else LAYERS_TWO
    if kind == 'seghead':
        keys = [kv for lvl in layers for kv in lvl]
        mfl = (tuple(tuple(lvl) for lvl in layers),)
    else:
        keys = [(f'm{mi}:{lid}', ch) for mi, fl in enumerate(layers) for lvl in fl
                for lid, ch in lvl]
        mfl = tuple(tuple(tuple(lvl) for lvl in fl) for fl in layers)
    feats = _features(keys)
    jm = jax_segmentor.SegHead(model_feature_layers=mfl, num_classes=CLASSES,
                               head_channels=CHANNELS, pool_scales=(1, 2), aux_in_index=1)
    pm = SegHead(mfl, CLASSES, CHANNELS, (1, 2), aux_in_index=1)
    return (jm, ({k: jnp.asarray(v) for k, v in feats.items()},), pm,
            ({k: torch.from_numpy(v) for k, v in feats.items()},))


def _jax_init(module, args):
    """A Flax module's variables, initialised in one compiled program (op by
    op, the heads' first calls compile every operator on its own)."""
    return jax.jit(lambda a: module.init(jax.random.PRNGKey(0), *a, train=False))(args)


@pytest.mark.parametrize('kind', ['uper', 'fcn', 'seghead', 'seghead_two_models'])
def test_head_matches_jax(kind):
    """Evaluation and training outputs, the BN running statistics after a
    training forward, and the parameter gradients of a loss on the logits,
    with every parameter and statistic redrawn at random and carried over
    by ``seg_head_from_jax``."""
    jm, jargs, pm, pargs = _build(kind)
    variables = _jax_init(jm, jargs)
    # the two-model wiring stacks each shared adapter 4 times between
    # training-mode BNs: at the other cases' weight scale fp32 rounding
    # alone moves its gradients by up to 5e-3 (both packages alike,
    # against a float64 run), so its weights are drawn smaller
    params = _randomise(variables['params'], 1, 0.1 if kind == 'seghead_two_models' else 0.3)
    stats = _randomise(variables['batch_stats'], 2)
    pm.load_state_dict(seg_head_from_jax(params, stats))

    def listify(out):
        return list(out) if isinstance(out, tuple) else [out]

    ref_eval = listify(jax.jit(lambda v, a: jm.apply(v, *a, train=False))(
        {'params': params, 'batch_stats': stats}, jargs))
    with torch.no_grad():
        ours_eval = listify(pm(*pargs, train=False))
    for o, r in zip(ours_eval, ref_eval):
        assert o.shape == r.shape and _rel_l2(o.numpy(), r) < VALUE_TOL

    weights = [_rand(10 + i, *r.shape) for i, r in enumerate(ref_eval)]

    def jax_loss(p):
        out, upd = jm.apply({'params': p, 'batch_stats': stats}, *jargs, train=True,
                            mutable=['batch_stats'])
        return sum(jnp.sum(o * w) for o, w in zip(listify(out), weights)), (out, upd)

    (_, (ref_train, upd)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    ours_train = listify(pm(*pargs, train=True))
    for o, r in zip(ours_train, listify(ref_train)):
        assert _rel_l2(o.detach().numpy(), r) < VALUE_TOL
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(ours_train, weights)).backward()
    state = seg_head_from_jax(params, upd['batch_stats'])
    own = pm.state_dict()
    for k, v in state.items():
        if 'running' in k:
            assert _rel_l2(own[k].numpy(), v.numpy()) < VALUE_TOL, k
    ref_grads = seg_head_from_jax(jax.tree.map(np.asarray, grads))
    assert_grads_close({k: p.grad.numpy() for k, p in pm.named_parameters()},
                       {k: v.numpy() for k, v in ref_grads.items()}, f'{kind} grads')


def _logits_labels(seed=0, b=2, c=CLASSES, h=12, w=10):
    logits = _rand(seed, b, c, h, w) * 2
    rs = np.random.RandomState(seed + 1)
    labels = rs.randint(0, c - 1, size=(b, h, w))      # the last class absent
    labels[rs.rand(b, h, w) < 0.2] = 255               # ignored pixels
    return logits, labels.astype(np.int32)


@pytest.mark.parametrize('loss', ['cross_entropy', 'lovasz', 'segmentation'])
def test_loss_and_gradient_match_jax(loss):
    """Value and d/dlogits of each loss with ignored pixels and an absent
    class (the combined objective with an aux head)."""
    logits, labels = _logits_labels()
    aux = _rand(7, *logits.shape)
    fns = {'cross_entropy': (cross_entropy_loss, jax_losses.cross_entropy_loss),
           'lovasz': (lovasz_softmax_loss, jax_losses.lovasz_softmax_loss),
           'segmentation': (lambda x, y: segmentation_loss(x, torch.from_numpy(aux), y)[0],
                            lambda x, y: jax_losses.segmentation_loss(x, jnp.asarray(aux), y)[0])}
    ours_fn, ref_fn = fns[loss]
    ref, ref_grad = jax.value_and_grad(ref_fn)(jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    ours = ours_fn(x, torch.from_numpy(labels))
    ours.backward()
    assert abs(float(ours.detach()) - float(ref)) < VALUE_TOL * abs(float(ref))
    err = float(np.abs(x.grad.numpy() - ref_grad).max() / np.abs(ref_grad).max())
    assert err < GRAD_TOL


def test_head_loss_step_and_optimizer_match_optax():
    """One ``head_loss`` training step on a SegHead: the loss and its parts,
    the head's gradients and BN statistics, then two AdamW + PolyLR updates
    (``make_optimizer``) against optax's ``adamw(polynomial_schedule)``
    with the JAX trainer's settings."""
    jm, jargs, pm, pargs = _build('seghead')
    variables = _jax_init(jm, jargs)
    params = {'head': _randomise(variables['params'], 3)}
    stats = _randomise(variables['batch_stats'], 4)
    pm.load_state_dict(seg_head_from_jax(params['head'], stats))
    labels = np.random.RandomState(5).randint(0, CLASSES, size=(2, 24, 24)).astype(np.int32)

    def jax_loss(p):
        return jax_segmentor.DiffusionSegmentor.head_loss(
            types.SimpleNamespace(head=jm), p, stats, jargs[0], jnp.asarray(labels), None)

    (ref, (ref_parts, new_stats)), grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(params)
    ours, parts = DiffusionSegmentor.head_loss(types.SimpleNamespace(head=pm), pargs[0],
                                               torch.from_numpy(labels))
    ours.backward()
    for k, v in ref_parts.items():
        assert abs(float(parts[k].detach()) - float(v)) < VALUE_TOL * abs(float(v)), k
    assert set(parts) == set(ref_parts)
    assert_grads_close({k: p.grad.numpy() for k, p in pm.named_parameters()},
                       {k: v.numpy() for k, v in seg_head_from_jax(
                           jax.tree.map(np.asarray, grads['head'])).items()}, 'head_loss grads')
    running = {k: v for k, v in seg_head_from_jax(params['head'], new_stats).items()
               if 'running' in k}
    _close_tree({k: pm.state_dict()[k] for k in running}, running, VALUE_TOL, 'batch stats')

    # a rate and a decay large enough that each part of the update stands
    # far above fp32 rounding of the parameters (the trainer's defaults are
    # 1.6e-4 and 1e-3)
    lr, wd, iters = 1e-2, 0.5, 10
    opt = optax.adamw(optax.polynomial_schedule(init_value=lr, end_value=1e-4, power=0.9,
                                                transition_steps=iters), weight_decay=wd)
    opt_state = opt.init(params)
    torch_opt, sched = trainer.make_optimizer(pm.parameters(), lr, wd, iters)
    jp = params
    start = {k: p.detach().clone() for k, p in pm.named_parameters()}
    ref_start = seg_head_from_jax(jax.tree.map(np.asarray, params['head']))
    # both optimisers step on the same gradients, JAX's: a conv bias that
    # feeds a training-mode BN has a gradient of fp32 noise, which Adam's
    # normalisation would turn into a full-size step of either sign
    grads = jax.tree.map(lambda g: g * 0.5 + 1e-3, grads)
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    for step in range(2):
        if step:
            grads = jax.tree.map(lambda g: g * 0.5 + 1e-3, grads)
        for k, g in seg_head_from_jax(jax.tree.map(np.asarray, grads['head'])).items():
            pm.get_parameter(k).grad = g.clone()
        updates, opt_state = update(grads, opt_state, jp)
        jp = jax.tree.map(lambda a, b: np.asarray(a + b), jp, updates)
        torch_opt.step()
        sched.step()
        # the updates so far, parameter by parameter
        ref_p = seg_head_from_jax(jax.tree.map(np.asarray, jp['head']))
        for k, p in pm.named_parameters():
            assert _rel_l2((p.detach() - start[k]).numpy(),
                           (ref_p[k] - ref_start[k]).numpy()) < VALUE_TOL, (step, k)
    assert trainer.poly_rate(1, lr, iters) == pytest.approx(
        float(optax.polynomial_schedule(lr, 1e-4, 0.9, iters)(1)), rel=1e-6)


def test_slide_inference_and_compute_iou_match_jax():
    """The windows, sums and visit counts of ``slide_inference`` (both
    segmentors' ``predict_logits`` replaced by one deterministic function of
    the crop, with overlapping and ragged windows), then ``compute_iou``
    against JAX's on the argmax with ignored labels."""
    b, h, w, crop, stride = 1, 40, 52, (24, 24), (16, 20)
    images = _rand(50, b, 3, h, w)
    proj = _rand(51, CLASSES, 3)

    def logits_np(crop_img):
        x = np.asarray(crop_img)
        return np.einsum('kc,bchw->bkhw', proj, x) + x.shape[-1] * 0.01

    jseg = types.SimpleNamespace(head=types.SimpleNamespace(num_classes=CLASSES),
                                 predict_logits=lambda p, s, c: jnp.asarray(logits_np(c)))
    ref = jax_segmentor.DiffusionSegmentor.slide_inference(jseg, None, None,
                                                           jnp.asarray(images), crop, stride)
    pseg = types.SimpleNamespace(head=types.SimpleNamespace(num_classes=CLASSES),
                                 device=torch.device('cpu'),
                                 predict_logits=lambda c: torch.from_numpy(logits_np(c)))
    ours = DiffusionSegmentor.slide_inference(pseg, torch.from_numpy(images), crop, stride)
    assert _rel_l2(ours.numpy(), ref) < VALUE_TOL
    preds = [ours.argmax(1)[0].numpy(), np.random.RandomState(52).randint(0, CLASSES, (h, w))]
    gts = [np.random.RandomState(53 + i).randint(0, CLASSES, (h, w)) for i in range(2)]
    gts[0][:5] = 255
    got, ref_iou = compute_iou(preds, gts, CLASSES, 255), jax_compute_iou(preds, gts, CLASSES, 255)
    assert got[0] == ref_iou[0] and got[1] == pytest.approx(ref_iou[1], abs=1e-12)


# ------------------------------------------------- the segmentor on test-sd
# (its prompt-tuning loss against JAX's is in tests/test_torch_segmentor.py)
SEG_SIZE = 64
SEG_LAYERS = {'up-level0-repeat1-res-out': True, 'up-level1-repeat0-vit-block0-cross-q': True}
SEG_FEATURE_LAYERS = [[('up-level0-repeat1-res-out', 64)],
                      [('up-level1-repeat0-vit-block0-cross-q', 32)]]
SEG_DF = {'layer': SEG_LAYERS, 'version': 'test-sd', 'attention': None, 'img_size': SEG_SIZE,
          't': 50}


def test_prompt_tuning_with_an_ensemble_is_refused():
    with pytest.raises(NotImplementedError, match='multi-model ensemble'):
        DiffusionSegmentor([SEG_DF, SEG_DF], [SEG_FEATURE_LAYERS] * 2, prompt_tuning=True,
                           device='cpu')


def _write_pairs(root, n, size=(40, 48)):
    from PIL import Image
    rs = np.random.RandomState(11)
    (root / 'imgs').mkdir()
    (root / 'labels').mkdir()
    for i in range(n):
        Image.fromarray(rs.randint(0, 256, size + (3,), np.uint8)).save(root / f'imgs/p{i}.png')
        Image.fromarray(rs.randint(0, CLASSES, size).astype(np.uint8)).save(
            root / f'labels/p{i}.png')


def test_trainer_cli_trains_checkpoints_and_resumes(tmp_path):
    """The port's trainer on --device cpu over synthetic pairs: two
    iterations, a val pass with slide inference, a checkpoint, then
    --resume --eval_only scoring it with the same mIoU; the data pipeline
    (list_pairs, load_pair with the same random draws) against the JAX
    trainer's; --dp 2 without a launched group of two ranks is refused."""
    _write_pairs(tmp_path, 3)
    cfg = {'diffusion_feature': {**SEG_DF, 't': [50, 100]},
           'feature_layers': [[list(x) for x in lvl] for lvl in SEG_FEATURE_LAYERS],
           'num_classes': CLASSES, 'head_channels': CHANNELS, 'pool_scales': [1, 2],
           'prompt': 'a photo', 'crop_size': [32, 32], 'stride': [24, 24]}
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    base = ['--config', str(tmp_path / 'cfg.json'), '--train_img_dir', str(tmp_path / 'imgs'),
            '--train_label_dir', str(tmp_path / 'labels'), '--val_img_dir',
            str(tmp_path / 'imgs'), '--val_label_dir', str(tmp_path / 'labels'),
            '--work_dir', str(tmp_path / 'out'), '--max_iters', '2', '--device', 'cpu',
            '--reduce_zero_label']
    pairs = trainer.list_pairs(str(tmp_path / 'imgs'), str(tmp_path / 'labels'))
    assert pairs == jax_trainer.list_pairs(str(tmp_path / 'imgs'), str(tmp_path / 'labels'))
    for train in (True, False):
        ours = trainer.load_pair(*pairs[0], (32, 32), random.Random(3), train, True)
        ref = jax_trainer.load_pair(*pairs[0], (32, 32), random.Random(3), train, True)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)
    run = trainer.main(base)
    assert len(run['losses']) == 2 and all(np.isfinite(run['losses']))
    assert [it for it, _ in run['miou']] == [2]
    assert (tmp_path / 'out' / 'iter_2.pt').exists()
    again = trainer.main(base + ['--resume', str(tmp_path / 'out' / 'iter_2.pt'), '--eval_only'])
    assert again['miou'] == run['miou']
    for k, v in run['seg'].state_dict().items():
        assert torch.equal(again['seg'].state_dict()[k], v), k
    with pytest.raises(ValueError, match='torchrun'):
        trainer.main(base + ['--dp', '2'])
