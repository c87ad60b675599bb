"""SPair correspondence in the PyTorch port against the JAX package, at fp32
on the CPU: every helper of ``tasks/correspondence/utils.py`` (points,
PCK, cosine similarities, the nearest-neighbour matchers, the best-buddies
and cyclical matchers on clustered descriptors with scikit-learn's k-means
in JAX and the port's own, the drawing, the annotation loader); a
two-extractor ``AggregationNetwork`` on ``test-sd`` at 64^2 (its extract,
its conv with the JAX kernel carried across, ``clip_loss`` and its
gradient); one AdamW update against optax; and the port's
``task_corres.main`` for two steps, a validation and a resume.

Tolerances: 1e-5 for the helpers, points exactly; the extract within 1e-4
relative L2; ``clip_loss`` within 1e-4 (relative) and its gradient within
1e-3 max-relative error.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax
from sklearn.cluster import KMeans

import task_corres as jax_task_corres
from diffusion_feature_tpu.tasks.correspondence import aggregation as jax_aggregation
from diffusion_feature_tpu.tasks.correspondence import utils as jax_utils
from diffusion_feature_tpu_torch import task_corres
from diffusion_feature_tpu_torch.io.images import preprocess_pil_batch
from diffusion_feature_tpu_torch.tasks.correspondence import aggregation, utils
from port_parity import jax_facade, jax_noise, load_jax_params

TOL, EXTRACT_TOL, VALUE_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4, 1e-3
CONFIGS = [
    {'feature_len': 32, 'layer': {'up-level1-repeat0-res-out': True}, 'version': 'test-sd',
     'attention': None, 'img_size': 64, 't': 50, 'dtype': 'float32'},
    {'feature_len': 32, 'layer': {'up-level1-repeat0-res-out': True}, 'version': 'test-sd',
     'attention': None, 'img_size': 64, 't': 100, 'dtype': 'float32'},
]
OUT = (16, 16)


def _rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def _image(seed, size=(80, 60)):
    rng = np.random.RandomState(seed)
    return Image.fromarray((rng.rand(size[1], size[0], 3) * 255).astype('uint8'))


# ------------------------------------------------------------------ helpers

def test_point_helpers_match():
    rng = np.random.RandomState(0)
    pts = rng.rand(9, 2) * 600 - 40                      # some outside the image
    for old, new in (((500, 375), (512, 512)), ((512, 512), (128, 128))):
        np.testing.assert_array_equal(utils.rescale_points(pts, old, new),
                                      jax_utils.rescale_points(pts, old, new))
    for size in ((512, 512), (128, 96)):
        np.testing.assert_array_equal(utils.points_to_idxs(pts, size),
                                      jax_utils.points_to_idxs(pts, size))
        np.testing.assert_array_equal(utils.points_to_patches(pts, 32, size),
                                      jax_utils.points_to_patches(pts, 32, size))
    pred = pts + rng.randn(9, 2) * 30
    for bbox in (None, (10, 20, 200, 120)):
        ours = utils.compute_pck(pred, pts, (500, 375), target_bounding_box=bbox)
        ref = jax_utils.compute_pck(pred, pts, (500, 375), target_bounding_box=bbox)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('flatten,normalize', [(True, True), (True, False), (False, True)])
def test_batch_cosine_sim_matches(flatten, normalize):
    rng = np.random.RandomState(1)
    shape = (2, 6, 5, 4) if flatten else (2, 20, 6)
    a, b = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    ours = utils.batch_cosine_sim(torch.from_numpy(a), torch.from_numpy(b), flatten, normalize)
    ref = jax_utils.batch_cosine_sim(jnp.asarray(a), jnp.asarray(b), flatten, normalize)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    step = utils.flatten_feats if flatten else utils.normalize_feats
    jax_step = jax_utils.flatten_feats if flatten else jax_utils.normalize_feats
    np.testing.assert_allclose(step(torch.from_numpy(a)).numpy(), np.asarray(jax_step(a)),
                               atol=TOL, rtol=TOL)


def test_chunk_cosine_sim_matches_with_a_zero_descriptor():
    rng = np.random.RandomState(2)
    a, b = rng.randn(2, 1, 12, 7).astype(np.float32), rng.randn(2, 1, 9, 7).astype(np.float32)
    a[0, 0, 3] = 0.0
    ours = utils.chunk_cosine_sim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_utils.chunk_cosine_sim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)
    assert not ours[0, 0, 3].any()


@pytest.mark.parametrize('grid,load', [(16, (64, 64)), (8, (48, 48))])
def test_find_nn_source_correspondences_matches(grid, load):
    """The features upsampled to the load size (jax.image.resize's bilinear
    on both sides), the source rows' argmax over the target: points
    exactly."""
    rng = np.random.RandomState(3)
    f1, f2 = (rng.randn(1, 8, grid, grid).astype(np.float32) for _ in range(2))
    sp = rng.rand(7, 2) * (load[0] + 10) - 5
    src, pred = utils.find_nn_source_correspondences(torch.from_numpy(f1), torch.from_numpy(f2),
                                                     sp, (grid, grid), load)
    ref_src, ref_pred = jax_utils.find_nn_source_correspondences(
        jnp.asarray(f1), jnp.asarray(f2), sp, (grid, grid), load)
    np.testing.assert_array_equal(src.numpy(), np.asarray(ref_src))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref_pred))


def test_find_nn_correspondences_matches():
    sims = np.random.RandomState(4).randn(2, 16, 16).astype(np.float32)
    ours = utils.find_nn_correspondences(torch.from_numpy(sims))
    ref = jax_utils.find_nn_correspondences(jnp.asarray(sims))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _clustered(t=64, d=16, k=6, seed=5):
    """(1, 1, t, d) descriptors, each its cluster's centre (one of ``k``,
    far apart) plus a little noise; the cluster of each point."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(k, d) * 4
    which = np.arange(t) % k
    rng.shuffle(which)
    desc = centres[which] + rng.randn(t, d) * 0.05
    return desc.astype(np.float32)[None, None], which


def test_kmeans_finds_the_partition_of_separated_clusters():
    """The port's k-means and scikit-learn's (the JAX package's) agree on
    the partition and its inertia; the cluster numbering may differ."""
    desc, which = _clustered()
    x = desc[0, 0].astype(np.float64)
    labels, centres, inertia = utils.kmeans(x, 6)
    ref = KMeans(n_clusters=6, random_state=0, n_init=10).fit(x)
    same = labels[:, None] == labels[None]
    np.testing.assert_array_equal(same, ref.labels_[:, None] == ref.labels_[None])
    np.testing.assert_array_equal(same, which[:, None] == which[None])
    assert abs(inertia - ref.inertia_) <= 1e-6 * ref.inertia_
    assert centres.shape == (6, 16)


def _rows(points):
    return sorted(map(tuple, np.asarray(points).tolist()))


def test_best_buddies_matches_on_clustered_descriptors():
    """Image 2 holds image 1's descriptors in another order (every point a
    best buddy), a few points under the saliency threshold; one pick per
    cluster, the most salient: the same rows as JAX's, in cluster order."""
    desc1, _ = _clustered()
    rng = np.random.RandomState(6)
    perm = rng.permutation(64)
    desc2 = desc1[:, :, perm]
    sal1, sal2 = rng.rand(1, 64).astype(np.float32), rng.rand(1, 64).astype(np.float32)
    sal1[0, :5] = 0.01
    ours = utils.find_best_buddies_correspondences(torch.from_numpy(desc1), desc2, sal1, sal2,
                                                   num_pairs=6)
    ref = jax_utils.find_best_buddies_correspondences(desc1, desc2, sal1, sal2, num_pairs=6)
    assert len(ours[0]) == 6
    pairs = sorted(zip(map(tuple, ours[0].tolist()), map(tuple, ours[1].tolist())))
    assert pairs == sorted(zip(map(tuple, ref[0].tolist()), map(tuple, ref[1].tolist())))
    empty = utils.find_best_buddies_correspondences(desc1, desc2, sal1 * 0, sal2 * 0)
    assert empty[0].shape == (0, 2)


def test_cyclical_matches_on_clustered_descriptors():
    """Identical images with 12 salient points off row and column 0 (the
    cycle's sentinel), two in each of 6 clusters: the 12 are the top
    cycle-consistent points, k-means pairs them, and each cluster keeps its
    more salient point."""
    rng = np.random.RandomState(7)
    centres = rng.randn(6, 16) * 4
    desc = rng.randn(64, 16) * 4
    fg = np.array([9, 12, 18, 21, 27, 30, 36, 41, 45, 50, 54, 63])
    desc[fg] = centres[np.arange(12) % 6] + rng.randn(12, 16) * 0.05
    desc = desc.astype(np.float32)[None, None]
    sal = np.zeros((1, 64), np.float32)
    sal[0, fg] = rng.rand(12) * 0.9 + 0.1
    ours = utils.find_cyclical_correspondences(desc, desc, sal, sal, num_pairs=6)
    ref = jax_utils.find_cyclical_correspondences(desc, desc, sal, sal, num_pairs=6)
    assert ours[0].shape == (6, 2)
    assert _rows(ours[0]) == _rows(ref[0]) and _rows(ours[1]) == _rows(ref[1])


def test_draw_correspondences_writes_the_same_png(tmp_path):
    rng = np.random.RandomState(8)
    sp, tp = rng.rand(10, 2) * 60, rng.rand(10, 2) * 50
    for title in ('', 'cat 0.7'):
        a = utils.draw_correspondences(torch.from_numpy(sp), tp, _image(1), _image(2, (50, 70)),
                                       str(tmp_path / 'ours.png'), title=title)
        b = jax_utils.draw_correspondences(sp, tp, _image(1), _image(2, (50, 70)),
                                           str(tmp_path / 'ref.png'), title=title)
        assert open(a, 'rb').read() == open(b, 'rb').read()


def _write_pairs(root, n_pairs, seed=9, points=10):
    """SPair-style pairs of unequal image sizes under ``root`` and their
    annotations: ~``points`` (x, y) points per image, a category and the
    target's bounding box."""
    rng = np.random.RandomState(seed)
    anns = []
    for i in range(n_pairs):
        sizes = [(500, 375), (375, 500)] if i % 2 == 0 else [(333, 500), (500, 400)]
        names = []
        for j, (w, h) in enumerate(sizes):
            names.append(f'pair{i}_{j}.jpg')
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                os.path.join(root, names[-1]))
        (sw, sh), (tw, th) = sizes
        anns.append({'source_path': names[0], 'target_path': names[1], 'category': 'cat',
                     'source_points': (rng.rand(points, 2) * [sw, sh]).round(1).tolist(),
                     'target_points': (rng.rand(points, 2) * [tw, th]).round(1).tolist(),
                     'target_bounding_box': [10, 20, tw - 30, th - 10]})
    return anns


def test_load_annotation_matches(tmp_path):
    (ann,) = _write_pairs(str(tmp_path), 1)
    ours_ann, ref_ann = json.loads(json.dumps(ann)), json.loads(json.dumps(ann))
    ours = utils.load_annotation(ours_ann, (512, 512), str(tmp_path))
    ref = jax_utils.load_annotation(ref_ann, (512, 512), str(tmp_path))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert ours_ann == ref_ann and ours_ann['target_size'] == (375, 500)


# --------------------------------------------------- the aggregation network

@pytest.fixture(scope='module')
def nets():
    """(JAX network, port network, JAX features, port features) of two
    images.  The JAX network's two extractors (one tap, t=50 and t=100) are
    one test-sd facade, whose noise each extract draws in turn; the port's
    are two extractors with its parameters, their steps fed those draws in
    the same order.  The JAX network takes the port's prompt embeddings
    (the text encoders' parity is tests/test_torch_sd15.py's): no CLIP
    compile."""
    jfe = jax_facade(CONFIGS[0]['layer'], 'test-sd', 64, seed=0)
    params = dict(jfe.params)
    calls = [0]
    port_fe = aggregation.FeatureExtractor

    def port_extractor(**kw):
        fe = port_fe(**kw)
        load_jax_params(types.SimpleNamespace(params=params), fe)
        fe.feature_dtype = None

        def injected(prompts, batch_size, image, t=50):
            img = torch.as_tensor(preprocess_pil_batch(image, fe.img_size)).to(fe.dtype)
            noise = jax_noise(0, fe.latent_shape(batch_size), calls[0])
            calls[0] += 1
            return fe._step(img, fe._step_conditioning(prompts, batch_size), fe._step_kit(t),
                            *noise, fe.feature_dtype)

        fe.extract = injected
        return fe

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aggregation, 'FeatureExtractor', port_extractor)
        net = aggregation.AggregationNetwork(CONFIGS, output_size=OUT, device='cpu')
        prompts = tuple(None if p is None else jnp.asarray(p.numpy())
                        for p in net.extractors[0]['prompt_embeds'])
        mp.setattr(jfe, 'encode_prompt', lambda prompt: prompts)
        mp.setattr(jax_aggregation, 'FeatureExtractor', lambda **_: jfe)
        jnet = jax_aggregation.AggregationNetwork(CONFIGS, output_size=OUT)
    images = [_image(1), _image(2, (50, 70))]
    jfeats = [np.array(jnet.extract(im)) for im in images]
    feats = [net.extract(im) for im in images]
    return jnet, net, jfeats, feats


def test_extract_matches(nets):
    """Both extractors' layers in sorted order, each resized to 16^2, fp32,
    frozen: within 1e-4 relative L2 of the JAX network's."""
    jnet, net, jfeats, feats = nets
    assert net.feature_dim == 64 and net.out_dim == 32 and net.extractors[1]['t'] == 100
    assert all(ex['model'].text_encoders == () for ex in net.extractors)
    for ours, ref in zip(feats, jfeats):
        assert ours.shape == (1, 64, 16, 16) and ours.dtype == torch.float32
        assert not ours.requires_grad
        assert _rel_l2(ours.numpy(), ref) < EXTRACT_TOL


def test_conv_matches_with_the_kernel_carried_across(nets):
    """The JAX ``init_params`` kernel loaded (HWIO -> OIHW): ``forward`` is
    JAX's ``apply``; with ``algorithm='nn'`` it hands the features back."""
    jnet, net, jfeats, _ = nets
    params = jnet.init_params()
    net.load_state_dict(aggregation.aggregation_params_from_jax(params))
    with torch.no_grad():
        ours = net(torch.from_numpy(jfeats[0]))
    ref = jnet.apply(params, jnp.asarray(jfeats[0]))
    assert ours.shape == (1, 32, 16, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    net.do_conv = False
    try:
        x = torch.from_numpy(jfeats[0])
        assert net(x) is x
    finally:
        net.do_conv = True


def test_params_round_trip_and_init_distribution(nets):
    """``aggregation_params_from_jax`` and back gives the JAX kernel; the
    port's own init is JAX's he_normal (truncated at 2 sigma) from its
    seed."""
    jnet, net, _, _ = nets
    kernel = np.asarray(jnet.init_params()['out_kernel'])
    weight = aggregation.aggregation_params_from_jax({'out_kernel': kernel})['conv.weight']
    np.testing.assert_array_equal(weight.numpy().transpose(2, 3, 1, 0), kernel)
    net.reset_parameters(3)
    w = net.conv.weight.detach().numpy().copy()
    std = (2 / (64 * 9)) ** 0.5
    assert np.abs(w).max() <= 2 * std / 0.87962566 + 1e-6
    assert abs(w.std() / std - 1) < 0.05
    net.reset_parameters(3)
    np.testing.assert_array_equal(net.conv.weight.detach().numpy(), w)
    assert [n for n, _ in net.named_parameters()] == ['conv.weight']


def test_clip_loss_and_gradient_match(nets):
    """The bidirectional CE over the annotated rows only against the JAX
    loss over the full similarity matrices, on the same features, and the
    conv kernel's gradient (OIHW back to HWIO) against ``jax.grad``."""
    jnet, net, jfeats, _ = nets
    params = {'out_kernel': jnp.asarray(np.random.RandomState(10).randn(3, 3, 64, 32)
                                        .astype(np.float32) * 0.05)}
    net.load_state_dict(aggregation.aggregation_params_from_jax(params))
    src = np.array([5, 100, 131, 255, 17], np.int64)
    tgt = np.array([6, 101, 200, 3, 17], np.int64)
    grad_fn = jax.jit(jax.value_and_grad(jax_task_corres.clip_loss), static_argnums=(1,))
    ref, grads = grad_fn(
        params, jnet, jnp.asarray(jfeats[0]), jnp.asarray(jfeats[1]),
        jnp.asarray(src, jnp.int32), jnp.asarray(tgt, jnp.int32))
    net.zero_grad()
    loss = task_corres.clip_loss(net, torch.from_numpy(jfeats[0]), torch.from_numpy(jfeats[1]),
                                 torch.from_numpy(src), torch.from_numpy(tgt))
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= VALUE_TOL * abs(float(ref))
    g = net.conv.weight.grad.numpy().transpose(2, 3, 1, 0)
    r = np.asarray(grads['out_kernel'])
    assert np.abs(r).max() > 0
    assert float(np.abs(g - r).max() / np.abs(r).max()) < GRAD_TOL


def test_adamw_update_matches_optax(nets):
    """Two steps of ``make_optimizer`` (torch AdamW, wd 0.01, eps 1e-8)
    against optax's ``adamw``: bias correction and the decoupled decay."""
    _, net, _, _ = nets
    rng = np.random.RandomState(11)
    w0 = rng.randn(32, 64, 3, 3).astype(np.float32) * 0.05
    with torch.no_grad():
        net.conv.weight.copy_(torch.from_numpy(w0))
    opt = task_corres.make_optimizer(net, 5e-4)
    tx = optax.adamw(5e-4, weight_decay=0.01)
    p = jnp.asarray(w0)
    state = tx.init(p)
    for _ in range(2):
        g = rng.randn(*w0.shape).astype(np.float32)
        net.conv.weight.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
    np.testing.assert_allclose(net.conv.weight.detach().numpy(), np.asarray(p),
                               atol=1e-7, rtol=1e-6)


# ------------------------------------------------------------------ the CLI

def test_task_corres_main_trains_validates_and_resumes(tmp_path, capsys):
    root = str(tmp_path)
    anns = _write_pairs(root, 3, points=5)
    paths = {}
    for name, obj in (('train', anns[:2]), ('val', anns[2:]), ('config', CONFIGS[:1])):
        paths[name] = os.path.join(root, f'{name}.json')
        with open(paths[name], 'w') as f:
            json.dump(obj, f)
    out = os.path.join(root, 'out')

    def argv(steps, *more):
        return ['--config', paths['config'], '--train_anns', paths['train'], '--val_anns',
                paths['val'], '--dataset_path', root, '--task_path', out, '--max_steps',
                str(steps), '--val_every', '2', '--device', 'cpu', *more]

    res = task_corres.main(argv(2))
    assert len(res['losses']) == 2 and all(np.isfinite(res['losses']))
    (step, pck_img, pck_bbox), = res['pck']
    assert step == 2 and 0 <= pck_img <= 1 and 0 <= pck_bbox <= 1
    ckpt = os.path.join(out, 'checkpoint_step_2.pt')
    saved = torch.load(ckpt, weights_only=True)
    assert saved['step'] == 2 and saved['config'] == CONFIGS[:1]
    torch.testing.assert_close(saved['params']['conv.weight'], res['net'].conv.weight.detach())
    again = task_corres.main(argv(3, '--load_weight', ckpt))
    assert again['start_step'] == 2 and len(again['losses']) == 1
    opt = again['optimizer']
    assert int(opt.state[again['net'].conv.weight]['step']) == 3
    log = open(os.path.join(out, 'log.txt')).read()
    assert 'step 0: loss' in log and 'val/pck_img' in log
    assert 'step 0: loss' in capsys.readouterr().out
