"""The label-scarce task in the PyTorch port against the JAX package, at fp32
on the CPU: the dataset settings, palettes, class names, splits, labels and
colourised masks; ``PixelClassifier`` in training and evaluation mode
(Flax's BatchNorm on (N, C) rows); ``train_one`` over two epochs and with
early stopping from the same initial parameters; ``predict_labels`` on a
3-member ensemble; the native ``AsyncNpyReader``; and the port's
``task_pixel.main`` end to end on tiny dumps, then again on its member
checkpoints, and with a training matrix too large for the device's room.

Tolerances: 1e-5 for a forward, the running statistics and the
uncertainty; 1e-4 relative L2 for parameters after training; labels and
bytes exactly.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import port_parity  # noqa: F401  (one intra-op thread)
from diffusion_feature_tpu.tasks.scarce import data as jax_data
from diffusion_feature_tpu.tasks.scarce import pixel_classifier as jax_pc
from diffusion_feature_tpu_torch import task_pixel
from diffusion_feature_tpu_torch.native import AsyncNpyReader, native_reader_available
from diffusion_feature_tpu_torch.tasks.scarce import data, pixel_classifier
from diffusion_feature_tpu_torch.tasks.scarce.pixel_classifier import (
    PixelClassifier, pixel_classifier_from_jax, predict_labels, train_one,
)

TOL, PARAM_TOL = 1e-5, 1e-4
CATEGORIES = sorted(jax_data.DATASET_SETTINGS)


def _rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize('category', CATEGORIES)
def test_dataset_setting_palette_and_names_match(category):
    assert data.get_dataset_setting(category) == jax_data.get_dataset_setting(category)
    np.testing.assert_array_equal(data.get_palette(category), jax_data.get_palette(category))
    assert data.get_class_names(category) == jax_data.get_class_names(category)
    assert len(data.get_class_names(category)) == data.get_dataset_setting(category)[
        'number_class']


def test_unknown_dataset_and_palette_fallback_match():
    with pytest.raises(KeyError):
        data.get_dataset_setting('nope_3')
    assert data.get_dataset_setting('bedroom_28')['number_class'] == 29   # the reference's quirk
    for n in (1, 5, 40):
        np.testing.assert_array_equal(data.get_palette(n), jax_data.get_palette(n))


def test_splits_labels_and_masks_match(tmp_path):
    imgs, labs = [f'i{k}' for k in range(11)], [f'l{k}' for k in range(11)]
    for seed in (0, 3):
        assert data.shuffle_split(imgs, labs, 4, seed) == jax_data.shuffle_split(imgs, labs, 4,
                                                                                 seed)
    rng = np.random.RandomState(0)
    lab = rng.randint(0, 21, (24, 20)).astype(np.uint8)
    Image.fromarray(lab).save(tmp_path / 'gray.png')
    Image.fromarray(np.stack([lab] * 3, -1)).save(tmp_path / 'rgb.png')
    np.save(tmp_path / 'lab.npy', lab.astype(np.int64))
    for name in ('gray.png', 'rgb.png', 'lab.npy'):
        for size in ((24, 20), (16, 12)):
            ours = data.load_label(str(tmp_path / name), size)
            ref = jax_data.load_label(str(tmp_path / name), size)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
    mask = rng.randint(-2, 30, (9, 7))
    for pal in (data.get_palette('horse_21'), data.get_palette(5)):
        np.testing.assert_array_equal(data.colorize_mask(mask, pal),
                                      jax_data.colorize_mask(mask, pal))


def test_feature_label_pairs_and_saved_predictions_match(tmp_path):
    feats, labs = tmp_path / 'f', tmp_path / 'l'
    feats.mkdir(), labs.mkdir()
    for stem, ext in (('a', '.png'), ('b', '.npy'), ('c', None), ('d', '.bmp')):
        np.save(feats / f'{stem}.npy', np.zeros((2, 2, 2), np.float16))
        if ext == '.npy':
            np.save(labs / f'{stem}.npy', np.zeros((2, 2), np.int32))
        elif ext is not None:
            Image.fromarray(np.zeros((2, 2), np.uint8)).save(labs / f'{stem}{ext}')
    assert data.list_feature_label_pairs(str(feats), str(labs)) == \
        jax_data.list_feature_label_pairs(str(feats), str(labs))
    preds = [np.random.RandomState(i).randint(0, 21, (8, 6)) for i in range(2)]
    ours = data.save_predictions(preds, str(tmp_path / 'ours'), 'horse_21', ['x', 'y'])
    ref = jax_data.save_predictions(preds, str(tmp_path / 'ref'), 'horse_21', ['x', 'y'])
    assert ours == ref
    for sub in ('predictions', 'visualizations'):
        for name in ('x', 'y'):
            assert (tmp_path / 'ours' / sub / f'{name}.png').read_bytes() == \
                (tmp_path / 'ref' / sub / f'{name}.png').read_bytes()


def _jax_variables(num_classes, dim, seed):
    """A JAX member's Flax init (what ``train_one`` starts from), with the
    BatchNorm statistics and scales redrawn so evaluation mode has signal."""
    model = jax_pc.PixelClassifier(num_classes=num_classes)
    init = jax.jit(lambda rng: model.init(rng, jnp.zeros((2, dim)), train=True))
    variables = init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, {'params': variables['params'],
                                     'batch_stats': variables['batch_stats']})


def _perturbed(variables, seed):
    rs = np.random.RandomState(seed)
    out = jax.tree.map(lambda v: v + rs.randn(*v.shape).astype(np.float32) * 0.1, variables)
    out['batch_stats'] = jax.tree.map(lambda v: np.abs(v) + 0.5, out['batch_stats'])
    return out


@pytest.mark.parametrize('num_classes', [21, 34], ids=['narrow', 'wide'])
def test_pixel_classifier_matches(num_classes):
    """Evaluation mode on the running statistics, then one training-mode
    forward: the logits and the running statistics it moves (Flax's
    momentum 0.99 and biased variance)."""
    dim = 12
    variables = _perturbed(_jax_variables(num_classes, dim, 0), 1)
    x = np.random.RandomState(2).randn(40, dim).astype(np.float32)
    model = jax_pc.PixelClassifier(num_classes=num_classes)
    ours = PixelClassifier.from_state_dict(pixel_classifier_from_jax(variables))
    assert (ours.dense_0.out_features, ours.dense_1.out_features) == \
        ((128, 32) if num_classes < 30 else (256, 128))
    ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    ref, updates = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=['batch_stats']))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    stats = pixel_classifier_from_jax({'params': variables['params'],
                                       'batch_stats': jax.tree.map(np.asarray,
                                                                   updates['batch_stats'])})
    for key in ('bn_0.running_mean', 'bn_0.running_var', 'bn_1.running_mean',
                'bn_1.running_var'):
        np.testing.assert_allclose(ours.state_dict()[key].numpy(), stats[key].numpy(),
                                   atol=TOL, rtol=TOL)


def test_pixel_classifier_from_jax_round_trip():
    """Every Flax leaf lands in one state-dict entry and comes back
    unchanged (kernels transposed back, ``scale`` from ``weight``)."""
    variables = _perturbed(_jax_variables(34, 7, 2), 3)
    state = PixelClassifier.from_state_dict(pixel_classifier_from_jax(variables)).state_dict()
    back = {'params': {}, 'batch_stats': {}}
    for name in ('dense_0', 'dense_1', 'out'):
        back['params'][name] = {'kernel': state[f'{name}.weight'].numpy().T,
                                'bias': state[f'{name}.bias'].numpy()}
    for bn in ('bn_0', 'bn_1'):
        back['params'][bn] = {'scale': state[f'{bn}.weight'].numpy(),
                              'bias': state[f'{bn}.bias'].numpy()}
        back['batch_stats'][bn] = {'mean': state[f'{bn}.running_mean'].numpy(),
                                   'var': state[f'{bn}.running_var'].numpy()}
    flat = jax.tree_util.tree_leaves_with_path
    want, got = dict(flat(variables)), dict(flat(back))
    assert want.keys() == got.keys()
    for path, val in want.items():
        np.testing.assert_array_equal(got[path], val, err_msg=str(path))


def test_pixel_classifier_init_draws_flax_lecun_normal():
    """Kernels: truncated at 2 sigma, std sqrt(1/fan_in); biases 0; the
    same seed gives the same draw."""
    a = PixelClassifier(21, 400, torch.Generator().manual_seed(3))
    b = PixelClassifier(21, 400, torch.Generator().manual_seed(3))
    w = a.dense_0.weight.detach().numpy()
    assert np.abs(w).max() <= 2 * (1 / 400) ** 0.5 / 0.87962566 + 1e-7
    assert abs(w.std() * 400 ** 0.5 - 1.0) < 0.03
    assert not a.dense_0.bias.detach().any()
    torch.testing.assert_close(a.state_dict(), b.state_dict())


def _separable(n, dim, classes, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    x = rng.randn(n, dim).astype(np.float32) * 0.5
    x[:, :classes] += np.eye(classes, dtype=np.float32)[y] * 2.0
    return x, y


@pytest.mark.parametrize('kw', [dict(max_epochs=2),
                                dict(max_epochs=4, warmup_epochs=0, patience=1)],
                         ids=['two-epochs', 'early-stop'])
def test_train_one_matches(kw):
    """The same initial parameters (the JAX member's init from its seed),
    the same batches (``RandomState(seed)``), Adam: the trained parameters
    and running statistics within 1e-4 relative L2 of the JAX member's."""
    x, y = _separable(320, 10, 5, 4)
    seed = 7
    ref = jax_pc.train_one(x, y, 5, seed=seed, batch_size=64, **kw)
    init = pixel_classifier_from_jax(_jax_variables(5, 10, seed))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pixel_classifier, 'PixelClassifier',
                   lambda *a, **k: PixelClassifier.from_state_dict(init))
        ours = train_one(x, y, 5, seed=seed, batch_size=64, device='cpu', **kw)
    want = pixel_classifier_from_jax(jax.tree.map(np.asarray, ref))
    got = ours.state_dict()
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert _rel_l2(got[key].numpy(), val.numpy()) < PARAM_TOL, key
    assert not ours.training


def test_predict_labels_matches():
    """A 3-member ensemble: the majority-vote labels exactly, the top-10%
    JS uncertainty within 1e-5."""
    variables = [_perturbed(_jax_variables(6, 9, s), 10 + s) for s in range(3)]
    feats = np.random.RandomState(5).randn(12 * 10, 9).astype(np.float32) * 2
    ref_pred, ref_u = jax_pc.predict_labels(variables, jnp.asarray(feats), (12, 10), 6)
    ensemble = [PixelClassifier.from_state_dict(pixel_classifier_from_jax(v)).eval()
                for v in variables]
    pred, u = predict_labels(ensemble, torch.from_numpy(feats), (12, 10), 6)
    assert pred.shape == (12, 10)
    np.testing.assert_array_equal(pred, np.asarray(ref_pred))
    assert abs(u - ref_u) <= TOL * max(1.0, abs(ref_u))


def test_predict_labels_ties_go_to_the_lowest_class():
    """Two members, each voting for another class: the lower id wins."""
    members = []
    for cls in (4, 1):
        m = PixelClassifier(6, 3).eval()
        with torch.no_grad():
            m.out.weight.zero_()
            m.out.bias.zero_()
            m.out.bias[cls] = 5.0
        members.append(m)
    pred, u = predict_labels(members, torch.randn(20, 3), (20,), 6)
    assert (pred == 1).all() and np.isfinite(u)


# ------------------------------------------------------------ native reader

def test_native_reader_builds():
    assert native_reader_available(), 'g++ expected'


@pytest.mark.parametrize('dtype,order', [
    (np.float32, 'C'), (np.float16, 'C'), (np.uint8, 'C'), (np.int64, 'C'), (np.float32, 'F'),
])
def test_reader_round_trip_matches_np_load(tmp_path, dtype, order):
    arr = np.asarray((np.random.RandomState(3).rand(4, 6, 5) * 100).astype(dtype), order=order)
    path = str(tmp_path / f'{np.dtype(dtype).name}_{order}.npy')
    np.save(path, arr)
    reader = AsyncNpyReader(n_threads=2)
    assert reader.is_native
    back = reader.get(reader.submit(path))
    reader.close()
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    back *= 2          # writable, as np.load's


def test_reader_out_of_order_and_many(tmp_path):
    rng = np.random.RandomState(4)
    arrays, paths = [], []
    for i in range(12):
        arrays.append(rng.rand(8, 3).astype(np.float32))
        paths.append(str(tmp_path / f'a{i}.npy'))
        np.save(paths[-1], arrays[-1])
    reader = AsyncNpyReader(n_threads=4)
    handles = [reader.submit(p) for p in paths]
    for h, a in list(zip(handles, arrays))[::-1]:
        np.testing.assert_array_equal(reader.get(h), a)
    reader.close()


@pytest.mark.parametrize('case', ['scalar', 'zero-size', 'structured', 'missing'])
def test_reader_edge_cases(tmp_path, case):
    """A scalar, an empty payload, a structured dtype (the native parse
    fails and np.load reads it) and a missing file (np.load's OSError)."""
    path = str(tmp_path / f'{case}.npy')
    want = {'scalar': np.float32(3.5), 'zero-size': np.zeros((0, 5), np.float32),
            'structured': np.zeros(4, dtype=[('a', '<f4'), ('b', '<i2')]), 'missing': None}[case]
    if want is not None:
        np.save(path, want)
    reader = AsyncNpyReader(n_threads=1)
    assert reader.is_native
    if want is None:
        with pytest.raises(OSError):
            reader.get(reader.submit(path))
    else:
        back = reader.get(reader.submit(path))
        assert back.dtype == want.dtype and back.shape == want.shape
        np.testing.assert_array_equal(back, want)
    reader.close()


@pytest.mark.parametrize('window,max_bytes', [(4, 1), (3, 2 << 30)], ids=['byte-cap', 'window'])
def test_reader_read_all_in_order(tmp_path, window, max_bytes):
    """A byte cap below one file still makes progress; every array comes
    back in path order."""
    arrays, paths = [], []
    for i in range(7):
        arrays.append(np.full((64, 64), i, np.float32))
        paths.append(str(tmp_path / f'w{i}.npy'))
        np.save(paths[-1], arrays[-1])
    reader = AsyncNpyReader(n_threads=2)
    out = list(reader.read_all(paths, window=window, max_bytes=max_bytes))
    reader.close()
    assert len(out) == len(arrays)
    for a, b in zip(out, arrays):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- the CLI

def _write_dumps(root, n=3, channels=8, side=16, classes=21):
    """``n`` fp16 (C, h, w) dumps as ``extract_feature --aggregate_output``
    writes them, and label PNGs at the working resolution whose classes
    follow the first channels, so the ensemble has something to learn."""
    rng = np.random.RandomState(6)
    feats, labs = os.path.join(root, 'feats'), os.path.join(root, 'labels')
    os.makedirs(feats)
    os.makedirs(labs)
    for i in range(n):
        lab_small = rng.randint(0, 4, (side, side))
        f = rng.randn(channels, side, side).astype(np.float32) * 0.3
        f[:4] += np.eye(4, dtype=np.float32)[lab_small].transpose(2, 0, 1) * 2
        np.save(os.path.join(feats, f'img{i}.npy'), f.astype(np.float16))
        lab = np.kron(lab_small, np.ones((256 // side, 256 // side), np.int64)).astype(np.uint8)
        lab[:3] = 255                                    # the ignore label
        Image.fromarray(lab).save(os.path.join(labs, f'img{i}.png'))
    return feats, labs


def test_to_rows_matches():
    feat = np.random.RandomState(8).randn(5, 16, 12).astype(np.float16)
    import task_pixel as jax_task_pixel
    np.testing.assert_allclose(task_pixel._to_rows(feat, (32, 24)).numpy(),
                               jax_task_pixel._to_rows(feat, (32, 24)), atol=TOL, rtol=TOL)


def test_task_pixel_main_trains_then_loads(tmp_path, capsys):
    feats, labs = _write_dumps(str(tmp_path))
    exp = str(tmp_path / 'exp')
    argv = ['--category', 'horse_21', '--feature_dir', feats, '--label_dir', labs, '--exp_dir',
            exp, '--train_num', '2', '--model_num', '2', '--max_epochs', '1', '--batch_size',
            '256', '--device', 'cpu']
    res = task_pixel.main(argv)
    assert res['trained'] == [0, 1] and res['rows'] == 2 * (256 * 256 - 3 * 256)
    assert sorted(os.listdir(exp)) == ['model_0.pt', 'model_1.pt', 'predictions',
                                       'visualizations']
    name = res['names'][0]
    pred = np.asarray(Image.open(os.path.join(exp, 'predictions', f'{name}.png')))
    assert pred.shape == (256, 256)
    vis = np.asarray(Image.open(os.path.join(exp, 'visualizations', f'{name}.png')))
    np.testing.assert_array_equal(vis, data.colorize_mask(pred, data.get_palette('horse_21')))
    assert np.isfinite(res['miou']) and res['miou'] > 0.1
    assert all(np.isfinite(res['uncertainties']))
    # the members come back from their checkpoints: nothing trained, the same result
    again = task_pixel.main(argv)
    assert again['trained'] == [] and again['rows'] == 0
    assert again['miou'] == res['miou'] and again['uncertainties'] == res['uncertainties']
    assert 'model 0: loaded existing checkpoint' in capsys.readouterr().out


def test_task_pixel_main_keeps_a_matrix_too_large_for_the_device_on_the_host(tmp_path):
    """Room for the matrix and four images' rows: the matrix sits on the
    device; one byte less: it stays on the host and each batch is copied.
    Both train the same members."""
    feats, labs = _write_dumps(str(tmp_path))
    rows, image_rows, row_bytes = 2 * (256 * 256 - 3 * 256), 256 * 256, 8 * 4
    need = (rows + 4 * image_rows) * row_bytes
    runs = {}
    for room in (need, need - 1):
        exp = str(tmp_path / f'exp{room}')
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(task_pixel, '_device_room', lambda device, room=room: room)
            runs[room] = task_pixel.main(
                ['--category', 'horse_21', '--feature_dir', feats, '--label_dir', labs,
                 '--exp_dir', exp, '--train_num', '2', '--model_num', '1', '--max_epochs', '1',
                 '--batch_size', '256', '--device', 'cpu'])
    assert not runs[need]['matrix_on_host'] and runs[need - 1]['matrix_on_host']
    assert runs[need]['rows'] == runs[need - 1]['rows'] == rows
    torch.testing.assert_close(runs[need]['ensemble'][0].state_dict(),
                               runs[need - 1]['ensemble'][0].state_dict(), rtol=0, atol=0)
    assert runs[need]['miou'] == runs[need - 1]['miou']
