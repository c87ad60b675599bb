"""The port's multi-device layer (``diffusion_feature_tpu_torch/parallel/mesh.py``)
against the unsharded port and the JAX package's mesh (tests/test_mesh.py).

One world of 4 gloo ranks on the CPU is spawned for the module
(``torch_mesh_ranks.spawn_world``, which imports no JAX); every case runs
in it, each rank writing its results as numpy files, while this process
prepares the JAX side: the weights, prompt embeddings and noise of the two
cases held against JAX's mesh, and the synthetic Flux tree of the int8
case.  Each case is its own test and waits for its files.

Tolerances: the mesh result against the unsharded port at JAX's TIGHT
(fp32; the only legitimate difference is the order of sums), sample()'s
per-step features at tests/test_mesh.py's 1e-4 (the steps compound the
batch-size-dependent order of the CPU's convolutions), and the JAX mesh
result within 1e-4 relative L2 (the two frameworks' kernels).
"""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from diffusion_feature_tpu.parallel import mesh as jax_mesh
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.models.dit_pixart import PixArtTransformer2D
from diffusion_feature_tpu_torch.models.flux import FluxTransformer2D, tiny_flux_config
from diffusion_feature_tpu_torch.models.hunyuan import HunyuanDiT2D
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.models.unet2d import UNet2DConditionModel
from diffusion_feature_tpu_torch.models.unet_if import IFUNet
from diffusion_feature_tpu_torch.parallel import mesh as port_mesh
from port_parity import jax_facade, jax_noise, load_jax_params

TIGHT = dict(rtol=1e-5, atol=2e-5)
SAMPLE_FEATURES = dict(rtol=1e-4, atol=1e-4)
JAX_REL = 1e-4
CASE_TIMEOUT = 240


def _rel(ours, ref):
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30))


class World:
    """The spawned ranks and the results they write."""

    def __init__(self, root: Path):
        self.root = root
        self.procs = ranks.spawn_world(root)
        self.jax = {}

    def results(self, case):
        """[rank 0's arrays, ..., rank 3's] of ``case``; raises with a rank's
        traceback where one failed."""
        for r in range(ranks.WORLD):
            ranks.wait_for(self.root / f'{case}.r{r}.done', CASE_TIMEOUT)
        errors = [(self.root / f'{case}.r{r}.err') for r in range(ranks.WORLD)]
        failed = [e.read_text() for e in errors if e.exists()]
        if failed:
            raise AssertionError(f'{case} failed on a rank:\n{failed[0]}')
        return [dict(np.load(self.root / f'{case}.r{r}.npz')) for r in range(ranks.WORLD)]


def _prepare_jax_case(world, name, version, layers, mesh_kw, t, jax_kw, port_kw):
    """Write case ``name``'s JAX inputs (the port's tree of the JAX
    facade's weights, its prompt embeddings and its first extract's noise)
    and keep the JAX mesh's features."""
    jfe = jax_facade(layers, version, ranks.SIZE, seed=0,
                     mesh=jax_mesh.make_mesh(devices=jax.devices()[:4], **mesh_kw), **jax_kw)
    if mesh_kw.get('sp', 1) > 1:
        # jax_facade hands the facade a module built without the facade's
        # token sharding, which its own build adds under an sp mesh
        jfe.unet = jfe.unet.clone(token_pspec=('dp', 'sp'))
    port = FeatureExtractor(layers, version, device='cpu', dtype='float32', img_size=ranks.SIZE,
                            **port_kw)
    load_jax_params(jfe, port)
    port.save_weights(str(world.root / 'jax' / name))
    prompts = jfe.encode_prompt('a cat')
    posterior, noise = jax_noise(0, port.latent_shape(4))
    np.savez(world.root / 'jax' / f'{name}.npz', posterior=posterior.numpy(),
             noise=noise.numpy(),
             **{f'prompt{i}': np.asarray(p) for i, p in enumerate(prompts) if p is not None})
    return jfe, prompts, t


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('mesh')
    (root / 'jax').mkdir()
    w = World(root)
    try:
        from synth_checkpoint import write_flux_checkpoint
        write_flux_checkpoint(str(root / 'flux_tree'))
        (root / 'flux_tree' / 'ready').touch()
        pending = [
            _prepare_jax_case(w, 'dp2_tp2_sd', 'test-sd', ranks.SD_LAYERS, dict(dp=2, tp=2), 50,
                              ranks.SD_STORE, ranks.SD_STORE),
            _prepare_jax_case(w, 'dp2_sp2_flux', 'test-flux', ranks.FLUX_LAYERS,
                              dict(dp=2, sp=2), 500, {},
                              dict(transformer_8bit=False, t5_8bit=False))]
        (root / 'jax' / 'ready').touch()
        imgs = [ranks.make_image(i) for i in range(4)]
        for name, (jfe, prompts, t) in zip(('dp2_tp2_sd', 'dp2_sp2_flux'), pending):
            w.jax[name] = {k: np.asarray(v, np.float32)
                           for k, v in jfe.extract(prompts, 4, imgs, t=t).items()}
        yield w
    finally:
        for p in w.procs:
            p.join(timeout=CASE_TIMEOUT)
            if p.is_alive():
                p.terminate()
        shutil.rmtree(root, ignore_errors=True)


def _assert_mesh_matches_plain(results, tol=TIGHT, ranks_with_mesh=range(ranks.WORLD)):
    """Every rank's mesh features equal rank 0's unsharded ones."""
    plain = {k[len('plain/'):]: v for k, v in results[0].items() if k.startswith('plain/')}
    assert plain
    for r in ranks_with_mesh:
        mesh = {k[len('mesh/'):]: v for k, v in results[r].items() if k.startswith('mesh/')}
        assert set(mesh) == set(plain), r
        for k, v in plain.items():
            assert mesh[k].shape == v.shape, (r, k)
            np.testing.assert_allclose(mesh[k], v, err_msg=f'rank {r} {k}', **tol)
    return plain


# ------------------------------------------------------------- the rules
@pytest.mark.parametrize('path,ndim', [
    (('to_q', 'kernel'), 2), (('add_k_proj', 'kernel_q'), 2), (('proj', 'kernel'), 4),
    (('net_0_proj', 'bias'), 1), (('proj_mlp', 'scale'), 1), (('to_out_0', 'kernel'), 2),
    (('to_add_out', 'kernel_q'), 2), (('net_2', 'bias'), 1), (('proj_out', 'kernel'), 2),
    (('proj_in', 'kernel'), 2), (('norm1_linear', 'kernel'), 2), (('to_out_0', 'scale'), 1)])
def test_param_pspec_is_jax_rule(path, ndim):
    """The name tables are JAX's: each spec as ``_param_pspec`` gives it."""
    value = np.zeros((2,) * ndim)
    assert port_mesh.param_pspec(path, ndim) == tuple(jax_mesh._param_pspec(path, value))


def _fake_mesh(rank, tp):
    axes = {'dp': port_mesh.Axis('dp', None, 0, 1), 'sp': port_mesh.Axis('sp', None, 0, 1),
            'tp': port_mesh.Axis('tp', None, rank, tp)}
    return port_mesh.Mesh({'dp': 1, 'sp': 1, 'tp': tp}, {'dp': 0, 'sp': 0, 'tp': rank}, axes,
                          'gloo')


FAMILIES = {'unet': lambda: UNet2DConditionModel(get_model_spec('test-xl').unet),
            'flux': lambda: FluxTransformer2D(tiny_flux_config()),
            'pixart': lambda: PixArtTransformer2D(get_model_spec('test-pixart').dit),
            'hunyuan': lambda: HunyuanDiT2D(get_model_spec('test-hunyuan').dit),
            'if': lambda: IFUNet(get_model_spec('test-if').unet)}


@pytest.mark.parametrize('family,tp', [('unet', 2), ('unet', 3), ('flux', 2), ('flux', 3),
                                       ('pixart', 2), ('hunyuan', 2), ('if', 2)])
def test_shards_put_back_together_equal_the_state_dict(family, tp):
    """``shard_state_dict`` of each rank's cuts: every tensor the rules
    match is cut, the parts cover each index once, and put back together
    they equal the full state dict; the others stay whole."""
    make = FAMILIES[family]
    torch.manual_seed(0)
    full = make().state_dict()
    rebuilt = {k: torch.zeros_like(v) for k, v in full.items()}
    hits = {k: torch.zeros(v.shape, dtype=torch.int64) for k, v in full.items()}
    matched = port_mesh.denoiser_param_specs(full)
    assert matched
    for r in range(tp):
        with torch.device('meta'):
            module = make()
        cuts = port_mesh.parallelize(module, _fake_mesh(r, tp))
        assert set(cuts) == set(matched)
        part = port_mesh.shard_state_dict(full, cuts)
        port_mesh.cut_parameters_(module, cuts)
        for k, v in part.items():
            assert tuple(v.shape) == tuple(module.state_dict()[k].shape), k
            if k in cuts:
                dim, idx = cuts[k]
                rebuilt[k].index_copy_(dim, idx, v)
                hits[k].index_add_(dim, idx, torch.ones_like(v, dtype=torch.int64))
            else:
                rebuilt[k] = v
    for k, v in full.items():
        assert torch.equal(rebuilt[k], v), k
        if k in matched:
            assert bool((hits[k] == 1).all()), k


def test_make_mesh_needs_a_launched_group():
    with pytest.raises(ValueError, match='torchrun'):
        port_mesh.make_mesh(dp=2)


class _Built(Exception):
    pass


@pytest.mark.parametrize('cli', ['extract_feature', 'train_segmentation'])
def test_launched_rank_runs_on_its_local_card(cli, tmp_path, monkeypatch):
    """Under torchrun (LOCAL_RANK 1 of 2) with ``--device cuda``, each CLI
    builds its models on ``cuda:1`` and makes it the current device, so
    that no two ranks share a card."""
    from diffusion_feature_tpu_torch import extract_feature, train_segmentation
    monkeypatch.setenv('LOCAL_RANK', '1')
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setattr(torch.distributed, 'is_initialized', lambda: True)
    current = []
    monkeypatch.setattr(torch.cuda, 'set_device', current.append)
    built = []

    def build(*args, device, **kwargs):
        built.append(device)
        raise _Built
    mesh = type('StubMesh', (), {'dp': 2, 'coords': {'dp': 1}})()
    if cli == 'extract_feature':
        monkeypatch.setattr(extract_feature, 'make_mesh', lambda **kw: mesh)
        monkeypatch.setattr(extract_feature, 'FeatureExtractor', build)
        argv = ['--version', 'test-sd', '--img_size', '64', '--prompt', 'a', '--input_dir',
                str(tmp_path / '*.png'), '--output_dir', str(tmp_path / 'out'), '--dp', '2']
        main = extract_feature.main
    else:
        monkeypatch.setattr(train_segmentation, 'make_mesh', lambda **kw: mesh)
        monkeypatch.setattr(train_segmentation, 'segmentor_from_config',
                            lambda cfg, weights, seed, device, mesh: build(device=device))
        argv = ['--config', str(Path(__file__).parent.parent / 'seg_configs' / 'ade_full.json'),
                '--train_img_dir', str(tmp_path), '--train_label_dir', str(tmp_path),
                '--work_dir', str(tmp_path / 'work'), '--dp', '2']
        main = train_segmentation.main
    with pytest.raises(_Built):
        main(argv)
    assert built == ['cuda:1']
    assert current and set(current) == {'cuda:1'}


# ------------------------------------------------------------ the mesh cases
def test_uneven_heads_and_inner_widths(world):
    """tp=4 over 10 heads (3, 3, 2, 2) and over GEGLU and GELU inner widths
    of 322: every tap, the store's maps and the outputs."""
    res = world.results('uneven_heads')
    _assert_mesh_matches_plain(res)
    assert [int(r['heads']) for r in res] == [3, 3, 2, 2]
    assert all(list(r['broadcast']) == [0.0] * 3 for r in res)


def test_dp4_sd_extract_matches_unsharded(world):
    plain = _assert_mesh_matches_plain(world.results('dp4_sd'))
    assert plain['up-level1-repeat0-res-out'].shape == (4, 32, 32, 32)


def test_params_placed_once(world):
    """Parameters are placed (and cut) once at construction: two extracts
    move none, and each tp rank holds its half of a projection."""
    for r in world.results('params_placed_once'):
        assert bool(r['same'])
        assert int(r['to_q_rows']) == 32 // 2


def test_dp2_tp2_sd_matches_unsharded_and_jax_mesh(world):
    """dp2 x tp2 on test-sd: the q, map and FFN inner taps, a block output
    and the store's 'attn', against the unsharded port and JAX's mesh."""
    res = world.results('dp2_tp2_sd')
    plain = _assert_mesh_matches_plain(res)
    assert {'attn', 'up-level1-repeat0-vit-block0-self-map'} <= set(plain)
    assert all(list(r['held'][2:]) == [1, 2] for r in res)   # one of the two heads
    ref = world.jax['dp2_tp2_sd']
    mesh = {k[len('mesh/'):]: v for k, v in world.results('dp2_tp2_sd')[0].items()
            if k.startswith('mesh/')}
    assert set(mesh) == set(ref)
    for k, v in ref.items():
        assert _rel(mesh[k], v) < JAX_REL, k


def test_dp2_sp2_flux_matches_unsharded_and_jax_mesh(world):
    res = world.results('dp2_sp2_flux')
    plain = _assert_mesh_matches_plain(res)
    assert all(list(r['held'][:2]) == [128, 256] for r in res)   # half the image tokens
    ref = world.jax['dp2_sp2_flux']
    mesh = {k[len('mesh/'):]: v for k, v in world.results('dp2_sp2_flux')[0].items()
            if k.startswith('mesh/')}
    assert set(mesh) == set(ref) == set(plain)
    for k, v in ref.items():
        assert _rel(mesh[k], v) < JAX_REL, k


@pytest.mark.parametrize('case', ['dp2_sp2_pixart', 'dp2_sp2_hunyuan'])
def test_dp2_sp2_dits_match_unsharded(world, case):
    res = world.results(case)
    plain = _assert_mesh_matches_plain(res)
    assert 'attn' in plain
    assert all(list(r['held'][:2]) == [128, 256] for r in res)


@pytest.mark.parametrize('case', ['dp2_tp2_pixart', 'dp2_tp2_hunyuan', 'dp2_tp2_if'])
def test_dp2_tp2_dits_and_if_match_unsharded(world, case):
    """tp on the other families: PixArt's and HunyuanDiT's heads, GELU and
    GEGLU FFNs and final projections, IF's added-KV attention and its
    text-time projection (gathered)."""
    res = world.results(case)
    _assert_mesh_matches_plain(res)
    assert all(2 * r['held'][2] == r['held'][3] for r in res)   # half the heads


def test_sp2_tp2_flux_matches_unsharded(world):
    """sp and tp at once (4 ranks where JAX uses 8): dual and single
    blocks' q/k/v, maps, attention outputs, outputs and the store."""
    res = world.results('sp2_tp2_flux')
    plain = _assert_mesh_matches_plain(res)
    assert {'vit-block2-attn-out', 'vit-block3-cross-map', 'attn'} <= set(plain)
    assert all(list(r['held']) == [128, 256, 1, 2] for r in res)


def test_int8_rules_and_explicit_int8_under_tp(world):
    """The JAX auto rule (tests/test_quant.py:277-306): off under tp, on
    under dp or sp alone; explicit int8 under dp2 x tp2 is the whole
    weight's quantization cut (a row-parallel layer's scale is the whole
    row's) and extracts what the unsharded int8 Flux does."""
    res = world.results('int8_tp')
    for r in res:
        assert list(r['rule']) == [False, True, True]
    _assert_mesh_matches_plain(res)
    for r in res:
        t = int(r['tp_rank'])
        for name, dim in (('transformer_blocks.0.attn.to_q', 0),
                          ('transformer_blocks.0.attn.to_out.0', 1)):
            full_q = res[0][f'plain_q/{name}']
            part = np.split(full_q, 2, axis=dim)[t]
            np.testing.assert_array_equal(r[f'mesh_q/{name}'], part, err_msg=name)
            full_scale = res[0][f'plain_scale/{name}']
            want = np.split(full_scale, 2)[t] if dim == 0 else full_scale
            np.testing.assert_array_equal(r[f'mesh_scale/{name}'], want, err_msg=name)
        # the single block's proj_out: this rank's heads' columns, then its MLP's
        name = 'single_transformer_blocks.0.proj_out'
        full_q = res[0][f'plain_q/{name}']
        dim = full_q.shape[0]
        heads, mlp = np.split(full_q[:, :dim], 2, axis=1)[t], np.split(full_q[:, dim:], 2,
                                                                         axis=1)[t]
        np.testing.assert_array_equal(r[f'mesh_q/{name}'], np.concatenate([heads, mlp], 1))
        np.testing.assert_array_equal(r[f'mesh_scale/{name}'], res[0][f'plain_scale/{name}'])


def test_tp_bundle_load_equals_the_tree_load(world):
    """A dp=4 int8 Flux's bundle (io/bundle.py: the first rank writes, every
    rank returns once it exists) loaded under dp2 x tp2 with default
    arguments: int8 flags from the manifest, every rank's tensors
    torch.equal to the same mesh's load of the tree; a tp extractor
    refuses to write a bundle."""
    for r in world.results('int8_tp'):
        assert bool(r['bundle_written'])
        assert r['bundle_equal'].all() and len(r['bundle_equal']) == 4
        assert r['bundle_int8'].all() and bool(r['tp_save_refused'])


def test_dp4_sample_matches_unsharded(world):
    res = world.results('sample_dp4_xl')
    plain = res[0]
    for r in res:
        np.testing.assert_allclose(r['mesh/images'], plain['plain/images'], **TIGHT)
        calls = sorted(k for k in plain if k.startswith('plain/call'))
        assert len(calls) == 3
        for k in calls:
            mk = 'mesh/' + k[len('plain/'):]
            assert r[mk].shape == plain[k].shape == (8, 32, 32, 32)
            np.testing.assert_allclose(r[mk], plain[k], **SAMPLE_FEATURES)


def test_batch_indivisible_by_dp_runs_replicated(world):
    _assert_mesh_matches_plain(world.results('sample_indivisible'))


def test_cli_dp2_tree_equals_dp1(world):
    """--batch_size 3 --dp 2 (rounded up to 4) over 5 images on each pair
    of ranks writes the tree --dp 1 --batch_size 4 writes: the same file
    names and values."""
    world.results('cli_dp2')
    ref = world.root / 'cli_dp1'
    names = sorted(p.relative_to(ref) for p in ref.rglob('*.npy'))
    assert len(names) == 10
    for pair in (0, 2):
        ours = world.root / f'cli_dp2_pair{pair}'
        assert sorted(p.relative_to(ours) for p in ours.rglob('*.npy')) == names
        for n in names:
            np.testing.assert_array_equal(np.load(ours / n), np.load(ref / n), err_msg=str(n))


def test_trainer_dp2_step_equals_dp1(world):
    """Two --dp 2 steps against two --dp 1 steps from the same seed: the
    losses, the first step's averaged gradients, the BatchNorm running
    statistics and the head's parameters afterwards.  A bias that feeds a
    training-mode BatchNorm has a gradient of fp32 noise (mathematically
    0), which Adam's normalisation turns into a step of up to the rate
    either way: those parameters are held to their two steps' rates."""
    res = world.results('trainer_dp2')
    ref = {k[len('dp1/'):]: v for k, v in res[0].items() if k.startswith('dp1/')}
    rates = 2 * 1.6e-4
    for r in res:
        ours = {k[len('dp2/'):]: v for k, v in r.items() if k.startswith('dp2/')}
        assert set(ours) == set(ref)
        np.testing.assert_allclose(ours['losses'], ref['losses'], **TIGHT)
        for k, v in ref.items():
            if k == 'losses':
                continue
            if k.startswith('grad/') or 'running' in k:
                np.testing.assert_allclose(ours[k], v, err_msg=k, **TIGHT)
            elif np.abs(ref['grad/' + k]).max() < 1e-6:
                assert np.abs(ours[k] - v).max() <= rates, k
            else:
                np.testing.assert_allclose(ours[k], v, err_msg=k, **TIGHT)
