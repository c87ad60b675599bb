"""The PyTorch port's extraction CLI and what it stands on, against the JAX
package's: layer enumeration, the dump layouts and the native writer, the
argument parser, and the two CLIs end to end on the same parameters and
noise (tests/test_cli_dump_oracle.py's layers and tolerance)."""

import json
import os
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import torch
from PIL import Image

import extract_feature as jax_cli
from diffusion_feature_tpu.enumerate_layers import enumerate_layers as jax_enumerate_layers
from diffusion_feature_tpu.io import dump as jax_dump
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch import extract_feature as port_cli
from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
from diffusion_feature_tpu_torch.io import dump
from diffusion_feature_tpu_torch.native import AsyncDumpWriter
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from port_parity import jax_facade, jax_noise, load_jax_params


# ------------------------------------------------------------- enumeration
@pytest.mark.parametrize('version,img_size,count', [
    ('test-sd', 64, None), ('test-xl', 64, None), ('xl', 1024, 612), ('1-5', 512, 197),
])
def test_enumeration_equals_jax(version, img_size, count):
    """Ids and reference-layout shapes; the shipped models' id counts are
    the reference's config_xl_full.json and config_15_full.json."""
    ours = enumerate_layers(version, img_size)
    ref = jax_enumerate_layers(version, img_size)
    assert ours == ref
    assert count is None or len(ours) == count


def test_show_all_layers_matches_enumeration():
    fe = FeatureExtractor({'mid-vit-out': True}, 'test-sd', device='cpu', img_size=64)
    assert fe.show_all_layers(2) == enumerate_layers('test-sd', 64, batch_size=2)
    assert fa.launches == 0


def test_enumeration_of_unported_version_names_its_item():
    with pytest.raises(NotImplementedError, match="Queue A item 9: 'DiT families'"):
        enumerate_layers('flux', 1024)
    with pytest.raises(NotImplementedError, match="Queue A item 9: 'DiT families'"):
        enumerate_layers('if', 64)


# ------------------------------------------------------------------- dumps
def _features(seed=0):
    """bf16 NCHW features at three sizes: 4x, 2x and 1x below the largest."""
    rs = np.random.RandomState(seed)
    shapes = {'a-out': (2, 3, 8, 8), 'b-out': (2, 2, 16, 16), 'c-cross-q': (2, 4, 32, 32)}
    ref = {k: (rs.randn(*s) * 3).astype(ml_dtypes.bfloat16) for k, s in shapes.items()}
    ours = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) for k, v in ref.items()}
    return ours, ref


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob('*.npy'))


def test_aggregate_matches_jax_at_shipped_ratios():
    ours, ref = _features()
    agg = dump.aggregate_features(ours)
    assert agg.shape == (2, 9, 32, 32)
    np.testing.assert_array_equal(agg.numpy(), np.asarray(jax_dump.aggregate_features(ref)))


@pytest.mark.parametrize('layout', [
    {}, {'sample_name_first': True}, {'aggregate_output': True},
    {'aggregate_output': True, 'use_original_filename': True, 'nested': True},
    {'use_original_filename': True, 'nested': True},
], ids=['per-layer', 'sample-first', 'aggregated', 'aggregated-nested', 'nested'])
@pytest.mark.parametrize('native', [True, False], ids=['writer', 'np-save'])
def test_save_batch_bytes_equal_jax(tmp_path, layout, native):
    """The same file list and the same bytes as the JAX ``save_batch`` on the
    same bf16 features, through the native writer and through np.save."""
    ours, ref = _features(1)
    names = ['sub1/imgA', 'sub2/imgB']
    kwargs = dict(batch_start_index=4, original_names=names, split='val', **layout)
    writer = AsyncDumpWriter() if native else None
    assert writer is None or writer.is_native
    dump.save_batch(ours, str(tmp_path / 'ours'), writer=writer, **kwargs)
    if writer is not None:
        writer.close()
    jax_dump.save_batch(ref, str(tmp_path / 'ref'), **kwargs)
    files = _tree(tmp_path / 'ref')
    assert _tree(tmp_path / 'ours') == files and files
    for f in files:
        assert (tmp_path / 'ours' / f).read_bytes() == (tmp_path / 'ref' / f).read_bytes(), f


def test_native_writer_bytes_equal_np_save(tmp_path):
    writer = AsyncDumpWriter(n_threads=2)
    assert writer.is_native
    rs = np.random.RandomState(2)
    arrays = {'a/x.npy': rs.randn(3, 5).astype(np.float16),
              'b/y.npy': rs.randn(7).astype(np.float32),
              'c.npy': rs.randint(0, 9, (2, 3, 4)).astype(np.int64),
              'd.npy': np.zeros((0, 4), np.float16)}
    for name, arr in arrays.items():
        writer.submit(str(tmp_path / 'native' / name), arr)
        (tmp_path / 'np' / name).parent.mkdir(parents=True, exist_ok=True)
        np.save(tmp_path / 'np' / name, arr)
    writer.close()
    for name in arrays:
        assert (tmp_path / 'native' / name).read_bytes() == (tmp_path / 'np' / name).read_bytes()


# ------------------------------------------------------------------ parsers
def _actions(parser):
    return {a.dest: (a.default, a.choices, tuple(a.option_strings))
            for a in parser._actions if a.dest != 'help'}


def test_parser_is_jax_parser_plus_device():
    ours, ref = _actions(port_cli.build_parser()), _actions(jax_cli.build_parser())
    assert set(ours) - set(ref) == {'device'} and set(ref) <= set(ours)
    assert {k: ours[k] for k in ref} == ref
    assert ours['device'][0] == 'cuda'


# ---------------------------------------------------------------- the CLIs
LAYER_JSON = '{"up-level1-repeat0-res-out": true, "mid-vit-block0-cross-q": true}'
IMG_SIZE, BATCH, SEED = 64, 2, 0


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp('imgs')
    rng = np.random.RandomState(3)
    for name in ('imgA', 'imgB', 'imgC'):
        Image.fromarray((rng.rand(80, 80, 3) * 255).astype('uint8')).save(d / f'{name}.png')
    return d


@pytest.fixture(scope='module')
def facades():
    """The JAX facade (fp32, numpy-drawn parameters) and the port's with
    those parameters, each built once; the CLIs' constructors are patched
    to hand them out."""
    layers = json.loads(LAYER_JSON)
    jfe = jax_facade(layers, 'test-sd', IMG_SIZE, SEED)
    port = FeatureExtractor(layers, 'test-sd', device='cpu', dtype='float32', img_size=IMG_SIZE)
    load_jax_params(jfe, port)
    return jfe, port


def _run_both(monkeypatch, tmp_path, images, flags, port_factory, jax_factory=None,
              version='test-sd', layers=LAYER_JSON):
    """Both CLIs over the 3 images (batches of 2 and 1), each from a fresh
    key chain; the port's step gets the JAX noise of the same call.
    ``port_factory`` (and ``jax_factory``, else the JAX facade itself)
    stands in for the CLI's FeatureExtractor."""
    calls = []

    def port_with_jax_noise(*args, **kwargs):
        port = port_factory(*args, **kwargs)
        lat = IMG_SIZE // port.vae_scale

        def with_jax_noise(method):
            # _step and _multistep take (img, ..., posterior, noise, out_dtype,
            # control=...)
            def call(img, *args, **kwargs):
                # the JAX CLI pads the trailing batch to BATCH; its real rows come first
                n = img.shape[0]
                posterior, noise = (x[:n] for x in jax_noise(SEED, (BATCH, 4, lat, lat),
                                                             len(calls)))
                calls.append(n)
                return method(img, *args[:-3], posterior, noise, args[-1], **kwargs)
            return call

        for name in ('_step', '_multistep'):
            monkeypatch.setattr(port, name, with_jax_noise(getattr(port, name)))
        return port

    if jax_factory is not None:
        monkeypatch.setattr(jax_cli, 'FeatureExtractor', jax_factory)
    monkeypatch.setattr(port_cli, 'FeatureExtractor', port_with_jax_noise)
    common = ['--version', version, '--img_size', str(IMG_SIZE), '--dtype', 'float32',
              '--batch_size', str(BATCH), '--layer', layers, '--prompt', 'a photo of a cat',
              '--input_dir', str(images / '*.png'), *flags]
    jax_cli.main([*common, '--output_dir', str(tmp_path / 'jax')])
    fa.launches = 0
    port_cli.main([*common, '--output_dir', str(tmp_path / 'port'), '--device', 'cpu'])
    assert calls == [2, 1] and fa.launches == 0
    return tmp_path / 'jax', tmp_path / 'port'


def _assert_trees_match(ref_root, ours_root, count):
    """File names, shapes and fp16 equal; values within the oracle's
    tolerance for a bf16 cast then fp16 (rtol 1e-2, atol 1e-2 max|JAX|)."""
    files = _tree(ref_root)
    assert _tree(ours_root) == files and len(files) == count
    for f in files:
        ref, ours = np.load(ref_root / f), np.load(ours_root / f)
        assert ours.dtype == ref.dtype == np.float16 and ours.shape == ref.shape, f
        ref32 = ref.astype(np.float32)
        np.testing.assert_allclose(ours.astype(np.float32), ref32, rtol=1e-2,
                                   atol=1e-2 * np.abs(ref32).max(), err_msg=f)


@pytest.mark.parametrize('flags,count', [
    ([], 6), (['--sample_name_first'], 6), (['--aggregate_output', '--use_original_filename'], 3),
], ids=['per-layer', 'sample-first', 'aggregated-original-names'])
def test_cli_trees_match_jax(monkeypatch, tmp_path, facades, images, flags, count):
    """The JAX facade keeps fp32 features here, the port's are bf16."""
    jfe, port = facades

    def jax_factory(*args, **kwargs):
        jfe._rng = jax.random.PRNGKey(SEED)
        return jfe

    ref_root, ours_root = _run_both(monkeypatch, tmp_path, images, flags,
                                    lambda *args, **kwargs: port, jax_factory)
    _assert_trees_match(ref_root, ours_root, count)
    if '--use_original_filename' in flags:
        assert _tree(ref_root) == ['imgA.npy', 'imgB.npy', 'imgC.npy']


VAE_OUT_LAYERS = {**json.loads(LAYER_JSON), 'vae-out': True}


@pytest.fixture(scope='module')
def vae_out_facades():
    """``facades`` with the 'vae-out' layer added."""
    jfe = jax_facade(VAE_OUT_LAYERS, 'test-sd', IMG_SIZE, SEED)
    port = FeatureExtractor(VAE_OUT_LAYERS, 'test-sd', device='cpu', dtype='float32',
                            img_size=IMG_SIZE)
    load_jax_params(jfe, port)
    return jfe, port


@pytest.mark.parametrize('flags', [[], ['--denoising_from', '56']],
                         ids=['vae-out', 'denoising_from'])
def test_cli_vae_out_and_denoising_from_match_jax(monkeypatch, tmp_path, vae_out_facades,
                                                  images, flags):
    """A 'vae-out' layer in --layer (the decoded image, 3 x 64 x 64 per
    image) on the single step and after a --denoising_from walk (7 PLMS
    forwards): the JAX CLI's tree."""
    jfe, port = vae_out_facades

    def jax_factory(*args, **kwargs):
        jfe._rng = jax.random.PRNGKey(SEED)
        return jfe

    flags = ['--layer', json.dumps(VAE_OUT_LAYERS), *flags]
    ref_root, ours_root = _run_both(monkeypatch, tmp_path, images, flags,
                                    lambda *args, **kwargs: port, jax_factory)
    _assert_trees_match(ref_root, ours_root, 9)
    assert np.load(ours_root / 'vae-out' / 'train0.npy').shape == (3, IMG_SIZE, IMG_SIZE)


PIXART_LAYERS = {'vit-block0-out': True, 'vit-block1-cross-q': True, 'vit-block1-ffn-inner': True}


def test_cli_pixart_matches_jax(monkeypatch, tmp_path, images):
    """--version test-pixart through both CLIs: the T5 prompt 4-tuple
    (embeds, mask, negative embeds, negative mask) goes through unchanged,
    DPM-Solver's kit, the DiT's taps: the JAX CLI's tree."""
    jfe = jax_facade(PIXART_LAYERS, 'test-pixart', IMG_SIZE, SEED)
    port = FeatureExtractor(PIXART_LAYERS, 'test-pixart', device='cpu', dtype='float32',
                            img_size=IMG_SIZE)
    load_jax_params(jfe, port)

    def jax_factory(*args, **kwargs):
        assert args[1] == 'test-pixart'
        jfe._rng = jax.random.PRNGKey(SEED)
        return jfe

    def port_factory(*args, **kwargs):
        assert args[1] == 'test-pixart'
        return port

    ref_root, ours_root = _run_both(monkeypatch, tmp_path, images, [], port_factory,
                                    jax_factory, 'test-pixart', json.dumps(PIXART_LAYERS))
    _assert_trees_match(ref_root, ours_root, 9)


def test_cli_control_on_pixart_says_why(tmp_path, images):
    args = ['--version', 'test-pixart', '--img_size', '64', '--device', 'cpu', '--prompt', 'a',
            '--input_dir', str(images / 'imgA.png'), '--output_dir', str(tmp_path), '--layer',
            '{"vit-block0-out": true}', '--control', 'canny']
    with pytest.raises(ValueError, match='control= needs a U-Net version'):
        port_cli.main(args)


def test_cli_show_all_layers_writes_record(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    port_cli.main(['--version', 'test-xl', '--img_size', '64', '--show_all_layers',
                   '--output_dir', str(tmp_path / 'out')])
    record = json.loads((tmp_path / 'layer_record.json').read_text())
    shapes = enumerate_layers('test-xl', 64)
    assert record == {k: True for k in shapes}
    printed = capsys.readouterr().out.splitlines()
    assert f'unet-out {shapes["unet-out"][1:]}' in printed


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    """A test-sd checkpoint dir written by the port holding two weight sets:
    the un-suffixed one from seed 2 and an 'fp16' variant from seed 1; and a
    peft LoRA over two U-Net projections."""
    root = tmp_path_factory.mktemp('ckpt')
    for seed, variant in ((2, None), (1, 'fp16')):
        port = FeatureExtractor({'unet-out': True}, 'test-sd', device='cpu', dtype='float32',
                                img_size=IMG_SIZE, seed=seed)
        port.save_weights(str(root), variant=variant)
    rs = np.random.RandomState(4)
    blk = 'unet.mid_block.attentions.0.transformer_blocks.0'
    lora = {f'{blk}.{p}.lora_{ab}.weight': (rs.randn(*shape) * 0.5).astype(np.float32)
            for p in ('attn1.to_q', 'attn2.to_v')
            for ab, shape in (('A', (4, 64)), ('B', (64, 4)))}
    safetensors.numpy.save_file(lora, str(root / 'lora.safetensors'))
    return root


@pytest.mark.parametrize('flags', [
    ['--weights', '{ckpt}'], ['--weights', '{ckpt}', '--weights_variant', 'fp16'],
    ['--weights', '{ckpt}', '--offline_lora', '{ckpt}/lora.safetensors'],
], ids=['weights', 'weights_variant', 'offline_lora'])
def test_weight_flags_match_jax_cli(monkeypatch, tmp_path, images, checkpoint, flags):
    """Both CLIs load the same checkpoint dir (the variant and the LoRA
    too) and write the same dumps; each builds its own facade."""
    flags = [f.format(ckpt=checkpoint) for f in flags]
    ref_root, ours_root = _run_both(monkeypatch, tmp_path, images, flags, FeatureExtractor)
    _assert_trees_match(ref_root, ours_root, 6)


@pytest.mark.parametrize('flags,item', [
    # ControlNet is ported; on an unported DiT family the version raises
    (['--control', 'canny', '--version', 'test-flux'], 9), (['--dp', '2'], 11),
    (['--tp', '2'], 11), (['--sp', '2'], 11), (['--transformer_8bit', 'true'], 9),
], ids=['control', 'dp', 'tp', 'sp', 'transformer_8bit'])
def test_unported_flags_raise(tmp_path, images, flags, item):
    args = ['--version', 'test-sd', '--img_size', '64', '--device', 'cpu', '--prompt', 'a',
            '--input_dir', str(images / 'imgA.png'), '--output_dir', str(tmp_path), '--layer',
            '{"mid-vit-out": true}', *flags]
    with pytest.raises(NotImplementedError, match=f'ROADMAP.md, Queue A item {item}:'):
        port_cli.main(args)
    assert os.listdir(tmp_path) == []


def test_cli_profile_writes_trace(tmp_path, images):
    port_cli.main(['--version', 'test-sd', '--img_size', '64', '--device', 'cpu',
                   '--prompt', 'a', '--input_dir', str(images / 'imgA.png'),
                   '--output_dir', str(tmp_path / 'out'), '--layer', '{"mid-vit-out": true}',
                   '--profile', str(tmp_path / 'prof')])
    trace = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    assert trace['traceEvents']
    assert _tree(tmp_path / 'out') == ['mid-vit-out/train0.npy']
