"""The port's deployment bundles (``diffusion_feature_tpu_torch/io/bundle.py``,
``models/convert.load_bundle_into``, ``FeatureExtractor.save_converted``,
``make_bundle``) against the JAX package's (``diffusion_feature_tpu/io/bundle.py``),
on the CPU at small size:

- bundles the JAX facade's ``save_converted`` writes from the synthetic
  test-sd, test-pixart and test-flux trees (int8 transformer and T5 at
  fp32; a bf16 transformer beside an int8 T5 at bfloat16) load into the
  port with default arguments, every parameter ``torch.equal`` to the
  port's own load of the tree, the taps within 1e-4 relative L2 of the
  JAX extractor's at fp32 on the JAX key chain's noise;
- the port's own bundle round-trips bit for bit (fp32 and int8, bfloat16
  with fp32 scales, a merged LoRA), also through ``make_bundle``;
- each refusal of tests/test_bundle.py, against the port; the JAX facade
  refuses the port's bundle;
- a JAX bundle's transposes stage one leaf at a time, and none on the host.
"""

import json
import os
import shutil
import weakref

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu_torch import FeatureExtractor, make_bundle
from diffusion_feature_tpu_torch.io import bundle as port_bundle
from diffusion_feature_tpu_torch.io.safetensors import save_file
from diffusion_feature_tpu_torch.models import convert
from jax_layout import jax_leaves
from port_parity import jax_noise
from synth_checkpoint import write_flux_checkpoint, write_pixart_checkpoint, write_sd_checkpoint

SEED, BATCH, SIZE, PROMPT = 0, 2, 64, 'a photo of a cat'
# fp32 on both sides: the slices' relative L2 for taps
REL = 1e-4
FLUX_LAYERS = {'vit-block0-out': True, 'vit-block3-out': True, 'vit-block1-q': True}
#: case -> (version, layers, dtype, JAX int8 flags, t); the trees come
#: from the fixture of the same version
CASES = {
    'test-sd': ('test-sd', {'up-level1-repeat0-res-out': True, 'mid-vit-block0-self-q': True},
                'float32', {}, 50),
    'test-pixart': ('test-pixart', {'vit-block0-out': True, 'vit-block1-out': True}, 'float32',
                    {}, 50),
    'test-flux-int8': ('test-flux', FLUX_LAYERS, 'float32', {}, 500),
    'test-flux-bf16': ('test-flux', FLUX_LAYERS, 'bfloat16', {'transformer_8bit': False}, 500),
}


@pytest.fixture(scope='module')
def flux_tree(tmp_path_factory):
    return write_flux_checkpoint(str(tmp_path_factory.mktemp('flux_tree')))


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


@pytest.fixture(scope='module')
def trees(tmp_path_factory, flux_tree):
    """The synthetic trees of tests/synth_checkpoint.py: test-sd's (the
    ``test_checkpoint_load.checkpoint_dir`` tree: U-Net, VAE, a CLIP whose
    config departs from the preset), test-pixart's and test-flux's.  Their
    values are numpy and torch draws; the Flax ``init`` the writers call
    gives only parameter shapes, so it is traced (``jax.eval_shape``)
    instead of run eagerly: the files are the same, ~15 s sooner."""
    init = flax_nn.Module.init

    def shapes_only(self, *args, **kwargs):
        return jax.eval_shape(lambda: init(self, *args, **kwargs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Module, 'init', shapes_only)
        return {'test-sd': write_sd_checkpoint(str(tmp_path_factory.mktemp('sd'))),
                'test-flux': flux_tree,
                'test-pixart': write_pixart_checkpoint(str(tmp_path_factory.mktemp('pixart')))}


@pytest.fixture(scope='module')
def jax_bundles(tmp_path_factory, trees, image):
    """{case: (bundle dir, (prompt embeddings, JAX taps) or None)}: each
    case's JAX facade on its tree and its bundle; at fp32 the JAX extract
    from a fresh key chain on the prompt embeddings of the port's load of
    the tree (whose text encoders the test holds bit for bit to the
    bundle's: JAX's own encode would compile three more programs)."""
    out = {}
    for case, (version, layers, dtype, flags, t) in CASES.items():
        jfe = JaxFeatureExtractor(layers, version, img_size=SIZE, dtype=dtype,
                                  weights=trees[version], train_unet=True, **flags)
        root = jfe.save_converted(str(tmp_path_factory.mktemp('jax_bundle') / case))
        taps = None
        if dtype == 'float32':
            prompts = tuple(None if p is None else p.numpy()
                            for p in _port(version, layers, dtype, trees[version],
                                           **flags).encode_prompt(PROMPT))
            jfe._rng = jax.random.PRNGKey(SEED)
            ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=t)
            taps = (prompts, {k: np.asarray(v) for k, v in ref.items()})
        out[case] = (root, taps)
    return out


@pytest.fixture(scope='module')
def port_flux_bundle(tmp_path_factory, flux_tree):
    """(the port's int8 test-flux at fp32 from the tree, its bundle)."""
    fe = FeatureExtractor(FLUX_LAYERS, 'test-flux', device='cpu', img_size=SIZE,
                          dtype='float32', weights=flux_tree)
    return fe, fe.save_converted(str(tmp_path_factory.mktemp('port_bundle') / 'b'))


def _port(version, layers, dtype, weights, **kw):
    return FeatureExtractor(layers, version, device='cpu', img_size=SIZE, dtype=dtype,
                            weights=weights, **kw)


def _modules(fe):
    return [fe.unet, *([fe.vae] if fe.vae is not None else []), *fe.text_encoders]


def _assert_same_params(a, b):
    for x, y in zip(_modules(a), _modules(b), strict=True):
        sx, sy = x.state_dict(), y.state_dict()
        assert sx.keys() == sy.keys(), type(x).__name__
        for key in sx:
            assert sx[key].dtype == sy[key].dtype and torch.equal(sx[key], sy[key]), key


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(ours.double().numpy() - ref) / np.linalg.norm(ref)


def _port_step(fe, prompts, image, t):
    posterior, noise = jax_noise(SEED, fe.latent_shape(BATCH))
    cond = fe._step_conditioning(
        tuple(None if p is None else torch.as_tensor(np.array(p)) for p in prompts), BATCH)
    return fe._step(torch.from_numpy(image), cond, fe._step_kit(t), posterior, noise, None)


# ------------------------------------------------------------ JAX bundles
@pytest.mark.parametrize('case', list(CASES))
def test_jax_bundle_loads_as_the_tree(case, jax_bundles, trees, image):
    """The port reads the JAX package's bundle with default arguments: the
    int8 flags resolve from its manifest, every parameter equals the port's
    own load of the tree the bundle was converted from (its int8 bits
    included: ``quantize_int8`` is JAX's bit for bit), and at fp32 every
    tap is within 1e-4 of the JAX extractor's."""
    version, layers, dtype, flags, t = CASES[case]
    root, taps = jax_bundles[case]
    manifest = json.load(open(os.path.join(root, port_bundle.MANIFEST)))
    assert manifest['kind'] == port_bundle.JAX_KIND
    ours = _port(version, layers, dtype, root)
    cold = _port(version, layers, dtype, trees[version], **flags)
    assert ours.spec == cold.spec
    assert set(ours.load_stats) == set(cold.load_stats)
    _assert_same_params(ours, cold)
    if version == 'test-flux':
        assert ours._int8_denoiser == (dtype == 'float32') and ours.spec.t5.quantize_int8
    if taps is None:
        # bfloat16 stored as uint16 bit patterns
        assert {e['dtype'] for e in manifest['leaves']} == {'bfloat16', 'int8', 'float32'}
        return
    prompts, ref = taps
    feats = _port_step(ours, prompts, image, t)
    assert sorted(feats) == sorted(ref) == sorted(layers)
    for key in ref:
        assert _rel(feats[key], ref[key]) <= REL, key


def test_numpy_jax_layout_writes_what_jax_writes(jax_bundles, port_flux_bundle):
    """tests/jax_layout.py (the JAX-free writer tests/test_torch_cuda.py
    uses) gives every leaf of the JAX bundle of the same int8 test-flux its
    JAX name, shape, dtype and value."""
    fe, _ = port_flux_bundle
    theirs = port_bundle.Bundle(jax_bundles['test-flux-int8'][0])
    for component, module in zip(('transformer', 'vae', 'text_encoder', 'text_encoder_2'),
                                 _modules(fe)):
        ref, ours = theirs.leaves(component), jax_leaves(module)
        assert ref.keys() == ours.keys(), component
        for name, t in ref.items():
            assert t.dtype == ours[name].dtype and torch.equal(t, ours[name]), name


def test_jax_leaves_stage_one_at_a_time_and_never_on_the_host(jax_bundles, monkeypatch):
    """The JAX layout's transposes run where the module lives: each leaf is
    staged there alone (one staged tensor alive at a time, so a load peaks
    at the resident bytes plus the largest leaf), and on the CPU the staged
    tensor is the memory-mapped file itself, no copy."""
    root = jax_bundles['test-flux-int8'][0]
    staged, alive, peak = [], [0], [0]
    real = convert._stage

    def counting(t, device):
        # a Python object of its own, which dies when the loader drops it
        out = real(t, device).view(t.shape)
        assert out.data_ptr() == t.data_ptr()
        alive[0] += 1
        peak[0] = max(peak[0], alive[0])
        weakref.finalize(out, lambda: alive.__setitem__(0, alive[0] - 1))
        staged.append(t.numel() * t.element_size())
        return out

    monkeypatch.setattr(convert, '_stage', counting)
    fe = _port('test-flux', FLUX_LAYERS, 'float32', root)
    leaves = sum(len(port_bundle.Bundle(root).leaves(c))
                 for c in ('unet', 'vae', 'text_encoder', 'text_encoder_2'))
    assert peak[0] == 1 and 0 < len(staged) < leaves
    assert sum(staged) < sum(n for n, _ in fe.load_stats.values())


def test_jax_facade_refuses_the_port_bundle(port_flux_bundle):
    """The JAX package is not changed for the port's bundle: its leaf count
    or its leaf paths never match a Flax tree, so it raises ValueError."""
    _, root = port_flux_bundle
    with pytest.raises(ValueError, match='bundle'):
        JaxFeatureExtractor(FLUX_LAYERS, 'test-flux', img_size=SIZE, dtype='float32',
                            weights=root)


# ------------------------------------------------------------ the port's own
def _lora(fe, path):
    """A rank-2 peft LoRA over the first two Linear layers of ``fe``'s U-Net."""
    rs = np.random.RandomState(7)
    names = [n for n, m in fe.unet.named_modules() if isinstance(m, torch.nn.Linear)][:2]
    state = {}
    for name in names:
        o, i = fe.unet.get_submodule(name).weight.shape
        state[f'unet.{name}.lora_A.weight'] = torch.from_numpy(rs.randn(2, i).astype(np.float32))
        state[f'unet.{name}.lora_B.weight'] = torch.from_numpy(rs.randn(o, 2).astype(np.float32))
    save_file(state, path)
    return names


@pytest.mark.parametrize('case', ['float32-int8', 'bfloat16-int8', 'lora'])
def test_port_bundle_round_trips_bit_for_bit(case, trees, tmp_path, image):
    """``save_converted`` writes each module's tensors as they are held
    (int8 ``weight_q`` with its fp32 ``scale``, bf16 at bfloat16, a merged
    LoRA's weights) with the configuration in the manifest; a load with
    default arguments gives every tensor back bit for bit, and the
    configs and tokenizers are copied."""
    if case == 'lora':
        version, layers, dtype = 'test-sd', CASES['test-sd'][1], 'float32'
        plain = _port(version, layers, dtype, trees[version])
        lora = str(tmp_path / 'lora.safetensors')
        merged_names = _lora(plain, lora)
        src = _port(version, layers, dtype, trees[version], offline_lora=lora)
        for name in merged_names:
            assert not torch.equal(src.unet.get_submodule(name).weight,
                                   plain.unet.get_submodule(name).weight)
    else:
        version, layers, dtype = 'test-flux', FLUX_LAYERS, case.split('-')[0]
        src = _port(version, layers, dtype, trees[version])
        assert src._int8_denoiser
    root = src.save_converted(str(tmp_path / 'bundle'))
    manifest = json.load(open(os.path.join(root, port_bundle.MANIFEST)))
    assert manifest['format'] == 1 and manifest['kind'] == port_bundle.KIND
    assert manifest['meta'] == src._bundle_meta()
    assert manifest['meta']['offline_lora'] == (lora if case == 'lora' else None)
    counts = {}
    for e in manifest['leaves']:
        counts[e['dtype']] = counts.get(e['dtype'], 0) + 1
    want = {'float32'} if case == 'lora' else {dtype, 'int8', 'float32'}
    assert set(counts) == want
    dirs = {'test-sd': ['text_encoder', 'unet', 'vae'],
            'test-flux': ['text_encoder', 'text_encoder_2', 'transformer', 'vae']}[version]
    configs = [d for d in os.listdir(root) if os.path.isfile(os.path.join(root, d, 'config.json'))]
    assert sorted(configs) == dirs
    loaded = _port(version, layers, dtype, root)
    assert loaded.spec == src.spec
    _assert_same_params(loaded, src)
    assert set(loaded.load_stats) == {e['component'] for e in manifest['leaves']}
    if case == 'float32-int8':
        prompts = src.encode_prompt(PROMPT)
        for a, b in zip(prompts, loaded.encode_prompt(PROMPT)):
            assert (a is None and b is None) or torch.equal(a, b)
        ours, ref = (_port_step(fe, prompts, image, 500) for fe in (loaded, src))
        assert all(torch.equal(ours[k], ref[k]) for k in ref)
    if case == 'lora':
        with pytest.raises(ValueError, match='bundle'):
            _port(version, layers, dtype, root, offline_lora=lora)


@pytest.mark.parametrize('flags', [[], ['--no_transformer_8bit', '--no_t5_8bit']],
                         ids=['int8', 'full-precision'])
def test_make_bundle_cli(flags, flux_tree, tmp_path, capsys):
    """``python -m diffusion_feature_tpu_torch.make_bundle`` with the JAX
    tool's flags and ``--device cpu``: the manifest records the int8
    flags, and a load with default arguments equals the tree's load under
    them."""
    out = make_bundle.main(['--version', 'test-flux', '--weights', flux_tree, '--out',
                            str(tmp_path / 'b'), '--dtype', 'float32', '--img_size', str(SIZE),
                            '--device', 'cpu', *flags])
    assert 'exported to' in capsys.readouterr().out
    int8 = not flags
    meta = port_bundle.read_meta(out)
    assert (meta['transformer_8bit'], meta['t5_8bit']) == (int8, int8)
    loaded = _port('test-flux', FLUX_LAYERS, 'float32', out)
    _assert_same_params(loaded, _port('test-flux', FLUX_LAYERS, 'float32', flux_tree,
                                      transformer_8bit=int8, t5_8bit=int8))


# ------------------------------------------------------------ refusals
def test_int8_bundle_into_full_precision_names_the_flags(port_flux_bundle, jax_bundles):
    """Explicit flags win over the manifest; a real mismatch names each
    differing meta entry (both kinds of bundle)."""
    for root in (port_flux_bundle[1], jax_bundles['test-flux-int8'][0]):
        with pytest.raises(ValueError, match='transformer_8bit: bundle=True vs this '
                                             'extractor=False'):
            _port('test-flux', FLUX_LAYERS, 'float32', root, transformer_8bit=False,
                  t5_8bit=False)


def test_lora_on_bundle_raises(port_flux_bundle):
    with pytest.raises(ValueError, match='bundle'):
        _port('test-flux', FLUX_LAYERS, 'float32', port_flux_bundle[1],
              offline_lora='nonexistent')


def test_cross_dtype_load_raises(port_flux_bundle, jax_bundles):
    """Leaves load as stored: another serving dtype is refused, not cast."""
    for root in (port_flux_bundle[1], jax_bundles['test-flux-bf16'][0]):
        dtype = 'bfloat16' if root == port_flux_bundle[1] else 'float32'
        with pytest.raises(ValueError, match='re-export the bundle at the serving dtype'):
            _port('test-flux', FLUX_LAYERS, dtype, root)


def test_save_into_nonempty_dir_raises(port_flux_bundle):
    fe, root = port_flux_bundle
    with pytest.raises(ValueError, match='not empty'):
        fe.save_converted(root)


def test_failed_export_leaves_nothing(port_flux_bundle, tmp_path, monkeypatch):
    """All or nothing: a write that fails midway (a full disk) leaves no
    half bundle, and the retry needs no clean-up."""
    fe, _ = port_flux_bundle
    target = tmp_path / 'bundle_atomic'
    calls = {'n': 0}
    real = port_bundle.save_file

    def failing(tensors, path):
        calls['n'] += 1
        if calls['n'] > 2:
            raise OSError('No space left on device (simulated)')
        return real(tensors, path)

    monkeypatch.setattr(port_bundle, 'save_file', failing)
    with pytest.raises(OSError):
        fe.save_converted(str(target))
    monkeypatch.undo()
    assert os.listdir(tmp_path) == []
    root = fe.save_converted(str(target))
    assert port_bundle.is_bundle(root)


@pytest.mark.parametrize('kind', ['port', 'jax'])
def test_tampered_leaf_raises_corrupt(kind, port_flux_bundle, jax_bundles, tmp_path):
    """Each leaf's file is held to the manifest: a file replaced out of band
    fails as 'corrupt', not as a configuration mismatch."""
    src = port_flux_bundle[1] if kind == 'port' else jax_bundles['test-flux-int8'][0]
    root = shutil.copytree(src, tmp_path / 'b')
    leaves = json.load(open(root / port_bundle.MANIFEST))['leaves']
    victim = next(e for e in leaves if 'vae' in e['path'])
    if kind == 'port':
        save_file({victim['key']: torch.zeros(1, 2, 3, dtype=torch.float64)},
                  str(root / victim['file']))
    else:
        np.save(root / victim['file'], np.zeros((1, 2, 3), np.float64))
    with pytest.raises(ValueError, match='corrupt; re-export it'):
        _port('test-flux', FLUX_LAYERS, 'float32', str(root))


def test_save_without_weights_raises(tmp_path):
    fe = _port('test-flux', FLUX_LAYERS, 'float32', None)
    with pytest.raises(ValueError, match='real weights'):
        fe.save_converted(str(tmp_path / 'b'))


def test_save_after_persistent_offload_raises(flux_tree, tmp_path):
    fe = _port('test-flux', FLUX_LAYERS, 'float32', flux_tree)
    fe.offload_prompt_encoder(persistent=True)
    with pytest.raises(ValueError, match='offloaded'):
        fe.save_converted(str(tmp_path / 'b'))
