"""The PyTorch port's checkpoint loader against the JAX package's: the
safetensors reader and writer (against the ``safetensors`` package), weight
set selection, ``.bin`` files, the config adapters, LoRA merging, and two
checkpoint dirs loaded by both facades end to end at fp32 (``test-sd`` from
tests/synth_checkpoint.py, ``test-xl`` written by the port itself).

The port's step takes the JAX key chain's noise (port_parity.jax_noise);
taps agree within the step tolerance of tests/test_torch_sd15.py.
"""

import copy
import dataclasses
import json
import os
import struct

import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from safetensors import safe_open

from diffusion_feature_tpu import FeatureExtractor as JaxFeatureExtractor
from diffusion_feature_tpu.models import clip_text as jclip
from diffusion_feature_tpu.models import convert as jconvert
from diffusion_feature_tpu.models import lora as jlora
from diffusion_feature_tpu.models import unet2d as junet
from diffusion_feature_tpu.models import vae as jvae
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch import facade as port_facade
from diffusion_feature_tpu_torch.io.safetensors import DTYPES, load_file, save_file
from diffusion_feature_tpu_torch.models import clip_text, convert, lora, unet2d, vae
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from port_parity import jax_noise
from synth_checkpoint import write_sd_checkpoint
from test_golden_parity import TINY_CFG

SIZE, BATCH, SEED = 64, 2, 0
ATOL, RTOL = 5e-4, 1e-4          # tests/test_torch_sd15.py's step tolerance
LAYERS = {'down-level0-repeat0-vit-block0-self-q': True, 'mid-vit-block0-cross-q': True,
          'up-level1-repeat0-res-out': True, 'unet-out': True}
PROMPT = 'a photo of a cat'


# ------------------------------------------------------------ safetensors
def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)

    def make(shape):
        if dtype == torch.bool:
            return torch.rand(shape, generator=g) > 0.5
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g).to(dtype)
        low = 0 if dtype == torch.uint8 else -100
        return torch.randint(low, 100, shape, generator=g).to(dtype)

    return {'matrix': make((3, 5)), 'scalar': make(()), 'empty': make((0, 4)), 'vec': make((7,))}


@pytest.mark.parametrize('names', [[n] for n in DTYPES] + [list(DTYPES)],
                         ids=[*DTYPES, 'mixed'])
def test_safetensors_round_trip(tmp_path, names):
    """Ours -> the package and the package -> ours, tensors and metadata, for
    every dtype (the 'mixed' file holds one of each, misaligned unless the
    writer orders them); numpy's reader too, except BF16."""
    tensors = {f'{n}.{k}': v for i, n in enumerate(names)
               for k, v in _tensors(DTYPES[n], i).items()}
    meta = {'format': 'pt', 'note': 'round trip'}
    ours, theirs = str(tmp_path / 'ours.safetensors'), str(tmp_path / 'theirs.safetensors')
    save_file(tensors, ours, metadata=meta)
    safetensors.torch.save_file(tensors, theirs, metadata=meta)
    with safe_open(ours, framework='pt') as f:
        assert f.metadata() == meta
    for got in (safetensors.torch.load_file(ours), load_file(theirs), load_file(ours)):
        assert got.keys() == tensors.keys()
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v)
    if 'BF16' not in names:
        ref = safetensors.numpy.load_file(ours)
        theirs_np = str(tmp_path / 'numpy.safetensors')
        safetensors.numpy.save_file({k: v.numpy() for k, v in tensors.items()}, theirs_np)
        got = load_file(theirs_np)
        for k, v in tensors.items():
            np.testing.assert_array_equal(ref[k], v.numpy())
            assert torch.equal(got[k], v)


def _raw(header, data: bytes, declared=None) -> bytes:
    blob = json.dumps(header).encode()
    return struct.pack('<Q', len(blob) if declared is None else declared) + blob + data


F32x2 = {'dtype': 'F32', 'shape': [2]}


@pytest.mark.parametrize('raw,match', [
    (_raw({'a': {**F32x2, 'data_offsets': [0, 8]}}, bytes(8), declared=10 ** 6), 'header of'),
    (_raw({'a': {**F32x2, 'data_offsets': [0, 8]}, 'b': {**F32x2, 'data_offsets': [4, 12]}},
          bytes(12)), 'overlap'),
    (_raw({'a': {'dtype': 'F32', 'shape': [4], 'data_offsets': [0, 16]}}, bytes(8)),
     'leave the data'),
    (_raw({'a': {'dtype': 'F8_E4M3', 'shape': [2], 'data_offsets': [0, 2]}}, bytes(2)),
     'unknown dtype'),
    (_raw({'a': {**F32x2, 'data_offsets': [0, 4]}}, bytes(4)), 'need 8'),
    (b'\x01\x00', 'too short'),
], ids=['header-too-long', 'overlap', 'outside-data', 'unknown-dtype', 'size-mismatch',
        'truncated'])
def test_safetensors_rejects_malformed(tmp_path, raw, match):
    path = tmp_path / 'bad.safetensors'
    path.write_bytes(raw)
    with pytest.raises(ValueError, match=match):
        load_file(str(path))


# ------------------------------------------------------------ weight sets
MAIN, FP16 = 'diffusion_pytorch_model.safetensors', 'diffusion_pytorch_model.fp16.safetensors'
BF16 = 'diffusion_pytorch_model.bf16.safetensors'
SHARDS = ('diffusion_pytorch_model-00001-of-00002.safetensors',
          'diffusion_pytorch_model-00002-of-00002.safetensors')
LAYOUTS = {   # tests/test_checkpoint_load.py::TestVariantSelection's layouts
    'main-preferred': ({MAIN: {'w': np.ones((2, 2), np.float32)},
                        FP16: {'w': np.zeros((2, 2), np.float16)}}, None),
    'ambiguous-variants': ({FP16: {'w': np.zeros((2,), np.float16)},
                            BF16: {'w': np.zeros((2,), np.float32)}}, None),
    'variant-selected': ({MAIN: {'w': np.full((2,), 32.0, np.float32)},
                          FP16: {'w': np.full((2,), 16.0, np.float16)}}, 'fp16'),
    'variant-main': ({MAIN: {'w': np.full((2,), 32.0, np.float32)},
                      FP16: {'w': np.full((2,), 16.0, np.float16)}}, 'main'),
    'variant-falls-back': ({MAIN: {'w': np.full((2,), 32.0, np.float32)},
                            FP16: {'w': np.full((2,), 16.0, np.float16)}}, 'bf16'),
    'absent-variant-no-main': ({FP16: {'w': np.ones((2,), np.float16)}}, 'bf16'),
    'lone-variant': ({FP16: {'w': np.ones((2,), np.float16)}}, None),
    'sharded': ({SHARDS[0]: {'a': np.ones((2,), np.float32)},
                 SHARDS[1]: {'b': np.zeros((3,), np.float32)}}, None),
    'empty-dir': ({}, None),
}


def _same_state(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        v = np.asarray(v)
        if v.dtype == ml_dtypes.bfloat16:
            assert ours[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(ours[k].float().numpy(), v.astype(np.float32))
        else:
            assert ours[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(ours[k].numpy(), v)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_weight_set_selection_equals_jax(tmp_path, layout):
    files, variant = LAYOUTS[layout]
    for name, state in files.items():
        safetensors.numpy.save_file(state, str(tmp_path / name))
    try:
        ref = jconvert.load_safetensors_dir(str(tmp_path), variant=variant)
    except (ValueError, FileNotFoundError) as e:
        with pytest.raises(type(e)):
            convert.load_safetensors_dir(str(tmp_path), variant=variant)
        assert layout in ('ambiguous-variants', 'absent-variant-no-main', 'empty-dir')
        return
    _same_state(convert.load_safetensors_dir(str(tmp_path), variant=variant), ref)


@pytest.mark.parametrize('nested', [False, True], ids=['state-dict', 'nested-state-dict'])
def test_bin_equals_jax_reader(tmp_path, nested):
    """A torch .bin (a module's OrderedDict, bf16 and int64 tensors, a
    non-tensor entry) reads to the JAX restricted unpickler's arrays, alone
    and through the dir loader."""
    state = torch.nn.Linear(3, 4).state_dict()
    state['half'] = torch.randn(2, 3).half()
    state['brain'] = torch.randn(5).bfloat16()
    state['position_ids'] = torch.arange(7)[None]
    state['scalar'] = torch.tensor(2.5)
    obj = {'state_dict': state, 'epoch': 3} if nested else state
    torch.save(obj, tmp_path / 'diffusion_pytorch_model.bin')
    path = str(tmp_path / 'diffusion_pytorch_model.bin')
    ref = jconvert.load_torch_bin(path)
    _same_state(convert.load_torch_bin(path), ref)
    _same_state(convert.load_safetensors_dir(str(tmp_path)), ref)


# ------------------------------------------------------- config adapters
def _same_fields(ours, ref):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


SD15_UNET_JSON = {   # stable-diffusion-v1-5 unet/config.json (the fields read)
    '_class_name': 'UNet2DConditionModel', 'attention_head_dim': 8,
    'block_out_channels': [320, 640, 1280, 1280], 'cross_attention_dim': 768,
    'down_block_types': ['CrossAttnDownBlock2D'] * 3 + ['DownBlock2D'], 'in_channels': 4,
    'layers_per_block': 2, 'norm_eps': 1e-05, 'out_channels': 4,
    'up_block_types': ['UpBlock2D'] + ['CrossAttnUpBlock2D'] * 3, 'flip_sin_to_cos': True,
    'freq_shift': 0}
SDXL_UNET_JSON = {   # stable-diffusion-xl-base-1.0 unet/config.json
    '_class_name': 'UNet2DConditionModel', 'addition_embed_type': 'text_time',
    'addition_time_embed_dim': 256, 'attention_head_dim': [5, 10, 20],
    'block_out_channels': [320, 640, 1280], 'cross_attention_dim': 2048,
    'down_block_types': ['DownBlock2D', 'CrossAttnDownBlock2D', 'CrossAttnDownBlock2D'],
    'in_channels': 4, 'layers_per_block': 2, 'num_attention_heads': None,
    'projection_class_embeddings_input_dim': 2816, 'transformer_layers_per_block': [1, 2, 10],
    'up_block_types': ['CrossAttnUpBlock2D', 'CrossAttnUpBlock2D', 'UpBlock2D'],
    'upcast_attention': None, 'use_linear_projection': True}


@pytest.mark.parametrize('cfg,preset', [
    ({k: list(v) if isinstance(v, tuple) else v for k, v in TINY_CFG.items()}, None),
    ({**TINY_CFG, 'addition_embed_type': 'text_time', 'addition_time_embed_dim': 32,
      'projection_class_embeddings_input_dim': 224}, None),
    (SD15_UNET_JSON, unet2d.SD15_UNET), (SDXL_UNET_JSON, unet2d.SDXL_UNET),
    (unet2d.SDXL_UNET.to_diffusers_config(), unet2d.SDXL_UNET),
    (unet2d.tiny_unet_config(64, True).to_diffusers_config(), unet2d.tiny_unet_config(64, True)),
], ids=['tiny', 'tiny-xl', 'sd15', 'sdxl', 'sdxl-written', 'test-xl-written'])
def test_unet_config_adapter_equals_jax(cfg, preset):
    ours = unet2d.UNetConfig.from_diffusers_config(cfg)
    ref = junet.UNetConfig.from_diffusers_config(cfg)
    # diffusers writes a null upcast_attention, which JAX keeps as None and
    # the port reads as False: both run without upcast
    _same_fields(ours, dataclasses.replace(ref, upcast_attention=bool(ref.upcast_attention)))
    assert preset is None or ours == preset


def test_unet_upcast_attention_is_not_ported():
    """Named for what it held before upcast_attention was ported: now that
    ``upcast_attention: true`` adapts, as JAX's adapter does."""
    ours = unet2d.UNetConfig.from_diffusers_config({**SD15_UNET_JSON, 'upcast_attention': True})
    assert ours == dataclasses.replace(unet2d.SD15_UNET, upcast_attention=True)
    _same_fields(ours, junet.UNetConfig.from_diffusers_config(
        {**SD15_UNET_JSON, 'upcast_attention': True}))


SDXL_VAE_JSON = {'_class_name': 'AutoencoderKL', 'block_out_channels': [128, 256, 512, 512],
                 'in_channels': 3, 'latent_channels': 4, 'layers_per_block': 2,
                 'out_channels': 3, 'sample_size': 1024, 'scaling_factor': 0.13025,
                 'norm_num_groups': 32}


@pytest.mark.parametrize('cfg,preset', [
    (dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=[32, 32],
          layers_per_block=1, scaling_factor=0.18215), vae.tiny_vae_config()),
    ({**SDXL_VAE_JSON, 'scaling_factor': 0.18215}, vae.SD_VAE),
    (SDXL_VAE_JSON, vae.SDXL_VAE), ({**SDXL_VAE_JSON, 'shift_factor': None}, vae.SDXL_VAE),
    (vae.SDXL_VAE.to_diffusers_config(), vae.SDXL_VAE),
], ids=['tiny', 'sd15', 'sdxl', 'null-shift', 'sdxl-written'])
def test_vae_config_adapter_equals_jax(cfg, preset):
    ours = vae.VAEConfig.from_diffusers_config(cfg)
    _same_fields(ours, jvae.VAEConfig.from_diffusers_config(cfg))
    assert ours == preset
    # a VAE without quant convs (Flux's) adapts as in JAX
    no_quant = vae.VAEConfig.from_diffusers_config({**cfg, 'use_quant_conv': False})
    _same_fields(no_quant, jvae.VAEConfig.from_diffusers_config({**cfg, 'use_quant_conv': False}))
    assert no_quant == dataclasses.replace(preset, use_quant_conv=False)


VIT_L_JSON = {'architectures': ['CLIPTextModel'], 'hidden_act': 'quick_gelu',
              'hidden_size': 768, 'intermediate_size': 3072, 'num_attention_heads': 12,
              'num_hidden_layers': 12, 'projection_dim': 768, 'vocab_size': 49408}
BIGG_JSON = {'architectures': ['CLIPTextModelWithProjection'], 'hidden_act': 'gelu',
             'hidden_size': 1280, 'intermediate_size': 5120, 'num_attention_heads': 20,
             'num_hidden_layers': 32, 'projection_dim': 1280, 'vocab_size': 49408}
TINY_CLIP_JSON = {'vocab_size': 1000, 'hidden_size': 32, 'intermediate_size': 64,
                  'num_hidden_layers': 2, 'num_attention_heads': 2, 'projection_dim': 32,
                  'eos_token_id': 999}


@pytest.mark.parametrize('cfg,base,preset', [
    (VIT_L_JSON, clip_text.CLIP_VIT_L, clip_text.CLIP_VIT_L),
    (BIGG_JSON, clip_text.OPENCLIP_BIGG, clip_text.OPENCLIP_BIGG),
    (BIGG_JSON, None, clip_text.OPENCLIP_BIGG),
    (TINY_CLIP_JSON, clip_text.tiny_clip_config(32), None),
    (TINY_CLIP_JSON, clip_text.tiny_clip_config(32, projection_dim=32), None),
    ({**TINY_CLIP_JSON, 'architectures': ['CLIPTextModel']},
     clip_text.tiny_clip_config(32, projection_dim=32), None),
    (clip_text.OPENCLIP_BIGG.to_diffusers_config(), None, clip_text.OPENCLIP_BIGG),
    (clip_text.CLIP_VIT_L.to_diffusers_config(), clip_text.OPENCLIP_BIGG,
     clip_text.CLIP_VIT_L),
], ids=['vit-l', 'bigg', 'bigg-no-base', 'tiny', 'tiny-projection-base',
        'tiny-architectures', 'bigg-written', 'vit-l-written'])
def test_clip_config_adapter_equals_jax(cfg, base, preset):
    ours = clip_text.CLIPTextConfig.from_diffusers_config(cfg, base)
    jbase = None if base is None else jclip.CLIPTextConfig(**dataclasses.asdict(base))
    _same_fields(ours, jclip.CLIPTextConfig.from_diffusers_config(cfg, jbase))
    assert preset is None or ours == preset


# ------------------------------------------------- the facades end to end
@pytest.fixture(scope='module')
def sd_checkpoint(tmp_path_factory):
    return write_sd_checkpoint(tmp_path_factory.mktemp('sd_ckpt'))


def _jax_facade(root, version, **kwargs):
    """The JAX facade loading ``root`` at fp32 with fp32 features."""
    return JaxFeatureExtractor(LAYERS, version, img_size=SIZE, dtype='float32', seed=SEED,
                               train_unet=True, weights=root, **kwargs)


def _assert_step_matches_jax(jfe, port, seed_image=3):
    """The port's step on the JAX key chain's noise against JAX extract."""
    image = np.random.RandomState(seed_image).rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
    prompts = jfe.encode_prompt(PROMPT)
    ours_prompts = port.encode_prompt(PROMPT)
    for a, b in zip(ours_prompts, prompts):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    ref = jfe.extract(prompts, BATCH, image * 2 - 1, image_type='tensor', t=50)
    lat = SIZE // port.vae_scale
    posterior, noise = jax_noise(SEED, (BATCH, 4, lat, lat))
    pe = torch.from_numpy(np.array(prompts[0])).expand(BATCH, -1, -1)
    pooled = None if prompts[2] is None else torch.from_numpy(np.array(prompts[2])).expand(
        BATCH, -1)
    fa.launches = 0
    ours = port._step(torch.from_numpy(image * 2 - 1),
                      port._step_conditioning((pe, None, pooled, None), BATCH),
                      port._img2img_kit(50), posterior, noise, None)
    assert fa.launches == 0
    assert sorted(ours) == sorted(ref) == sorted(LAYERS)
    for key, val in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


@pytest.fixture(scope='module')
def sd_pair(sd_checkpoint):
    port = FeatureExtractor(LAYERS, 'test-sd', device='cpu', dtype='float32', img_size=SIZE,
                            weights=sd_checkpoint)
    return _jax_facade(sd_checkpoint, 'test-sd'), port


def test_sd_checkpoint_taps_match_jax(sd_checkpoint, sd_pair):
    """write_sd_checkpoint (torch_ref U-Net under dotted keys, a VAE with its
    decoder, a transformers CLIP narrower than the preset) in both facades."""
    jfe, port = sd_pair
    assert port.spec.text_encoders[0].intermediate_size == 64
    _same_fields(port.spec.text_encoders[0], jfe.spec.text_encoders[0])
    _assert_step_matches_jax(jfe, port)
    # the whole VAE loads: the decoder and post_quant_conv too, nothing unused
    state = convert.load_component_state(sd_checkpoint, 'vae')
    assert 'post_quant_conv.weight' in state
    assert any(k.startswith('decoder.up_blocks.') for k in state)
    assert convert.load_state_into(copy.deepcopy(port.vae), state, torch.float32, 'cpu') == []
    # so does an older CLIP checkpoint's I64 position_ids
    state = {**convert.load_component_state(sd_checkpoint, 'text_encoder'),
             'text_model.embeddings.position_ids': torch.arange(77)[None]}
    assert convert.load_state_into(copy.deepcopy(port.text_encoders[0]), state, torch.float32,
                                   'cpu') == ['text_model.embeddings.position_ids']


def _write_tokenizer(d):
    """A byte-level BPE vocabulary of 1000 ids (test-xl's) with two merges
    and the specials at 998/999, the CLIP eos id of the tiny configs."""
    from diffusion_feature_tpu_torch.tokenizers.clip_bpe import bytes_to_unicode
    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + '</w>': 256 + i for i, c in enumerate(chars)})
    vocab.update({'ca': 512, 'cat</w>': 513, '<|startoftext|>': 998, '<|endoftext|>': 999})
    os.makedirs(d)
    with open(os.path.join(d, 'vocab.json'), 'w') as f:
        json.dump(vocab, f)
    with open(os.path.join(d, 'merges.txt'), 'w') as f:
        f.write('#version: 0.2\nc a\nca t</w>\n')


@pytest.fixture(scope='module')
def xl_tree(tmp_path_factory):
    """(random-init test-xl extractor, the dir it wrote): bf16-variant names,
    the U-Net in two shards, a tokenizer_2 dir, and the whole VAE."""
    root = str(tmp_path_factory.mktemp('xl_tree'))
    src = FeatureExtractor(LAYERS, 'test-xl', device='cpu', dtype='float32', img_size=SIZE,
                           seed=5)
    src.save_weights(root, variant='bf16', unet_shards=2)
    _write_tokenizer(os.path.join(root, 'tokenizer_2'))
    return src, root


def test_port_written_xl_tree_matches_jax(xl_tree):
    """Two text encoders (text_projection on the second), a BPE tokenizer_2
    and a sharded variant U-Net, loaded by both facades."""
    src, root = xl_tree
    port = FeatureExtractor(LAYERS, 'test-xl', device='cpu', dtype='float32', img_size=SIZE,
                            weights=root, weights_variant='bf16')
    assert type(port.tokenizers[1]).__name__ == 'CLIPTokenizer'
    assert port.spec == src.spec
    _assert_step_matches_jax(_jax_facade(root, 'test-xl', weights_variant='bf16'), port)


def test_loaded_extractor_equals_random_init_source(xl_tree):
    """Same seed, weights written then loaded: equal parameters, and equal
    features through the public extract (the noise does not depend on
    whether the weights were drawn)."""
    src, root = xl_tree
    loaded = FeatureExtractor(LAYERS, 'test-xl', device='cpu', dtype='float32', img_size=SIZE,
                              weights=root, weights_variant='bf16', seed=5)
    for a, b in ((src.unet, loaded.unet), (src.vae, loaded.vae),
                 *zip(src.text_encoders, loaded.text_encoders)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    image = np.random.RandomState(4).rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
    # the loaded tree's tokenizer_2 is BPE, the source's a hash: one prompt
    prompts = src.encode_prompt(PROMPT)
    for _ in range(2):   # the second call draws the stream's next noise
        a = src.extract(prompts, BATCH, image, image_type='tensor', t=50)
        b = loaded.extract(prompts, BATCH, image, image_type='tensor', t=50)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_weights_build_no_random_init(sd_checkpoint, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('random init with weights=')
    monkeypatch.setattr(port_facade, 'random_module', refuse)
    fe = FeatureExtractor(LAYERS, 'test-sd', device='cpu', dtype='float32', img_size=SIZE,
                          weights=sd_checkpoint)
    assert set(fe.load_stats) == {'unet', 'vae', 'text_encoder'}
    assert not any(p.is_meta for m in (fe.unet, fe.vae, *fe.text_encoders)
                   for p in m.parameters())


@pytest.mark.parametrize('fault', ['missing', 'shape'])
def test_checkpoint_faults_raise(sd_checkpoint, tmp_path, fault):
    """A missing tensor or one of the wrong shape raises naming it."""
    state = dict(convert.load_component_state(sd_checkpoint, 'unet'))
    key = 'mid_block.attentions.0.proj_in.weight'
    if fault == 'missing':
        del state[key]
        match = r'1 parameters of UNet2DConditionModel not found.*proj_in\.weight'
    else:
        state[key] = state[key][..., 0, 0]    # a Linear's shape where a 1x1 conv is
        match = r'proj_in\.weight \(64, 64\) does not fit .*proj_in\.weight \(64, 64, 1, 1\)'
    for comp in ('vae', 'text_encoder'):
        os.symlink(os.path.join(sd_checkpoint, comp), tmp_path / comp)
    convert.save_component(str(tmp_path), 'unet', state,
                           convert.load_component_config(sd_checkpoint, 'unet'))
    with pytest.raises(ValueError, match=match):
        FeatureExtractor(LAYERS, 'test-sd', device='cpu', dtype='float32', img_size=SIZE,
                         weights=str(tmp_path))


def test_bundle_dir_is_refused(tmp_path):
    (tmp_path / 'tpu_bundle.json').write_text('{}')
    with pytest.raises(ValueError, match='deployment bundle'):
        FeatureExtractor(LAYERS, 'test-sd', device='cpu', img_size=SIZE, weights=str(tmp_path))


# ------------------------------------------------------------------- LoRA
def _lora_state(rs, dialect):
    """Rank-2 adapters over test-sd U-Net weights in one key dialect: two
    Linear projections and the 1x1-conv proj_in (a 4-d LoRA)."""
    d = lambda o, i: (rs.randn(2, i) * 0.3).astype(np.float32)          # noqa: E731
    u = lambda o, i: (rs.randn(o, 2) * 0.3).astype(np.float32)          # noqa: E731
    blk = 'down_blocks.0.attentions.0'
    targets = {f'{blk}.transformer_blocks.0.attn1.to_q': (32, 32),
               f'{blk}.transformer_blocks.0.attn2.to_v': (32, 32),
               f'{blk}.proj_in': (32, 32)}
    state = {}
    for path, (o, i) in targets.items():
        down, up = d(o, i), u(o, i)
        if path.endswith('proj_in'):
            down, up = down[..., None, None], up[..., None, None]
        if dialect == 'peft':
            state[f'unet.{path}.lora_A.weight'], state[f'unet.{path}.lora_B.weight'] = down, up
        elif dialect == 'legacy':
            state[f'{path}.lora.down.weight'], state[f'{path}.lora.up.weight'] = down, up
        else:
            base = 'lora_unet_' + path.replace('.', '_')
            state[f'{base}.lora_down.weight'], state[f'{base}.lora_up.weight'] = down, up
            state[f'{base}.alpha'] = np.array(1.0, np.float32)
    return state


@pytest.mark.parametrize('dialect', ['peft', 'legacy', 'kohya'])
def test_lora_pairs_and_merge_equal_jax(sd_pair, tmp_path, dialect):
    jfe, port = sd_pair
    state = _lora_state(np.random.RandomState(7), dialect)
    path = str(tmp_path / 'lora.safetensors')
    safetensors.numpy.save_file(state, path)
    ref = jlora.collect_lora_pairs(state)
    ours = lora.collect_lora_pairs(load_file(path))
    assert ours.keys() == ref.keys() and len(ours) == 3
    for k, (down, up, scale) in ref.items():
        np.testing.assert_array_equal(ours[k][0].numpy(), down)
        np.testing.assert_array_equal(ours[k][1].numpy(), up)
        assert ours[k][2] == scale
    merged_ref = jlora.apply_lora_to_params(jfe.params['unet'], str(tmp_path), 'lora.safetensors')
    unet = copy.deepcopy(port.unet)
    assert lora.apply_lora_to_module(unet, str(tmp_path), 'lora.safetensors') == 3
    want = convert.params_from_jax(merged_ref, unet)
    changed = 0
    for k, v in unet.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
        changed += not torch.equal(v, port.unet.state_dict()[k])
    assert changed == 3


def test_unmatched_lora_raises(sd_pair, tmp_path):
    _, port = sd_pair
    safetensors.numpy.save_file({'unet.nonexistent.lora_A.weight': np.zeros((2, 3), np.float32),
                                 'unet.nonexistent.lora_B.weight': np.zeros((3, 2), np.float32)},
                                str(tmp_path / 'lora.safetensors'))
    with pytest.raises(ValueError, match='matched no parameters'):
        lora.apply_lora_to_module(copy.deepcopy(port.unet), str(tmp_path))
    with pytest.raises(ValueError, match='matched no parameters'):
        jlora.apply_lora_to_params(sd_pair[0].params['unet'], str(tmp_path))
