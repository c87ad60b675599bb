"""The PyTorch port's HunyuanDiT against the JAX package, at the tiny
``test-hunyuan`` size on the CPU, at fp32: the DiT's taps at two timesteps
with the attention store, the img2img kit, ``encode_prompt``'s BERT and
mT5 streams with their masks, DDPM's v-prediction step, a 3-step
``sample()``, the 2-D RoPE, BERT and WordPiece, the full-size specs and
mT5, layer enumeration, one DiT against the torch transcription of the
reference (``tests/torch_ref.py::HunyuanDiT2DModel``) and a
``save_weights`` -> ``weights=`` round trip.

The port gets the JAX facade's parameters (numpy-drawn,
``port_parity.jax_facade``) and the noise of the JAX key chain.  At 64^2
the tiny VAE halves the image, so the DiT has 256 tokens of 2 heads x 16:
the JAX gates keep every attention on the explicit path and no Pallas
kernel runs (the d=88 kernels' twins are held to JAX's in
tests/test_torch_attention.py).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_feature_tpu.enumerate_layers import enumerate_layers as jax_enumerate_layers
from diffusion_feature_tpu.models import flux as jax_flux
from diffusion_feature_tpu.models import hunyuan as jax_hunyuan
from diffusion_feature_tpu.models.convert import convert_torch_state, rename_bert_keys
from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.models.t5 import T5EncoderModel as JaxT5
from diffusion_feature_tpu.schedulers import make_scheduler as jax_make_scheduler
from diffusion_feature_tpu.tokenizers import wordpiece as jax_wordpiece
from diffusion_feature_tpu_torch import FeatureExtractor
from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
from diffusion_feature_tpu_torch.models import bert_text, hunyuan
from diffusion_feature_tpu_torch.models.convert import params_from_jax
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.models.t5 import T5EncoderModel
from diffusion_feature_tpu_torch.ops import flash_attention as fa
from diffusion_feature_tpu_torch.ops import rope
from diffusion_feature_tpu_torch.schedulers.diffusion import DDPMScheduler, make_scheduler
from diffusion_feature_tpu_torch.taps import TapSpec, is_filtered_id
from diffusion_feature_tpu_torch.tokenizers import wordpiece
from diffusion_feature_tpu_torch.tokenizers.t5_tok import load_t5_tokenizer
from port_parity import (assert_params_round_trip, jax_ddpm_sample_noise, jax_facade, jax_noise,
                         load_jax_params)

VERSION, SIZE, BATCH, SEED = 'test-hunyuan', 64, 2, 0
# every tap kind of a first-half block, a skip-connected second-half one
# (3) and the block before it (2)
LAYERS = {f'vit-block{i}-{n}': True for i in (0, 3)
          for n in ('self-q', 'self-k', 'self-v', 'self-map', 'cross-q', 'cross-map',
                    'ffn-inner')}
LAYERS['vit-block2-self-q'] = True
STORE = dict(attention=['up_cross', 'up_self'], attn_store_sizes=(2, 30))
PROMPT = 'a photo of a cat'
LAT = SIZE // 2
# fp32 on both sides: the U-Net and PixArt slices' tolerance for taps and 'attn'
ATOL, RTOL = 5e-4, 1e-4


@pytest.fixture(scope='module')
def pair():
    """The JAX facade (fp32 features, numpy-drawn parameters) with taps and
    the store, and the port's with its parameters."""
    jfe = jax_facade(LAYERS, VERSION, SIZE, SEED, **STORE)
    port = FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                            **STORE)
    load_jax_params(jfe, port)
    return jfe, port


@pytest.fixture(scope='module')
def image():
    return np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32) * 2 - 1


def _torch(pairs):
    """encode_prompt pairs of JAX arrays as torch tensors."""
    return tuple((torch.from_numpy(np.array(e)), torch.from_numpy(np.array(m))) for e, m in pairs)


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol, rtol=RTOL)


def _jax_and_port(pair, image, t, port=None):
    """JAX ``extract`` from a fresh key chain, and the port's step (of
    ``port``, else the pair's) on the same noise, embeddings and masks."""
    jfe, ours_fe = pair
    port = port or ours_fe
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref = jfe.extract(prompts, BATCH, image, image_type='tensor', t=t)
    (pe, bmask), (t5, tmask) = _torch(prompts)
    posterior, noise = jax_noise(SEED, (BATCH, 4, LAT, LAT))
    fa.launches = fa.lse_launches = fa.headmean_launches = 0
    ours = port._step(torch.from_numpy(image), pe.expand(BATCH, -1, -1),
                      t5.expand(BATCH, -1, -1), port._step_kit(t), posterior, noise, None,
                      mask=(bmask.expand(BATCH, -1), tmask.expand(BATCH, -1)))
    assert (fa.launches, fa.lse_launches, fa.headmean_launches) == (0, 0, 0)
    return ours, ref


@pytest.mark.parametrize('t', [50, 500])
def test_extract_matches_jax(pair, image, t):
    """Every tap of both blocks and the store's 'attn' (each block's self
    and cross maps of the 16^2 tokens, averaged: 256 + 8 BERT + 8 T5 keys)."""
    ours, ref = _jax_and_port(pair, image, t)
    assert sorted(ours) == sorted(ref) == sorted([*LAYERS, 'attn'])
    assert ours['attn'].shape == (BATCH, 256 + 16, SIZE // 8, SIZE // 8)
    assert ours['vit-block3-cross-map'].shape == (BATCH, 2, 256, 16)
    assert ours['vit-block0-ffn-inner'].shape == (BATCH, 64, 16, 16)
    for key in ref:
        _close(ours[key], ref[key])


def test_hunyuan_kit_equals_jax(pair):
    """T, A and B of the 50-step DDPM ladder (steps_offset 1: t=50 -> 21)."""
    jfe, port = pair
    for t in (50, 200, 500, 999):
        assert port._hunyuan_kit(t) == jfe._hunyuan_kit(t)
    assert port._hunyuan_kit(50)['T'] == 21.0


def test_encode_prompt_matches_jax(pair):
    """((BERT embeddings, mask), (T5 embeddings, mask)): the hash
    tokenizers' ids padded to 8 tokens, the masks' ones on the tokens and
    EOS."""
    jfe, port = pair
    ours, ref = port.encode_prompt(PROMPT), jfe.encode_prompt(PROMPT)
    for (e, m), (re, rm), width in zip(ours, ref, (32, 32)):
        assert m.dtype == torch.int32 and m.shape == (1, 8) and int(m.sum()) == 5 + 1
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        assert e.shape == (1, 8, width)
        _close(e, re)


def test_public_extract_takes_a_string_and_refuses_what_jax_lacks(pair, image):
    """A raw prompt string, bf16 features; no denoising_from, no DDIM
    inversion, no 'vae-out', no ControlNet on HunyuanDiT."""
    _, port = pair
    feats = port.extract(PROMPT, BATCH, image, image_type='tensor', t=50)
    assert sorted(feats) == sorted([*LAYERS, 'attn'])
    assert all(v.dtype == torch.bfloat16 for v in feats.values())
    with pytest.raises(ValueError, match='denoising_from'):
        port.extract(PROMPT, 1, image[:1], image_type='tensor', denoising_from=60)
    with pytest.raises(NotImplementedError, match='use_ddim_inversion'):
        port.extract(PROMPT, 1, image[:1], image_type='tensor', use_ddim_inversion=True)
    with pytest.raises(ValueError, match="'vae-out' is unavailable"):
        FeatureExtractor({'vae-out': True}, VERSION, device='cpu', img_size=SIZE)
    with pytest.raises(ValueError, match='U-Net'):
        FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, control=['canny'])


# ------------------------------------------------------------------- DDPM
def test_ddpm_ladder_and_step_equal_jax():
    """HunyuanDiT's DDPM (v-prediction, fixed-small variance): the 50- and
    7-step ladders, then a 5-step walk from numpy draws with noise at every
    step (the last, t=1, adds it too)."""
    spec = get_model_spec(VERSION)
    ours = make_scheduler(spec.scheduler, spec.scheduler_config)
    ref = jax_make_scheduler('ddpm', jax_model_spec(VERSION).scheduler_config)
    assert isinstance(ours, DDPMScheduler)
    for steps in (50, 7):
        np.testing.assert_array_equal(ours.set_timesteps(steps).timesteps,
                                      ref.set_timesteps(steps).timesteps)
    np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    x_ours, x_ref = torch.from_numpy(x), x
    s_ours, s_ref = ours.set_timesteps(5), ref.set_timesteps(5)
    assert s_ref.timesteps[-1] == 1
    for t in s_ref.timesteps:
        out, noise = (rs.randn(2, 4, 8, 8).astype(np.float32) for _ in range(2))
        x_ours, _ = ours.step(s_ours, torch.from_numpy(out), t, x_ours, torch.from_numpy(noise))
        x_ref, _ = ref.step(s_ref, out, t, x_ref, noise)
        np.testing.assert_allclose(x_ours.numpy(), np.asarray(x_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('field', ['variance_type', 'thresholding'])
def test_ddpm_of_deepfloyd_if_names_its_item(field):
    cfg = dataclasses.replace(get_model_spec(VERSION).scheduler_config,
                              **{field: 'learned_range' if field == 'variance_type' else True})
    with pytest.raises(NotImplementedError, match="Queue A item 9: 'DiT families'"):
        DDPMScheduler(cfg)


# ---------------------------------------------------------------- sample
def test_sample_matches_jax(pair):
    """A 3-step DDPM sample at guidance 4.5: the CFG batch [negative;
    positive] of both streams with both masks in the same order, the
    learned sigma dropped, JAX's per-step noise; images and every tap
    encounter (the JAX side's default scanned loop, which equals its
    unrolled one and compiles one DiT call instead of three)."""
    jfe, port = pair
    jfe._rng = jax.random.PRNGKey(SEED)
    prompts = jfe.encode_prompt(PROMPT)
    ref_images, ref = jfe.sample(prompts, batch_size=1, num_inference_steps=3,
                                 guidance_scale=4.5)
    (pe, bmask), (t5, tmask) = _torch(prompts)
    (ne, nbmask), (nt5, ntmask) = _torch(jfe.encode_prompt(''))
    init, steps = jax_ddpm_sample_noise(SEED, (1, 4, LAT, LAT), 3)
    images, feats, _ = port._sample(pe, ne, t5, nt5, init, 3, 4.5,
                                    (torch.cat([nbmask, bmask]), torch.cat([ntmask, tmask])),
                                    steps)
    _close(images, ref_images)
    assert sorted(feats) == sorted(ref) == sorted(LAYERS)
    for key, encounters in ref.items():
        assert len(feats[key]) == len(encounters) == 3
        for a, b in zip(feats[key], encounters):
            assert a.shape[0] == 2
            _close(a, b)


def test_public_sample_and_background(pair):
    """A raw string (the negative '' encoded for CFG) and the encode_prompt
    result give the same sample from the same generator state; encounter
    2 is kept."""
    _, port = pair
    port.set_background_extraction([2])
    try:
        port._noise_gen.manual_seed(3)
        images, feats = port.sample(PROMPT, 1, 2, 4.5)
        assert images.shape == (1, 3, SIZE, SIZE) and sorted(feats) == sorted(LAYERS)
        kept = port.get_background_extraction()
        assert all(sorted(v) == [2] and v[2] is feats[k][1] for k, v in kept.items())
        port._noise_gen.manual_seed(3)
        again, _ = port.sample(port.encode_prompt(PROMPT), 1, 2, 4.5)
        assert torch.equal(images, again)
    finally:
        port.store_idx, port._background_feats = None, {}


# ------------------------------------------------------------------ RoPE
@pytest.mark.parametrize('grid,head_dim,base', [(16, 16, 8), (64, 88, 32), (32, 88, 32)])
def test_rope_equals_jax(grid, head_dim, base):
    """HunyuanDiT's 2-D tables (column then row) and the rotation in fp32
    of a bf16 input, cast back."""
    cos, sin = hunyuan.hunyuan_rope(grid, head_dim, base)
    ref_cos, ref_sin = jax_hunyuan.hunyuan_rope(grid, head_dim, base)
    np.testing.assert_array_equal(cos, ref_cos)
    np.testing.assert_array_equal(sin, ref_sin)
    ids = np.random.RandomState(2).rand(7, 3) * 40
    for a, b in zip(rope.rope_cos_sin(ids, (8, 4, 4)), jax_flux.rope_cos_sin(ids, (8, 4, 4))):
        np.testing.assert_array_equal(a, b)
    x = np.random.RandomState(3).randn(1, 2, grid * grid, head_dim).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ours = rope.apply_rope(torch.from_numpy(x).to(dtype), torch.from_numpy(cos),
                               torch.from_numpy(sin))
        ref = jax_flux.apply_rope(jnp.asarray(x, jdtype), jnp.asarray(cos), jnp.asarray(sin))
        assert ours.dtype == dtype
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                                   atol=1e-6 if dtype == torch.float32 else 1e-2, rtol=1e-5)


# ------------------------------------------------------- BERT, WordPiece
VOCAB = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', 'a', 'photo', 'of', 'cat', 'un', '##believ',
         '##able', ',', '!', '猫', '的', 'dog', '##s']
TEXTS = ['A photo of a cat!', 'unbelievable dogs, 的猫', 'xyz photo', '', 'a ' * 20]


@pytest.fixture(scope='module')
def vocab_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp('bert_tok')
    (root / 'vocab.txt').write_text('\n'.join(VOCAB) + '\n', encoding='utf-8')
    return str(root)


def test_wordpiece_matches_jax(vocab_dir):
    """Lower-casing, punctuation and CJK characters as tokens of their own,
    longest-match '##' pieces, [UNK], [CLS]/[SEP], padding with [PAD] and
    the mask, truncation at 12; without vocab.txt both fall back to the
    hash tokenizer."""
    ours = wordpiece.load_bert_tokenizer(vocab_dir, model_max_length=12)
    ref = jax_wordpiece.load_bert_tokenizer(vocab_dir, model_max_length=12)
    assert isinstance(ours, wordpiece.WordPieceTokenizer)
    for text in TEXTS:
        assert ours([text]) == ref([text]), text
    ids, mask = ours(['unbelievable dogs, 的猫'])
    assert ids[0][:9] == [2, 8, 9, 10, 15, 16, 11, 14, 13] and mask[0][:10] == [1] * 10
    fallback = wordpiece.load_bert_tokenizer(None, model_max_length=8, vocab_size=1000)
    assert fallback([PROMPT]) == jax_wordpiece.load_bert_tokenizer(
        None, model_max_length=8, vocab_size=1000)([PROMPT])


@pytest.mark.parametrize('masked', [True, False], ids=['mask', 'no-mask'])
def test_bert_matches_jax(pair, vocab_dir, masked):
    """The BERT encoder alone on WordPiece ids, post-LN with exact GELU and
    the -1e9 key mask (without it, every position attends to the padding)."""
    jfe, port = pair
    ids, mask = wordpiece.load_bert_tokenizer(vocab_dir, model_max_length=8)(
        ['unbelievable cat', 'a photo of a cat, dogs!'])
    ids, mask = np.asarray(ids, np.int32), np.asarray(mask, np.int32)
    ref = jfe.text_encoders[0].apply({'params': jfe.params['text'][0]}, ids,
                                     mask if masked else None)
    with torch.no_grad():
        ours = port.text_encoders[0](torch.from_numpy(ids).long(),
                                     torch.from_numpy(mask) if masked else None)
    _close(ours, ref)


def test_params_round_trip(pair):
    """The DiT's diffusers keys, and BERT's transformers keys through the
    JAX loader's own renames (``rename_bert_keys``), give back the JAX
    trees."""
    jfe, port = pair
    assert_params_round_trip(jfe.params['unet'], port.unet)
    te, tree = port.text_encoders[0], jfe.params['text'][0]
    state = {k: v.numpy() for k, v in params_from_jax(tree, te, bert_text.jax_param_name).items()}
    back, missing, unused = convert_torch_state(rename_bert_keys(state), tree)
    assert not missing and not unused
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert set(bert_text.bert_checkpoint_state(
        {'bert.encoder.layer.0.output.dense.weight': 0, 'embeddings.position_ids': 0})) == {
        'encoder.layer.0.output.dense.weight'}


# ---------------------------------------------------- specs and full size
def test_spec_equals_jax():
    for version in ('hunyuan', VERSION):
        ours, ref = get_model_spec(version), jax_model_spec(version)
        for name in ('version', 'family', 'hf_id', 'scheduler', 'default_img_size',
                     'prompt_max_length'):
            assert getattr(ours, name) == getattr(ref, name), (version, name)
        for name in ('dit', 't5', 'bert', 'vae', 'scheduler_config'):
            a, b = getattr(ours, name), getattr(ref, name)
            for f in dataclasses.fields(a):
                assert getattr(a, f.name) == getattr(b, f.name), (version, name, f.name)
    assert get_model_spec('hunyuan').dit.head_dim == 88


@pytest.mark.parametrize('act', ['gelu-approximate', 'gelu'])
def test_checkpoint_naming_another_ffn_is_refused(tmp_path, act):
    """A transformer/config.json whose ``activation_fn`` is not the
    reference's GEGLU stops the build, naming the open question, before any
    weight is read; 'geglu' or no key at all reads as the preset."""
    cfg = hunyuan.HUNYUAN_DIT.to_diffusers_config()
    assert hunyuan.HunyuanConfig.from_diffusers_config(cfg) == hunyuan.HUNYUAN_DIT
    del cfg['activation_fn']
    assert hunyuan.HunyuanConfig.from_diffusers_config(cfg) == hunyuan.HUNYUAN_DIT
    (tmp_path / 'transformer').mkdir()
    (tmp_path / 'transformer' / 'config.json').write_text(json.dumps(
        {**hunyuan.tiny_hunyuan_config().to_diffusers_config(), 'activation_fn': act}))
    with pytest.raises(NotImplementedError, match=f"activation_fn='{act}'.*Queue C"):
        FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                         weights=str(tmp_path))


def test_full_size_mt5_and_dit_match_jax_parameter_counts():
    """HunyuanDiT's mT5 (vocab 250112, d_model 2048, 24 layers, 32 heads)
    and DiT (40 blocks, a GEGLU MLP of 6062 hidden units), built on the
    meta device, hold as many parameters as the JAX presets' traced inits
    (1,669,958,656 and 1,848,948,608); the mT5 tokenizer pads to 256."""
    spec = get_model_spec('hunyuan')
    with torch.device('meta'):
        t5, dit = T5EncoderModel(spec.t5), hunyuan.HunyuanDiT2D(spec.dit)
    count = sum(p.numel() for p in t5.parameters())
    shapes = jax.eval_shape(lambda: JaxT5(cfg=jax_model_spec('hunyuan').t5).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    assert count == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert count == 1_669_958_656
    assert sum(p.numel() for p in dit.parameters()) == 1_848_948_608
    assert dit.blocks[0].ff.net[0].proj.weight.shape == (12124, 1408)
    tok = load_t5_tokenizer(None, model_max_length=spec.dit.text_len_t5,
                            vocab_size=spec.t5.vocab_size)
    ids, mask = tok([PROMPT])
    assert len(ids[0]) == 256 and sum(mask[0]) == 5 + 1 and max(ids[0]) < 250112


def test_show_all_layers_matches_jax():
    """test-hunyuan's ids and shapes through ``show_all_layers`` equal
    JAX's ``eval_shape``; 'hunyuan' at 1024^2 on the meta device has JAX's
    facts (tests/test_enumeration.py): 7 ids a block over 40 blocks, no
    block-level 'out'."""
    ours = FeatureExtractor({'vit-block0-self-q': True}, VERSION, device='cpu',
                            img_size=SIZE).show_all_layers()
    assert ours == jax_enumerate_layers(VERSION, SIZE) and len(ours) == 4 * 7
    full = enumerate_layers('hunyuan', 1024)
    assert len(full) == 40 * 7
    assert full['vit-block0-self-q'] == (1, 1408, 64, 64)
    assert full['vit-block0-cross-map'] == (1, 16, 4096, 333)
    assert 'vit-block39-ffn-inner' in full and 'vit-block0-out' not in full


def test_dit_matches_torch_ref():
    """The port's DiT against the torch transcription of diffusers'
    HunyuanDiT2DModel in tests/torch_ref.py, which has the same keys: a
    6-block config (3 skips) with 4 heads of 16, every tap of every block
    and the output (fp32; 1e-4 covers the summation order)."""
    from torch_ref import HunyuanDiT2DModel
    cfg = dataclasses.replace(hunyuan.tiny_hunyuan_config(), num_layers=6, hidden_size=64,
                              num_attention_heads=4)
    gen = torch.Generator().manual_seed(5)
    ours = hunyuan.HunyuanDiT2D(cfg, taps=TapSpec.all())
    with torch.no_grad():
        for p in ours.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    ref = HunyuanDiT2DModel(dataclasses.asdict(cfg))
    ref.load_state_dict(ours.state_dict())
    x = torch.randn(2, 4, 16, 16, generator=gen)
    bert = torch.randn(2, cfg.text_len, cfg.cross_attention_dim, generator=gen)
    t5 = torch.randn(2, cfg.text_len_t5, cfg.cross_attention_dim_t5, generator=gen)
    bmask = torch.tensor([[1] * 5 + [0] * 3, [1] * 8])
    tmask = torch.tensor([[1] * 3 + [0] * 5, [1] * 6 + [0] * 2])
    cos, sin = (torch.from_numpy(t) for t in hunyuan.hunyuan_rope(8, 16, cfg.rope_base_size))
    feats, ref_taps = {}, {}
    with torch.no_grad():
        out = ours(x, 300.0, bert, bmask, t5, tmask, feats=feats)
        want = ref(x, 300.0, bert, t5, cos, sin, bmask, tmask, taps=ref_taps)
    # the store filters cross-attention k and v (token-aligned with the text)
    assert sorted(feats) == sorted(k for k in ref_taps if not is_filtered_id(k))
    assert len(feats) == 6 * 7
    for key, val in feats.items():
        torch.testing.assert_close(val, ref_taps[key], atol=1e-4, rtol=1e-4, msg=key)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- checkpoints
def test_save_weights_round_trip(pair, tmp_path, image):
    """``save_weights`` writes transformer/, vae/, text_encoder/ (BERT) and
    text_encoder_2/ (mT5, two shards); ``weights=`` loads them back, with
    the tiny config's RoPE frame, to the same parameters, prompts and
    features."""
    _, port = pair
    stats = port.save_weights(str(tmp_path), text_shards=2)
    assert set(stats) == {'transformer', 'vae', 'text_encoder', 'text_encoder_2'}
    assert len(list((tmp_path / 'text_encoder_2').glob('model-0000?-of-00002.safetensors'))) == 2
    assert json.loads((tmp_path / 'transformer' / 'config.json').read_text())[
        'attention_head_dim'] == 16
    loaded = FeatureExtractor(LAYERS, VERSION, device='cpu', img_size=SIZE, dtype='float32',
                              weights=str(tmp_path), **STORE)
    assert loaded.spec == port.spec
    for a, b in ((port.unet, loaded.unet), (port.vae, loaded.vae),
                 *zip(port.text_encoders, loaded.text_encoders)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    for (a, am), (b, bm) in zip(port.encode_prompt(PROMPT), loaded.encode_prompt(PROMPT)):
        assert torch.equal(a, b) and torch.equal(am, bm)
    ours, ref = _jax_and_port(pair, image, 50, port=loaded)
    for key in ref:
        _close(ours[key], ref[key])


def test_cli_on_test_hunyuan(tmp_path):
    """extract_feature with --version test-hunyuan writes one dump per tap
    and image; generate_with_extraction keeps the DiT taps of calls 1 and 2
    of a 2-step DDPM sample over the CFG-doubled batch."""
    from PIL import Image
    from diffusion_feature_tpu_torch import extract_feature, generate_with_extraction
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (SIZE, SIZE, 3), np.uint8)).save(
        tmp_path / 'img.png')
    layer = {'vit-block3-self-q': True, 'vit-block0-cross-q': True}
    common = ['--device', 'cpu', '--version', VERSION, '--img_size', str(SIZE), '--dtype',
              'float32', '--layer', json.dumps(layer)]
    extract_feature.main([*common, '--prompt', PROMPT, '--input_dir', str(tmp_path / 'img.png'),
                          '--output_dir', str(tmp_path / 'out')])
    assert sorted(p.name for p in (tmp_path / 'out').iterdir()) == sorted(layer)
    dump = np.load(tmp_path / 'out' / 'vit-block3-self-q' / 'train0.npy')
    assert dump.shape == (32, 16, 16) and np.isfinite(dump).all()
    fe = generate_with_extraction.main([*common, '--steps', '2', '--store_steps', '1', '2',
                                        '--output', str(tmp_path / 'g.png')])
    assert (tmp_path / 'g.png').exists()
    kept = fe.get_background_extraction()
    assert sorted(kept) == sorted(layer)
    assert all(sorted(v) == [1, 2] and v[1].shape == (2, 256, 32) for v in kept.values())
