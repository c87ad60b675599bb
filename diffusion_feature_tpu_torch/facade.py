"""FeatureExtractor in PyTorch (port of ``diffusion_feature_tpu/facade.py``),
mirroring the reference's ``diffusion_feature.FeatureExtractor``
(feature/diffusion_feature.py:26-517).  It dispatches on the model's
family (``spec.family``): the U-Nets, the PixArt DiTs, or HunyuanDiT.

Ported: extraction for SD-1.5 (``'1-5'``, ``'test-sd'``), SD-2.1 (``'2-1'``),
SDXL (``'xl'``, ``'test-xl'``) and Playground v2 (``'pgv2'``): CLIP tokenize
-> the text encoders (long prompts in chunks) -> image preprocess -> VAE
encode + posterior sample -> add_noise at the img2img timestep of ``t``
(Euler, or PNDM for SD-1.5) -> scale_model_input -> one U-Net forward with
the requested taps -> store post-processing; or, with ``denoising_from``, a
scheduler walk down to ``t`` first, and with ``use_ddim_inversion`` a DDIM
inversion in place of the noise.  PixArt-alpha and PixArt-Sigma
(``'pixart-alpha'``, ``'pixart-sigma'``, ``'pixart-sigma-512'``,
``'test-pixart'``) take the same path with the T5 encoder (prompts come as
(embeds, mask, negative embeds, negative mask)), DPM-Solver, and the DiT,
whose learned-sigma half of the output is dropped; they have no ControlNet
and no DDIM inversion, as in the JAX package.  HunyuanDiT (``'hunyuan'``,
``'test-hunyuan'``) runs the JAX package's pipeline-driven single step:
BERT and mT5 encode the prompt (``((bert embeds, mask), (t5 embeds,
mask))``), the latents are noised at the DDPM img2img timestep of ``t``,
and one DiT forward gives the taps (no ``vae-out``, no ``denoising_from``);
``sample`` follows the stock HunyuanDiT pipeline (DDPM, v-prediction).
The attention store (``attention=``) gives
the aggregated ``'attn'`` feature, the ``'vae-out'`` layer the decoded image
of one scheduler step; ``extract_ensemble`` crosses timesteps with prompts.
``control=`` adds ControlNets (Canny, DPT depth) to the tapped forward;
``sample`` generates images with the taps of every step, and
``set_background_extraction`` keeps chosen encounters of them.
Weights come from a local diffusers checkpoint (``weights=``,
``weights_variant=``) or at random from ``seed``, with offline LoRA merging.
The JAX package's other model versions raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import resolve_layer_config
from .ddim_inversion import ddim_invert
from .enumerate_layers import enumerate_layers
from .io.images import preprocess_pil_batch, resize_tensor_batch
from .models.bert_text import BertConfig, BertTextModel, bert_checkpoint_state
from .models.clip_text import CLIPTextConfig, CLIPTextModel
from .models.convert import (load_component_config, load_component_state, load_state_into,
                             random_module, save_component)
from .models.controlnet import ControlNetPipeline
from .models.dit_pixart import PixArtConfig, PixArtTransformer2D
from .models.hunyuan import HunyuanConfig, HunyuanDiT2D
from .models.layers import ATTN_STORE
from .models.lora import apply_lora_to_module
from .models.registry import ModelSpec, get_model_spec
from .models.t5 import T5Config, T5EncoderModel, t5_checkpoint_state
from .models.unet2d import UNet2DConditionModel, UNetConfig
from .models.vae import AutoencoderKL, VAEConfig
from .roadmap import not_ported
from .schedulers.diffusion import (DDPMScheduler, DPMSolverMultistepScheduler,
                                   EulerDiscreteScheduler, make_scheduler, scalar_like)
from .store import aggregate_attention, postprocess_taps, select_background_encounters
from .taps import TapSpec, declared_ids, is_filtered_id
from .tokenizers.clip_bpe import load_clip_tokenizer
from .tokenizers.t5_tok import load_t5_tokenizer
from .tokenizers.wordpiece import load_bert_tokenizer
from .utils.prompt import encode_long_prompt

_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16, 'float32': torch.float32}
TEXT_DIRS = ('text_encoder', 'text_encoder_2')


def _adapt_spec_to_checkpoint(spec: ModelSpec, weights: str) -> ModelSpec:
    """Rebuild the denoiser, VAE and text-encoder configs from the
    checkpoint's own config.json files where present (JAX
    ``_adapt_spec_to_checkpoint``), so fine-tunes that deviate from the
    presets load exactly.  An unreadable config keeps the preset, as there;
    a field the port cannot honour raises."""
    updates = {}

    def has(component):
        return os.path.exists(os.path.join(weights, component, 'config.json'))

    try:
        if spec.family in ('pixart', 'hunyuan'):
            dit = PixArtConfig if spec.family == 'pixart' else HunyuanConfig
            if has('transformer'):
                updates['dit'] = dit.from_diffusers_config(
                    load_component_config(weights, 'transformer'))
            # T5 sits in text_encoder_2 where BERT comes first (HunyuanDiT)
            t5_dir = 'text_encoder' if spec.family == 'pixart' else 'text_encoder_2'
            if has(t5_dir):
                updates['t5'] = T5Config.from_diffusers_config(
                    load_component_config(weights, t5_dir), spec.t5)
            if spec.bert is not None and has('text_encoder'):
                updates['bert'] = BertConfig.from_hf_config(
                    load_component_config(weights, 'text_encoder'), spec.bert)
        elif has('unet'):
            updates['unet'] = UNetConfig.from_diffusers_config(
                load_component_config(weights, 'unet'))
        if has('vae'):
            updates['vae'] = VAEConfig.from_diffusers_config(
                load_component_config(weights, 'vae'))
        adapted = tuple(
            CLIPTextConfig.from_diffusers_config(load_component_config(weights, d), base)
            if has(d) else base
            for d, base in zip(TEXT_DIRS, spec.text_encoders))
        if any(a is not b for a, b in zip(adapted, spec.text_encoders)):
            updates['text_encoders'] = adapted
    except (OSError, ValueError, KeyError):
        return spec
    return dataclasses.replace(spec, **updates) if updates else spec


class FeatureExtractor:
    """``encode_prompt``, ``offload_prompt_encoder``, ``preprocess_image``,
    ``extract``, ``extract_ensemble``, ``sample`` and the background
    extraction pair with the JAX facade's signatures and return values.

    weights: a local diffusers checkpoint dir (``unet``, ``vae``,
    ``text_encoder``[``_2``], each a config.json and safetensors or ``.bin``
    files; ``tokenizer``[``_2``] when present; PixArt: ``transformer``,
    ``vae``, ``text_encoder`` (T5) and ``tokenizer/spiece.model``).  The architecture follows
    its config.json files, and each module is filled straight from the
    files, with no random init (HunyuanDiT: ``transformer``, ``vae``,
    ``text_encoder`` (BERT), ``text_encoder_2`` (mT5), ``tokenizer/vocab.txt``
    and ``tokenizer_2/spiece.model``).  weights_variant: the weight set to load
    ('fp16', 'bf16', ..., 'main'), falling back per component to the
    un-suffixed set.  Without weights, models initialise at random from
    ``seed``.  offline_lora (with offline_lora_filename): a LoRA merged
    into the U-Net after its weights.  The noise of ``extract`` has its own
    generator, seeded from ``seed``, so it does not depend on where the
    weights came from; ``sample`` draws its initial latents from it too.
    control: ControlNet kinds ('canny', 'depth') or (kind, preprocessor)
    pairs, a depth pair naming a transformers DPT dir; weights from
    ``{weights}/controlnet_{kind}`` and ``{weights}/depth_estimator`` where
    present (the JAX ``ControlNetPipeline``); U-Nets only.
    attention: attention-store categories ('{down|mid|up}_{self|cross}';
    the DiTs' blocks are 'up'); their head-mean maps of the size band
    ``attn_store_sizes`` (tokens per side, default (img_size/32,
    img_size/16), the DiTs' (img_size/32, img_size/8)) come back as
    ``feats['attn']``.
    train_unet, external_model, mesh, t5_8bit, transformer_8bit: the JAX
    facade's keywords; False or None (their defaults) pass, and any other
    value raises ``NotImplementedError`` naming the ROADMAP.md item that
    ports it.
    """

    def __init__(self, layer, version: str, device='cuda', dtype: str = 'bfloat16',
                 img_size: int = 1024, offline_lora: Optional[str] = None,
                 offline_lora_filename: Optional[str] = None,
                 feature_resize: int = 1, control=None,
                 attention: Optional[Sequence[str]] = None,
                 weights: Optional[str] = None, weights_variant: Optional[str] = None,
                 seed: int = 0, attn_store_sizes: Optional[Tuple[int, int]] = None,
                 validate_layers: bool = True, train_unet: bool = False,
                 external_model=None, mesh=None, t5_8bit=None, transformer_8bit=None):
        for name, value, item, queue in (
                ('train_unet', train_unet, 'Training and tasks', 'A'),
                ('external_model', external_model, 'external_model', 'A'),
                ('mesh', mesh, 'Multi-GPU', 'A'),
                ('t5_8bit', t5_8bit, 'Int8 weight-only dense', 'B'),
                ('transformer_8bit', transformer_8bit, 'Int8 weight-only dense', 'B')):
            if value is not None and value is not False:
                raise not_ported(f'FeatureExtractor({name}={value!r})', item, queue)
        if weights and os.path.isfile(os.path.join(weights, 'tpu_bundle.json')):
            raise ValueError(f'{weights} is a deployment bundle of the JAX package; the port '
                             'loads the diffusers checkpoint dir it was exported from instead')
        self.spec: ModelSpec = get_model_spec(version)
        if control and self.spec.family != 'unet':
            # the JAX ControlNetPipeline builds its nets from spec.unet
            raise ValueError(f'control= needs a U-Net version: {version!r} is a '
                             f'{self.spec.family} DiT, and the ControlNets copy a U-Net '
                             'encoder (models/controlnet.py)')
        if weights:
            self.spec = _adapt_spec_to_checkpoint(self.spec, weights)
        self.version = version
        self.img_size = img_size
        self.feature_resize = feature_resize
        self.device = torch.device(device)
        self.dtype = _DTYPES[dtype]
        self.feature_dtype = torch.bfloat16
        self.taps = TapSpec.from_config(resolve_layer_config(layer))
        # the 'vae-out' pseudo-layer: one scheduler step decoded to an image
        self.store_vae_output = not self.taps.accept_all and 'vae-out' in self.taps.ids
        self.attention = list(attention) if attention else None
        # the store's size band (reference components/attention.py:542, :569)
        self._attn_sizes = None
        if self.attention:
            top = img_size // (16 if self.spec.family == 'unet' else 8)
            self._attn_sizes = (tuple(attn_store_sizes) if attn_store_sizes is not None
                                else (img_size // 32, top))
        self.scheduler = make_scheduler(self.spec.scheduler, self.spec.scheduler_config)
        self.vae_scale = 2 ** (len(self.spec.vae.block_out_channels) - 1)
        # the extract's noise and the random init draw from generators of
        # their own (the JAX facade's _rng and init key)
        self._noise_gen = torch.Generator(device=self.device).manual_seed(seed)
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        #: {component: (bytes, seconds)} of the checkpoint load
        self.load_stats: Dict[str, Tuple[int, float]] = {}

        spec = self.spec

        def build(make, component, adapt=None):
            if weights:
                return self._load_component(make, weights, weights_variant, component, adapt)
            return random_module(make, self.device, self.dtype, init_gen)

        categories = tuple(self.attention or ())
        tok_dirs = [os.path.join(weights, d) if weights else None
                    for d in ('tokenizer', 'tokenizer_2')]
        pixart = spec.family == 'pixart'
        # the DiT keeps the facade's attribute name of the denoiser
        denoiser = {'pixart': PixArtTransformer2D, 'hunyuan': HunyuanDiT2D,
                    'unet': UNet2DConditionModel}[spec.family]
        self.unet = build(lambda: denoiser(spec.unet if denoiser is UNet2DConditionModel
                                           else spec.dit, self.taps, self._attn_sizes,
                                           categories),
                          'unet' if spec.family == 'unet' else 'transformer')
        self.vae = build(lambda: AutoencoderKL(spec.vae), 'vae')
        if spec.family == 'hunyuan':
            # BERT WordPiece from tokenizer/vocab.txt, the hash tokenizer offline
            self.text_encoders = (
                build(lambda: BertTextModel(spec.bert), 'text_encoder', bert_checkpoint_state),
                build(lambda: T5EncoderModel(spec.t5), 'text_encoder_2', t5_checkpoint_state))
            self.tokenizers = (
                load_bert_tokenizer(tok_dirs[0], model_max_length=spec.dit.text_len,
                                    vocab_size=spec.bert.vocab_size),
                load_t5_tokenizer(tok_dirs[1], model_max_length=spec.dit.text_len_t5,
                                  vocab_size=spec.t5.vocab_size))
        elif pixart:
            self.text_encoders = (build(lambda: T5EncoderModel(spec.t5), 'text_encoder',
                                        t5_checkpoint_state),)
            self.tokenizers = (load_t5_tokenizer(tok_dirs[0],
                                                 model_max_length=spec.prompt_max_length,
                                                 vocab_size=spec.t5.vocab_size),)
        else:
            self.text_encoders = tuple(build(lambda c=c: CLIPTextModel(c), d)
                                       for c, d in zip(spec.text_encoders, TEXT_DIRS))
            # tokenizer_2 (OpenCLIP) pads with id 0; the first pads with EOS
            self.tokenizers = tuple(
                load_clip_tokenizer(d if d and os.path.isdir(d) else None,
                                    vocab_size=c.vocab_size, pad_with_eos=(i == 0))
                for i, (d, c) in enumerate(zip(tok_dirs, spec.text_encoders)))
        if offline_lora:
            apply_lora_to_module(self.unet, offline_lora, offline_lora_filename)
        if validate_layers and not self.taps.accept_all:
            self._validate_layer_ids()
        # background extraction: the encounters to keep and what was kept
        self.store_idx: Optional[list] = None
        self._background_feats: Dict[str, dict] = {}
        self.control_pipe = ControlNetPipeline(self, control, weights) if control else None

    def _load_component(self, make, root: str, variant: Optional[str], component: str,
                        adapt=None):
        """Build ``make()`` on the meta device and fill it from the
        checkpoint's ``component`` dir (its tensors through ``adapt``, where
        given): parameters are allocated once, at the compute dtype, and
        never initialised at random."""
        with torch.device('meta'):
            module = make()
        t0 = time.perf_counter()
        state = load_component_state(root, component, variant=variant)
        if adapt is not None:
            state = adapt(state)
        unused = set(load_state_into(module, state, self.dtype, self.device))
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        nbytes = sum(t.numel() * t.element_size() for k, t in state.items() if k not in unused)
        self.load_stats[component] = (nbytes, time.perf_counter() - t0)
        return module.eval().requires_grad_(False)

    def save_weights(self, root: str, variant: Optional[str] = None, unet_shards: int = 1,
                     text_shards: int = 1) -> Dict[str, Tuple[int, float]]:
        """Write the denoiser (U-Net, or the DiT's transformer), the VAE and
        the text encoders as a diffusers checkpoint dir that ``weights=``
        loads: a config.json and safetensors files per component, named
        with ``variant``, the denoiser in ``unet_shards`` files and each
        text encoder in ``text_shards``.  Returns {component: (bytes
        written, seconds)}, as ``load_stats``."""
        spec = self.spec
        if spec.family == 'pixart':
            comps = [('transformer', self.unet, spec.dit), ('vae', self.vae, spec.vae),
                     ('text_encoder', self.text_encoders[0], spec.t5)]
        elif spec.family == 'hunyuan':
            comps = [('transformer', self.unet, spec.dit), ('vae', self.vae, spec.vae),
                     *zip(TEXT_DIRS, self.text_encoders, (spec.bert, spec.t5))]
        else:
            comps = [('unet', self.unet, spec.unet), ('vae', self.vae, spec.vae),
                     *zip(TEXT_DIRS, self.text_encoders, spec.text_encoders)]
        stats = {}
        for i, (comp, module, cfg) in enumerate(comps):
            t0 = time.perf_counter()
            shards = unet_shards if i == 0 else text_shards if comp in TEXT_DIRS else 1
            files = save_component(root, comp, module.state_dict(), cfg.to_diffusers_config(),
                                   variant, shards)
            stats[comp] = (sum(files.values()), time.perf_counter() - t0)
        return stats

    def _validate_layer_ids(self):
        """Fail fast on ids the U-Net does not declare, with near-miss
        suggestions (the reference silently drops unknown ids)."""
        known = declared_ids(self.unet)
        # 'attn' is assembled only when attention categories were requested;
        # the pipeline-driven HunyuanDiT path decodes no 'vae-out'
        pseudo = ({'attn'} if self.attention else set()) | (
            set() if self.spec.family == 'hunyuan' else {'vae-out'})
        unknown = [i for i in sorted(self.taps.ids)
                   if i not in known and i not in pseudo and not is_filtered_id(i)]
        if not unknown:
            return
        import difflib
        lines = []
        for i in unknown[:10]:
            if i == 'attn':
                lines.append("  'attn' needs the attention= argument (e.g. "
                             "attention=['up_cross']) so there are aggregated maps to assemble")
                continue
            if i == 'vae-out':
                lines.append("  'vae-out' is unavailable for the pipeline-driven "
                             f'{self.spec.family} path (one denoiser forward, no decode step)')
                continue
            near = difflib.get_close_matches(i, known, n=3, cutoff=0.55)
            hint = f" (did you mean: {', '.join(near)}?)" if near else ''
            lines.append(f'  {i!r}{hint}')
        more = '' if len(unknown) <= 10 else f'\n  ... and {len(unknown) - 10} more'
        raise ValueError(
            f'{len(unknown)} unknown/unavailable layer id(s) for version {self.version!r} '
            f'at img_size={self.img_size}:\n' + '\n'.join(lines) + more
            + '\nPass validate_layers=False to skip this check.')

    def show_all_layers(self, batch_size: int = 1) -> Dict[str, tuple]:
        """{layer-id: reference-layout shape} of every tappable layer at this
        extractor's version and img_size, with no weights and no compute:
        ``enumerate_layers`` runs the U-Net on the meta device."""
        return enumerate_layers(self.version, self.img_size, batch_size)

    # ---------------------------------------------------------------- prompts
    def encode_prompt(self, prompt_str: Optional[str] = None,
                      prompt_file: Optional[str] = None):
        """Returns (prompt_embeds, negative_prompt_embeds, pooled,
        negative_pooled), the reference's 4-tuple (diffusion_feature.py:203-206);
        the pooled entries are None for a 'final'-layer model (SD-1.5).
        PixArt: (prompt_embeds, mask, negative_prompt_embeds, negative_mask),
        the T5 embeddings of ``prompt_max_length`` tokens and their int32
        (1, L) attention masks (diffusion_feature.py:195-202).  HunyuanDiT:
        ((BERT embeddings, mask), (T5 embeddings, mask)) of the prompt alone,
        as the JAX facade's ``_encode_hunyuan`` (its two streams travel
        together; ``sample`` encodes the empty negative itself)."""
        if (prompt_str is None) == (prompt_file is None):
            raise ValueError('pass exactly one of prompt_str and prompt_file')
        if prompt_file:
            with open(prompt_file) as f:
                prompt_str = f.read()
        if self.spec.family == 'pixart':
            return (*self._encode_masked(prompt_str), *self._encode_masked(''))
        if self.spec.family == 'hunyuan':
            return self._encode_hunyuan(prompt_str)
        if len(prompt_str.split(' ')) > 70:
            # the first tokenizer and encoder alone, in chunks: no pooled embedding
            self._require_text_encoders()
            pe, ne = encode_long_prompt(self.tokenizers[0], self.text_encoders[0], prompt_str)
            return pe.to(self.device), ne.to(self.device), None, None
        pe, pooled = self._encode_one(prompt_str)
        ne, neg_pooled = self._encode_one('')
        return pe, ne, pooled, neg_pooled

    def _require_text_encoders(self):
        if not self.text_encoders:
            raise ValueError('the text encoders were offloaded persistently '
                             '(offload_prompt_encoder(persistent=True)); pass pre-encoded '
                             'prompts, or rebuild the extractor to encode raw strings')

    @torch.inference_mode()
    def _encode_one(self, text: str):
        self._require_text_encoders()
        penultimate = self.spec.clip_layer == 'penultimate'
        embeds, pooled = [], None
        for tok, te in zip(self.tokenizers, self.text_encoders):
            ids = torch.tensor(tok([text]), dtype=torch.long,
                               device=next(te.parameters()).device)
            last, pool, hidden = te(ids)
            embeds.append(hidden[-2] if penultimate else last)
            pooled = pool   # the last encoder's pooled output wins (text_encoder_2)
        pe = torch.cat([e.to(self.device) for e in embeds], dim=-1)
        return pe, pooled.to(self.device) if penultimate else None

    @torch.inference_mode()
    def _encode_masked(self, text: str, index: int = 0):
        """(embeddings (1, L, width), int32 mask (1, L)) of ``text`` padded or
        cut to the length of tokenizer ``index``, through the text encoder
        of that index (T5, or HunyuanDiT's BERT), which takes the mask."""
        self._require_text_encoders()
        ids, mask = self.tokenizers[index]([text])
        te = self.text_encoders[index]
        dev = next(te.parameters()).device
        mask = torch.tensor(mask, dtype=torch.int32, device=dev)
        emb = te(torch.tensor(ids, dtype=torch.long, device=dev), mask)
        return emb.to(self.device), mask.to(self.device)

    def _encode_hunyuan(self, text: str):
        """((BERT embeddings, mask), (T5 embeddings, mask)) of ``text``."""
        return self._encode_masked(text, 0), self._encode_masked(text, 1)

    def offload_prompt_encoder(self, persistent: bool = False):
        """Free the text encoders' device memory (reference
        diffusion_feature.py:209-219): moved to the CPU, or with
        ``persistent=True`` dropped."""
        if persistent:
            self.text_encoders = ()
        else:
            self.text_encoders = tuple(te.to('cpu') for te in self.text_encoders)

    # ----------------------------------------------------------------- images
    def preprocess_image(self, x, is_tensor: bool = False):
        if not is_tensor:
            return preprocess_pil_batch([x], self.img_size)
        return resize_tensor_batch(x, self.img_size)

    # ---------------------------------------------------------------- extract
    def extract(self, prompts, batch_size: int, image, image_type: str = 'image',
                t: int = 50, denoising_from: Optional[int] = None,
                use_control: bool = False,
                use_ddim_inversion: bool = False) -> Dict[str, torch.Tensor]:
        """Features of one img2img extraction at ``t``: {tap_id: NCHW tensor}
        in bf16 (attention maps (B, H, Sq, Sk)), plus 'attn' (B, sum of Sk
        over the aggregated maps, img/8, img/8) with ``attention=`` and
        'vae-out' (B, 3, img, img) when that layer was requested.
        ``denoising_from`` starts the latents there and walks the scheduler
        down to ``t`` first; ``use_ddim_inversion`` inverts the image with
        DDIM up to ``t`` in place of adding noise.  ``use_control`` adds the
        summed residuals of the ``control=`` ControlNets, which see the
        images (tensors in [-1, 1] turned back into PIL images) through
        their preprocessors, at the tapped forward; it has no effect without
        a ControlNet, as in the JAX facade.  With
        ``set_background_extraction`` active the features are also kept,
        as encounter 1, for ``get_background_extraction``.  PixArt's
        ``prompts`` carry the T5 mask second, broadcast to the batch;
        HunyuanDiT's are ``encode_prompt``'s pairs or a raw string, and its
        one forward at the DDPM timestep of ``t`` takes no
        ``denoising_from`` and no DDIM inversion."""
        spec = self.spec
        hunyuan = spec.family == 'hunyuan'
        if use_ddim_inversion and (spec.family != 'unet'
                                   or spec.unet.addition_embed_type is not None
                                   or spec.scheduler_config.prediction_type != 'epsilon'):
            # the reference runs DDIM inversion on the epsilon SD U-Nets only
            raise NotImplementedError(
                'use_ddim_inversion supports the epsilon-prediction SD '
                "U-Net families ('1-5'/'2-1'), as in the reference")
        if hunyuan and denoising_from is not None:
            raise ValueError('denoising_from is unavailable for the pipeline-driven hunyuan '
                             'path (one denoiser forward at t), as in the JAX package')

        if hunyuan and isinstance(prompts, str):
            prompts = self._encode_hunyuan(prompts)
        pe, pooled, mask = self._step_conditioning(prompts, batch_size)
        if image_type == 'image':
            img = preprocess_pil_batch(image, self.img_size)
        else:
            img = resize_tensor_batch(image, self.img_size)
        img = torch.as_tensor(img).to(self.device, self.dtype)
        control = None
        if use_control and self.control_pipe is not None:
            raw = image if image_type == 'image' else self.control_pipe.tensors_to_pil(img)
            control = self.control_pipe.prepare_control_images(raw, batch_size)

        lat = self.img_size // self.vae_scale
        shape = (img.shape[0], self.spec.vae.latent_channels, lat, lat)
        # drawn in fp32 and cast inside the step (JAX utils.normal_like)
        posterior_noise = torch.randn(shape, generator=self._noise_gen, device=self.device)
        noise = torch.randn(shape, generator=self._noise_gen, device=self.device)
        if denoising_from is None and not use_ddim_inversion:
            feats = self._step(img, pe, pooled, self._step_kit(int(t)), posterior_noise,
                               noise, self.feature_dtype, control=control, mask=mask)
        else:
            feats = self._multistep(img, pe, pooled, int(t), denoising_from, use_ddim_inversion,
                                    posterior_noise, noise, self.feature_dtype, control=control,
                                    mask=mask)
        self._keep_background(feats)
        return feats

    def extract_ensemble(self, prompts, batch_size: int, image, image_type: str = 'image',
                         ts: Sequence[int] = (50,), prompt_list: Optional[Sequence] = None,
                         concat: bool = True):
        """Extract at every t in ``ts``, crossed with every prompt set of
        ``prompt_list`` when given (else ``prompts``), and concatenate each
        layer along channels in (t index, prompt index) order: {layer: (B,
        len(ts) * len(prompt sets) * C, h, w)}; with ``concat=False``
        {(t_index, prompt_index): features}."""
        prompt_sets = list(prompt_list) if prompt_list is not None else [prompts]
        per = {(ti, pi): self.extract(p, batch_size, image, image_type=image_type, t=int(t))
               for pi, p in enumerate(prompt_sets) for ti, t in enumerate(ts)}
        if not concat:
            return per
        keys = sorted(per)
        return {layer: torch.cat([per[k][layer] for k in keys], dim=1) for layer in per[keys[0]]}

    def _step_conditioning(self, prompts, batch_size: int):
        """(pe, pooled, mask) of ``encode_prompt``'s output on the device,
        broadcast to ``batch_size`` and checked against the denoiser: the
        U-Net's context and SDXL's pooled embedding; PixArt's T5 context and
        its mask; HunyuanDiT's BERT context, its T5 stream in the pooled
        slot and the pair of their masks."""
        def bcast(x, dtype=None):
            return self._batch(x, batch_size, dtype)

        mask = None
        if self.spec.family == 'hunyuan':
            (pe, bmask), (pooled, tmask) = prompts
            mask = (bcast(bmask), bcast(tmask))
        else:
            pe = prompts[0]
            pooled = prompts[2] if self.spec.clip_layer == 'penultimate' else None
            if self.spec.family == 'pixart':
                mask = bcast(prompts[1])
        pe, pooled = bcast(pe, self.dtype), bcast(pooled, self.dtype)
        self._check_conditioning(pe, pooled)
        return pe, pooled, mask

    def _check_conditioning(self, pe, pooled):
        """Refuse, before any compute, prompts the denoiser cannot take: a
        context of another width, or no pooled embedding for SDXL's
        micro-conditioning (long prompts are encoded by the first encoder
        alone and carry none).  The JAX facade fails on them inside its
        step."""
        if self.spec.family == 'hunyuan':
            cfg = self.spec.dit
            for name, x, width in (('BERT', pe, cfg.cross_attention_dim),
                                   ('T5', pooled, cfg.cross_attention_dim_t5)):
                if x is None or x.shape[-1] != width:
                    raise ValueError(f'the {self.version!r} DiT takes {width}-wide {name} '
                                     f'embeddings, got {None if x is None else x.shape[-1]}')
            return
        if self.spec.family == 'pixart':
            width = self.spec.dit.caption_channels
            if pe.shape[-1] != width:
                raise ValueError(f'prompt embeddings are {pe.shape[-1]} wide, the '
                                 f'{self.version!r} DiT takes {width}-wide T5 embeddings')
            return
        cfg = self.spec.unet
        if pe.shape[-1] != cfg.cross_attention_dim:
            raise ValueError(
                f'prompt embeddings are {pe.shape[-1]} wide, the {self.version!r} U-Net '
                f'attends to {cfg.cross_attention_dim}-wide context; a prompt of more than 70 '
                'words is encoded by the first text encoder alone')
        if cfg.addition_embed_type == 'text_time' and pooled is None:
            raise ValueError(f'the {self.version!r} U-Net needs the pooled prompt embedding '
                             '(text_time micro-conditioning), and these prompts carry none')

    def _img2img_kit(self, t: int) -> Dict[str, float]:
        """The Euler, DPM-Solver and PNDM branches of the JAX facade's
        ``_img2img_kit``:
        model timestep T (SDXL's leading schedule maps t=50 to 50), noise
        injection latents <- A*latents + B*noise, the scale_model_input
        divisor S, the x0 reconstruction x0 = X1*latents + X2*model_output,
        and one fresh-state scheduler step for 'vae-out',
        prev = C1*x0 + C2*latents + C3*model_output, each folded for the
        prediction type."""
        sched = self.scheduler
        state = sched.set_timesteps(1000)
        timesteps, _ = sched.get_timesteps(state, 1000, t / 1000)
        lt = timesteps[0]
        pred = sched.config.prediction_type
        if isinstance(sched, EulerDiscreteScheduler):
            idx = sched.sigma_index(state, lt)
            sigma, sigma_next = float(state.sigmas[idx]), float(state.sigmas[idx + 1])
            A, B, S = 1.0, sigma, float(np.sqrt(sigma ** 2 + 1))
            if pred == 'v_prediction':
                c = sigma ** 2 + 1
                X1, X2 = 1.0 / c, float(-sigma / np.sqrt(c))
            elif pred == 'sample':
                X1, X2 = 0.0, 1.0
            else:
                X1, X2 = 1.0, -sigma
            r = (sigma_next - sigma) / sigma
            C1, C2, C3 = -r, 1.0 + r, 0.0
        elif isinstance(sched, DPMSolverMultistepScheduler):
            # DDPM-family noising; the step of a fresh state has no x0
            # history, so it is first order: prev = C2*latents + C1*x0
            ti = int(lt)
            prev_t = sched.prev_timestep(state, ti)
            a_t = float(sched.alphas_cumprod[ti])
            A, B, S = float(np.sqrt(a_t)), float(np.sqrt(1 - a_t)), 1.0
            h = sched.lambda_t[prev_t] - sched.lambda_t[ti]
            C1 = float(-sched.alpha_t[prev_t] * np.expm1(-h))
            C2, C3 = float(sched.sigma_t[prev_t] / sched.sigma_t[ti]), 0.0
            if pred == 'sample':
                X1, X2 = 0.0, 1.0
            elif pred == 'v_prediction':
                X1, X2 = A, -B
            else:
                X1, X2 = 1.0 / A, -B / A
        else:   # PNDM: DDPM-family noising, counter-0 PLMS step
            if pred == 'sample':
                # diffusers' PLMS step has no 'sample' form either
                raise NotImplementedError("prediction_type='sample' with PNDMScheduler")
            ti = int(lt)
            prev_t = ti - sched.step_size(state)
            a_t = float(sched.alphas_cumprod[ti])
            a_prev = float(sched.alphas_cumprod[prev_t]) if prev_t >= 0 else 1.0
            A, B, S = float(np.sqrt(a_t)), float(np.sqrt(1 - a_t)), 1.0
            beta_t, beta_prev = 1 - a_t, 1 - a_prev
            denom = a_t * np.sqrt(beta_prev) + np.sqrt(a_t * beta_t * a_prev)
            C1, C2, C3 = 0.0, float(np.sqrt(a_prev / a_t)), float(-(a_prev - a_t) / denom)
            if pred == 'v_prediction':
                # out' = sqrt(a_t)*mo + sqrt(beta_t)*sample
                C2 += C3 * float(np.sqrt(beta_t))
                C3 *= float(np.sqrt(a_t))
                X1, X2 = A, -B
            else:
                X1, X2 = 1.0 / A, -B / A
        return {'T': float(lt), 'A': A, 'B': B, 'S': S, 'X1': float(X1), 'X2': float(X2),
                'C1': C1, 'C2': C2, 'C3': C3}

    def _hunyuan_kit(self, t: int, num_inference_steps: int = 50) -> Dict[str, float]:
        """The JAX facade's ``_hunyuan_kit``: the pipeline's img2img
        timestep T of ``t`` on the ``num_inference_steps`` DDPM ladder and
        the noising latents <- A*latents + B*noise, A = sqrt(abar_T), B =
        sqrt(1 - abar_T)."""
        sched = self.scheduler
        state = sched.set_timesteps(num_inference_steps)
        timesteps, _ = sched.get_timesteps(state, num_inference_steps, t / 1000)
        latent_t = int(timesteps[0])
        a = float(sched.alphas_cumprod[latent_t])
        return {'T': float(latent_t), 'A': float(np.sqrt(a)), 'B': float(np.sqrt(1 - a))}

    def _step_kit(self, t: int) -> Dict[str, float]:
        """The single step's kit at ``t``: HunyuanDiT's pipeline kit, whose
        latents enter the DiT unscaled (S = 1), or the img2img kit."""
        if self.spec.family == 'hunyuan':
            return {**self._hunyuan_kit(t), 'S': 1.0}
        return self._img2img_kit(t)

    def _added_cond(self, pooled, bsz: int):
        """SDXL text_time micro-conditioning: time ids [h, w, 0, 0, h, w]
        (reference diffusion_feature.py:534); HunyuanDiT's T5 embeddings
        (the pooled slot carries them); None for a denoiser without
        either."""
        if self.spec.family == 'hunyuan':
            return pooled
        if self.spec.family != 'unet' or self.spec.unet.addition_embed_type != 'text_time':
            return None
        s = float(self.img_size)
        time_ids = torch.tensor([[s, s, 0.0, 0.0, s, s]], dtype=self.dtype,
                                device=self.device).repeat(bsz, 1)
        return {'text_embeds': pooled, 'time_ids': time_ids}

    def _denoise(self, model_in, timestep, pe, added, mask, feats=None, down=None, mid=None):
        """One denoiser forward: the U-Net (with SDXL's ``added`` and a
        ControlNet's residuals ``down``/``mid``), or a DiT whose
        learned-sigma half is dropped, as the JAX facade drops it before the
        scheduler (diffusers' contract): PixArt's with the T5 ``mask``,
        HunyuanDiT's with the BERT ``pe``, the T5 ``added`` and ``mask`` the
        pair of their masks."""
        if self.spec.family == 'hunyuan':
            bmask, tmask = mask
            return self.unet(model_in, timestep, pe, bmask, added, tmask,
                             feats=feats)[:, :model_in.shape[1]]
        if self.spec.family == 'pixart':
            return self.unet(model_in, timestep, pe, mask, feats=feats)[:, :model_in.shape[1]]
        return self.unet(model_in, timestep, pe, added, feats=feats,
                         down_block_additional_residuals=down, mid_block_additional_residual=mid)

    def _forward(self, lat_in, timestep, pe, pooled, out_dtype, control=None, mask=None):
        """The denoiser forward with taps and store, then the store
        post-processing (the JAX ``_collect_feats``): returns (model output,
        features).  ``control`` (one condition image batch per ControlNet)
        runs the ControlNets on the same input and adds their residuals."""
        feats = {}
        added = self._added_cond(pooled, lat_in.shape[0])
        down = mid = None
        if control is not None:
            down, mid = self.control_pipe.encode_all(lat_in, timestep, pe, control, added)
        out = self._denoise(lat_in, timestep, pe, added, mask, feats, down, mid)
        store = feats.pop(ATTN_STORE, {})
        feats = postprocess_taps(feats, resize_ratio=self.feature_resize, out_dtype=out_dtype)
        if self.attention:
            agg = aggregate_attention(store, self.attention, self.img_size, out_dtype)
            if agg is not None:
                feats['attn'] = agg
        return out, feats

    def _decode(self, latents, out_dtype):
        """'vae-out': scaled latents decoded to images, in ``out_dtype``
        (None keeps the compute dtype), with no feature_resize."""
        cfg = self.spec.vae
        img = self.vae.decode(latents / scalar_like(cfg.scaling_factor, latents)
                              + scalar_like(cfg.shift_factor, latents))
        return img.to(out_dtype or img.dtype)

    @torch.inference_mode()
    def _step(self, img, pe, pooled, kit, posterior_noise, noise, out_dtype, control=None,
              mask=None):
        """The single step (the JAX ``_get_step_fn_generic`` program): VAE
        encode + posterior sample -> latents*A + noise*B -> /S -> denoiser
        with taps -> store post-processing to ``out_dtype`` (None keeps the
        compute dtype), and 'vae-out' from the kit's fresh-state step.
        Noise tensors are standard-normal draws of the latent shape, cast
        here to the model dtype; ``control`` goes to ``_forward``, PixArt's
        T5 ``mask`` (B, L) to the DiT, HunyuanDiT's pair of BERT and T5
        masks with its T5 stream in ``pooled`` (its kit's S is 1: the
        JAX facade's ``_get_hunyuan_step_fn`` program)."""
        latents = self.vae(img, posterior_noise)
        latents = (scalar_like(kit['A'], latents) * latents
                   + scalar_like(kit['B'], latents) * noise.to(latents.dtype))
        out, feats = self._forward(latents / scalar_like(kit['S'], latents), kit['T'], pe, pooled,
                                   out_dtype, control, mask)
        if self.store_vae_output:
            x0 = scalar_like(kit['X1'], latents) * latents + scalar_like(kit['X2'], latents) * out
            lat2 = (scalar_like(kit['C1'], latents) * x0
                    + scalar_like(kit['C2'], latents) * latents
                    + scalar_like(kit['C3'], latents) * out)
            feats['vae-out'] = self._decode(lat2, out_dtype)
        return feats

    @torch.inference_mode()
    def _multistep(self, img, pe, pooled, t: int, denoising_from: Optional[int],
                   use_ddim_inversion: bool, posterior_noise, noise, out_dtype, control=None,
                   mask=None):
        """The multi-step paths (the JAX ``_get_step_fn``).  Timesteps: with
        ``denoising_from`` within 50 of ``t`` the 1000-step schedule from
        ``denoising_from``, else the 100-step one at strength
        ``denoising_from / 100`` (JAX's quirk: t=50, denoising_from=200
        starts at 991), cut at the last timestep >= ``t``.  The latents are
        noised at the first (or DDIM-inverted up to ``t``), walked through
        ``sched.step`` over all but the last with forwards whose taps and
        store maps are discarded, then the last forward keeps them; the
        ControlNets (``control``) join that last forward only.  'vae-out'
        decodes one step of the fresh schedule from there."""
        sched = self.scheduler
        state = sched.set_timesteps(1000)
        if denoising_from is None:
            timesteps = sched.get_timesteps(state, 1000, t / 1000)[0][:1]
        else:
            if denoising_from - t <= 50:
                timesteps, _ = sched.get_timesteps(state, 1000, denoising_from / 1000)
            else:
                state = sched.set_timesteps(100)
                timesteps, _ = sched.get_timesteps(state, 100, denoising_from / 100)
            timesteps = timesteps[:sum(1 for ts in timesteps if ts >= t)]
        latent_t, walk, t = timesteps[0], timesteps[:-1], timesteps[-1]
        if use_ddim_inversion:
            latents = ddim_invert(self, img, pe, posterior_noise, stop_at_t=t)
        else:
            latents = self.vae(img, posterior_noise)
            latents = sched.add_noise(state, latents, noise.to(latents.dtype), latent_t)
        added = self._added_cond(pooled, latents.shape[0])
        walk_state = state
        for ts in walk:
            # the same routing as the last forward; taps and maps are dropped
            out = self._denoise(sched.scale_model_input(state, latents, ts), float(ts), pe, added,
                                mask)
            latents, walk_state = sched.step(walk_state, out, ts, latents)
        out, feats = self._forward(sched.scale_model_input(state, latents, t), float(t), pe,
                                   pooled, out_dtype, control, mask)
        if self.store_vae_output:
            lat2, _ = sched.step(state, out, t, latents)
            feats['vae-out'] = self._decode(lat2, out_dtype)
        return feats

    # --------------------------------------------------------------- sampling
    def sample(self, prompts, batch_size: int = 1, num_inference_steps: int = 50,
               guidance_scale: float = 7.5, return_features: bool = True,
               unrolled: bool = False):
        """Text-to-image generation with the taps firing at every denoising
        step, the substrate of background extraction (reference
        generate_with_extraction.py: a StableDiffusionPipeline run with the
        store capturing selected U-Net calls).

        ``prompts`` is ``encode_prompt``'s 4-tuple, broadcast to
        ``batch_size``; with ``guidance_scale`` > 1 every denoiser call runs
        the [negative; positive] batch (PixArt's masks concatenated the
        same way) and combines its halves (classifier-free guidance).
        HunyuanDiT takes a raw string (the negative '' is encoded for CFG),
        one ``encode_prompt`` result or a (positive, negative) pair of them,
        and follows the stock HunyuanDiT pipeline: both streams and both
        masks in [negative; positive] order, the learned sigma dropped
        before each DDPM step, whose noise comes from the noise generator
        too.
        Returns (images (B, 3, H, W) in [0, 1], features), the features
        {layer: tuple of the raw tap of every denoiser call, step-major,
        over the CFG-doubled batch} as the JAX facade returns them (no
        store post-processing, no cast), or None with
        ``return_features=False``.  The initial latents are a standard
        normal draw from the extract's noise generator in fp32, cast, then
        scaled by the schedule's ``init_noise_sigma``.  ``unrolled`` is
        accepted for the JAX signature: this loop is the JAX facade's
        unrolled one, which its scanned loop equals."""
        del unrolled
        spec = self.spec

        def bcast(x, dtype=None):
            return self._batch(x, batch_size, dtype or self.dtype)

        mask = step_noise = None
        if spec.family == 'hunyuan':
            pos, neg = self._hunyuan_sample_prompts(prompts, guidance_scale)
            (pe, bmask), (pooled, tmask) = pos
            pe, pooled = bcast(pe), bcast(pooled)
            mask = (bcast(bmask, torch.int32), bcast(tmask, torch.int32))
            ne = neg_pooled = None
            if neg is not None:
                (ne, nbmask), (neg_pooled, ntmask) = neg
                ne, neg_pooled = bcast(ne), bcast(neg_pooled)
                mask = (torch.cat([bcast(nbmask, torch.int32), mask[0]]),
                        torch.cat([bcast(ntmask, torch.int32), mask[1]]))
        elif spec.family == 'pixart':
            pe, pmask, ne, nmask = prompts
            pooled = neg_pooled = None
            pmask, nmask = bcast(pmask, torch.int32), bcast(nmask, torch.int32)
            mask = torch.cat([nmask, pmask]) if guidance_scale > 1.0 else pmask
            pe, ne = bcast(pe), bcast(ne)
        else:
            pe, ne, pooled, neg_pooled = (bcast(x) for x in prompts)
            if spec.clip_layer != 'penultimate':
                pooled = neg_pooled = None
        self._check_conditioning(pe, pooled)
        lat = self.img_size // self.vae_scale
        channels = spec.unet.in_channels if spec.family == 'unet' else spec.dit.in_channels
        shape = (batch_size, channels, lat, lat)
        noise = torch.randn(shape, generator=self._noise_gen, device=self.device)
        if isinstance(self.scheduler, DDPMScheduler):
            step_noise = [torch.randn(shape, generator=self._noise_gen, device=self.device)
                          for _ in range(int(num_inference_steps))]
        images, feats, _ = self._sample(pe, ne, pooled, neg_pooled, noise,
                                        int(num_inference_steps), float(guidance_scale), mask,
                                        step_noise)
        self._keep_background(feats)
        return images, (feats if return_features else None)

    def _batch(self, x, batch_size: int, dtype=None):
        """``x`` (1, ...) on the device, in ``dtype`` (None keeps its own),
        expanded to ``batch_size``; None stays None."""
        if x is None:
            return None
        x = torch.as_tensor(x).to(self.device, dtype)
        return x.expand(batch_size, *x.shape[1:])

    def _hunyuan_sample_prompts(self, prompts, guidance_scale: float):
        """(positive, negative or None) ``encode_prompt`` pairs of a
        HunyuanDiT ``sample``'s ``prompts``, as the JAX facade resolves
        them: the negative is '' encoded here unless a pair was given, and
        None without CFG."""
        do_cfg = guidance_scale > 1.0
        if isinstance(prompts, str):
            return (self._encode_hunyuan(prompts),
                    self._encode_hunyuan('') if do_cfg else None)
        if isinstance(prompts[0][0], (tuple, list)):
            pos, neg = prompts
            return pos, (neg if do_cfg else None)
        if not do_cfg:
            return prompts, None
        if not self.text_encoders:
            raise ValueError('hunyuan sample() with guidance_scale > 1 needs a negative '
                             'encoding: pass a raw prompt string, a (positive, negative) pair '
                             'of encode_prompt() results, or keep the text encoders loaded so '
                             'the empty negative prompt can be encoded here')
        return prompts, self._encode_hunyuan('')

    @torch.inference_mode()
    def _sample(self, pe, ne, pooled, neg_pooled, noise, num_inference_steps: int,
                guidance_scale: float, mask=None, step_noise=None):
        """The generation loop (the JAX ``_get_sample_fn``'s unrolled
        ``run``) from ``noise``, a standard-normal draw of the latent shape:
        the latents are the noise in the model dtype times
        ``init_noise_sigma``; per timestep scale_model_input, one denoiser
        forward on the (CFG-doubled) batch with the taps (PixArt's with the
        T5 ``mask``, HunyuanDiT's with the T5 embeddings as ``pooled`` and
        the pair of masks, already CFG-doubled), the guidance combine and
        the scheduler's ``step`` (DDPM's with ``step_noise[i]``, a
        standard-normal draw of the latent shape per step); then the VAE
        decode mapped to [0, 1].
        Returns (images, {layer: tuple of per-call raw taps}, the final
        latents)."""
        sched = self.scheduler
        state = sched.set_timesteps(num_inference_steps)
        do_cfg = guidance_scale > 1.0
        latents = noise.to(self.dtype)
        latents = latents * scalar_like(state.init_noise_sigma, latents)
        ctx = torch.cat([ne, pe]) if do_cfg else pe
        pp = torch.cat([neg_pooled, pooled]) if do_cfg and pooled is not None else pooled
        added = self._added_cond(pp, ctx.shape[0])
        merged: Dict[str, tuple] = {}
        step_state = state
        ddpm = isinstance(sched, DDPMScheduler)
        if ddpm and (step_noise is None or len(step_noise) != len(state.timesteps)):
            raise ValueError(f'DDPM sampling needs one noise draw per step '
                             f'({len(state.timesteps)})')
        for i, t in enumerate(state.timesteps):
            model_in = torch.cat([latents] * 2) if do_cfg else latents
            model_in = sched.scale_model_input(step_state, model_in, t)
            taps = {}
            out = self._denoise(model_in, float(t), ctx, added, mask, taps)
            taps.pop(ATTN_STORE, None)   # sample() runs no attention store
            for key, val in taps.items():
                merged[key] = merged.get(key, ()) + (val,)
            out = out[:, :latents.shape[1]]
            if do_cfg:
                uncond, cond = out.chunk(2)
                out = uncond + guidance_scale * (cond - uncond)
            if ddpm:
                latents, step_state = sched.step(step_state, out, t, latents, step_noise[i])
            else:
                latents, step_state = sched.step(step_state, out, t, latents)
        images = (self._decode(latents, None) / 2 + 0.5).clamp(0.0, 1.0)
        return images, merged, latents

    # ------------------------------------------------------------- background
    def set_background_extraction(self, idxs):
        """Keep the features of these 1-based U-Net-call encounters from
        every later ``sample`` (or ``extract``, encounter 1)."""
        self.store_idx = list(idxs)

    def get_background_extraction(self):
        """{layer: {encounter: tensor}} of the last ``sample`` or
        ``extract`` since ``set_background_extraction``."""
        return {k: v['feat'] for k, v in self._background_feats.items()}

    def _keep_background(self, feats):
        if self.store_idx is not None:
            self._background_feats = select_background_encounters(feats, self.store_idx)
