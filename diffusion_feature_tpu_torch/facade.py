"""FeatureExtractor in PyTorch (port of ``diffusion_feature_tpu/facade.py``),
mirroring the reference's ``diffusion_feature.FeatureExtractor``
(feature/diffusion_feature.py:26-517).  It dispatches on the model's
family (``spec.family``): the U-Nets, the PixArt DiTs, HunyuanDiT, Flux or
DeepFloyd IF; each family's conditioning is one object of
``conditioning.py``.

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
Flux (``'flux'``, ``'test-flux'``) likewise: CLIP-L's pooled vector and
T5's sequence (``(t5 embeds, None, clip pooled, None)`` or a raw string),
flow-match noising at sigma(t) of the resolution-shifted 28-step schedule,
the latents 2x2-packed into one transformer forward; ``sample`` has no CFG
batch (the guidance scale feeds the guidance embedding).  DeepFloyd IF
(``'if'``, ``'test-if'``) works in pixel space: no VAE, the image itself
is noised (DDPM at the img2img timestep of ``t``) and denoised by the IF
U-Net on T5's context, whose learned variance half DDPM's step takes;
``sample`` thresholds each x0 prediction and returns the pixels.
The attention store (``attention=``) gives
the aggregated ``'attn'`` feature, the ``'vae-out'`` layer the decoded image
of one scheduler step; ``extract_ensemble`` crosses timesteps with prompts.
``control=`` adds ControlNets (Canny, DPT depth) to the tapped forward;
``sample`` generates images with the taps of every step, and
``set_background_extraction`` keeps chosen encounters of them.
Weights come from a local diffusers checkpoint (``weights=``,
``weights_variant=``), from a deployment bundle of either package
(``weights=<bundle>``, ``io/bundle.py``; ``save_converted`` writes the
port's), or at random from ``seed``, with offline LoRA merging,
or are shared with another extractor (``external_model=``); a loaded Flux
holds its transformer's projections and T5-XXL's in int8 (the JAX auto
rule, ``ops/quant.py``'s W8A16 kernel), any T5 on request (``t5_8bit``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .conditioning import BY_FAMILY as CONDITIONING
from .configs import resolve_layer_config
from .ddim_inversion import ddim_invert
from .enumerate_layers import enumerate_layers
from .io.bundle import Bundle, dtype_name, is_bundle, save_bundle
from .io.images import preprocess_pil_batch, resize_tensor_batch
from .models.bert_text import BertConfig, BertTextModel, bert_checkpoint_state
from .models.clip_text import CLIPTextConfig, CLIPTextModel
from .models.convert import (load_bundle_into, load_component_config, load_component_state,
                             load_state_into, random_module, save_component, text_jax_name)
from .models.controlnet import ControlNetPipeline
from .models.dit_pixart import PixArtConfig, PixArtTransformer2D
from .models.flux import FluxConfig, FluxTransformer2D
from .models.hunyuan import HunyuanConfig, HunyuanDiT2D
from .models.layers import ATTN_STORE
from .models.lora import apply_lora_to_module
from .models.registry import ModelSpec, get_model_spec
from .models.t5 import T5Config, T5EncoderModel, t5_checkpoint_state
from .models.unet2d import UNet2DConditionModel, UNetConfig
from .models.unet_if import IFUNet, IFUNetConfig
from .models.vae import AutoencoderKL, VAEConfig
from .parallel.mesh import Mesh, cut_parameters_, has_sp, has_tp, parallelize
from .schedulers.diffusion import (DDPMScheduler, DPMSolverMultistepScheduler,
                                   EulerDiscreteScheduler, make_scheduler, scalar_like)
from .schedulers.flow_match import FlowMatchEulerDiscreteScheduler, calculate_shift
from .store import aggregate_attention, postprocess_taps, select_background_encounters
from .taps import TapSpec, declared_ids, is_filtered_id
from .tokenizers.clip_bpe import load_clip_tokenizer
from .tokenizers.t5_tok import load_t5_tokenizer
from .tokenizers.wordpiece import load_bert_tokenizer
from .utils.prompt import encode_long_prompt

_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16, 'float32': torch.float32}
TEXT_DIRS = ('text_encoder', 'text_encoder_2')
_DIT_CONFIGS = {'pixart': PixArtConfig, 'hunyuan': HunyuanConfig, 'flux': FluxConfig}
#: the families whose denoiser is a U-Net (keyed 'unet' in a checkpoint)
_UNET_FAMILIES = ('unet', 'if')
#: the families whose single step is the pipeline's one forward: no
#: 'vae-out', no ``denoising_from``
_PIPELINE_DRIVEN = ('hunyuan', 'flux')


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
        if spec.family in _DIT_CONFIGS:
            if has('transformer'):
                updates['dit'] = _DIT_CONFIGS[spec.family].from_diffusers_config(
                    load_component_config(weights, 'transformer'))
            if spec.bert is not None and has('text_encoder'):
                updates['bert'] = BertConfig.from_hf_config(
                    load_component_config(weights, 'text_encoder'), spec.bert)
        elif has('unet'):
            updates['unet'] = (IFUNetConfig if spec.family == 'if' else UNetConfig
                               ).from_diffusers_config(load_component_config(weights, 'unet'))
        # T5 sits in text_encoder_2 where BERT or CLIP comes first
        t5_dir = 'text_encoder' if spec.family in ('pixart', 'if') else 'text_encoder_2'
        if spec.t5 is not None and has(t5_dir):
            updates['t5'] = T5Config.from_diffusers_config(
                load_component_config(weights, t5_dir), spec.t5)
        if spec.vae is not None and has('vae'):
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


def _int8_spec(spec: ModelSpec, weights: Optional[str], offline_lora: Optional[str],
               t5_8bit: Optional[bool], transformer_8bit: Optional[bool],
               tensor_parallel: bool = False, bundle_meta: Optional[dict] = None) -> ModelSpec:
    """``spec`` with the int8 flags of the T5 and of Flux's transformer set
    by the JAX facade's rules (facade.py:253-300): None turns the T5's on
    for ``flux`` with ``weights``, and the transformer's for ``flux`` with
    ``weights``, no ``offline_lora`` and no ``tensor_parallel`` (a tp mesh
    cuts the weights instead; dp and sp keep each rank's whole transformer,
    so the rule stays on there); from a deployment bundle
    (``bundle_meta``), None takes what the bundle holds instead;
    True without ``weights`` (int8 layers hold quantized checkpoint weights)
    or, for the transformer, with ``offline_lora`` raises ValueError."""
    if bundle_meta is not None:
        t5_8bit = bool(bundle_meta.get('t5_8bit')) if t5_8bit is None else t5_8bit
        transformer_8bit = (bool(bundle_meta.get('transformer_8bit'))
                            if transformer_8bit is None else transformer_8bit)
    if spec.t5 is not None:
        use = t5_8bit if t5_8bit is not None else spec.family == 'flux' and bool(weights)
        if use and not weights:
            raise ValueError('t5_8bit=True requires real weights: int8 layers take quantized '
                             'checkpoint weights, and a random init has none')
        if use:
            spec = dataclasses.replace(spec, t5=dataclasses.replace(spec.t5, quantize_int8=True))
    if spec.family == 'flux':
        use = (transformer_8bit if transformer_8bit is not None
               else bool(weights) and not offline_lora and not tensor_parallel)
        if use and offline_lora:
            raise ValueError('transformer_8bit=True cannot be combined with offline_lora: LoRA '
                             'deltas merge into full-precision weights, which int8 layers do '
                             'not carry (merge the LoRA with transformer_8bit=False)')
        if use and not weights:
            raise ValueError('transformer_8bit=True requires real weights: int8 layers take '
                             'quantized checkpoint weights, and a random init has none')
        if use:
            spec = dataclasses.replace(spec, dit=dataclasses.replace(spec.dit,
                                                                     quantize_int8=True))
    return spec


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
    and ``tokenizer_2/spiece.model``; Flux: ``transformer``, ``vae``,
    ``text_encoder`` (CLIP-L), ``text_encoder_2`` (T5), ``tokenizer`` and
    ``tokenizer_2/spiece.model``; DeepFloyd IF: ``unet``, ``text_encoder``
    (T5) and ``tokenizer/spiece.model``, no VAE).  weights_variant: the weight set to load
    ('fp16', 'bf16', ..., 'main'), falling back per component to the
    un-suffixed set.  ``weights`` may also be a deployment bundle
    (``io/bundle.py``): the JAX package's (``save_converted``,
    ``tools/make_bundle.py``) or the port's (``save_converted``,
    ``make_bundle``), whose converted weights load as stored (int8 layers
    included) into an extractor of the configuration the bundle records:
    its int8 flags resolve from the manifest where left None, explicit
    flags that differ fail with the differing entries named, another
    ``dtype`` or an ``offline_lora`` raises ValueError.  Without weights,
    models initialise at random from ``seed``.  offline_lora (with
    offline_lora_filename): a LoRA merged into the U-Net after its
    weights.  The noise of ``extract`` has its own generator, seeded from
    ``seed``, so it does not depend on where the weights came from; ``sample`` draws its initial latents from it too.
    control: ControlNet kinds ('canny', 'depth') or (kind, preprocessor)
    pairs, a depth pair naming a transformers DPT dir; weights from
    ``{weights}/controlnet_{kind}`` and ``{weights}/depth_estimator`` where
    present (the JAX ``ControlNetPipeline``); U-Nets only.
    attention: attention-store categories ('{down|mid|up}_{self|cross}';
    the DiTs' blocks are 'up'); their head-mean maps of the size band
    ``attn_store_sizes`` (tokens per side, default (img_size/32,
    img_size/16), the DiTs' (img_size/32, img_size/8)) come back as
    ``feats['attn']``.
    external_model: another extractor of the same version, device and
    dtype (else ``ValueError``) whose modules this one shares: its VAE,
    text encoders and tokenizers as they are, and its denoiser's tensors
    under a denoiser built anew with this extractor's taps and attention
    store (the JAX facade re-instruments the shared denoiser the same way),
    so no parameter memory is allocated.  It takes no ``weights=`` and no
    ``offline_lora`` (a merge would change the source's tensors).
    train_unet: as in the JAX facade, the denoiser is trained through the
    features: its parameters require grad, ``extract`` runs with autograd
    on and returns live features in the compute dtype (no bf16 cast, no
    detach).  The VAE encode, the noise draws and 'vae-out''s decode stay
    without gradients (the VAE is frozen), and so does a DDIM inversion.
    Without it, a conditioning tensor that requires grad (prompt tuning:
    ``encode_prompt``'s embeddings replaced by trainable tensors) also turns
    autograd on for the step; otherwise the step runs under
    ``torch.inference_mode``.
    t5_8bit, transformer_8bit: int8 weight-only projections
    (``ops/quant.py``, the W8A16 kernel) in the T5 encoder and in Flux's
    transformer, by the JAX facade's rules: None (the default) turns both on
    for ``flux`` loaded from ``weights=`` (the transformer's only without
    ``offline_lora``, whose deltas merge into full-precision weights), True
    forces them on (ValueError without ``weights=``, for the transformer
    also with ``offline_lora`` or on another family than Flux), False off.
    The checkpoint's weights are quantized as they load.  An int8 denoiser
    takes no ``train_unet`` (no gradient reaches int8 weights, as in JAX)
    and no ``save_weights`` (a diffusers tree holds full-precision
    weights); prompt tuning through it gets its input gradient.  With
    ``external_model`` the source's choice holds and its int8 tensors are
    shared.
    mesh: a ``parallel.mesh.Mesh`` (``make_mesh(dp=, tp=, sp=)`` in every
    rank's process), or None or False for one device.  dp: each rank runs
    its rows of the batch (a batch that dp does not divide runs whole on
    every rank) from the whole batch's noise, and ``extract`` and
    ``sample`` return the whole batch on every rank; ``extract_rows``
    returns a rank's own rows.  tp: the denoiser's projections are cut
    (``parallel/mesh.py``); each rank holds its part, from the random init
    or the checkpoint, and the taps come back whole.  sp: the DiTs' tokens
    are split between blocks.  Other values raise TypeError; gradients
    (``train_unet``, prompt tuning) take dp alone (ValueError under tp or
    sp).
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
        if mesh is False:
            mesh = None
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f'mesh must be a parallel.mesh.Mesh (make_mesh(...)), None or '
                            f'False, got {type(mesh).__name__}')
        self.mesh = mesh
        if train_unet and (has_tp(mesh) or has_sp(mesh)):
            raise ValueError('train_unet=True takes a dp mesh alone: gradients do not flow '
                             'through the tensor- and sequence-parallel collectives')
        self.spec: ModelSpec = get_model_spec(version)
        if transformer_8bit and self.spec.family != 'flux':
            raise ValueError('transformer_8bit is only supported for flux (the JAX facade '
                             "quantizes no other family's denoiser)")
        if control and self.spec.family != 'unet':
            # the JAX ControlNetPipeline builds its nets from spec.unet
            raise ValueError(f'control= needs a U-Net version: {version!r} is a '
                             f'{self.spec.family!r} model, and the ControlNets copy an SD '
                             'U-Net encoder (models/controlnet.py)')
        self.version = version
        self.device = torch.device(device)
        self.dtype = _DTYPES[dtype]
        self._offline_lora = offline_lora
        #: the deployment bundle ``weights`` names (io/bundle.py), or None
        self._bundle: Optional[Bundle] = None
        if external_model is not None:
            self._check_external(external_model, weights, offline_lora)
            self.spec = external_model.spec
        elif weights:
            if is_bundle(weights):
                if offline_lora:
                    raise ValueError('offline_lora cannot be applied on top of a deployment '
                                     'bundle: bundles carry already-merged weights (merge the '
                                     'LoRA when exporting: build from the checkpoint with '
                                     'offline_lora, then save_converted)')
                self._bundle = Bundle(weights)
            self.spec = _adapt_spec_to_checkpoint(self.spec, weights)
            if self.spec.family == 'unet' and isinstance(self.spec.unet, IFUNetConfig):
                raise ValueError(f'{weights} holds a DeepFloyd IF U-Net; load it with '
                                 "version='if' (or 'test-if')")
        if external_model is None:
            self.spec = _int8_spec(self.spec, weights, offline_lora, t5_8bit, transformer_8bit,
                                   has_tp(mesh), self._bundle.meta if self._bundle else None)
        if self._bundle is not None:
            self._bundle.check_dtype(self._bundle_expect())
        if train_unet and self._int8_denoiser:
            raise ValueError('train_unet=True needs a full-precision denoiser: no gradient '
                             'reaches int8 weights (pass transformer_8bit=False)')
        self.img_size = img_size
        self.feature_resize = feature_resize
        self.train_unet = bool(train_unet)
        # features keep the compute dtype when the denoiser is trained
        # (JAX facade.py:88-90; the reference's store skips its fp16 cast)
        self.feature_dtype = None if self.train_unet else torch.bfloat16
        self.taps = TapSpec.from_config(resolve_layer_config(layer))
        # the 'vae-out' pseudo-layer: one scheduler step decoded to an image
        self.store_vae_output = (not self.taps.accept_all and 'vae-out' in self.taps.ids
                                 and self.spec.vae is not None)
        self.attention = list(attention) if attention else None
        # the store's size band (reference components/attention.py:542, :569)
        self._attn_sizes = None
        if self.attention:
            top = img_size // (16 if self.spec.family in _UNET_FAMILIES else 8)
            self._attn_sizes = (tuple(attn_store_sizes) if attn_store_sizes is not None
                                else (img_size // 32, top))
        self.scheduler = make_scheduler(self.spec.scheduler, self.spec.scheduler_config)
        # pixel space (IF) has no VAE: its latents are the image
        self.vae_scale = (1 if self.spec.vae is None
                          else 2 ** (len(self.spec.vae.block_out_channels) - 1))
        # the extract's noise and the random init draw from generators of
        # their own (the JAX facade's _rng and init key)
        self._noise_gen = torch.Generator(device=self.device).manual_seed(seed)
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        #: {component: (bytes, seconds)} of the checkpoint load
        self.load_stats: Dict[str, Tuple[int, float]] = {}
        self._weights_root = weights

        spec = self.spec
        categories = tuple(self.attention or ())
        # the DiT keeps the facade's attribute name of the denoiser
        denoiser = {'pixart': PixArtTransformer2D, 'hunyuan': HunyuanDiT2D,
                    'flux': FluxTransformer2D, 'unet': UNet2DConditionModel,
                    'if': IFUNet}[spec.family]

        def make_denoiser():
            return denoiser(spec.unet if spec.family in _UNET_FAMILIES else spec.dit, self.taps,
                            self._attn_sizes, categories)

        def build(make, component, adapt=None, parallel=None):
            if weights:
                return self._load_component(make, weights, weights_variant, component, adapt,
                                            parallel)
            return random_module(make, self.device, self.dtype, init_gen, parallel)

        #: {key: cut} of the denoiser's tensors on this rank (tp)
        self._cuts = {}
        if external_model is not None:
            self._share_models(external_model, make_denoiser)
        else:
            self.unet = build(make_denoiser,
                              'unet' if spec.family in _UNET_FAMILIES else 'transformer',
                              parallel=self._parallel if self._model_parallel else None)
            self.vae = None if spec.vae is None else build(lambda: AutoencoderKL(spec.vae), 'vae')
            self.text_encoders, self.tokenizers = self._build_text_encoders(build, weights)
        if offline_lora:
            apply_lora_to_module(self.unet, offline_lora, offline_lora_filename, self._cuts)
        if self.train_unet:
            # the reference hands the U-Net to the optimizer
            # (feature/diffusion_feature.py:87-89)
            self.unet.requires_grad_(True)
        if validate_layers and not self.taps.accept_all:
            self._validate_layer_ids()
        # background extraction: the encounters to keep and what was kept
        self.store_idx: Optional[list] = None
        self._background_feats: Dict[str, dict] = {}
        self.control_pipe = ControlNetPipeline(self, control, weights) if control else None

    def _build_text_encoders(self, build, weights: Optional[str]):
        """(text encoders, tokenizers) of the family, each encoder through
        ``build`` (random or from the checkpoint dir ``weights``)."""
        spec = self.spec
        tok_dirs = [os.path.join(weights, d) if weights else None
                    for d in ('tokenizer', 'tokenizer_2')]
        if spec.family == 'hunyuan':
            # BERT WordPiece from tokenizer/vocab.txt, the hash tokenizer offline
            encoders = (
                build(lambda: BertTextModel(spec.bert), 'text_encoder', bert_checkpoint_state),
                build(lambda: T5EncoderModel(spec.t5), 'text_encoder_2', t5_checkpoint_state))
            tokenizers = (
                load_bert_tokenizer(tok_dirs[0], model_max_length=spec.dit.text_len,
                                    vocab_size=spec.bert.vocab_size),
                load_t5_tokenizer(tok_dirs[1], model_max_length=spec.dit.text_len_t5,
                                  vocab_size=spec.t5.vocab_size))
        elif spec.family in ('pixart', 'if'):
            encoders = (build(lambda: T5EncoderModel(spec.t5), 'text_encoder',
                              t5_checkpoint_state),)
            tokenizers = (load_t5_tokenizer(tok_dirs[0], model_max_length=spec.prompt_max_length,
                                            vocab_size=spec.t5.vocab_size),)
        else:
            encoders = tuple(build(lambda c=c: CLIPTextModel(c), d)
                             for c, d in zip(spec.text_encoders, TEXT_DIRS))
            # tokenizer_2 (OpenCLIP) pads with id 0; the first pads with EOS
            tokenizers = tuple(
                load_clip_tokenizer(d if d and os.path.isdir(d) else None,
                                    vocab_size=c.vocab_size, pad_with_eos=(i == 0))
                for i, (d, c) in enumerate(zip(tok_dirs, spec.text_encoders)))
            if spec.family == 'flux':
                # T5 after CLIP-L, over prompt_max_length tokens
                encoders += (build(lambda: T5EncoderModel(spec.t5), 'text_encoder_2',
                                   t5_checkpoint_state),)
                tokenizers += (load_t5_tokenizer(tok_dirs[1],
                                                 model_max_length=spec.prompt_max_length,
                                                 vocab_size=spec.t5.vocab_size),)
        return encoders, tokenizers

    @property
    def _model_parallel(self) -> bool:
        """Whether the mesh cuts the denoiser (tp) or its tokens (sp)."""
        return has_tp(self.mesh) or has_sp(self.mesh)

    def _parallel(self, module):
        """Cut the denoiser ``module`` (on the meta device) for this rank of
        the mesh; its cuts are kept in ``_cuts`` and returned."""
        self._cuts = parallelize(module, self.mesh)
        cut_parameters_(module, self._cuts)
        return self._cuts

    @property
    def _int8_denoiser(self) -> bool:
        return bool(getattr(self.spec.dit, 'quantize_int8', False))

    def _check_external(self, source, weights, offline_lora):
        """Refuse an ``external_model`` whose modules this extractor could
        not run as they are: another version, device or dtype, or with
        ``weights=`` or ``offline_lora``."""
        if not isinstance(source, FeatureExtractor):
            raise ValueError(f'external_model must be a FeatureExtractor, got {type(source)}')

        def resolved(device):
            if device.type == 'cuda' and device.index is None:
                return torch.device('cuda', torch.cuda.current_device())
            return device
        for name, ours, theirs in (('version', self.version, source.version),
                                   ('device', resolved(self.device), resolved(source.device)),
                                   ('dtype', self.dtype, source.dtype),
                                   ('mesh', self.mesh, source.mesh)):
            if ours != theirs:
                raise ValueError(f"external_model's {name} is {theirs}, this extractor's "
                                 f'{ours}: its modules cannot be shared')
        if weights or offline_lora:
            raise ValueError('external_model shares the source\'s parameters: pass no weights= '
                             'or offline_lora with it (a LoRA merge would change the source)')

    def _share_models(self, source, make_denoiser):
        """This extractor's modules over ``source``'s tensors: the denoiser
        built on the meta device with this request's taps and store, then
        given the source's parameters (``assign``: the same storage); the
        VAE, text encoders and tokenizers as they are."""
        with torch.device('meta'):
            self.unet = make_denoiser()
        if self._model_parallel:
            self._parallel(self.unet)
        self.unet.load_state_dict(source.unet.state_dict(), assign=True)
        self.unet.eval().requires_grad_(False)
        self.vae = source.vae
        self.text_encoders = source.text_encoders
        self.tokenizers = source.tokenizers

    def _load_component(self, make, root: str, variant: Optional[str], component: str,
                        adapt=None, parallel=None):
        """Build ``make()`` on the meta device and fill it from the
        checkpoint's ``component`` dir (its tensors through ``adapt``, where
        given): parameters are allocated once, at the compute dtype, and
        never initialised at random.  ``parallel`` (meta module -> cuts)
        cuts the module first, and each cut tensor is cut from the
        checkpoint's view before it is copied to the device."""
        with torch.device('meta'):
            module = make()
        cuts = parallel(module) if parallel is not None else None
        if self._bundle is not None:
            return self._load_bundle_component(module, component, cuts)
        t0 = time.perf_counter()
        state = load_component_state(root, component, variant=variant)
        if adapt is not None:
            state = adapt(state)
        unused = set(load_state_into(module, state, self.dtype, self.device, cuts,
                                     self.mesh.axis('tp') if cuts else None))
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        nbytes = sum(t.numel() * t.element_size() for k, t in state.items() if k not in unused)
        self.load_stats[component] = (nbytes, time.perf_counter() - t0)
        return module.eval().requires_grad_(False)

    def _load_bundle_component(self, module, component: str, cuts):
        """Fill the meta-built ``module`` from the bundle's ``component``
        (``convert.load_bundle_into``); a mismatch names the meta entries
        where the bundle and this extractor differ."""
        bundle = self._bundle
        t0 = time.perf_counter()
        leaves = bundle.leaves(component)
        try:
            unused = set(load_bundle_into(
                module, leaves, self.dtype, self.device, cuts, bundle.jax_layout,
                text_jax_name(module) if bundle.jax_layout else None))
        except ValueError as e:
            raise ValueError(f'{e}{bundle.mismatch_hint(self._bundle_expect())}') from e
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        nbytes = sum(t.numel() * t.element_size() for k, t in leaves.items() if k not in unused)
        self.load_stats[component] = (nbytes, time.perf_counter() - t0)
        return module.eval().requires_grad_(False)

    def _bundle_meta(self) -> dict:
        """The configuration a deployment bundle records (the JAX facade's
        ``_bundle_meta``); a bundle loads into an extractor of the same."""
        return {'version': self.version, 'family': self.spec.family,
                'dtype': dtype_name(self.dtype), 'transformer_8bit': self._int8_denoiser,
                't5_8bit': bool(getattr(self.spec.t5, 'quantize_int8', False)),
                'offline_lora': self._offline_lora}

    def _bundle_expect(self) -> dict:
        """``_bundle_meta`` without ``offline_lora``, which a bundle keeps
        as provenance only (a bundle never loads with a LoRA)."""
        return {k: v for k, v in self._bundle_meta().items() if k != 'offline_lora'}

    def save_converted(self, out_dir: str) -> str:
        """Write a deployment bundle (``io/bundle.py``) to ``out_dir`` and
        return it: the denoiser, the VAE and the text encoders as they are
        held (at the serving dtype, int8 ``weight_q`` with its fp32
        ``scale``, a merged LoRA's weights), each a safetensors file in the
        port's layout, beside the manifest and copies of the source
        checkpoint's config.json, tokenizer, depth and ControlNet dirs.
        ``FeatureExtractor(weights=out_dir)`` with the same configuration
        loads it with no key matching and no quantization.  ValueError for
        an extractor without ``weights=`` (a random init is not a
        deployable artifact), with its text encoders dropped, or under tp
        (each rank holds a part); under dp or sp the mesh's first rank
        writes and the others wait for it."""
        if not self._weights_root:
            raise ValueError('save_converted requires the extractor to have been built from '
                             'real weights (weights=<checkpoint dir>): a random-init extractor '
                             'is not a deployable artifact')
        if not self.text_encoders:
            raise ValueError('the text encoders were offloaded persistently; rebuild the '
                             'extractor before exporting a bundle')
        if has_tp(self.mesh):
            raise ValueError('save_converted writes whole tensors; under tp each rank holds a '
                             'part of the denoiser (save from an extractor without a mesh)')
        states = {'unet' if self.spec.family in _UNET_FAMILIES else 'transformer':
                  self.unet.state_dict()}
        if self.vae is not None:
            states['vae'] = self.vae.state_dict()
        states.update((d, te.state_dict()) for d, te in zip(TEXT_DIRS, self.text_encoders))
        if self.mesh is None:
            return save_bundle(out_dir, states, meta=self._bundle_meta(),
                               src_checkpoint=self._weights_root)[0]
        error = None
        if all(c == 0 for c in self.mesh.coords.values()):
            try:
                save_bundle(out_dir, states, meta=self._bundle_meta(),
                            src_checkpoint=self._weights_root)
            except (OSError, ValueError) as e:
                error = f'{type(e).__name__}: {e}'
        error = self.mesh.first_rank_object(error)
        if error is not None:
            raise RuntimeError(f'the first rank of the mesh failed to write {out_dir}: {error}')
        return str(out_dir)

    def save_weights(self, root: str, variant: Optional[str] = None, unet_shards: int = 1,
                     text_shards: int = 1) -> Dict[str, Tuple[int, float]]:
        """Write the denoiser (U-Net, or the DiT's transformer), the VAE (none
        in pixel space) and the text encoders as a diffusers checkpoint dir
        that ``weights=`` loads: a config.json and safetensors files per
        component, named with ``variant``, the denoiser in ``unet_shards``
        files and each text encoder in ``text_shards``; the tokenizer dirs
        of the checkpoint this extractor was loaded from, where it has
        them, are copied.  Returns {component: (bytes written, seconds)},
        as ``load_stats``.  An extractor with int8 layers raises ValueError."""
        spec = self.spec
        if has_tp(self.mesh):
            raise ValueError('save_weights writes whole tensors; under tp each rank holds a '
                             'part of the denoiser (save from an extractor without a mesh)')
        if self._int8_denoiser or getattr(spec.t5, 'quantize_int8', False):
            raise ValueError('save_weights writes a diffusers tree of full-precision weights; '
                             'this extractor holds int8 weight-only layers (build it with '
                             'transformer_8bit=False, t5_8bit=False to write one)')
        comps = [('unet', self.unet, spec.unet) if spec.family in _UNET_FAMILIES
                 else ('transformer', self.unet, spec.dit)]
        if self.vae is not None:
            comps.append(('vae', self.vae, spec.vae))
        text_cfgs = {'pixart': (spec.t5,), 'if': (spec.t5,), 'hunyuan': (spec.bert, spec.t5),
                     'flux': (*spec.text_encoders, spec.t5)}.get(spec.family,
                                                                 spec.text_encoders)
        comps += zip(TEXT_DIRS, self.text_encoders, text_cfgs)
        stats = {}
        for i, (comp, module, cfg) in enumerate(comps):
            t0 = time.perf_counter()
            shards = unet_shards if i == 0 else text_shards if comp in TEXT_DIRS else 1
            files = save_component(root, comp, module.state_dict(), cfg.to_diffusers_config(),
                                   variant, shards)
            stats[comp] = (sum(files.values()), time.perf_counter() - t0)
        for d in ('tokenizer', 'tokenizer_2') if self._weights_root else ():
            src = os.path.join(self._weights_root, d)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(root, d), dirs_exist_ok=True)
        return stats

    def _validate_layer_ids(self):
        """Fail fast on ids the U-Net does not declare, with near-miss
        suggestions (the reference silently drops unknown ids)."""
        known = declared_ids(self.unet)
        # 'attn' is assembled only when attention categories were requested;
        # the pipeline-driven HunyuanDiT and Flux paths decode no 'vae-out'
        pseudo = ({'attn'} if self.attention else set()) | (
            set() if self.spec.family in _PIPELINE_DRIVEN or self.vae is None else {'vae-out'})
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
            if i == 'vae-out' and self.spec.family in _PIPELINE_DRIVEN:
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
        together; ``sample`` encodes the empty negative itself).  Flux:
        (T5 embeddings, None, CLIP pooled, None), the JAX facade's
        ``_encode_flux`` (no negative: Flux runs no CFG).  DeepFloyd IF:
        (T5 embeddings, negative T5 embeddings, None, None), the masks used
        by the encoder and dropped (the U-Net takes none), as in JAX."""
        if (prompt_str is None) == (prompt_file is None):
            raise ValueError('pass exactly one of prompt_str and prompt_file')
        if prompt_file:
            with open(prompt_file) as f:
                prompt_str = f.read()
        if self.spec.family == 'pixart':
            return (*self._encode_masked(prompt_str), *self._encode_masked(''))
        if self.spec.family == 'hunyuan':
            return self._encode_hunyuan(prompt_str)
        if self.spec.family == 'flux':
            return self._encode_flux(prompt_str)
        if self.spec.family == 'if':
            return self._encode_masked(prompt_str)[0], self._encode_masked('')[0], None, None
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

    @torch.inference_mode()
    def _encode_flux(self, text: str):
        """(T5 embeddings (1, L, 4096), None, CLIP-L pooled (1, 768), None)
        of ``text``: the T5 sees its ids without a mask, as in the JAX
        facade."""
        self._require_text_encoders()
        (clip_tok, t5_tok), (clip, t5) = self.tokenizers, self.text_encoders
        ids = torch.tensor(clip_tok([text]), dtype=torch.long,
                           device=next(clip.parameters()).device)
        _, pooled, _ = clip(ids)
        t5_ids, _ = t5_tok([text])
        pe = t5(torch.tensor(t5_ids, dtype=torch.long, device=next(t5.parameters()).device))
        return pe.to(self.device), None, pooled.to(self.device), None

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
        ``denoising_from`` and no DDIM inversion; so do Flux's
        (``encode_prompt``'s 4-tuple or a raw string, one forward at the
        flow-match sigma of ``t``).  IF noises the pixels themselves, and
        its ``denoising_from`` walk thresholds each step's x0; it has no
        'vae-out', no DDIM inversion and no attention maps (its
        ``attention=`` yields no 'attn').  Under a mesh with dp each rank
        runs its rows and every rank returns the whole batch."""
        kw = dict(image_type=image_type, t=t, denoising_from=denoising_from,
                  use_control=use_control, use_ddim_inversion=use_ddim_inversion)
        rows = self._sharded_rows(batch_size)
        if rows is None:
            feats = self._extract(prompts, batch_size, image, (0, batch_size), **kw)
        else:
            feats = {k: self._gather_batch(v, batch_size) for k, v in self._extract(
                prompts, batch_size, image[rows[0]:rows[1]], rows, **kw).items()}
        self._keep_background(feats)
        return feats

    def dp_rows(self, batch_size: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of a batch of ``batch_size`` under
        the mesh's dp (``parallel.mesh.split_sizes``: uneven where dp does
        not divide the batch); the whole batch without dp."""
        if self.mesh is None or self.mesh.dp == 1:
            return 0, batch_size
        return self.mesh.axis('dp').bounds(batch_size)

    def extract_rows(self, prompts, batch_size: int, image, image_type: str = 'image',
                     t: int = 50, denoising_from: Optional[int] = None,
                     use_control: bool = False,
                     use_ddim_inversion: bool = False) -> Dict[str, torch.Tensor]:
        """``extract`` of this dp rank's rows ``dp_rows(batch_size)`` of a
        batch of ``batch_size``: ``image`` holds those rows' images alone,
        and their features come back, not gathered (the extraction CLI's
        ranks each write their own).  The noise is the whole batch's rows,
        so the rows equal ``extract``'s of the whole batch; a rank with no
        rows draws it too and returns {}."""
        lo, hi = self.dp_rows(batch_size)
        if len(image) != hi - lo:
            raise ValueError(f'this rank holds rows [{lo}, {hi}) of the batch of {batch_size}, '
                             f'got {len(image)} images')
        return self._extract(prompts, batch_size, image, (lo, hi), image_type=image_type, t=t,
                             denoising_from=denoising_from, use_control=use_control,
                             use_ddim_inversion=use_ddim_inversion)

    def _sharded_rows(self, batch_size: int) -> Optional[Tuple[int, int]]:
        """This rank's rows where the mesh's dp divides ``batch_size``;
        None where there is no dp or it does not divide (the batch then
        runs whole on every rank, as in JAX)."""
        if self.mesh is None or self.mesh.dp == 1 or batch_size % self.mesh.dp:
            return None
        return self.dp_rows(batch_size)

    def _gather_batch(self, x: torch.Tensor, batch_size: int, halves: int = 1) -> torch.Tensor:
        """Every dp rank's rows of ``x`` in batch order; a batch of
        ``halves`` stacked parts ([negative; positive] under CFG) is
        gathered part by part."""
        dp = self.mesh.axis('dp')
        sizes = dp.split(batch_size)
        return torch.cat([dp.gather(part, 0, sizes) for part in x.chunk(halves)])

    def _latent_noise(self, batch_size: int):
        """(posterior noise, forward noise): standard-normal fp32 draws of
        the whole batch's latent shape from the noise generator (cast inside
        the step, JAX utils.normal_like)."""
        shape = self.latent_shape(batch_size)
        return (torch.randn(shape, generator=self._noise_gen, device=self.device),
                torch.randn(shape, generator=self._noise_gen, device=self.device))

    def _extract(self, prompts, batch_size: int, image, rows: Tuple[int, int],
                 image_type: str, t: int, denoising_from: Optional[int], use_control: bool,
                 use_ddim_inversion: bool) -> Dict[str, torch.Tensor]:
        """The features of rows [lo, hi) of a batch of ``batch_size``;
        ``image`` holds those rows' images."""
        spec = self.spec
        if use_ddim_inversion and (spec.family != 'unet'
                                   or spec.unet.addition_embed_type is not None
                                   or spec.scheduler_config.prediction_type != 'epsilon'):
            # the reference runs DDIM inversion on the epsilon SD U-Nets only
            raise NotImplementedError(
                'use_ddim_inversion supports the epsilon-prediction SD '
                "U-Net families ('1-5'/'2-1'), as in the reference")
        if spec.family in _PIPELINE_DRIVEN and denoising_from is not None:
            raise ValueError(f'denoising_from is unavailable for the pipeline-driven '
                             f'{spec.family} path (one denoiser forward at t), as in the JAX '
                             'package')
        lo, hi = rows
        cond = self._step_conditioning(prompts, batch_size)
        if (lo, hi) != (0, batch_size):
            cond = cond.rows(lo, hi)
        if hi == lo:
            self._latent_noise(batch_size)   # the generator stays in step with the others
            return {}
        if image_type == 'image':
            img = preprocess_pil_batch(image, self.img_size)
        else:
            img = resize_tensor_batch(image, self.img_size)
        img = torch.as_tensor(img).to(self.device, self.dtype)
        control = None
        if use_control and self.control_pipe is not None:
            raw = image if image_type == 'image' else self.control_pipe.tensors_to_pil(img)
            control = self.control_pipe.prepare_control_images(raw, hi - lo)

        posterior_noise, noise = (x[lo:hi] for x in self._latent_noise(batch_size))
        if denoising_from is None and not use_ddim_inversion:
            return self._step(img, cond, self._step_kit(int(t)), posterior_noise, noise,
                              self.feature_dtype, control=control)
        return self._multistep(img, cond, int(t), denoising_from, use_ddim_inversion,
                               posterior_noise, noise, self.feature_dtype, control=control)

    def latent_shape(self, batch_size: int) -> Tuple[int, int, int, int]:
        """(B, C, h, w) of what the denoiser walks: the VAE's latents, or in
        pixel space (IF) the image itself."""
        lat = self.img_size // self.vae_scale
        channels = (self.spec.unet.in_channels if self.spec.is_pixel_space
                    else self.spec.vae.latent_channels)
        return batch_size, channels, lat, lat

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
        """The denoiser's conditioning object (``conditioning.py``) of
        ``encode_prompt``'s output (HunyuanDiT's and Flux's also of a raw
        string), on
        the device, broadcast to ``batch_size`` and checked against the
        denoiser before any compute."""
        return CONDITIONING[self.spec.family].from_prompts(self, prompts, batch_size)

    def _sample_conditioning(self, prompts, batch_size: int, guidance_scale: float):
        """(positive, negative or None) conditioning objects of ``sample``'s
        ``prompts``, broadcast to ``batch_size``; the negative only where
        the family runs classifier-free guidance at ``guidance_scale``."""
        return CONDITIONING[self.spec.family].for_sample(self, prompts, batch_size,
                                                         guidance_scale)

    def _img2img_kit(self, t: int) -> Dict[str, float]:
        """The Euler, DPM-Solver, DDPM and PNDM branches of the JAX facade's
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
        elif isinstance(sched, DDPMScheduler):
            # DDPM-family noising; the posterior mean of x0 and the latents
            # (IF's, the learned variance and the noise not entering it)
            ti = int(lt)
            prev_t = ti - sched.step_size(state)
            a_t = float(sched.alphas_cumprod[ti])
            a_prev = float(sched.alphas_cumprod[prev_t]) if prev_t >= 0 else 1.0
            A, B, S = float(np.sqrt(a_t)), float(np.sqrt(1 - a_t)), 1.0
            current_beta = 1 - a_t / a_prev
            C1 = float(np.sqrt(a_prev) * current_beta / (1 - a_t))
            C2, C3 = float(np.sqrt(a_t / a_prev) * (1 - a_prev) / (1 - a_t)), 0.0
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

    def _flux_kit(self, t: int, num_inference_steps: int = 28) -> Dict[str, float]:
        """The JAX facade's ``_flux_kit``: the first timestep T >= ``t`` of
        the resolution-shifted ``num_inference_steps`` flow-match ladder
        and the noising latents <- A*latents + B*noise, A = 1 - sigma(T),
        B = sigma(T)."""
        sched = self.scheduler
        state = self._set_timesteps(num_inference_steps)
        timesteps, _ = sched.get_timesteps(state, num_inference_steps, t / 1000)
        latent_t = float(timesteps[0])
        sigma = float(state.sigmas[sched._index(state, latent_t)])
        return {'T': latent_t, 'A': 1.0 - sigma, 'B': sigma}

    def _set_timesteps(self, num_inference_steps: int):
        """The scheduler's state for ``num_inference_steps``; flow match's
        ladder is shifted by the packed token count (``calculate_shift``
        of (lat/2)^2, the stock FluxPipeline's linspace sigmas)."""
        sched = self.scheduler
        if not isinstance(sched, FlowMatchEulerDiscreteScheduler):
            return sched.set_timesteps(num_inference_steps)
        lat = self.img_size // self.vae_scale
        return sched.set_timesteps(
            num_inference_steps, mu=calculate_shift((lat // 2) ** 2, sched.config),
            sigmas=np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps))

    def _step_kit(self, t: int) -> Dict[str, float]:
        """The single step's kit at ``t``: HunyuanDiT's or Flux's pipeline
        kit, whose latents enter the denoiser unscaled (S = 1), or the
        img2img kit."""
        if self.spec.family == 'hunyuan':
            return {**self._hunyuan_kit(t), 'S': 1.0}
        if self.spec.family == 'flux':
            return {**self._flux_kit(t), 'S': 1.0}
        return self._img2img_kit(t)

    def _forward(self, lat_in, timestep, cond, out_dtype, control=None):
        """The denoiser forward on ``cond`` (a conditioning object) with
        taps and store, then the store post-processing (the JAX
        ``_collect_feats``): returns (model output, features).  ``control``
        (one condition image batch per ControlNet) runs the ControlNets on
        the same input and adds their residuals."""
        feats = {}
        down = mid = None
        if control is not None:
            down, mid = cond.control_residuals(self.control_pipe, lat_in, timestep, control)
        out = cond.forward(self.unet, lat_in, timestep, feats, down, mid)
        store = feats.pop(ATTN_STORE, {})
        feats = postprocess_taps(feats, resize_ratio=self.feature_resize, out_dtype=out_dtype)
        if self.attention:
            agg = aggregate_attention(store, self.attention, self.img_size, out_dtype)
            if agg is not None:
                feats['attn'] = agg
        return out, feats

    def _decode(self, latents, out_dtype):
        """'vae-out': scaled latents decoded to images, in ``out_dtype``
        (None keeps the compute dtype), with no feature_resize; the frozen
        VAE records no gradient."""
        cfg = self.spec.vae
        with torch.no_grad():
            img = self.vae.decode(latents / scalar_like(cfg.scaling_factor, latents)
                                  + scalar_like(cfg.shift_factor, latents))
        return img.to(out_dtype or img.dtype)

    def _autograd(self, cond):
        """(context, conditioning) for a step: autograd on, with the
        conditioning's tensors made by ``encode_prompt`` under inference
        mode copied into ordinary ones, when grad mode is on and the
        denoiser is trained or a conditioning tensor requires grad (prompt
        tuning); else inference mode, as extraction always ran."""
        if torch.is_grad_enabled() and (self.train_unet or cond.requires_grad()):
            if self._model_parallel:
                raise ValueError('gradients take a dp mesh alone: they do not flow through '
                                 'the tensor- and sequence-parallel collectives')
            return torch.enable_grad(), cond.outside_inference_mode()
        return torch.inference_mode(), cond

    def _step(self, img, cond, kit, posterior_noise, noise, out_dtype, control=None):
        """The single step (the JAX ``_get_step_fn_generic`` program): VAE
        encode + posterior sample -> latents*A + noise*B -> /S -> denoiser
        on the conditioning object ``cond`` with taps -> store
        post-processing to ``out_dtype`` (None keeps the compute dtype),
        and 'vae-out' from the kit's fresh-state step.  Noise tensors are
        standard-normal draws of the latent shape, cast here to the model
        dtype; ``control`` goes to ``_forward``.  HunyuanDiT's kit has S =
        1 (the JAX facade's ``_get_hunyuan_step_fn`` program).  In pixel
        space (IF) the latents are the image and ``posterior_noise`` is
        unused.  Autograd as ``_autograd`` says; the VAE never records."""
        mode, cond = self._autograd(cond)
        with mode:
            with torch.no_grad():
                latents = img if self.vae is None else self.vae(img, posterior_noise)
            latents = (scalar_like(kit['A'], latents) * latents
                       + scalar_like(kit['B'], latents) * noise.to(latents.dtype))
            out, feats = self._forward(latents / scalar_like(kit['S'], latents), kit['T'], cond,
                                       out_dtype, control)
            if self.store_vae_output:
                x0 = (scalar_like(kit['X1'], latents) * latents
                      + scalar_like(kit['X2'], latents) * out)
                lat2 = (scalar_like(kit['C1'], latents) * x0
                        + scalar_like(kit['C2'], latents) * latents
                        + scalar_like(kit['C3'], latents) * out)
                feats['vae-out'] = self._decode(lat2, out_dtype)
        return feats

    def _multistep(self, img, cond, t: int, denoising_from: Optional[int],
                   use_ddim_inversion: bool, posterior_noise, noise, out_dtype, control=None):
        """The multi-step paths (the JAX ``_get_step_fn``).  Timesteps: with
        ``denoising_from`` within 50 of ``t`` the 1000-step schedule from
        ``denoising_from``, else the 100-step one at strength
        ``denoising_from / 100`` (JAX's quirk: t=50, denoising_from=200
        starts at 991), cut at the last timestep >= ``t``.  The latents are
        noised at the first (or DDIM-inverted up to ``t``), walked through
        ``sched.step`` over all but the last with forwards whose taps and
        store maps are discarded, then the last forward keeps them; the
        ControlNets (``control``) join that last forward only.  'vae-out'
        decodes one step of the fresh schedule from there.  With autograd
        (``_autograd``) the walk's forwards are recorded too, as JAX
        differentiates them; the VAE and a DDIM inversion are not."""
        mode, cond = self._autograd(cond)
        with mode:
            return self._multistep_walk(img, cond, t, denoising_from, use_ddim_inversion,
                                        posterior_noise, noise, out_dtype, control)

    def _multistep_walk(self, img, cond, t, denoising_from, use_ddim_inversion,
                        posterior_noise, noise, out_dtype, control):
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
            latents = ddim_invert(self, img, cond, posterior_noise, stop_at_t=t)
            if torch.is_grad_enabled():
                # an inference-mode result: copied to take part in autograd
                latents = latents.clone()
        else:
            with torch.no_grad():
                latents = img if self.vae is None else self.vae(img, posterior_noise)
            latents = sched.add_noise(state, latents, noise.to(latents.dtype), latent_t)
        walk_state = state
        for ts in walk:
            # the same routing as the last forward; taps and maps are dropped
            out = cond.forward(self.unet, sched.scale_model_input(state, latents, ts), float(ts))
            latents, walk_state = sched.step(walk_state, out, ts, latents)
        out, feats = self._forward(sched.scale_model_input(state, latents, t), float(t), cond,
                                   out_dtype, control)
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
        too.  Flux takes a raw string or its ``encode_prompt`` result and
        runs no CFG batch: ``guidance_scale`` * 1000 feeds the guidance
        embedding, over the resolution-shifted flow-match schedule.
        DeepFloyd IF follows the stock IF pipeline in pixel space: CFG on
        the noise prediction, the positive's learned variance, each x0
        dynamically thresholded by the DDPM step, the final pixels mapped
        to [0, 1].
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
        cond, neg = self._sample_conditioning(prompts, batch_size, guidance_scale)
        shape = self.latent_shape(batch_size)
        noise = torch.randn(shape, generator=self._noise_gen, device=self.device)
        step_noise = None
        if isinstance(self.scheduler, DDPMScheduler):
            step_noise = [torch.randn(shape, generator=self._noise_gen, device=self.device)
                          for _ in range(int(num_inference_steps))]
        rows = self._sharded_rows(batch_size)
        if rows is not None:   # dp: this rank's rows of the whole batch's draws
            lo, hi = rows
            cond, noise = cond.rows(lo, hi), noise[lo:hi]
            neg = None if neg is None else neg.rows(lo, hi)
            step_noise = None if step_noise is None else [x[lo:hi] for x in step_noise]
        images, feats, _ = self._sample(cond, neg, noise, int(num_inference_steps),
                                        float(guidance_scale), step_noise)
        if rows is not None:
            images = self._gather_batch(images, batch_size)
            halves = 1 if neg is None else 2
            feats = {k: tuple(self._gather_batch(x, batch_size, halves) for x in v)
                     for k, v in feats.items()}
        self._keep_background(feats)
        return images, (feats if return_features else None)

    @torch.inference_mode()
    def _sample(self, cond, neg, noise, num_inference_steps: int, guidance_scale: float,
                step_noise=None):
        """The generation loop (the JAX ``_get_sample_fn``'s unrolled
        ``run``) from ``noise``, a standard-normal draw of the latent shape:
        the latents are the noise in the model dtype times
        ``init_noise_sigma``; per timestep scale_model_input, one denoiser
        forward on the conditioning object ``cond`` (with the negative
        ``neg`` before it, classifier-free guidance, unless ``neg`` is
        None) with the taps, the guidance combine (``_combine``) and the
        scheduler's ``step`` (DDPM's with ``step_noise[i]``, a
        standard-normal draw of the latent shape per step); then the VAE
        decode (none in pixel space) mapped to [0, 1].
        Returns (images, {layer: tuple of per-call raw taps}, the final
        latents)."""
        sched = self.scheduler
        state = self._set_timesteps(num_inference_steps)
        do_cfg = neg is not None
        latents = noise.to(self.dtype)
        latents = latents * scalar_like(state.init_noise_sigma, latents)
        if do_cfg:
            cond = cond.cat_negative(neg)
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
            out = cond.forward(self.unet, model_in, float(t), taps)
            taps.pop(ATTN_STORE, None)   # sample() runs no attention store
            for key, val in taps.items():
                merged[key] = merged.get(key, ()) + (val,)
            out = self._combine(out, latents, guidance_scale if do_cfg else None)
            if ddpm:
                latents, step_state = sched.step(step_state, out, t, latents, step_noise[i])
            else:
                latents, step_state = sched.step(step_state, out, t, latents)
        images = latents if self.vae is None else self._decode(latents, None)
        return (images / 2 + 0.5).clamp(0.0, 1.0), merged, latents

    def _combine(self, out, latents, guidance_scale: Optional[float]):
        """The denoiser's output for the scheduler (the JAX ``combine``):
        classifier-free guidance over the [negative; positive] batch unless
        ``guidance_scale`` is None.  A DDPM learned-range output (IF's) keeps
        its variance half, the positive's; any other is cut to the
        latents' channels."""
        sched = self.scheduler
        channels = latents.shape[1]
        if (isinstance(sched, DDPMScheduler) and sched.config.variance_type == 'learned_range'
                and out.shape[1] == 2 * channels):
            pred, var = out.chunk(2, dim=1)
            if guidance_scale is not None:
                uncond, text = pred.chunk(2)
                pred, var = uncond + guidance_scale * (text - uncond), var.chunk(2)[1]
            return torch.cat([pred, var], dim=1)
        out = out[:, :channels]
        if guidance_scale is not None:
            uncond, text = out.chunk(2)
            out = uncond + guidance_scale * (text - uncond)
        return out

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
