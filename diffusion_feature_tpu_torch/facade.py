"""FeatureExtractor for the U-Net family in PyTorch (port of
``diffusion_feature_tpu/facade.py``), mirroring the reference's
``diffusion_feature.FeatureExtractor`` (feature/diffusion_feature.py:26-517).

Ported: extraction for SD-1.5 (``'1-5'``, ``'test-sd'``), SD-2.1 (``'2-1'``),
SDXL (``'xl'``, ``'test-xl'``) and Playground v2 (``'pgv2'``): CLIP tokenize
-> the text encoders (long prompts in chunks) -> image preprocess -> VAE
encode + posterior sample -> add_noise at the img2img timestep of ``t``
(Euler, or PNDM for SD-1.5) -> scale_model_input -> one U-Net forward with
the requested taps -> store post-processing; or, with ``denoising_from``, a
scheduler walk down to ``t`` first, and with ``use_ddim_inversion`` a DDIM
inversion in place of the noise.  The attention store (``attention=``) gives
the aggregated ``'attn'`` feature, the ``'vae-out'`` layer the decoded image
of one scheduler step; ``extract_ensemble`` crosses timesteps with prompts.
Weights come from a local diffusers checkpoint (``weights=``,
``weights_variant=``) or at random from ``seed``, with offline LoRA merging.
What is not ported raises ``NotImplementedError`` naming its ROADMAP.md item.
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
from .models.clip_text import CLIPTextConfig, CLIPTextModel
from .models.convert import (load_component_config, load_component_state, load_state_into,
                             save_component)
from .models.layers import ATTN_STORE
from .models.lora import apply_lora_to_module
from .models.registry import ModelSpec, get_model_spec
from .models.unet2d import UNet2DConditionModel, UNetConfig
from .models.vae import AutoencoderKL, VAEConfig
from .roadmap import not_ported
from .schedulers.diffusion import EulerDiscreteScheduler, make_scheduler, scalar_like
from .store import aggregate_attention, postprocess_taps
from .taps import TapSpec, declared_ids, is_filtered_id
from .tokenizers.clip_bpe import load_clip_tokenizer
from .utils.prompt import encode_long_prompt

_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16, 'float32': torch.float32}
TEXT_DIRS = ('text_encoder', 'text_encoder_2')


def _random_module(make, device, dtype, generator):
    """Build ``make()`` on the meta device, then materialise it on ``device``
    with a deterministic random init drawn from ``generator``: weights of
    rank >= 2 ~ N(0, 1/fan_in), norm scales 1, biases 0."""
    with torch.device('meta'):
        module = make()
    module = module.to(dtype=dtype).to_empty(device=device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
            elif name.endswith('weight'):
                p.fill_(1.0)
            else:
                p.zero_()
    return module.eval().requires_grad_(False)


def _adapt_spec_to_checkpoint(spec: ModelSpec, weights: str) -> ModelSpec:
    """Rebuild the U-Net, VAE and text-encoder configs from the checkpoint's
    own config.json files where present (JAX ``_adapt_spec_to_checkpoint``,
    U-Net family), so fine-tunes that deviate from the presets load exactly.
    An unreadable config keeps the preset, as there; a field the port cannot
    honour raises."""
    updates = {}

    def has(component):
        return os.path.exists(os.path.join(weights, component, 'config.json'))

    try:
        if has('unet'):
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
    """``encode_prompt``, ``offload_prompt_encoder``, ``preprocess_image``
    and ``extract`` with the JAX facade's signatures and return values.

    weights: a local diffusers checkpoint dir (``unet``, ``vae``,
    ``text_encoder``[``_2``], each a config.json and safetensors or ``.bin``
    files; ``tokenizer``[``_2``] when present).  The architecture follows
    its config.json files, and each module is filled straight from the
    files, with no random init.  weights_variant: the weight set to load
    ('fp16', 'bf16', ..., 'main'), falling back per component to the
    un-suffixed set.  Without weights, models initialise at random from
    ``seed``.  offline_lora (with offline_lora_filename): a LoRA merged
    into the U-Net after its weights.  The noise of ``extract`` has its own
    generator, seeded from ``seed``, so it does not depend on where the
    weights came from.
    attention: attention-store categories ('{down|mid|up}_{self|cross}');
    their head-mean maps of the size band ``attn_store_sizes`` (tokens per
    side, default (img_size/32, img_size/16)) come back as ``feats['attn']``.
    """

    def __init__(self, layer, version: str, device='cuda', dtype: str = 'bfloat16',
                 img_size: int = 1024, offline_lora: Optional[str] = None,
                 offline_lora_filename: Optional[str] = None,
                 feature_resize: int = 1, control=None,
                 attention: Optional[Sequence[str]] = None,
                 weights: Optional[str] = None, weights_variant: Optional[str] = None,
                 seed: int = 0, attn_store_sizes: Optional[Tuple[int, int]] = None,
                 validate_layers: bool = True):
        if control:
            raise not_ported('control= (ControlNet)', 'ControlNet and depth')
        if weights and os.path.isfile(os.path.join(weights, 'tpu_bundle.json')):
            raise ValueError(f'{weights} is a deployment bundle of the JAX package; the port '
                             'loads the diffusers checkpoint dir it was exported from instead')
        self.spec: ModelSpec = get_model_spec(version)
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
            self._attn_sizes = (tuple(attn_store_sizes) if attn_store_sizes is not None
                                else (img_size // 32, img_size // 16))
        self.scheduler = make_scheduler(self.spec.scheduler, self.spec.scheduler_config)
        self.vae_scale = 2 ** (len(self.spec.vae.block_out_channels) - 1)
        # the extract's noise and the random init draw from generators of
        # their own (the JAX facade's _rng and init key)
        self._noise_gen = torch.Generator(device=self.device).manual_seed(seed)
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        #: {component: (bytes, seconds)} of the checkpoint load
        self.load_stats: Dict[str, Tuple[int, float]] = {}

        spec = self.spec

        def build(make, component):
            if weights:
                return self._load_component(make, weights, weights_variant, component)
            return _random_module(make, self.device, self.dtype, init_gen)

        self.unet = build(lambda: UNet2DConditionModel(spec.unet, self.taps, self._attn_sizes,
                                                       tuple(self.attention or ())), 'unet')
        self.vae = build(lambda: AutoencoderKL(spec.vae), 'vae')
        self.text_encoders = tuple(build(lambda c=c: CLIPTextModel(c), d)
                                   for c, d in zip(spec.text_encoders, TEXT_DIRS))
        tok_dirs = [os.path.join(weights, d) if weights else None
                    for d in ('tokenizer', 'tokenizer_2')]
        # tokenizer_2 (OpenCLIP) pads with id 0; the first pads with EOS
        self.tokenizers = tuple(
            load_clip_tokenizer(d if d and os.path.isdir(d) else None, vocab_size=c.vocab_size,
                                pad_with_eos=(i == 0))
            for i, (d, c) in enumerate(zip(tok_dirs, spec.text_encoders)))
        if offline_lora:
            apply_lora_to_module(self.unet, offline_lora, offline_lora_filename)
        if validate_layers and not self.taps.accept_all:
            self._validate_layer_ids()

    def _load_component(self, make, root: str, variant: Optional[str], component: str):
        """Build ``make()`` on the meta device and fill it from the
        checkpoint's ``component`` dir: parameters are allocated once, at
        the compute dtype, and never initialised at random."""
        with torch.device('meta'):
            module = make()
        t0 = time.perf_counter()
        state = load_component_state(root, component, variant=variant)
        unused = set(load_state_into(module, state, self.dtype, self.device))
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        nbytes = sum(t.numel() * t.element_size() for k, t in state.items() if k not in unused)
        self.load_stats[component] = (nbytes, time.perf_counter() - t0)
        return module.eval().requires_grad_(False)

    def save_weights(self, root: str, variant: Optional[str] = None,
                     unet_shards: int = 1) -> Dict[str, Tuple[int, float]]:
        """Write the U-Net, the VAE and the text encoders as a diffusers
        checkpoint dir that ``weights=`` loads: a config.json and
        safetensors files per component, named with ``variant`` and the
        U-Net in ``unet_shards`` files.  Returns
        {component: (bytes written, seconds)}, as ``load_stats``."""
        comps = [('unet', self.unet, self.spec.unet), ('vae', self.vae, self.spec.vae),
                 *zip(TEXT_DIRS, self.text_encoders, self.spec.text_encoders)]
        stats = {}
        for comp, module, cfg in comps:
            t0 = time.perf_counter()
            files = save_component(root, comp, module.state_dict(), cfg.to_diffusers_config(),
                                   variant, unet_shards if comp == 'unet' else 1)
            stats[comp] = (sum(files.values()), time.perf_counter() - t0)
        return stats

    def _validate_layer_ids(self):
        """Fail fast on ids the U-Net does not declare, with near-miss
        suggestions (the reference silently drops unknown ids)."""
        known = declared_ids(self.unet)
        # 'attn' is assembled only when attention categories were requested
        pseudo = {'vae-out', 'attn'} if self.attention else {'vae-out'}
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
        the pooled entries are None for a 'final'-layer model (SD-1.5)."""
        if (prompt_str is None) == (prompt_file is None):
            raise ValueError('pass exactly one of prompt_str and prompt_file')
        if prompt_file:
            with open(prompt_file) as f:
                prompt_str = f.read()
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
        DDIM up to ``t`` in place of adding noise.  ``use_control`` has no
        effect without a ControlNet, as in the JAX facade."""
        spec = self.spec
        if use_ddim_inversion and (spec.unet.addition_embed_type is not None
                                   or spec.scheduler_config.prediction_type != 'epsilon'):
            # the reference runs DDIM inversion on the epsilon SD U-Nets only
            raise NotImplementedError(
                'use_ddim_inversion supports the epsilon-prediction SD '
                "U-Net families ('1-5'/'2-1'), as in the reference")
        pe = torch.as_tensor(prompts[0]).to(self.device, self.dtype)
        pooled = prompts[2] if spec.clip_layer == 'penultimate' else None
        self._check_conditioning(pe, pooled)
        pe = pe.expand(batch_size, *pe.shape[1:])
        if pooled is not None:
            pooled = torch.as_tensor(pooled).to(self.device, self.dtype)
            pooled = pooled.expand(batch_size, *pooled.shape[1:])
        if image_type == 'image':
            img = preprocess_pil_batch(image, self.img_size)
        else:
            img = resize_tensor_batch(image, self.img_size)
        img = torch.as_tensor(img).to(self.device, self.dtype)

        lat = self.img_size // self.vae_scale
        shape = (img.shape[0], self.spec.vae.latent_channels, lat, lat)
        # drawn in fp32 and cast inside the step (JAX utils.normal_like)
        posterior_noise = torch.randn(shape, generator=self._noise_gen, device=self.device)
        noise = torch.randn(shape, generator=self._noise_gen, device=self.device)
        if denoising_from is None and not use_ddim_inversion:
            return self._step(img, pe, pooled, self._img2img_kit(int(t)), posterior_noise, noise,
                              self.feature_dtype)
        return self._multistep(img, pe, pooled, int(t), denoising_from, use_ddim_inversion,
                               posterior_noise, noise, self.feature_dtype)

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

    def _check_conditioning(self, pe, pooled):
        """Refuse, before any compute, prompts the U-Net cannot take: a
        context of another width, or no pooled embedding for SDXL's
        micro-conditioning (long prompts are encoded by the first encoder
        alone and carry none).  The JAX facade fails on them inside its
        step."""
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
        """The Euler and PNDM branches of the JAX facade's ``_img2img_kit``:
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

    def _added_cond(self, pooled, bsz: int):
        """SDXL text_time micro-conditioning: time ids [h, w, 0, 0, h, w]
        (reference diffusion_feature.py:534); None for a U-Net without it."""
        if self.spec.unet.addition_embed_type != 'text_time':
            return None
        s = float(self.img_size)
        time_ids = torch.tensor([[s, s, 0.0, 0.0, s, s]], dtype=self.dtype,
                                device=self.device).repeat(bsz, 1)
        return {'text_embeds': pooled, 'time_ids': time_ids}

    def _forward(self, lat_in, timestep, pe, pooled, out_dtype):
        """The U-Net forward with taps and store, then the store
        post-processing (the JAX ``_collect_feats``): returns (model output,
        features)."""
        feats = {}
        out = self.unet(lat_in, timestep, pe, self._added_cond(pooled, lat_in.shape[0]),
                        feats=feats)
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
    def _step(self, img, pe, pooled, kit, posterior_noise, noise, out_dtype):
        """The single step (the JAX ``_get_step_fn_generic`` program): VAE
        encode + posterior sample -> latents*A + noise*B -> /S -> U-Net with
        taps -> store post-processing to ``out_dtype`` (None keeps the
        compute dtype), and 'vae-out' from the kit's fresh-state step.
        Noise tensors are standard-normal draws of the latent shape, cast
        here to the model dtype."""
        latents = self.vae(img, posterior_noise)
        latents = (scalar_like(kit['A'], latents) * latents
                   + scalar_like(kit['B'], latents) * noise.to(latents.dtype))
        out, feats = self._forward(latents / scalar_like(kit['S'], latents), kit['T'], pe, pooled,
                                   out_dtype)
        if self.store_vae_output:
            x0 = scalar_like(kit['X1'], latents) * latents + scalar_like(kit['X2'], latents) * out
            lat2 = (scalar_like(kit['C1'], latents) * x0
                    + scalar_like(kit['C2'], latents) * latents
                    + scalar_like(kit['C3'], latents) * out)
            feats['vae-out'] = self._decode(lat2, out_dtype)
        return feats

    @torch.inference_mode()
    def _multistep(self, img, pe, pooled, t: int, denoising_from: Optional[int],
                   use_ddim_inversion: bool, posterior_noise, noise, out_dtype):
        """The multi-step paths (the JAX ``_get_step_fn``).  Timesteps: with
        ``denoising_from`` within 50 of ``t`` the 1000-step schedule from
        ``denoising_from``, else the 100-step one at strength
        ``denoising_from / 100`` (JAX's quirk: t=50, denoising_from=200
        starts at 991), cut at the last timestep >= ``t``.  The latents are
        noised at the first (or DDIM-inverted up to ``t``), walked through
        ``sched.step`` over all but the last with forwards whose taps and
        store maps are discarded, then the last forward keeps them.
        'vae-out' decodes one step of the fresh schedule from there."""
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
            out = self.unet(sched.scale_model_input(state, latents, ts), float(ts), pe, added)
            latents, walk_state = sched.step(walk_state, out, ts, latents)
        out, feats = self._forward(sched.scale_model_input(state, latents, t), float(t), pe,
                                   pooled, out_dtype)
        if self.store_vae_output:
            lat2, _ = sched.step(state, out, t, latents)
            feats['vae-out'] = self._decode(lat2, out_dtype)
        return feats
