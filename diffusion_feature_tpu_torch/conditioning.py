"""The denoiser's conditioning, one class per model family.

Each object holds what one denoiser forward takes besides its latents and
timestep, on the device and already broadcast to the batch.  It is built
from ``FeatureExtractor.encode_prompt``'s output (``from_prompts`` for an
extract, ``for_sample`` for generation, which also gives the negative
that classifier-free guidance needs), checks itself against the model's
spec, concatenates a negative onto itself in [negative; positive] order,
and runs the denoiser (``forward``).  The facade's step, multi-step walk
and sampling loop pass it through without looking inside.

- ``UNetConditioning``: the CLIP context, and SDXL's pooled embedding with
  the ``text_time`` size ids.
- ``PixArtConditioning``: the T5 context and its mask; the DiT's
  learned-sigma half is dropped.
- ``HunyuanConditioning``: BERT's and mT5's contexts with their masks;
  the learned sigma is dropped.
- ``FluxConditioning``: T5's sequence, CLIP-L's pooled vector and the
  guidance scale; the latents are 2x2-packed around the transformer, and
  generation has no CFG batch.
- ``IFConditioning``: DeepFloyd IF's T5 context, no pooled vector and no
  mask into the U-Net; the learned variance half of the output is kept for
  the scheduler.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .models.flux import pack_latents, unpack_latents


def _batch(fe, x, batch_size: int, dtype=None):
    """``x`` (1, ...) on the extractor's device, in ``dtype`` (None keeps
    its own), expanded to ``batch_size``; None stays None."""
    if x is None:
        return None
    x = torch.as_tensor(x).to(fe.device, dtype)
    return x.expand(batch_size, *x.shape[1:])


@dataclasses.dataclass
class _Conditioning:
    """Shared behaviour: tensor fields concatenate in [negative; positive]
    order, every other field is the positive's."""

    def cat_negative(self, neg: '_Conditioning') -> '_Conditioning':
        """This conditioning with ``neg`` before it along the batch (the
        CFG batch)."""
        def cat(a, b):
            return torch.cat([b, a]) if isinstance(a, torch.Tensor) else a
        return dataclasses.replace(self, **{
            f.name: cat(getattr(self, f.name), getattr(neg, f.name))
            for f in dataclasses.fields(self)})

    def rows(self, lo: int, hi: int) -> '_Conditioning':
        """Batch rows [lo, hi) of every tensor field (a dp rank's)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[lo:hi] if isinstance(getattr(self, f.name),
                                                               torch.Tensor)
            else getattr(self, f.name) for f in dataclasses.fields(self)})

    def requires_grad(self) -> bool:
        """Whether a tensor field requires grad (prompt tuning's trainable
        embeddings)."""
        return any(isinstance(v, torch.Tensor) and v.requires_grad
                   for v in (getattr(self, f.name) for f in dataclasses.fields(self)))

    def outside_inference_mode(self) -> '_Conditioning':
        """This conditioning with every tensor that inference mode made
        (``encode_prompt``'s) copied into an ordinary tensor, which autograd
        may save; call it outside inference mode."""
        def plain(x):
            return x.clone() if isinstance(x, torch.Tensor) and x.is_inference() else x
        return dataclasses.replace(self, **{
            f.name: plain(getattr(self, f.name)) for f in dataclasses.fields(self)})

    @classmethod
    def for_sample(cls, fe, prompts, batch_size: int, guidance_scale: float):
        """(positive, negative or None) of ``encode_prompt``'s 4-tuple
        (positive first, negative third), broadcast to ``batch_size``; the
        negative only with classifier-free guidance (``guidance_scale`` >
        1)."""
        pos = cls.from_prompts(fe, prompts, batch_size, sample=True)
        if guidance_scale <= 1.0:
            return pos, None
        return pos, cls.from_prompts(fe, cls.negative(prompts), batch_size, sample=True)


@dataclasses.dataclass
class UNetConditioning(_Conditioning):
    """The U-Net's CLIP context (B, 77k, width); SDXL's pooled embedding
    (B, width) and its ``text_time`` image size."""
    context: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    size: Optional[float] = None

    @classmethod
    def from_prompts(cls, fe, prompts, batch_size: int, sample: bool = False):
        """(pe, ne, pooled, neg_pooled): pe and, for a 'penultimate'-layer
        model (SDXL), the pooled embedding."""
        spec = fe.spec
        pooled = prompts[2] if spec.clip_layer == 'penultimate' else None
        text_time = spec.unet.addition_embed_type == 'text_time'
        cond = cls(_batch(fe, prompts[0], batch_size, fe.dtype),
                   _batch(fe, pooled, batch_size, fe.dtype),
                   float(fe.img_size) if text_time else None)
        cond.check(fe)
        return cond

    @staticmethod
    def negative(prompts):
        """The negative's (pe, ne, pooled, neg_pooled) slots."""
        return prompts[1], None, prompts[3], None

    def check(self, fe):
        """Refuse, before any compute, prompts the U-Net cannot take: a
        context of another width, or no pooled embedding for SDXL's
        micro-conditioning (long prompts are encoded by the first encoder
        alone and carry none).  The JAX facade fails on them inside its
        step."""
        cfg = fe.spec.unet
        if self.context.shape[-1] != cfg.cross_attention_dim:
            raise ValueError(
                f'prompt embeddings are {self.context.shape[-1]} wide, the {fe.version!r} U-Net '
                f'attends to {cfg.cross_attention_dim}-wide context; a prompt of more than 70 '
                'words is encoded by the first text encoder alone')
        if self.size is not None and self.pooled is None:
            raise ValueError(f'the {fe.version!r} U-Net needs the pooled prompt embedding '
                             '(text_time micro-conditioning), and these prompts carry none')

    def added(self):
        """SDXL text_time micro-conditioning: time ids [h, w, 0, 0, h, w]
        (reference diffusion_feature.py:534); None without it."""
        if self.size is None:
            return None
        s = self.size
        time_ids = torch.tensor([[s, s, 0.0, 0.0, s, s]], dtype=self.context.dtype,
                                device=self.context.device).repeat(self.context.shape[0], 1)
        return {'text_embeds': self.pooled, 'time_ids': time_ids}

    def control_residuals(self, pipe, model_in, timestep, control):
        """The ControlNets' summed residuals (down, mid) for this forward."""
        return pipe.encode_all(model_in, timestep, self.context, control, self.added())

    def forward(self, denoiser, model_in, timestep, feats=None, down=None, mid=None, **kw):
        """The U-Net with a ControlNet's residuals ``down``/``mid``;
        ``kw`` (``plain=True``) goes to the U-Net."""
        return denoiser(model_in, timestep, self.context, self.added(), feats=feats,
                        down_block_additional_residuals=down, mid_block_additional_residual=mid,
                        **kw)


@dataclasses.dataclass
class PixArtConditioning(_Conditioning):
    """PixArt's T5 context (B, L, 4096) and its attention mask (B, L)."""
    context: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def from_prompts(cls, fe, prompts, batch_size: int, sample: bool = False):
        """(pe, mask, ne, nmask): the positive embeddings and mask (int32
        in generation, as the JAX facade casts them)."""
        cond = cls(_batch(fe, prompts[0], batch_size, fe.dtype),
                   _batch(fe, prompts[1], batch_size, torch.int32 if sample else None))
        width = fe.spec.dit.caption_channels
        if cond.context.shape[-1] != width:
            raise ValueError(f'prompt embeddings are {cond.context.shape[-1]} wide, the '
                             f'{fe.version!r} DiT takes {width}-wide T5 embeddings')
        return cond

    @staticmethod
    def negative(prompts):
        """The negative's (pe, mask) slots."""
        return prompts[2], prompts[3]

    def forward(self, denoiser, model_in, timestep, feats=None, down=None, mid=None):
        """The DiT with the T5 mask; its learned-sigma half dropped, as
        the JAX facade drops it before the scheduler (diffusers'
        contract)."""
        return denoiser(model_in, timestep, self.context, self.mask,
                        feats=feats)[:, :model_in.shape[1]]


@dataclasses.dataclass
class HunyuanConditioning(_Conditioning):
    """HunyuanDiT's BERT context (B, 77, 1024) and mask, and its mT5
    context (B, 256, 2048) and mask."""
    context: torch.Tensor
    mask: torch.Tensor
    t5: torch.Tensor
    t5_mask: torch.Tensor

    @classmethod
    def from_prompts(cls, fe, prompts, batch_size: int, sample: bool = False):
        """``encode_prompt``'s ((BERT embeddings, mask), (T5 embeddings,
        mask)), or a raw string, encoded here."""
        if isinstance(prompts, str):
            prompts = fe.encode_prompt(prompts)
        (pe, bmask), (t5, tmask) = prompts
        mask_dtype = torch.int32 if sample else None
        cond = cls(_batch(fe, pe, batch_size, fe.dtype), _batch(fe, bmask, batch_size, mask_dtype),
                   _batch(fe, t5, batch_size, fe.dtype), _batch(fe, tmask, batch_size, mask_dtype))
        cfg = fe.spec.dit
        for name, x, width in (('BERT', cond.context, cfg.cross_attention_dim),
                               ('T5', cond.t5, cfg.cross_attention_dim_t5)):
            if x.shape[-1] != width:
                raise ValueError(f'the {fe.version!r} DiT takes {width}-wide {name} '
                                 f'embeddings, got {x.shape[-1]}')
        return cond

    @classmethod
    def for_sample(cls, fe, prompts, batch_size: int, guidance_scale: float):
        """A raw string (the negative '' is encoded for CFG), one
        ``encode_prompt`` result or a (positive, negative) pair of them,
        resolved as the JAX facade resolves them; the negative is None
        without CFG."""
        do_cfg = guidance_scale > 1.0
        if isinstance(prompts, str):
            pos, neg = prompts, ('' if do_cfg else None)
        elif isinstance(prompts[0][0], (tuple, list)):
            pos, neg = prompts[0], (prompts[1] if do_cfg else None)
        else:
            pos, neg = prompts, None
            if do_cfg:
                if not fe.text_encoders:
                    raise ValueError(
                        'hunyuan sample() with guidance_scale > 1 needs a negative encoding: '
                        'pass a raw prompt string, a (positive, negative) pair of '
                        'encode_prompt() results, or keep the text encoders loaded so the '
                        'empty negative prompt can be encoded here')
                neg = ''
        return (cls.from_prompts(fe, pos, batch_size, sample=True),
                None if neg is None else cls.from_prompts(fe, neg, batch_size, sample=True))

    def forward(self, denoiser, model_in, timestep, feats=None, down=None, mid=None):
        """The DiT on both streams and masks; the learned sigma dropped."""
        return denoiser(model_in, timestep, self.context, self.mask, self.t5, self.t5_mask,
                        feats=feats)[:, :model_in.shape[1]]


@dataclasses.dataclass
class FluxConditioning(_Conditioning):
    """Flux's T5 sequence (B, L, 4096), CLIP-L pooled vector (B, 768) and
    the guidance embedding's value (None: 1000, as in the JAX package)."""
    context: torch.Tensor
    pooled: torch.Tensor
    guidance: Optional[float] = None

    @classmethod
    def from_prompts(cls, fe, prompts, batch_size: int, sample: bool = False):
        """``encode_prompt``'s (T5 embeddings, None, CLIP pooled, None), or
        a raw string, encoded here."""
        if isinstance(prompts, str):
            prompts = fe.encode_prompt(prompts)
        cond = cls(_batch(fe, prompts[0], batch_size, fe.dtype),
                   _batch(fe, prompts[2], batch_size, fe.dtype))
        cfg = fe.spec.dit
        for name, x, width in (('T5', cond.context, cfg.joint_attention_dim),
                               ('pooled CLIP', cond.pooled, cfg.pooled_projection_dim)):
            if x is None or x.shape[-1] != width:
                raise ValueError(f'the {fe.version!r} transformer takes {width}-wide {name} '
                                 f'embeddings, got {None if x is None else x.shape[-1]}')
        return cond

    @classmethod
    def for_sample(cls, fe, prompts, batch_size: int, guidance_scale: float):
        """Flux.1-dev is guidance-distilled: no negative and no CFG batch;
        ``guidance_scale`` * 1000 feeds the guidance embedding (the stock
        FluxPipeline)."""
        cond = cls.from_prompts(fe, prompts, batch_size, sample=True)
        return dataclasses.replace(cond, guidance=guidance_scale * 1000.0), None

    def forward(self, denoiser, model_in, timestep, feats=None, down=None, mid=None):
        """The transformer on the 2x2-packed latents NCHW; the prediction
        unpacked to NCHW (the flow step is elementwise, so it commutes
        with the packing)."""
        _, _, h, w = model_in.shape
        out = denoiser(pack_latents(model_in), timestep, self.context, self.pooled,
                       self.guidance, (h // 2, w // 2), feats=feats)
        return unpack_latents(out, h, w)


@dataclasses.dataclass
class IFConditioning(_Conditioning):
    """DeepFloyd IF's T5 context (B, L, 4096).  The T5 mask stays with the
    encoder: the U-Net takes none (the JAX facade's IF path)."""
    context: torch.Tensor

    @classmethod
    def from_prompts(cls, fe, prompts, batch_size: int, sample: bool = False):
        """``encode_prompt``'s (pe, ne, None, None): the positive T5
        embeddings."""
        cond = cls(_batch(fe, prompts[0], batch_size, fe.dtype))
        width = fe.spec.unet.encoder_hid_dim
        if cond.context.shape[-1] != width:
            raise ValueError(f'prompt embeddings are {cond.context.shape[-1]} wide, the '
                             f'{fe.version!r} U-Net takes {width}-wide T5 embeddings')
        return cond

    @staticmethod
    def negative(prompts):
        """The negative's slot first, as ``from_prompts`` reads it."""
        return prompts[1], None, None, None

    def forward(self, denoiser, model_in, timestep, feats=None, down=None, mid=None):
        """The U-Net on the pixels: the noise prediction and the learned
        variance (6 channels), both of which DDPM's step takes."""
        return denoiser(model_in, timestep, self.context, feats=feats)


#: The conditioning class of each model family.
BY_FAMILY = {'unet': UNetConditioning, 'pixart': PixArtConditioning,
             'hunyuan': HunyuanConditioning, 'flux': FluxConditioning, 'if': IFConditioning}
