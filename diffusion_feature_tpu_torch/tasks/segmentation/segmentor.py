"""DiffusionSegmentor: diffusion features -> adapters -> UPerNet (port of
``diffusion_feature_tpu/tasks/segmentation/segmentor.py``).

Reference: segmentation/models/diffusion_segmentor.py (an mmseg
BaseSegmentor).  The trainable state is the ``SegHead`` module (per-layer
ResBlock adapters, per-level sum adapters, UPerHead, FCNHead) and, with
prompt tuning, the prompt embeddings that replace the encoded ones
(``meta_prompt``, ``meta_pooled``); the extractor is frozen, or with its
config's ``train_unet`` returns live fp32 features.

Semantics kept from the JAX package:
  - a random t from the configured list in training, the first at test
    (:212-217); random control on or off likewise (:218-223), both from
    ``random.Random(seed)``;
  - adapters in fp32 whatever the extraction dtype;
  - per-level channel concat, then a sum ResBlock; the multi-model
    "Ours-XL-t" wiring with weight-shared MultiRes blocks and an
    ``amalgamated{level}`` ResBlock over the cross-model concat;
  - prompt tuning replaces the prompt embeddings with trainable tensors,
    and the gradient flows through the extraction step (``extract`` runs
    with autograd when a conditioning tensor requires grad);
  - sliding-window inference with logit accumulation (:421-472);
  - ``mesh`` (dp, the JAX trainer's one program over the global batch):
    each rank extracts and heads its rows, with the whole batch's noise,
    BatchNorm statistics and dropout masks, and the loss is taken over the
    gathered logits and labels, so it is the whole batch's on every rank.
"""

from __future__ import annotations

import random
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...facade import FeatureExtractor
from ...ops.resize import resize_bilinear_nchw
from ...parallel.mesh import gather_with_grad
from .heads import FCNHead, ResBlockAdapter, UPerHead, init_like_flax, set_data_parallel
from .losses import segmentation_loss


def _san(layer_id: str) -> str:
    return layer_id.replace('-', '_')


class SegHead(nn.Module):
    """Adapters + decode/aux heads as one module (the Flax ``SegHead``,
    its child names kept).

    ``model_feature_layers``: per model, per level, a tuple of
    (layer_id, channels).  Feature keys are the layer ids for one model and
    ``m{i}:{layer_id}`` for an ensemble, whose adapters and sum blocks are
    per model (suffix ``_m{i}``), each applied 4 times (a layer's) or twice
    (a sum block), weights shared (reference MultiRes,
    diffusion_segmentor.py:43-51, :177-180), then an ``amalgamated{level}``
    ResBlock over the models' concat."""

    def __init__(self, model_feature_layers, num_classes: int = 150, head_channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2), aux_in_index: int = -1,
                 dropout_ratio: float = 0.1):
        super().__init__()
        self.model_feature_layers = tuple(
            tuple(tuple((lid, int(ch)) for lid, ch in lvl) for lvl in fl)
            for fl in model_feature_layers)
        self.num_classes = num_classes
        self.aux_in_index = aux_in_index
        n_models = len(self.model_feature_layers)
        self.n_levels = max(len(fl) for fl in self.model_feature_layers)
        for mi, fl in enumerate(self.model_feature_layers):
            suffix = '' if n_models == 1 else f'_m{mi}'
            for level, res_level in enumerate(fl):
                if not res_level:
                    continue
                for lid, ch in res_level:
                    self.add_module(f'adapter{suffix}_{_san(lid)}', ResBlockAdapter(ch))
                self.add_module(f'sum{level}{suffix}',
                                ResBlockAdapter(sum(ch for _, ch in res_level)))
        in_channels = tuple(
            sum(c for fl in self.model_feature_layers
                for _, c in (fl[lvl] if lvl < len(fl) else ()))
            for lvl in range(self.n_levels))
        if n_models > 1:
            for level, ch in enumerate(in_channels):
                self.add_module(f'amalgamated{level}', ResBlockAdapter(ch))
        self.decode_head = UPerHead(in_channels, head_channels, pool_scales, num_classes,
                                    dropout_ratio)
        self.auxiliary_head = FCNHead(in_channels[aux_in_index], head_channels,
                                      num_classes=num_classes, dropout_ratio=dropout_ratio)
        #: the dp axis whose ranks hold the batch's rows (``set_data_parallel``)
        self.dp = None

    def forward(self, features: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None):
        """{key: (B, C, h, w)} -> (decode logits, aux logits), each at its
        level's resolution.  ``generator`` draws the decode head's dropout,
        then the aux head's; None drops nothing."""
        n_models = len(self.model_feature_layers)
        per_level: List[List[torch.Tensor]] = [[] for _ in range(self.n_levels)]
        for mi, fl in enumerate(self.model_feature_layers):
            suffix = '' if n_models == 1 else f'_m{mi}'
            n_layer_apps, n_sum_apps = (1, 1) if n_models == 1 else (4, 2)
            for level, res_level in enumerate(fl):
                if not res_level:
                    continue
                per = []
                for lid, _ in res_level:
                    f = features[lid if n_models == 1 else f'm{mi}:{lid}'].float()
                    blk = getattr(self, f'adapter{suffix}_{_san(lid)}')
                    for _ in range(n_layer_apps):
                        f = blk(f, train)
                    per.append(f)
                x = torch.cat(per, dim=1)
                sum_blk = getattr(self, f'sum{level}{suffix}')
                for _ in range(n_sum_apps):
                    x = sum_blk(x, train)
                per_level[level].append(x)
        outs = []
        for level, feats in enumerate(per_level):
            x = torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]
            if n_models > 1:
                x = getattr(self, f'amalgamated{level}')(x, train)
            outs.append(x)
        decode = self.decode_head(outs, train, generator)
        aux = self.auxiliary_head(outs[self.aux_in_index], train, generator)
        return decode, aux


def seg_head_from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """The port's ``SegHead`` state_dict of the JAX head's numpy trees:
    ``params`` (Flax names; conv kernels HWIO -> OIHW ``weight``, BN
    ``scale`` -> ``weight``, ``bias`` as it is) and ``batch_stats`` (BN
    ``mean``/``var`` -> ``running_mean``/``running_var``)."""
    state = {}

    def walk(tree, prefix, leaf_map):
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, prefix + (name,), leaf_map)
            else:
                arr = np.asarray(sub)
                key, arr = leaf_map(name, arr)
                state['.'.join(prefix + (key,))] = torch.from_numpy(np.array(arr))

    def param_leaf(name, arr):
        if name == 'kernel':
            return 'weight', arr.transpose(3, 2, 0, 1)
        return {'scale': 'weight'}.get(name, name), arr

    walk(dict(params), (), param_leaf)
    if batch_stats:
        walk(dict(batch_stats), (),
             lambda name, arr: ({'mean': 'running_mean', 'var': 'running_var'}[name], arr))
    return state


def _frozen(x: torch.Tensor) -> torch.Tensor:
    """A feature without gradient that autograd may save: an inference-mode
    tensor (a frozen extract's) is copied into an ordinary one."""
    return x.clone() if x.is_inference() else x.detach()


def _as_labels(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)


class DiffusionSegmentor:
    """Diffusion extractor(s) + a trainable ``SegHead`` (the JAX
    ``DiffusionSegmentor``).

    ``diffusion_feature``: a config dict (``layer``, ``version``,
    ``attention``, ``img_size``, ``t``, optional ``train_unet``, ``dtype``,
    ``control`` as [kind, n], ``offline_lora``) or a list of them (the
    ensemble, with ``feature_layers`` per model).  Each extractor runs in
    float32 under prompt tuning or ``train_unet``, else bf16, unless the
    config names a dtype; its prompt is encoded once and the text encoders
    dropped (``offload_prompt_encoder(persistent=True)``).  The head lives
    on ``device`` and initialises from ``seed`` (``init_state``).
    ``mesh``: a dp ``parallel.mesh.Mesh`` (the module docstring); ``loss``
    then takes this rank's rows of a batch whose rows every rank holds
    equally many of."""

    def __init__(self, diffusion_feature, feature_layers, num_classes: int = 150,
                 head_channels: int = 512, pool_scales=(1, 2),
                 aux_in_index: Optional[int] = None, prompt: str = '',
                 prompt_tuning: bool = False, weights=None, seed: int = 0, device='cuda',
                 mesh=None):
        self.multi = isinstance(diffusion_feature, (list, tuple))
        if prompt_tuning and self.multi:
            raise NotImplementedError('prompt tuning with the multi-model ensemble is not '
                                      'supported (nor used by the reference configs)')
        df_list = list(diffusion_feature) if self.multi else [diffusion_feature]
        mfl = feature_layers if self.multi else [feature_layers]
        self.device = torch.device(device)

        def build(df):
            control = df.get('control')
            train_unet = df.get('train_unet', False)
            fe = FeatureExtractor(
                layer=df['layer'], version=df['version'], attention=df.get('attention'),
                img_size=df['img_size'], train_unet=train_unet,
                dtype=df.get('dtype', 'float32' if prompt_tuning or train_unet
                             else 'bfloat16'),
                control=control[0] if control else None, offline_lora=df.get('offline_lora'),
                weights=weights, device=device, mesh=mesh)
            choices = None
            if control:
                n = control[1] if len(control) > 1 else 0
                choices = ([True] * n + [False]) if n > 0 else [True]
            pe = fe.encode_prompt(prompt)
            fe.offload_prompt_encoder(persistent=True)
            return {'model': fe, 'prompt_embeds': pe, 't': df['t'], 'control_choices': choices}

        self.extractors = [build(df) for df in df_list]
        self.extractor = self.extractors[0]['model']
        self.prompt_embeds = self.extractors[0]['prompt_embeds']
        self.t = self.extractors[0]['t']
        self.use_control_choices = self.extractors[0]['control_choices']
        self.prompt_tuning = prompt_tuning
        n_levels = max(len(fl) for fl in mfl)
        if aux_in_index is None:
            # the reference configs pin the aux head to level 1 (ade_sdxl.py:38)
            aux_in_index = min(1, n_levels - 1)
        self.head = SegHead(mfl, num_classes=num_classes, head_channels=head_channels,
                            pool_scales=tuple(pool_scales),
                            aux_in_index=aux_in_index).to(self.device)
        #: the dp axis whose ranks hold the training batch's rows, or None
        self.dp = mesh.axis('dp') if mesh is not None and mesh.dp > 1 else None
        set_data_parallel(self.head, self.dp)
        self.meta_prompt: Optional[nn.Parameter] = None
        self.meta_pooled: Optional[nn.Parameter] = None
        self._seed = seed
        self._rng = random.Random(seed)

    # ------------------------------------------------------------------ state
    def init_state(self, seed: Optional[int] = None) -> Dict[str, nn.Parameter]:
        """Initialise the head (Flax's default inits from a generator seeded
        with ``seed``, default the segmentor's; zero adapters; fresh BN
        statistics) and, with prompt tuning, ``meta_prompt``/``meta_pooled``:
        standard normal draws of the encoded embeddings' shapes (the
        reference's torch.randn, not a copy), fp32.  Returns
        ``trainable()``."""
        gen = torch.Generator(device=self.device).manual_seed(
            self._seed if seed is None else seed)
        init_like_flax(self.head, gen)
        if self.prompt_tuning:
            pe = self.prompt_embeds
            self.meta_prompt = nn.Parameter(torch.randn(
                tuple(pe[0].shape), generator=gen, device=self.device))
            if pe[2] is not None:
                self.meta_pooled = nn.Parameter(torch.randn(
                    tuple(pe[2].shape), generator=gen, device=self.device))
        return self.trainable()

    def trainable(self) -> Dict[str, nn.Parameter]:
        """{name: parameter} the optimiser steps: the head's (``head.*``)
        and, with prompt tuning, ``meta_prompt`` (and ``meta_pooled``)."""
        out = {f'head.{k}': p for k, p in self.head.named_parameters()}
        for name in ('meta_prompt', 'meta_pooled'):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The head's state (parameters and BN statistics, ``head.*``) and
        the meta prompt, for a checkpoint."""
        out = {f'head.{k}': v.detach().clone() for k, v in self.head.state_dict().items()}
        for name in ('meta_prompt', 'meta_pooled'):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name).detach().clone()
        return out

    def load_state_dict(self, state: Dict[str, torch.Tensor]):
        self.head.load_state_dict({k[5:]: v for k, v in state.items() if k.startswith('head.')})
        with torch.no_grad():
            for name in ('meta_prompt', 'meta_pooled'):
                if name in state:
                    if getattr(self, name) is None:
                        setattr(self, name, nn.Parameter(state[name].to(self.device).clone()))
                    else:
                        getattr(self, name).copy_(state[name])

    def reseed_noise(self, seed: int):
        """Restart every extractor's noise generator from ``seed`` (the
        trainer's evaluation does, so a checkpoint scores the same in any
        process)."""
        for ex in self.extractors:
            ex['model']._noise_gen.manual_seed(seed)

    # --------------------------------------------------------------- features
    def _pick_t(self, is_test: bool) -> int:
        if isinstance(self.t, (list, tuple)):
            return self.t[0] if is_test else self._rng.choice(self.t)
        return self.t

    def _pick_control(self, is_test: bool) -> bool:
        if self.use_control_choices is None:
            return False
        return True if is_test else self._rng.choice(self.use_control_choices)

    def extract_features(self, images: torch.Tensor,
                         is_test: bool = False) -> Dict[str, torch.Tensor]:
        """images (B, 3, H, W) in [-1, 1] -> {layer: (B, C, h, w)}.  The
        features are detached unless prompt tuning (or the extractor's
        ``train_unet``) carries gradients through them; with prompt tuning
        ``meta_prompt`` (and ``meta_pooled``) replace the encoded
        embeddings.  An ensemble extracts model by model, keys
        ``m{i}:{layer}``.  Under dp, in training, ``images`` are this
        rank's rows of the batch."""
        images = images.to(self.device)
        batch = images.shape[0]
        if self.dp is not None and not is_test:
            batch *= self.dp.size

        def extract(fe, prompts, t, use_control=False):
            kw = dict(image_type='tensors', t=t, use_control=use_control)
            if self.dp is not None and not is_test:
                return fe.extract_rows(prompts, batch, images, **kw)
            return fe.extract(prompts, batch, images, **kw)
        if self.multi:
            out = {}
            for mi, ex in enumerate(self.extractors):
                t = ex['t']
                if isinstance(t, (list, tuple)):
                    t = t[0] if is_test else self._rng.choice(t)
                feats = extract(ex['model'], ex['prompt_embeds'], t)
                out.update({f'm{mi}:{k}': _frozen(v) for k, v in feats.items()})
            return out
        prompts = self.prompt_embeds
        if self.prompt_tuning and self.meta_prompt is not None:
            pe = list(prompts)
            pe[0] = self.meta_prompt
            if self.meta_pooled is not None:
                pe[2] = self.meta_pooled
            prompts = tuple(pe)
        feats = extract(self.extractor, prompts, self._pick_t(is_test),
                        self._pick_control(is_test))
        if not (self.prompt_tuning or self.extractor.train_unet):
            feats = {k: _frozen(v) for k, v in feats.items()}
        return feats

    # ------------------------------------------------------------------- loss
    def head_loss(self, feats, labels, generator: Optional[torch.Generator] = None):
        """The objective over extracted features, in training mode (BN
        batch statistics, which update the running ones in place; dropout
        from ``generator``): logits resized to the labels' size, then
        ``segmentation_loss``.  Returns (total, parts).  Under dp the
        logits (with their gradient) and the labels of every rank are
        gathered first: the loss is the whole batch's on every rank."""
        decode, aux = self.head(feats, train=True, generator=generator)
        labels = _as_labels(labels).to(decode.device)
        hw = tuple(labels.shape[-2:])
        decode, aux = resize_bilinear_nchw(decode, hw), resize_bilinear_nchw(aux, hw)
        dp = self.head.dp
        if dp is not None:
            sizes = [labels.shape[0]] * dp.size
            decode, aux = (gather_with_grad(x, dp, 0, sizes) for x in (decode, aux))
            labels = dp.gather(labels, 0, sizes)
        return segmentation_loss(decode, aux, labels)

    def loss(self, images, labels, generator: Optional[torch.Generator] = None):
        """The training objective at label resolution (mmseg: logits
        upsampled to the label map first); with prompt tuning the gradient
        reaches ``meta_prompt`` through the extraction step."""
        return self.head_loss(self.extract_features(images, is_test=False), labels, generator)

    # -------------------------------------------------------------- inference
    @torch.no_grad()
    def predict_logits(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.extract_features(images, is_test=True)
        decode, _ = self.head(feats, train=False)
        return resize_bilinear_nchw(decode, tuple(images.shape[-2:]))

    @torch.no_grad()
    def slide_inference(self, images: torch.Tensor, crop_size=(512, 512),
                        stride=(512, 512)) -> torch.Tensor:
        """Sliding-window logits (reference slide_inference :421-472): crop
        logits summed and divided by the visit count."""
        images = torch.as_tensor(images).to(self.device)
        b, _, H, W = images.shape
        ch, cw = crop_size
        sh, sw = stride
        preds = torch.zeros((b, self.head.num_classes, H, W), device=self.device)
        count = torch.zeros((1, 1, H, W), device=self.device)
        h_grids = max(H - ch + sh - 1, 0) // sh + 1
        w_grids = max(W - cw + sw - 1, 0) // sw + 1
        for i in range(h_grids):
            for j in range(w_grids):
                y1, x1 = i * sh, j * sw
                y2, x2 = min(y1 + ch, H), min(x1 + cw, W)
                y1, x1 = max(y2 - ch, 0), max(x2 - cw, 0)
                preds[:, :, y1:y2, x1:x2] += self.predict_logits(images[:, :, y1:y2, x1:x2])
                count[:, :, y1:y2, x1:x2] += 1.0
        return preds / count

    def predict(self, images, mode: str = 'whole', **kw) -> np.ndarray:
        """Class ids (B, H, W) as numpy: ``mode='slide'`` through
        ``slide_inference`` (``crop_size``, ``stride``), else one whole
        forward."""
        images = torch.as_tensor(images).to(self.device)
        logits = (self.slide_inference(images, **kw) if mode == 'slide'
                  else self.predict_logits(images))
        return logits.argmax(dim=1).cpu().numpy()

