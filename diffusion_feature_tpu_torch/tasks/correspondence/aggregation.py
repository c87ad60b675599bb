"""Aggregation network for SPair-71k correspondence (port of
``diffusion_feature_tpu/tasks/correspondence/aggregation.py``).

Reference (correspondence/correspondence/aggregation_network.py): wraps 1-N
FeatureExtractors; per image, extracts the configured layers, bilinearly
resizes each to 128x128, channel-concats; with >1 extractor a learned 3x3
conv halves the channel count; a CLIP-style ``logit_scale`` drives the
symmetric cross-entropy loss.

The extraction is frozen (``no_grad``, detached); the module's one
parameter is the conv's OIHW weight ``conv.weight``, which ``forward``
(the JAX ``apply``) runs in fp32.  ``logit_scale`` is a constant, not a
parameter: the reference keeps it out of the optimizer.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn as nn

from ...configs import resolve_layer_config
from ...facade import FeatureExtractor
from ...ops.resize import interpolate_bilinear_nchw

# fixed SPair class-list prompt (reference :28)
SPAIR_PROMPT = (
    'a highly realistic photo that may contain an aeroplane, a bicycle, a '
    'bird, a boat, a bottle, a bus, a car, a cat, a chair, a cow, a dog, a '
    'horse, a motorbike, a person, a plant within a pot, a sheep, a train, '
    'or a tv monitor.')


class AggregationNetwork(nn.Module):
    """One port ``FeatureExtractor`` per config ({feature_len, layer,
    version, attention, img_size, t, dtype (default bfloat16)}) on
    ``device``, each with the prompt encoded once and its text encoders
    then dropped, and the 3x3 conv (no bias) from ``feature_dim`` to
    ``out_dim`` channels: the same width for one extractor, half for more
    (reference :20-22).  ``algorithm='nn'`` keeps the conv's weight but
    ``forward`` skips it, as the JAX ``apply`` does.  The weight draws
    JAX's ``he_normal`` (a normal truncated at +-2 sigma, std
    sqrt(2 / fan_in) / 0.87962566) from a generator seeded with ``seed``."""

    # CLIP temperature log(1/0.07): a plain tensor in the reference (:25),
    # NOT a registered parameter — the optimizer never updates it
    logit_scale = float(np.log(1 / 0.07))

    def __init__(self, configs: List[dict], weights=None, output_size=(128, 128),
                 prompt: str = SPAIR_PROMPT, algorithm: str = 'conv', seed: int = 0,
                 device='cuda'):
        super().__init__()
        self.output_size = tuple(output_size)
        self.device = torch.device(device)
        self.extractors = []
        for config in configs:
            fe = FeatureExtractor(
                layer=resolve_layer_config(config['layer']),
                version=config['version'],
                attention=config.get('attention'),
                img_size=config['img_size'],
                weights=weights,
                dtype=config.get('dtype', 'bfloat16'),
                device=device,
            )
            self.extractors.append({
                'model': fe,
                'prompt_embeds': fe.encode_prompt(prompt),
                't': config['t'],
            })
            fe.offload_prompt_encoder(persistent=True)

        self.feature_dim = sum(c['feature_len'] for c in configs)
        self.out_dim = (self.feature_dim if len(configs) == 1
                        else self.feature_dim // 2)
        self.do_conv = algorithm == 'conv'
        self.conv = nn.Conv2d(self.feature_dim, self.out_dim, 3, padding=1, bias=False,
                              device=self.device)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0):
        """Draw the conv's weight anew (JAX's ``init_params``)."""
        w = self.conv.weight
        std = math.sqrt(2.0 / (w.shape[1] * 9)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=torch.Generator(device=w.device).manual_seed(seed))

    @torch.no_grad()
    def extract(self, image) -> torch.Tensor:
        """image (path / PIL) -> frozen stacked features (1, C, 128, 128) in
        fp32: every extractor's layers in sorted order, each resized
        bilinearly (``F.interpolate``, align_corners=False)."""
        from PIL import Image
        if isinstance(image, str):
            image = Image.open(image)
        feats = []
        for ex in self.extractors:
            out = ex['model'].extract(ex['prompt_embeds'], 1, [image], t=ex['t'])
            for key in sorted(out):
                f = out[key].to(self.device, torch.float32)
                feats.append(interpolate_bilinear_nchw(f, self.output_size))
        x = torch.cat(feats, dim=1)
        assert x.shape[1] == self.feature_dim, \
            (f'feature_len mismatch: configs promise {self.feature_dim}, '
             f'extraction produced {x.shape[1]}')
        return x.detach()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """Trainable head: the optional 3x3 conv in fp32 (reference forward
        :97-100)."""
        if not self.do_conv:
            return feats
        return self.conv(feats.float())


def aggregation_params_from_jax(params: dict) -> dict:
    """The JAX ``init_params`` tree ``{'out_kernel': (3, 3, in, out)}`` ->
    ``AggregationNetwork``'s state dict (the OIHW ``conv.weight``)."""
    kernel = np.asarray(params['out_kernel'], np.float32)
    return {'conv.weight': torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())}
