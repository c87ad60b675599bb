"""Feature post-processing (port of ``diffusion_feature_tpu/store.py``): the
reference's ``FeatureStore.store`` filter pipeline
(feature/components/feature_extractor.py:31-77) as a function on tensors,
the attention store's aggregation (the JAX facade's
``_aggregate_attention``) and background extraction's encounter filter."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .ops.resize import interpolate_bilinear_nchw
from .taps import is_filtered_id


def tokens_to_map(feat: torch.Tensor) -> torch.Tensor:
    """(B, S, C) -> (B, C, sqrt(S), sqrt(S)); square token maps assumed, as
    in the reference (feature_extractor.py:46-48)."""
    b, s, c = feat.shape
    size = int(math.sqrt(s))
    return feat.reshape(b, size, size, c).permute(0, 3, 1, 2)


def postprocess_feature(feat: torch.Tensor, *, resize_ratio: int = 1,
                        out_dtype: Optional[torch.dtype] = torch.bfloat16) -> torch.Tensor:
    """In the reference's order (feature_extractor.py:41-66):
      1. 3-D token tensors reshaped to (B, C, h, w);
      2. adaptive average pool by ``resize_ratio``;
      3. TF.normalize(mean=0, std=1), an identity as the reference writes
         it, so nothing is done;
      4. cast to ``out_dtype`` (None keeps the compute dtype).
    4-D attention maps (B, H, Sq, Sk) skip the reshape, as in the reference.
    """
    if feat.dim() == 3:
        feat = tokens_to_map(feat)
    if resize_ratio > 1 and feat.dim() == 4:
        feat = F.adaptive_avg_pool2d(
            feat, (feat.shape[2] // resize_ratio, feat.shape[3] // resize_ratio))
    if out_dtype is not None:
        feat = feat.to(out_dtype)
    return feat


def postprocess_taps(taps: Dict[str, torch.Tensor], *, resize_ratio: int = 1,
                     out_dtype: Optional[torch.dtype] = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """The store pipeline on every captured tap; cross-k/cross-v dropped."""
    return {tap_id: postprocess_feature(feat, resize_ratio=resize_ratio, out_dtype=out_dtype)
            for tap_id, feat in taps.items() if not is_filtered_id(tap_id)}


def aggregate_attention(store: Dict[str, List[torch.Tensor]], categories: Sequence[str],
                        img_size: int, out_dtype: Optional[torch.dtype]
                        ) -> Optional[torch.Tensor]:
    """AttentionStore.aggregate_attention and the facade's resize/concat
    (reference components/attention.py:143-161, diffusion_feature.py:492-500).

    ``store`` maps '{place}_{kind}' to its (B, Sq, Sk) head-mean maps.  Per
    requested category, in order, the maps are grouped by side length and
    each group, in ascending size, is averaged, laid out as (B, Sk, h, w)
    and resized bilinearly to img_size/8; the groups are concatenated on
    channels.  None when nothing was stored."""
    all_attns = []
    for cat in categories:
        by_size: Dict[int, list] = {}
        for m in store.get(cat, ()):
            size = int(math.sqrt(m.shape[1]))
            by_size.setdefault(size, []).append(
                m.reshape(m.shape[0], size, size, m.shape[2]).permute(0, 3, 1, 2))
        for size in sorted(by_size):
            group = by_size[size]
            target = img_size // 8
            all_attns.append(interpolate_bilinear_nchw(sum(group) / len(group), (target, target)))
    if not all_attns:
        return None
    out = torch.cat(all_attns, dim=1)
    return out.to(out_dtype) if out_dtype else out


def select_background_encounters(taps: Dict[str, object], store_idx) -> Dict[str, dict]:
    """Background extraction's filter: per layer, the encounters whose
    1-based index is in ``store_idx``, as {layer: {'feat': {idx: tensor},
    'count': n}}, the reference's stored entry (feature_extractor.py:68-76).
    A layer's value is a tuple of encounters (``sample``) or one tensor
    (``extract``: the single encounter 1)."""
    store_idx = set(store_idx)
    out = {}
    for tap_id, feats in taps.items():
        if not isinstance(feats, tuple):
            feats = (feats,)
        out[tap_id] = {'feat': {i: f for i, f in enumerate(feats, start=1) if i in store_idx},
                       'count': len(feats)}
    return out
