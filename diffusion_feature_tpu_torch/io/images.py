"""Host-side image preprocessing (port of ``diffusion_feature_tpu/io/images.py``).

PIL resize to (img_size, img_size) + RGB convert (reference
diffusion_feature.py:118), then normalisation to [-1, 1]; tensor inputs are
bilinearly resized (diffusion_feature.py:357-366).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.resize import interpolate_bilinear_nchw


def preprocess_pil_batch(images: Sequence, img_size: int) -> np.ndarray:
    """PIL images -> (B, 3, H, W) float32 in [-1, 1]."""
    out = []
    for im in images:
        im = im.resize((img_size, img_size)).convert('RGB')
        arr = np.asarray(im, dtype=np.float32) / 255.0
        out.append((arr * 2.0 - 1.0).transpose(2, 0, 1))
    return np.stack(out, axis=0)


def resize_tensor_batch(x, img_size: int) -> torch.Tensor:
    """(B, 3, H, W) arrays or tensors, already normalised -> float32 tensor
    bilinearly resized to img_size^2, on the input's device."""
    x = torch.as_tensor(x).float()
    if x.shape[-1] == img_size and x.shape[-2] == img_size:
        return x
    return interpolate_bilinear_nchw(x, (img_size, img_size))
