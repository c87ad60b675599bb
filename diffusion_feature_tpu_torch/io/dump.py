"""Feature dump writer (port of ``diffusion_feature_tpu/io/dump.py``, taking
torch tensors): the reference CLI's on-disk output format matrix
(reference: extract_feature.py:113-148).

Formats:
  - per-layer:      outdir/<layer>/<name>.npy          (default)
  - sample-first:   outdir/<name>/<layer>.npy          (--sample_name_first)
  - aggregated:     outdir/<name>.npy                  (--aggregate_output)

Names are either ``<split><global_index>`` or the original (possibly nested)
filename stem (--use_original_filename / --nested_input_dir,
extract_feature.py:68-75).

Dumps are fp16.  Features arrive in bf16 and are cast to fp16 on their
device, then copied to the host once per layer and batch; the JAX package
casts bf16 -> fp32 -> fp16, which rounds the same, since bf16 -> fp32 is
exact.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.resize import interpolate_nearest_nchw


def _to_host(feat: torch.Tensor, dtype=torch.float16) -> np.ndarray:
    """C-contiguous host copy in ``dtype`` (the cast runs on the device)."""
    return feat.to(dtype=dtype, memory_format=torch.contiguous_format).cpu().numpy()


def sample_name(index: int, split: str, original: str | None, use_original: bool) -> str:
    """Output-name rule: original stem when requested, else ``split+index``
    (extract_feature.py:130, :143)."""
    return original if (use_original and original is not None) else f'{split}{index}'


def aggregate_features(features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """--aggregate_output: resize every layer to the largest spatial size
    present and concatenate along channels -> (B, sum(C), h, w) in fp32
    (extract_feature.py:113-126).

    torch ``F.interpolate(v, size)`` defaults to mode='nearest' and an int
    size resizes *both* spatial dims; reproduced here.
    """
    target = max(v.shape[-1] for v in features.values())
    resized = []
    for v in features.values():
        v = v.float()
        if v.shape[-2] != target or v.shape[-1] != target:
            v = interpolate_nearest_nchw(v, (target, target))
        resized.append(v)
    return torch.cat(resized, dim=1)


def _write(path: str, arr: np.ndarray, writer=None):
    if writer is not None:
        writer.submit(path, arr)
    else:
        np.save(path, arr)


def save_batch(
    features: Dict[str, torch.Tensor],
    out_dir: str,
    *,
    batch_start_index: int,
    original_names: Sequence[str] | None = None,
    split: str = 'train',
    use_original_filename: bool = False,
    sample_name_first: bool = False,
    aggregate_output: bool = False,
    nested: bool = False,
    dtype=torch.float16,
    writer=None,
) -> List[str]:
    """Write one extracted batch to disk; returns the written paths.

    ``writer``: optional native AsyncDumpWriter; IO then overlaps the next
    batch's device work (the caller must flush()/close())."""
    written = []
    if not features:
        raise ValueError(
            'no features to write: the extraction returned an empty dict '
            '(every requested layer id was unknown/filtered; run with '
            'layer validation on, or --show_all_layers, to see valid ids)')
    batch = next(iter(features.values())).shape[0]

    def name_of(j):
        return sample_name(batch_start_index + j, split,
                           original_names[j] if original_names else None,
                           use_original_filename)

    if aggregate_output:
        agg = _to_host(aggregate_features(features), dtype)
        for j in range(batch):
            name = name_of(j)
            if nested and '/' in name:
                os.makedirs(os.path.join(out_dir, name.rsplit('/', 1)[0]), exist_ok=True)
            else:
                os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, name + '.npy')
            _write(path, agg[j], writer)
            written.append(path)
        return written

    host = {layer: _to_host(v, dtype) for layer, v in features.items()}
    for j in range(batch):
        name = name_of(j)
        for layer, arr in host.items():
            if sample_name_first:
                path = os.path.join(out_dir, name, layer + '.npy')
            else:
                path = os.path.join(out_dir, layer, name + '.npy')
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _write(path, arr[j], writer)
            written.append(path)
    return written
