"""Offline LoRA merging (port of ``diffusion_feature_tpu/models/lora.py``).

The reference defers to ``pipe.load_lora_weights`` (diffusers/peft runtime
adapters, feature/diffusion_feature.py:50-53); as in the JAX package the
adapter is merged instead, W' = W + (alpha/r) * (up @ down), in fp32 and cast
back, so inference pays nothing for it.

Key dialects (auto-detected):
  - peft/diffusers:  unet.<path>.lora_A.weight / lora_B.weight
  - legacy diffusers attn-procs: <path>.lora.down.weight / up.weight
  - kohya: lora_unet_<path-with-_>.lora_down.weight / lora_up.weight + .alpha
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..io.safetensors import load_file
from .convert import _normalize_key


def _read_lora_file(root: str, filename: Optional[str]) -> Dict[str, torch.Tensor]:
    """``root``/``filename``, or ``root`` itself; a directory gives its first
    safetensors file by name."""
    path = os.path.join(root, filename) if filename else root
    if os.path.isdir(path):
        cands = sorted(f for f in os.listdir(path) if f.endswith('.safetensors'))
        if not cands:
            raise FileNotFoundError(f'no safetensors in {path}')
        path = os.path.join(path, cands[0])
    return load_file(path)


def collect_lora_pairs(state: Dict[str, torch.Tensor]
                       ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, float]]:
    """Group raw keys into {module path: (down, up, scale)}, scale being
    alpha / rank (alpha defaults to the rank)."""
    downs, ups, alphas = {}, {}, {}
    for key, t in state.items():
        k = key
        if k.startswith('lora_unet_'):
            # kohya: underscores for dots
            base = k[len('lora_unet_'):]
            if base.endswith('.lora_down.weight'):
                downs[base[:-len('.lora_down.weight')]] = t
            elif base.endswith('.lora_up.weight'):
                ups[base[:-len('.lora_up.weight')]] = t
            elif base.endswith('.alpha'):
                alphas[base[:-len('.alpha')]] = float(t)
            continue
        if k.startswith('unet.'):
            k = k[len('unet.'):]
        for suffix, table in (('.lora_A.weight', downs), ('.lora_B.weight', ups),
                              ('.lora.down.weight', downs), ('.lora.up.weight', ups),
                              ('.alpha', alphas)):
            if k.endswith(suffix):
                table[k[:-len(suffix)]] = float(t) if table is alphas else t
                break

    pairs = {}
    for base, down in downs.items():
        up = ups.get(base)
        if up is None:
            continue
        rank = down.shape[0]
        pairs[base] = (down, up, alphas.get(base, float(rank)) / rank)
    return pairs


def apply_lora_to_module(module: nn.Module, root: str, filename: Optional[str] = None,
                         cuts=None) -> int:
    """Merge a LoRA checkpoint into ``module``'s Linear and 1x1-conv weights
    in place; returns how many were merged.  Adapters whose module is
    missing or whose shape does not fit are skipped (they may target text
    encoders); ValueError when none matched.  ``cuts`` ({key: (dim,
    indices)}, a tensor-parallel module's): a cut weight takes the same
    part of its delta."""
    from ..parallel.mesh import take
    cuts = cuts or {}
    by_norm = {_normalize_key(name[:-len('.weight')]): (p, cuts.get(name))
               for name, p in module.named_parameters() if name.endswith('.weight')}
    pairs = collect_lora_pairs(_read_lora_file(root, filename))
    n_merged = 0
    with torch.no_grad():
        for base, (down, up, scale) in pairs.items():
            w, cut = by_norm.get(_normalize_key(base.replace('_', '.') if '.' not in base
                                                else base), (None, None))
            if w is None or w.dim() not in (2, 4):
                continue
            d = down.to(w.device, torch.float32)
            u = up.to(w.device, torch.float32)
            if d.dim() == 4:      # 1x1-conv LoRA
                d, u = d[..., 0, 0], u[..., 0, 0]
            delta = (u @ d) * scale                         # (O, I)
            if w.dim() == 4:
                delta = delta[..., None, None]              # OIHW 1x1 conv
            if cut is not None:
                delta = take(delta, cut)
            if delta.shape != w.shape:
                continue
            w.copy_((w.float() + delta).to(w.dtype))
            n_merged += 1
    if n_merged == 0:
        raise ValueError('LoRA checkpoint matched no parameters; '
                         'check key dialect / model version')
    return n_merged
