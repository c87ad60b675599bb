"""JAX parameter tree -> port state_dict (the inverse of
``diffusion_feature_tpu/models/convert.py::convert_torch_state``).

The JAX package names its Flax parameters so that a diffusers/transformers
key normalised by ``'.' -> '_'`` (plus a few CLIP segment strips) equals the
flattened Flax path.  The port's modules use the checkpoint keys themselves,
so each key of a port module's ``state_dict`` is normalised the same way,
looked up in the flattened tree, and transposed back (Dense (I, O) ->
Linear (O, I); Conv HWIO -> OIHW).  Takes numpy-convertible leaves; needs
no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# torch leaf name -> Flax leaf names to try, in order
_LEAF_CANDIDATES = {'weight': ('kernel', 'scale', 'embedding'), 'bias': ('bias',)}


def _normalize_key(key: str) -> str:
    """The JAX package's ``_normalize_key``: torch module path -> Flax path."""
    k = key.replace('.', '_')
    k = k.replace('text_model_', '')
    k = k.replace('encoder_layers_', 'layers_')
    k = k.replace('_self_attn_', '_')
    k = k.replace('_mlp_', '_')
    return k.replace('embeddings_', '')


def _flatten(tree, prefix=()) -> Dict[str, object]:
    flat = {}
    for name, value in tree.items():
        path = prefix + (str(name),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat['_'.join(path)] = value
    return flat


def params_from_jax(flax_params: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Build a state_dict for ``module`` from a JAX parameter tree.

    Every key of ``module.state_dict()`` must be found; tensors come back in
    the module's dtype.  Tree entries the module does not have (e.g. the
    VAE decoder for the encoder-only port) are ignored."""
    flat = _flatten(flax_params)
    out = {}
    for key, ref in module.state_dict().items():
        base, _, leaf = key.rpartition('.')
        norm_base = _normalize_key(base)
        for cand in _LEAF_CANDIDATES.get(leaf, (leaf,)):
            norm = f'{norm_base}_{cand}' if norm_base else cand
            if norm in flat:
                break
        else:
            raise KeyError(f'{key}: no JAX parameter {norm_base}_{{'
                           f"{','.join(_LEAF_CANDIDATES.get(leaf, (leaf,)))}}}")
        arr = np.array(flat[norm], dtype=np.float32)
        if cand == 'kernel':
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f'{key} <- {norm}: shape {arr.shape}, want {tuple(ref.shape)}')
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(ref.dtype)
    return out
