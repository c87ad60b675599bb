"""Local diffusers checkpoints -> the port's modules (port of
``diffusion_feature_tpu/models/convert.py``), and JAX parameter trees ->
port state_dicts for the parity tests.

The port's parameter names are the diffusers/transformers checkpoint keys,
so a checkpoint loads with no renames and no transposes: a key is matched to
a parameter when their ``_normalize_key`` forms are equal, which also
resolves the normalised keys of a JAX-side template.  Weight files are
grouped into sets (``<base>[.<variant>][-NNNNN-of-NNNNN].<ext>``) and one set
is chosen per component dir with the JAX package's variant rules.

``params_from_jax`` is the inverse of the JAX ``convert_torch_state``: each
key of a port module's ``state_dict`` is normalised, looked up in the
flattened Flax tree, and transposed back (Dense (I, O) -> Linear (O, I);
Conv HWIO -> OIHW).  Takes numpy-convertible leaves; needs no JAX.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..io.safetensors import load_file, save_file

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


# ------------------------------------------------------------ checkpoints
_SHARD_RE = re.compile(r'-\d{5}-of-\d{5}$')
#: the weight file's base name per component dir (diffusers / transformers)
WEIGHTS_NAME = {'unet': 'diffusion_pytorch_model', 'vae': 'diffusion_pytorch_model',
                'text_encoder': 'model', 'text_encoder_2': 'model'}


def _group_weight_files(files: Iterable[str], ext: str):
    """Group weight files by (base, variant): diffusers names weights
    ``<base>[.<variant>][-NNNNN-of-NNNNN].<ext>`` (variant e.g. 'fp16').
    Returns {(base, variant_or_None): [files]}."""
    groups: Dict[Tuple[str, Optional[str]], list] = {}
    for f in sorted(files):
        stem = _SHARD_RE.sub('', f[:-len(ext) - 1])
        base, _, variant = stem.partition('.')
        groups.setdefault((base, variant or None), []).append(f)
    return groups


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch ``.bin`` state dict (older diffusers
    checkpoints ship only these), memory-mapped; ``weights_only`` refuses
    anything but tensors and plain containers."""
    obj = torch.load(path, map_location='cpu', weights_only=True, mmap=True)
    if isinstance(obj, dict) and isinstance(obj.get('state_dict'), dict):
        obj = obj['state_dict']
    if not isinstance(obj, dict):
        raise ValueError(f'{path}: checkpoint root is {type(obj).__name__}, '
                         'expected a tensor state_dict')
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_safetensors_dir(path: str, variant: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The tensors of ONE weight set of a diffusers component dir (shards
    included), as the JAX ``load_safetensors_dir`` chooses it:

    - ``variant`` ('fp16', 'bf16', ..., or 'main' for the un-suffixed set)
      picks that set, falling back per component to the un-suffixed set
      when the variant is absent (diffusers ``from_pretrained(variant=...)``);
      FileNotFoundError when neither exists;
    - without ``variant``: the un-suffixed set when present, else the one
      variant present; ValueError, listing them, when several variant sets
      exist and no un-suffixed one;
    - ``.bin`` files when the dir holds no safetensors at all.
    """
    names = os.listdir(path)
    ext = 'safetensors'
    files = [f for f in names if f.endswith('.safetensors')]
    if not files:
        ext = 'bin'
        files = [f for f in names if f.endswith('.bin')]
        if not files:
            raise FileNotFoundError(f'no .safetensors or .bin in {path}')
    groups = _group_weight_files(files, ext)
    if variant is not None:
        want = None if variant == 'main' else variant
        matches = ({k: v for k, v in groups.items() if k[1] == want}
                   or {k: v for k, v in groups.items() if k[1] is None})
        if not matches:
            have = sorted({k[1] or 'main' for k in groups})
            raise FileNotFoundError(f'{path}: no {ext} files with variant {variant!r} and no '
                                    f'un-suffixed set to fall back to (available: {have})')
        groups = matches
    if len(groups) > 1:
        main = {k: v for k, v in groups.items() if k[1] is None}
        if len(main) != 1:
            cands = sorted(f'{b}.{v}' if v else b for b, v in groups)
            raise ValueError(f'{path}: ambiguous weight sets {cands} - pass variant= '
                             "(e.g. variant='fp16', or variant='main' for the "
                             'un-suffixed set) to pick one')
        groups = main
    read = load_file if ext == 'safetensors' else load_torch_bin
    state: Dict[str, torch.Tensor] = {}
    for f in next(iter(groups.values())):
        state.update(read(os.path.join(path, f)))
    return state


def load_component_config(root: str, component: str) -> dict:
    with open(os.path.join(root, component, 'config.json')) as f:
        return json.load(f)


def load_component_state(root: str, component: str,
                         variant: Optional[str] = None) -> Dict[str, torch.Tensor]:
    return load_safetensors_dir(os.path.join(root, component), variant=variant)


def load_state_into(module: nn.Module, state: Mapping[str, torch.Tensor], dtype: torch.dtype,
                    device) -> List[str]:
    """Fill ``module`` (built on the meta device; a materialised module's
    values are replaced) from a checkpoint state in place, on ``device``
    with floating tensors cast to ``dtype``; returns the checkpoint keys no
    parameter took (e.g. the VAE decoder's, or CLIP's ``position_ids``).

    A key takes the parameter whose ``_normalize_key`` form equals its own.
    Every parameter must be found (ValueError with the count and the first
    five names), and shapes must agree (ValueError naming both keys)."""
    targets = module.state_dict(keep_vars=True)
    by_norm = {_normalize_key(k): k for k in targets}
    if len(by_norm) != len(targets):
        raise ValueError(f'{type(module).__name__}: parameter names collide when normalised')
    found, unused = {}, []
    for key, tensor in state.items():
        name = by_norm.get(_normalize_key(key))
        if name is None:
            unused.append(key)
            continue
        want = tuple(targets[name].shape)
        if tuple(tensor.shape) != want:
            raise ValueError(f'checkpoint {key} {tuple(tensor.shape)} does not fit '
                             f'{name} {want}')
        found[name] = tensor
    missing = [k for k in targets if k not in found]
    if missing:
        raise ValueError(f'{len(missing)} parameters of {type(module).__name__} not found in '
                         f'the checkpoint, e.g. {missing[:5]}')
    module.to(dtype=dtype).to_empty(device=device)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            t.copy_(found[name])
    return unused


def save_component(root: str, component: str, state: Mapping[str, torch.Tensor], config: dict,
                   variant: Optional[str] = None, shards: int = 1) -> Dict[str, int]:
    """Write ``state`` and its ``config.json`` as one diffusers component dir
    under ``root``: ``<base>[.<variant>][-0000i-of-0000n].safetensors`` in
    ``shards`` files of about equal size (keys in order).  Returns
    {file name: bytes written}."""
    d = os.path.join(root, component)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, 'config.json'), 'w') as f:
        json.dump(config, f, indent=2)
    stem = WEIGHTS_NAME[component] + (f'.{variant}' if variant else '')
    keys = list(state)
    sizes = [state[k].numel() * state[k].element_size() for k in keys]
    total, groups, acc = sum(sizes), [[] for _ in range(shards)], 0
    for k, n in zip(keys, sizes):
        groups[min(shards - 1, acc * shards // max(total, 1))].append(k)
        acc += n
    written = {}
    for i, group in enumerate(groups):
        name = (f'{stem}-{i + 1:05d}-of-{shards:05d}.safetensors' if shards > 1
                else f'{stem}.safetensors')
        written[name] = save_file({k: state[k] for k in group}, os.path.join(d, name))
    return written
