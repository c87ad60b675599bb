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
Conv HWIO -> OIHW; a kernel==stride ConvTranspose (k, k, I, O) -> (I, O,
k, k); an int8 ``kernel_q`` (I, O) -> ``weight_q`` (O, I)).  Takes
numpy-convertible leaves; needs no JAX.

An int8 layer (``ops/quant.Int8Linear``) takes a checkpoint's
full-precision ``weight``: ``load_state_into`` quantizes it on the device as
it loads (the JAX ``convert_torch_state``'s ``kernel_q`` rule).

``load_bundle_into`` fills a module from a deployment bundle
(``io/bundle.py``): the port's, in its own layout, or the JAX package's,
whose leaves take ``params_from_jax``'s names and transposes (run on the
device); int8 leaves are taken as stored.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..io.safetensors import load_file, save_file
from ..ops.quant import Int8Linear, has_int8, quantize_int8

# torch leaf name -> Flax leaf names to try, in order.  An Int8Linear's
# weight_q is JAX's kernel_q alone, and its scale JAX's scale: a 'weight'
# never takes a 'scale' that sits beside a kernel_q (see params_from_jax)
_LEAF_CANDIDATES = {'weight': ('kernel', 'scale', 'embedding', 'weight'), 'bias': ('bias',),
                    'weight_q': ('kernel_q',)}


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


def _jax_leaf(key: str, module: nn.Module, flat: Mapping,
              jax_name: Optional[Callable[[str], str]] = None
              ) -> Optional[Tuple[str, Optional[Tuple[int, ...]]]]:
    """(the flat JAX name that ``module``'s state_dict ``key`` takes in
    ``flat``, the permutation of the JAX array's dims into the port's
    layout, or None where none is needed), or None where ``flat`` lacks
    it.  Dense (I, O) -> Linear (O, I); Conv HWIO -> OIHW; a
    kernel==stride ConvTranspose (k, k, I, O) -> (I, O, k, k); an int8
    ``kernel_q`` (I, O) -> ``weight_q`` (O, I).  A full-precision weight
    whose JAX layer is int8 raises ValueError."""
    base, _, leaf = (jax_name(key) if jax_name else key).rpartition('.')
    norm_base = _normalize_key(base)
    if leaf == 'weight' and f'{norm_base}_kernel_q' in flat:
        raise ValueError(f'{key}: the JAX layer {norm_base} is int8 (kernel_q, scale); '
                         'build the module with quantize_int8 to take it')
    for cand in _LEAF_CANDIDATES.get(leaf, (leaf,)):
        norm = f'{norm_base}_{cand}' if norm_base else cand
        if norm in flat:
            break
    else:
        return None
    perm = None
    if cand == 'kernel_q' or (cand == 'kernel' and len(flat[norm].shape) == 2):
        perm = (1, 0)
    elif cand == 'kernel':
        perm = ((2, 3, 0, 1) if isinstance(module.get_submodule(key.rpartition('.')[0]),
                                           nn.ConvTranspose2d)
                else (3, 2, 0, 1))
    return norm, perm


def text_jax_name(module: nn.Module) -> Optional[Callable[[str], str]]:
    """The JAX-name map of a port text encoder for ``params_from_jax`` and
    ``load_bundle_into`` (T5's and BERT's differ from their transformers
    keys; CLIP's names normalise as they are), or None."""
    from .bert_text import BertTextModel, jax_param_name as bert_name
    from .t5 import T5EncoderModel, jax_param_name as t5_name
    if isinstance(module, T5EncoderModel):
        return t5_name
    if isinstance(module, BertTextModel):
        return bert_name
    return None


def params_from_jax(flax_params: Mapping, module: nn.Module,
                    jax_name: Optional[Callable[[str], str]] = None) -> Dict[str, torch.Tensor]:
    """Build a state_dict for ``module`` from a JAX parameter tree.

    Every key of ``module.state_dict()`` must be found; tensors come back in
    the module's dtype.  Tree entries the module does not have (e.g. the
    VAE decoder for the encoder-only port) are ignored.  ``jax_name`` maps
    a key to the JAX module's own name, in the same dotted form, where the
    two differ (the DPT's transformers keys)."""
    flat = _flatten(flax_params)
    out = {}
    for key, ref in module.state_dict().items():
        found = _jax_leaf(key, module, flat, jax_name)
        if found is None:
            base, _, leaf = (jax_name(key) if jax_name else key).rpartition('.')
            raise KeyError(f'{key}: no JAX parameter {_normalize_key(base)}_{{'
                           f"{','.join(_LEAF_CANDIDATES.get(leaf, (leaf,)))}}}")
        norm, perm = found
        arr = np.array(flat[norm], dtype=np.float32)
        if perm is not None:
            arr = arr.transpose(perm)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f'{key} <- {norm}: shape {arr.shape}, want {tuple(ref.shape)}')
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(ref.dtype)
    return out


# ------------------------------------------------------------ checkpoints
_SHARD_RE = re.compile(r'-\d{5}-of-\d{5}$')


def weights_name(component: str) -> str:
    """The weight file's base name in a component dir: transformers' models
    (the text encoders, the depth estimator) write 'model', diffusers'
    (U-Net, VAE, ControlNets) 'diffusion_pytorch_model'."""
    if component.startswith('text_encoder') or component == 'depth_estimator':
        return 'model'
    return 'diffusion_pytorch_model'


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
                    device, cuts: Optional[Mapping[str, tuple]] = None, tp=None) -> List[str]:
    """Fill ``module`` (built on the meta device; a materialised module's
    values are replaced) from a checkpoint state in place, on ``device``
    with floating tensors cast to ``dtype``; returns the checkpoint keys no
    parameter took (e.g. the VAE decoder's, or CLIP's ``position_ids``).

    A key takes the parameter whose ``_normalize_key`` form equals its own.
    An ``Int8Linear`` at ``p`` takes the checkpoint's ``p.weight``: that one
    tensor is copied to ``device`` and quantized there into ``weight_q`` and
    its fp32 ``scale`` (JAX's ``convert_torch_state`` quantizes the same
    values), so one staged tensor is alive at a time and no full-precision
    copy of the layer stays.  Every parameter must be found (ValueError
    with the count and the first five names), and shapes must agree
    (ValueError naming both keys).

    ``cuts`` ({module key: (dim, indices)}, ``parallel/mesh.parallelize``'s
    of a module already cut): each such checkpoint tensor is cut before it
    is copied, so only this rank's part reaches the device.  An int8 layer
    cut along its input columns (row-parallel) takes its channels' maxima
    over the whole row: the part's maxima, the largest over the ``tp``
    axis, so the int8 values are the whole weight's quantization, cut."""
    from ..parallel.mesh import take
    cuts = dict(cuts or {})
    targets = module.state_dict(keep_vars=True)
    # an int8 layer's slot is its full-precision 'weight', of weight_q's shape
    shapes = {k: tuple(t.shape) for k, t in targets.items()}
    quantized = set()
    for name, m in module.named_modules():
        if isinstance(m, Int8Linear):
            prefix = f'{name}.' if name else ''
            del shapes[f'{prefix}weight_q'], shapes[f'{prefix}scale']
            shapes[f'{prefix}weight'] = tuple(m.weight_q.shape)
            quantized.add(f'{prefix}weight')
            if f'{prefix}weight_q' in cuts:
                cuts[f'{prefix}weight'] = cuts[f'{prefix}weight_q']
    by_norm = {_normalize_key(k): k for k in shapes}
    if len(by_norm) != len(shapes):
        raise ValueError(f'{type(module).__name__}: parameter names collide when normalised')
    found, unused = {}, []
    for key, tensor in state.items():
        name = by_norm.get(_normalize_key(key))
        if name is None:
            unused.append(key)
            continue
        shape = list(tensor.shape)
        if name in cuts and len(shape) > cuts[name][0]:
            shape[cuts[name][0]] = cuts[name][1].numel()
        if tuple(shape) != shapes[name]:
            raise ValueError(f'checkpoint {key} {tuple(tensor.shape)} does not fit '
                             f'{name} {shapes[name]}' + (' (cut)' if name in cuts else ''))
        found[name] = tensor
    missing = [k for k in shapes if k not in found]
    if missing:
        raise ValueError(f'{len(missing)} parameters of {type(module).__name__} not found in '
                         f'the checkpoint, e.g. {missing[:5]}')
    # Int8Linear keeps its scale in fp32 through the cast
    module.to(dtype=dtype).to_empty(device=device)
    targets = module.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, t in found.items():
            if name in cuts:
                t = take(t, cuts[name])
            if name in quantized:
                prefix = name[:-len('weight')]
                t = t.to(device)
                absmax = None
                if name in cuts and cuts[name][0] == 1:
                    absmax = t.float().abs().amax(dim=1)
                    tp.all_reduce(absmax, torch.distributed.ReduceOp.MAX)
                q, scale = quantize_int8(t, absmax)
                targets[f'{prefix}weight_q'].copy_(q)
                targets[f'{prefix}scale'].copy_(scale)
                del q, scale
            else:
                targets[name].copy_(t)
    return unused


def _stage(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``, where a bundle leaf is transposed: the one
    staged tensor of ``load_bundle_into`` (``t`` itself on the CPU)."""
    return t.to(device)


def load_bundle_into(module: nn.Module, leaves: Mapping[str, torch.Tensor], dtype: torch.dtype,
                     device, cuts: Optional[Mapping[str, tuple]] = None, jax_layout: bool = False,
                     jax_name: Optional[Callable[[str], str]] = None) -> List[str]:
    """Fill ``module`` (built on the meta device) from one component of a
    deployment bundle (``io/bundle.Bundle.leaves``: host views of its
    files), as ``load_state_into`` fills it from a checkpoint: the module
    is materialised once at ``dtype`` on ``device`` and each parameter
    copied from its leaf; returns the leaves no parameter took.

    The port's bundle is keyed by the module's own state_dict keys, in its
    layout.  A JAX bundle (``jax_layout``) is keyed by flat JAX names,
    which a key resolves to as ``params_from_jax`` does (``jax_name``:
    ``text_jax_name``'s map); such a leaf is copied to ``device`` as stored
    and transposed there, one staged tensor alive at a time.  Leaves load
    as stored: float leaves are at the serving dtype the bundle's meta
    records, and an int8 ``weight_q`` with its fp32 ``scale`` is taken as
    it is, never quantized again.  Every parameter must be found
    (ValueError with the count and the first five names), and shapes and
    kinds (int8 or float) must agree (ValueError naming both sides).

    ``cuts`` ({module key: (dim, indices)}, as in ``load_state_into``) cut
    each leaf in the port's layout, from the transposed view of its file
    and before its copy; an int8 layer cut along its input columns keeps
    the whole row's scale, which its stored bits were quantized with."""
    from ..parallel.mesh import take
    cuts = cuts or {}
    plan, missing = {}, []
    for key, ref in module.state_dict(keep_vars=True).items():
        found = (_jax_leaf(key, module, leaves, jax_name) if jax_layout
                 else (key, None) if key in leaves else None)
        if found is None:
            missing.append(key)
            continue
        name, perm = found
        leaf = leaves[name]
        shape = [leaf.shape[d] for d in perm] if perm else list(leaf.shape)
        if key in cuts:
            shape[cuts[key][0]] = cuts[key][1].numel()
        if tuple(shape) != tuple(ref.shape):
            raise ValueError(f'bundle leaf {name} {tuple(leaf.shape)} does not fit {key} '
                             f'{tuple(ref.shape)}' + (' (cut)' if key in cuts else '')
                             + (f' (as {tuple(shape)} in the port\'s layout)' if perm else ''))
        if leaf.dtype.is_floating_point != ref.dtype.is_floating_point:
            raise ValueError(f'bundle leaf {name} is {leaf.dtype}, {key} is {ref.dtype}')
        plan[key] = (name, perm)
    if missing:
        raise ValueError(f'{len(missing)} parameters of {type(module).__name__} not found in '
                         f'the bundle, e.g. {missing[:5]}')
    # Int8Linear keeps its scale in fp32 through the cast
    module.to(dtype=dtype).to_empty(device=device)
    targets = module.state_dict(keep_vars=True)
    with torch.no_grad():
        for key, (name, perm) in plan.items():
            t = leaves[name]
            if key in cuts:
                dim, idx = cuts[key]
                t = take(t, (perm[dim] if perm else dim, idx))
            if perm is None:
                targets[key].copy_(t)
            else:
                staged = _stage(t, device)
                targets[key].copy_(staged.permute(perm))
                del staged
    used = {name for name, _ in plan.values()}
    return [n for n in leaves if n not in used]


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
    stem = weights_name(component) + (f'.{variant}' if variant else '')
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


def random_module(make, device, dtype, generator, parallel=None) -> nn.Module:
    """Build ``make()`` on the meta device, then materialise it on ``device``
    with a deterministic random init drawn from ``generator``: weights of
    rank >= 2 ~ N(0, 1/fan_in), norm scales 1, biases 0.  ``parallel``
    (meta module -> {key: cut}, ``parallel/mesh.py``) cuts the module
    first; a cut tensor is drawn whole, one at a time, and its part kept,
    so every rank holds the unsharded init's values.  An int8 module
    raises ValueError: its layers hold quantized checkpoint weights (the JAX
    package refuses int8 without weights too)."""
    from ..parallel.mesh import take
    with torch.device('meta'):
        module = make()
    if has_int8(module):
        raise ValueError(f'{type(module).__name__} has int8 weight-only layers, which take '
                         'quantized checkpoint weights: a random init has none to quantize')
    whole = {k: tuple(p.shape) for k, p in module.named_parameters()}
    cuts = parallel(module) if parallel is not None else {}
    module = module.to(dtype=dtype).to_empty(device=device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            full = p if name not in cuts else torch.empty(whole[name], dtype=p.dtype,
                                                          device=p.device)
            if full.dim() >= 2:
                full.normal_(0.0, full[0].numel() ** -0.5, generator=generator)
            elif name.endswith('weight'):
                full.fill_(1.0)
            else:
                full.zero_()
            if name in cuts:
                p.copy_(take(full, cuts[name]))
                del full
    return module.eval().requires_grad_(False)
