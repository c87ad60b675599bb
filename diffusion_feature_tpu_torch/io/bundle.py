"""Deployment bundles (port of ``diffusion_feature_tpu/io/bundle.py``):
converted weights on disk that ``FeatureExtractor(weights=<bundle>)``
warm-starts from, with no checkpoint key matching and no int8
quantization pass.

A bundle dir mirrors a diffusers checkpoint's layout, so the facade's spec
adaptation and tokenizer loading work on it unchanged::

    bundle/
      tpu_bundle.json           manifest: format, kind, meta, leaves
      params/...                the converted weights
      {unet|transformer}/config.json  vae/config.json  text_encoder*/config.json
      tokenizer/  tokenizer_2/  depth_estimator/  controlnet_*/   copied verbatim

Two kinds share the manifest (``format`` 1, the JAX ``_bundle_meta``'s
``meta``: version, family, dtype, transformer_8bit, t5_8bit,
offline_lora):

- the JAX package's (``kind`` ``diffusion_feature_tpu_bundle``, read only):
  one ``params/NNNNNN.npy`` per leaf of the Flax tree ``{'unet', 'vae',
  'text': [...]}``, each listed as ``{file, path, dtype, shape}`` with its
  ``jax.tree_util.keystr`` path; Flax layout (Dense (in, out), Conv HWIO,
  int8 ``kernel_q`` (in, out) beside its fp32 ``scale``); bfloat16 stored
  as uint16 bit patterns.  ``Bundle.leaves`` hands each leaf back under
  the flat ``_``-joined name ``models/convert.py`` looks up, as a view of
  its memory-mapped file; ``convert.load_bundle_into`` transposes it on
  the device.
- the port's (``kind`` ``diffusion_feature_tpu_torch_bundle``):
  ``params/<component>.safetensors``, each a module's ``state_dict`` in
  torch layout at the serving dtype (int8 ``weight_q`` and its fp32
  ``scale`` as they are), every tensor listed as ``{component, key, path,
  file, dtype, shape}``.  The JAX package refuses it with ``ValueError``:
  its leaf count or its leaf paths (``component/key``) never match a Flax
  tree.

Leaves load as stored: float leaves are at the serving dtype the meta
records, and a bundle of another dtype is refused, as in JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .safetensors import load_file, save_file

MANIFEST = 'tpu_bundle.json'
FORMAT = 1
#: the ``kind`` of the port's bundles, and of the JAX package's
KIND = 'diffusion_feature_tpu_torch_bundle'
JAX_KIND = 'diffusion_feature_tpu_bundle'
# checkpoint pieces copied verbatim, so a bundle dir behaves like a
# checkpoint dir for everything that is not the converted weights
_CONFIG_COMPONENTS = ('unet', 'transformer', 'vae', 'text_encoder', 'text_encoder_2')
_COPY_TREES = ('tokenizer', 'tokenizer_2', 'depth_estimator')
#: the checkpoint component of each text encoder of the JAX tree's 'text' list
_TEXT_COMPONENTS = ('text_encoder', 'text_encoder_2')
_KEY = re.compile(r"\['([^'\\]*)'\]|\[(\d+)\]")


def is_bundle(root: str) -> bool:
    return os.path.isfile(os.path.join(str(root), MANIFEST))


def read_meta(root: str) -> Dict:
    """The manifest's ``meta`` (the configuration the bundle was saved
    under); the facade resolves its auto (None) int8 flags from it."""
    with open(os.path.join(str(root), MANIFEST)) as f:
        return json.load(f).get('meta', {})


def dtype_name(dtype: torch.dtype) -> str:
    """'bfloat16', 'int8', ...: numpy's and the manifest's name of ``dtype``."""
    return str(dtype).removeprefix('torch.')


def parse_keystr(path: str) -> Tuple:
    """The keys of a ``jax.tree_util.keystr`` path: ``"['text'][0]['a']"``
    -> ('text', 0, 'a')."""
    keys, pos = [], 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            break
        keys.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f'bundle leaf path {path!r} is not a keystr path')
    return tuple(keys)


def _jax_component(keys: Tuple) -> Tuple[str, str]:
    """(checkpoint component, flat name) of a JAX leaf's keys: the tree's
    'unet' is the denoiser ('unet' or 'transformer' to the facade), its
    'text' list the text encoders in checkpoint order."""
    if keys[0] == 'text' and len(keys) > 2 and isinstance(keys[1], int):
        return _TEXT_COMPONENTS[keys[1]], '_'.join(map(str, keys[2:]))
    if keys[0] in ('unet', 'vae') and len(keys) > 1:
        return keys[0], '_'.join(map(str, keys[1:]))
    raise ValueError(f'bundle leaf {keys} is outside the denoiser, VAE and text encoders')


def _corrupt(what: str, file: str, got, want) -> ValueError:
    return ValueError(f'bundle leaf {what}: {file} does not match the manifest (file '
                      f'{got} vs manifest {want}) - the bundle is corrupt; re-export it')


class Bundle:
    """An opened bundle dir: ``meta``, ``jax_layout`` (a JAX package
    bundle) and each component's leaves (``leaves``)."""

    def __init__(self, root: str):
        self.root = str(root)
        with open(os.path.join(self.root, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get('format') != FORMAT or manifest.get('kind') not in (KIND, JAX_KIND):
            raise ValueError(f'unsupported deployment bundle at {root}: format '
                             f'{manifest.get("format")!r}, kind {manifest.get("kind")!r}')
        self.meta: Dict = manifest.get('meta', {})
        self.jax_layout = manifest['kind'] == JAX_KIND
        #: {component: [manifest entry]}, each entry with its flat 'name'
        self._entries: Dict[str, list] = {}
        for ent in manifest['leaves']:
            if self.jax_layout:
                comp, name = _jax_component(parse_keystr(ent['path']))
            else:
                comp, name = ent['component'], ent['key']
            self._entries.setdefault(comp, []).append({**ent, 'name': name})

    def leaves(self, component: str) -> Dict[str, torch.Tensor]:
        """{name: host tensor} of ``component`` ('unet' or 'transformer' for
        the denoiser, 'vae', 'text_encoder', 'text_encoder_2'): views of the
        memory-mapped files, each checked against the manifest (ValueError
        'corrupt' where a file differs); a JAX bundle's names are the flat
        JAX names, the port's the module's state_dict keys."""
        if self.jax_layout and component == 'transformer':
            component = 'unet'
        entries = self._entries.get(component)
        if not entries:
            raise ValueError(f'bundle at {self.root} holds no {component!r} weights')
        return self._jax_leaves(entries) if self.jax_layout else self._port_leaves(entries)

    def _jax_leaves(self, entries) -> Dict[str, torch.Tensor]:
        out = {}
        for ent in entries:
            # copy-on-write: never written, and writable for torch.from_numpy
            arr = np.load(os.path.join(self.root, ent['file']), mmap_mode='c')
            # bfloat16 has no numpy dtype: its bits are stored as uint16
            stored = 'uint16' if ent['dtype'] == 'bfloat16' else ent['dtype']
            if list(arr.shape) != list(ent['shape']) or str(arr.dtype) != stored:
                raise _corrupt(ent['path'], ent['file'], f'{tuple(arr.shape)}/{arr.dtype}',
                               f'{tuple(ent["shape"])}/{ent["dtype"]}')
            if ent['dtype'] == 'bfloat16':
                out[ent['name']] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                out[ent['name']] = torch.from_numpy(arr)
        return out

    def _port_leaves(self, entries) -> Dict[str, torch.Tensor]:
        out, files = {}, {}
        for ent in entries:
            if ent['file'] not in files:
                files[ent['file']] = load_file(os.path.join(self.root, ent['file']))
            t = files[ent['file']].get(ent['key'])
            if (t is None or list(t.shape) != list(ent['shape'])
                    or dtype_name(t.dtype) != ent['dtype']):
                got = 'missing' if t is None else f'{tuple(t.shape)}/{dtype_name(t.dtype)}'
                raise _corrupt(ent['path'], ent['file'], got,
                               f'{tuple(ent["shape"])}/{ent["dtype"]}')
            out[ent['name']] = t
        extra = {k for f in files.values() for k in f} - set(out)
        if extra:
            raise ValueError(f'bundle files {sorted(files)} hold tensors the manifest does not '
                             f'list, e.g. {sorted(extra)[:5]} - the bundle is corrupt; '
                             're-export it')
        return out

    def mismatch_hint(self, expect: Mapping) -> str:
        """The JAX hint: each meta entry where this bundle and the
        extractor (``expect``) differ, or ''."""
        diffs = [f'  {k}: bundle={self.meta.get(k)!r} vs this extractor={v!r}'
                 for k, v in sorted(expect.items()) if self.meta.get(k) != v]
        if not diffs:
            return ''
        return ('\nbundle/extractor configuration differs:\n' + '\n'.join(diffs)
                + '\nconstruct the FeatureExtractor with the settings the bundle was saved '
                  'under')

    def check_dtype(self, expect: Mapping):
        """Refuse a bundle of another serving dtype than ``expect['dtype']``:
        its leaves load as stored, and casting would have to guess which
        float leaves are the intentionally fp32 int8 scales."""
        saved = self.meta.get('dtype')
        if saved != expect['dtype']:
            raise ValueError(f'bundle at {self.root} was exported at dtype={saved!r} but this '
                             f'extractor serves dtype={expect["dtype"]!r}; re-export the bundle '
                             'at the serving dtype' + self.mismatch_hint(expect))


def save_bundle(out_root: str, states: Mapping[str, Mapping[str, torch.Tensor]], *,
                meta: Mapping, src_checkpoint: Optional[str] = None
                ) -> Tuple[str, Dict[str, Tuple[int, float]]]:
    """Write the port's bundle: each component's ``states`` entry (a
    ``state_dict``, on any device) as ``params/<component>.safetensors``,
    ``meta``, and the config.json files, tokenizer, depth and ControlNet
    dirs of ``src_checkpoint``.  All or nothing: it is built in a sibling
    ``<out_root>.partial-<pid>`` dir and renamed on success, and a
    non-empty ``out_root`` is refused (a partial overwrite would mix two
    bundles).  Returns (out_root, {component: (bytes written, seconds)})."""
    out_root = str(out_root)
    if os.path.isdir(out_root) and os.listdir(out_root):
        raise ValueError(f'bundle output dir {out_root} exists and is not empty; delete it first')
    tmp_root = f'{out_root}.partial-{os.getpid()}'
    try:
        stats = _write_bundle(states, tmp_root, meta, src_checkpoint)
        # POSIX rename replaces an existing empty out_root
        os.rename(tmp_root, out_root)
    except BaseException:
        shutil.rmtree(tmp_root, ignore_errors=True)
        raise
    return out_root, stats


def _write_bundle(states, tmp_root, meta, src_checkpoint):
    os.makedirs(os.path.join(tmp_root, 'params'))
    leaves, stats = [], {}
    for comp, state in states.items():
        file = f'params/{comp}.safetensors'
        t0 = time.perf_counter()
        nbytes = save_file(state, os.path.join(tmp_root, file))
        stats[comp] = (nbytes, time.perf_counter() - t0)
        leaves += [{'component': comp, 'key': key, 'path': f'{comp}/{key}', 'file': file,
                    'dtype': dtype_name(t.dtype), 'shape': list(t.shape)}
                   for key, t in state.items()]
    if src_checkpoint:
        for comp in _CONFIG_COMPONENTS:
            cj = os.path.join(src_checkpoint, comp, 'config.json')
            if os.path.isfile(cj):
                os.makedirs(os.path.join(tmp_root, comp), exist_ok=True)
                shutil.copy2(cj, os.path.join(tmp_root, comp, 'config.json'))
        trees = list(_COPY_TREES) + sorted(d for d in os.listdir(src_checkpoint)
                                           if d.startswith('controlnet_'))
        for tree in trees:
            src = os.path.join(src_checkpoint, tree)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(tmp_root, tree))
    manifest = {'format': FORMAT, 'kind': KIND, 'meta': dict(meta), 'leaves': leaves}
    with open(os.path.join(tmp_root, MANIFEST), 'w') as f:
        json.dump(manifest, f, indent=1)
    return stats
