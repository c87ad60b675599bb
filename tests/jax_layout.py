"""A deployment bundle in the JAX package's layout, written with numpy from
a port extractor's modules, for tests that cannot import JAX
(tests/test_torch_cuda.py runs where flax is missing).

Each state_dict tensor goes back through the inverse of the transposes
``models/convert.py`` applies to a JAX leaf (Linear (O, I) -> Dense
(I, O), OIHW -> HWIO, ``weight_q`` (O, I) -> ``kernel_q`` (I, O)) under
the flat JAX name the loader resolves it to, one ``params/NNNNNN.npy`` per
leaf with bfloat16 stored as uint16, beside a manifest of the JAX
package's kind.  tests/test_torch_bundle.py holds the leaves it writes to
those of a bundle the JAX package writes.
"""

import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from diffusion_feature_tpu_torch.io.bundle import FORMAT, JAX_KIND, MANIFEST, dtype_name
from diffusion_feature_tpu_torch.models.convert import _normalize_key, text_jax_name
from diffusion_feature_tpu_torch.models.t5 import T5LayerNorm

TEXT_DIRS = ('text_encoder', 'text_encoder_2')


def jax_leaves(module: nn.Module) -> dict:
    """{flat JAX name: tensor in the JAX layout} of ``module``'s state."""
    jax_name = text_jax_name(module)
    out = {}
    for key, t in module.state_dict().items():
        base, _, leaf = (jax_name(key) if jax_name else key).rpartition('.')
        owner = module.get_submodule(key.rpartition('.')[0])
        if leaf == 'weight_q':
            leaf, t = 'kernel_q', t.T
        elif leaf == 'weight' and isinstance(owner, nn.Linear):
            leaf, t = 'kernel', t.T
        elif leaf == 'weight' and isinstance(owner, nn.ConvTranspose2d):
            leaf, t = 'kernel', t.permute(2, 3, 0, 1)
        elif leaf == 'weight' and isinstance(owner, nn.Conv2d):
            leaf, t = 'kernel', t.permute(2, 3, 1, 0)
        elif leaf == 'weight' and isinstance(owner, nn.Embedding):
            leaf = 'embedding'
        elif leaf == 'weight' and t.dim() == 1 and not isinstance(owner, T5LayerNorm):
            leaf = 'scale'      # JAX's norms, but its T5 layer norm keeps 'weight'
        norm = _normalize_key(base)
        out[f'{norm}_{leaf}' if norm else leaf] = t.contiguous()
    return out


def write_jax_bundle(fe, root: str, src_checkpoint: str) -> str:
    """Write ``fe``'s denoiser, VAE and text encoders to ``root`` as the
    JAX package's ``save_converted`` lays a bundle out; returns ``root``."""
    trees = [(['unet'], fe.unet)] + ([(['vae'], fe.vae)] if fe.vae is not None else [])
    trees += [(['text', i], te) for i, te in enumerate(fe.text_encoders)]
    os.makedirs(os.path.join(root, 'params'))
    leaves = []
    for prefix, module in trees:
        for name, t in jax_leaves(module).items():
            file = f'params/{len(leaves):06d}.npy'
            arr = (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
                   else t.numpy())
            np.save(os.path.join(root, file), arr)
            path = ''.join(f'[{k}]' if isinstance(k, int) else f"['{k}']" for k in prefix + [name])
            leaves.append({'file': file, 'path': path, 'dtype': dtype_name(t.dtype),
                           'shape': list(t.shape)})
    for comp in ('unet', 'transformer', 'vae', *TEXT_DIRS):
        cfg = os.path.join(src_checkpoint, comp, 'config.json')
        if os.path.isfile(cfg):
            os.makedirs(os.path.join(root, comp))
            shutil.copy2(cfg, os.path.join(root, comp, 'config.json'))
    for tree in ('tokenizer', 'tokenizer_2'):
        if os.path.isdir(os.path.join(src_checkpoint, tree)):
            shutil.copytree(os.path.join(src_checkpoint, tree), os.path.join(root, tree))
    with open(os.path.join(root, MANIFEST), 'w') as f:
        json.dump({'format': FORMAT, 'kind': JAX_KIND, 'meta': fe._bundle_meta(),
                   'leaves': leaves}, f)
    return root
