"""Built-in layer configurations.

The reference ships JSON layer configs (feature/configs/*.json: layer-id ->
bool maps, SURVEY §2.2) selecting which activations each published experiment
extracts.  Here the named selections live as Python data — same byte-exact
layer ids — and can be materialized to JSON for CLI use.

Naming: '{model}-{selection}' mirrors the reference file stems
(config_15_practical.json -> '15-practical').

Selections (paper "Not All Diffusion Model Activations ...", reference
README.md:111-141):
  legacy     — conventional up-block upsampler/res outputs (prior-work layers)
  practical  — the paper's recommended discriminative set (Ours)
  amalgamation / amalgamation-small / pg-amalgamation — ablation sets
  full       — every layer (use TapSpec.all() / layer=None instead for the
               complete surface; 'full' here enumerates at runtime)
"""

from __future__ import annotations

import json
import os

BUILTIN_CONFIGS = {
    # reference feature/configs/config_15_practical.json
    '15-practical': (
        'up-level1-repeat1-vit-block0-cross-q',
        'up-level1-repeat2-res-out',
        'up-level2-repeat1-vit-block0-cross-q',
        'up-level3-repeat0-vit-block0-self-k',
    ),
    # reference feature/configs/config_15_legacy.json
    '15-legacy': (
        'up-level0-upsampler-out',
        'up-level1-upsampler-out',
        'up-level2-upsampler-out',
        'up-level3-repeat2-vit-out',
    ),
    # reference feature/configs/config_xl_practical.json
    'xl-practical': (
        'up-level0-repeat0-vit-block7-out',
        'up-level0-repeat0-vit-block5-out',
        'up-level1-repeat0-vit-block0-cross-q',
        'up-level1-repeat0-vit-block0-out',
    ),
    # reference feature/configs/config_xl_legacy.json
    'xl-legacy': (
        'up-level0-upsampler-out',
        'up-level1-upsampler-out',
        'up-level2-repeat2-res-out',
    ),
    # reference feature/configs/config_15_amalgamation(.small).json
    '15-amalgamation': (
        'up-level1-repeat1-vit-block0-cross-q',
        'up-level2-repeat1-vit-block0-cross-q',
        'up-level2-upsampler-out',
        'up-level3-repeat0-vit-block0-self-k',
    ),
    '15-amalgamation-small': (
        'up-level2-repeat1-vit-block0-cross-q',
        'up-level2-upsampler-out',
        'up-level3-repeat0-vit-block0-self-k',
    ),
    # reference feature/configs/config_pg_amalgamation.json
    'pg-amalgamation': (
        'up-level0-repeat0-vit-block3-out',
    ),
    # reference feature/configs/config_figure.json (paper figures)
    'figure': (
        'down-level0-downsampler-out', 'down-level1-downsampler-out',
        'down-level2-repeat1-vit-out', 'up-level0-upsampler-out',
        'up-level1-upsampler-out', 'up-level2-repeat2-vit-out',
        'down-level0-repeat0-res-out', 'down-level1-repeat0-vit-out',
        'down-level2-repeat0-vit-out', 'up-level0-repeat1-vit-out',
        'up-level1-repeat1-vit-out', 'up-level2-repeat1-res-out',
        'mid-vit-out',
        'up-level0-repeat1-vit-block0-out', 'up-level0-repeat1-vit-block2-out',
        'up-level0-repeat1-vit-block4-out', 'up-level0-repeat1-vit-block6-out',
        'up-level0-repeat1-vit-block8-out',
        'up-level0-repeat1-vit-block0-self-k',
        'up-level0-repeat1-vit-block2-self-k',
        'up-level0-repeat1-vit-block4-self-k',
        'up-level0-repeat1-vit-block6-self-k',
        'up-level0-repeat1-vit-block8-self-k',
    ),
}


def _block_taps(prefix, kinds=('self-q', 'self-k', 'self-v', 'cross-q',
                               'ffn-inner', 'out')):
    return tuple(f'{prefix}-{k}' for k in kinds)


def _analysis_15():
    """config_15_analysis.json: every per-block activation kind at every
    SD-1.5 position (reference's paper-analysis sweep) — generated from the
    same structural pattern the file encodes, verified byte-exact in tests."""
    ids = ['unet-in', 'unet-after-conv-in']
    for lvl in range(4):
        for rep in range(2):
            p = f'down-level{lvl}-repeat{rep}'
            ids += [f'{p}-res-increment', f'{p}-res-out']
            if lvl < 3:                       # level 3 is DownBlock2D
                ids += list(_block_taps(f'{p}-vit-block0')) + [f'{p}-vit-out']
        if lvl < 3:
            ids.append(f'down-level{lvl}-downsampler-out')
    for rep in range(2):
        ids += [f'mid-repeat{rep}-res-increment', f'mid-repeat{rep}-res-out']
        if rep == 0:
            ids += list(_block_taps('mid-vit-block0')) + ['mid-vit-out']
    for lvl in range(4):
        for rep in range(3):
            p = f'up-level{lvl}-repeat{rep}'
            ids += [f'{p}-res-increment', f'{p}-res-out']
            if lvl > 0:                       # level 0 is UpBlock2D
                ids += list(_block_taps(f'{p}-vit-block0')) + [f'{p}-vit-out']
        if lvl < 3:
            ids.append(f'up-level{lvl}-upsampler-out')
    return tuple(ids)


def _analysis_xl():
    """config_xl_analysis(.2).json (the two reference files are identical):
    SDXL up-path sweep — level0 depth-10 stacks at blocks {0,1,3,5,7,9},
    level1 blocks {0,1}, level2 resnets only.  Per block: self-q/k, cross-q,
    ffn-inner, out (no self-v)."""
    kinds = ('self-q', 'self-k', 'cross-q', 'ffn-inner', 'out')
    ids = []
    for lvl, blocks in ((0, (0, 1, 3, 5, 7, 9)), (1, (0, 1)), (2, ())):
        for rep in range(3):
            p = f'up-level{lvl}-repeat{rep}'
            ids += [f'{p}-res-increment', f'{p}-res-out']
            for blk in blocks:
                ids += list(_block_taps(f'{p}-vit-block{blk}', kinds))
            if blocks:
                ids.append(f'{p}-vit-out')
        if lvl < 2:
            ids.append(f'up-level{lvl}-upsampler-out')
    return tuple(ids)


BUILTIN_CONFIGS['15-analysis'] = _analysis_15()
BUILTIN_CONFIGS['xl-analysis'] = _analysis_xl()
BUILTIN_CONFIGS['xl-analysis2'] = BUILTIN_CONFIGS['xl-analysis']


def get_builtin_config(name: str) -> dict:
    """'xl-practical' -> {layer-id: True, ...} (FeatureExtractor layer arg)."""
    if name not in BUILTIN_CONFIGS:
        raise KeyError(f'unknown config {name!r}; known: '
                       f'{sorted(BUILTIN_CONFIGS)}')
    return {k: True for k in BUILTIN_CONFIGS[name]}


def resolve_layer_config(layer):
    """CLI-facing resolver: a builtin name, a JSON path, a dict, or None."""
    if isinstance(layer, str) and layer in BUILTIN_CONFIGS:
        return get_builtin_config(layer)
    return layer


def write_config_json(name: str, path: str):
    with open(path, 'w') as f:
        json.dump(get_builtin_config(name), f, indent=1)


def edit_config(path: str, updates: dict, out_path: str = None):
    """Batch-edit a layer config (reference feature/configs/edit_config.py)."""
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(updates)
    with open(out_path or path, 'w') as f:
        json.dump(cfg, f, indent=1)
    return cfg
