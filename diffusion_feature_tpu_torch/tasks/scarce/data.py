"""Dataset settings + split handling for the label-scarce task (a copy of
the JAX package's ``tasks/scarce/data.py``: numpy and PIL only).

Reference: scarce_segmentation/segmentation/data_util.py (per-dataset
settings; Horse-21: 21 classes / 10 ensemble members / 256x256, :65-75) and
datasets.py ``shuffle_split`` (:45-58).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, List, Tuple

import numpy as np

def _setting(number_class: int) -> dict:
    """Shared scaffold: every reference dataset uses 10 ensemble members,
    30-epoch cap, 50/650 train/test split sizes, 256^2 bilinear upsampling,
    8448-dim aggregated features (data_util.py:30-100)."""
    return dict(number_class=number_class, ignore_label=255, model_num=10,
                max_training=30, upsample_mode='bilinear',
                training_number=50, testing_number=650, dim=[256, 256, 8448])


# all 6 reference dataset settings (data_util.py get_dataset_setting);
# NOTE bedroom_28 really has 29 classes in the reference — keep the quirk
DATASET_SETTINGS: Dict[str, dict] = {
    'ffhq_34': _setting(34),
    'bedroom_28': _setting(29),
    'cat_15': _setting(15),
    'horse_21': _setting(21),
    'ade_bedroom_30': _setting(30),
    'celeba_19': _setting(19),
}
DATASET_SETTINGS['face_34'] = DATASET_SETTINGS['ffhq_34']  # round-1 alias


def get_dataset_setting(category: str) -> dict:
    if category not in DATASET_SETTINGS:
        raise KeyError(f'unknown dataset {category!r}; known: '
                       f'{sorted(DATASET_SETTINGS)}')
    return dict(DATASET_SETTINGS[category])


def shuffle_split(image_paths: List[str], label_paths: List[str],
                  train_num: int, seed: int = 0):
    """Random train/test reshuffle (reference datasets.py:45-58)."""
    order = list(range(len(image_paths)))
    random.Random(seed).shuffle(order)
    tr = order[:train_num]
    te = order[train_num:]
    return ([image_paths[i] for i in tr], [label_paths[i] for i in tr],
            [image_paths[i] for i in te], [label_paths[i] for i in te])


def list_feature_label_pairs(feature_dir: str, label_dir: str
                             ) -> Tuple[List[str], List[str]]:
    """Match dumped .npy features with label images by stem."""
    feats = sorted(glob.glob(os.path.join(feature_dir, '*.npy')))
    pairs_f, pairs_l = [], []
    for f in feats:
        stem = os.path.splitext(os.path.basename(f))[0]
        for ext in ('.png', '.npy', '.bmp', '.jpg'):
            cand = os.path.join(label_dir, stem + ext)
            if os.path.exists(cand):
                pairs_f.append(f)
                pairs_l.append(cand)
                break
    return pairs_f, pairs_l


def get_palette(category) -> np.ndarray:
    """(num_classes, 3) uint8 palette.  Given a dataset name, returns the
    reference's hand-picked palette (data_util.py get_palette); given an
    integer class count, falls back to a deterministic HSV wheel (used by
    tests / unknown datasets)."""
    if isinstance(category, str):
        from .palettes import PALETTES
        if category == 'face_34':            # round-1 alias
            category = 'ffhq_34'
        return PALETTES[category].copy()
    num_classes = int(category)
    import colorsys
    cols = [(0, 0, 0)]
    for i in range(1, num_classes):
        r, g, b = colorsys.hsv_to_rgb((i - 1) / max(num_classes - 1, 1),
                                      0.85, 0.95)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return np.asarray(cols, np.uint8)


def get_class_names(category: str) -> List[str]:
    """Per-dataset class-name list (reference data_util.py get_class_names)."""
    from .palettes import CLASS_NAMES
    if category == 'face_34':
        category = 'ffhq_34'
    return list(CLASS_NAMES[category])


def colorize_mask(mask: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 (reference utils.colorize_mask)."""
    mask = np.asarray(mask, np.int64)
    safe = np.clip(mask, 0, len(palette) - 1)
    return palette[safe]


def save_predictions(preds, out_dir: str, category, names=None):
    """Write raw + colorized prediction PNGs (reference
    pixel_classifier.save_predictions); ``category`` is the dataset name so
    the hand-picked per-dataset palette colors the visualizations exactly
    like the reference (get_palette(args['category']),
    pixel_classifier.py:111) — an int falls back to the HSV wheel."""
    import os
    from PIL import Image
    os.makedirs(os.path.join(out_dir, 'predictions'), exist_ok=True)
    os.makedirs(os.path.join(out_dir, 'visualizations'), exist_ok=True)
    palette = get_palette(category)
    paths = []
    for i, pred in enumerate(preds):
        name = names[i] if names else f'pred_{i}'
        p = np.asarray(pred, np.uint8)
        Image.fromarray(p).save(
            os.path.join(out_dir, 'predictions', f'{name}.png'))
        Image.fromarray(colorize_mask(p, palette)).save(
            os.path.join(out_dir, 'visualizations', f'{name}.png'))
        paths.append(name)
    return paths


def load_label(path: str, size) -> np.ndarray:
    if path.endswith('.npy'):
        lab = np.load(path)
    else:
        from PIL import Image
        lab = np.asarray(Image.open(path))
        if lab.ndim == 3:
            lab = lab[..., 0]
    if lab.shape != tuple(size):
        from PIL import Image
        lab = np.asarray(Image.fromarray(lab.astype(np.uint8)).resize(
            (size[1], size[0]), Image.NEAREST))
    return lab.astype(np.int32)
