#!/usr/bin/env python
"""Label-scarce pixel classification over dumped diffusion features (port of
the root ``task_pixel.py``):

    python -m diffusion_feature_tpu_torch.task_pixel --category horse_21 \\
        --feature_dir feats/ --label_dir labels/ --exp_dir pixel_out/

The reference's scarce_segmentation/task-pixel.py: load pre-dumped
aggregated features (one .npy per image, from ``extract_feature
--aggregate_output``) through the native reader pool, resize them
bilinearly to the dataset's working resolution on the device, flatten to
per-pixel rows, train an ensemble of MLP classifiers with early stopping
(a member whose checkpoint exists is loaded, not trained), evaluate with
majority vote + JS uncertainty and per-class IoU -> mIoU, and write the
predictions and their colourised visualisations.

The training matrix (the labelled pixels of the training images, one row
of the dump's width each, fp32) sits on ``--device`` (default cuda) and is
indexed there when it fits beside room for a few images' rows: Horse-21's
published setting (30 images of 256^2, 8448 channels) makes it 66 GB.  A
larger one (the settings' 50 training images: 111 GB) stays in host
memory, and each batch is copied to the device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .native import AsyncNpyReader
from .ops.resize import interpolate_bilinear_nchw
from .tasks.scarce import compute_iou, get_dataset_setting, predict_labels, shuffle_split
from .tasks.scarce.data import list_feature_label_pairs, load_label, save_predictions
from .tasks.scarce.pixel_classifier import PixelClassifier, train_one


def _to_rows(feat: np.ndarray, size, device='cpu') -> torch.Tensor:
    """(C, H, W) (or (1, C, H, W)) array -> (H*W, C) fp32 rows at the
    working resolution, on ``device``."""
    f = torch.from_numpy(np.ascontiguousarray(feat)).to(device).float()
    if f.dim() == 4:
        f = f[0]
    f = interpolate_bilinear_nchw(f[None], tuple(size))[0]
    return f.reshape(f.shape[0], -1).t().contiguous()


def load_features(paths, size, device='cpu'):
    """Prefetch all dumps through the native reader pool (npyio.cpp): file
    IO overlaps with the resize and flatten of the previous file."""
    reader = AsyncNpyReader(n_threads=4)
    try:
        for feat in reader.read_all(paths):
            yield _to_rows(feat, size, device)
    finally:
        reader.close()


def _device_room(device: torch.device) -> float:
    """Bytes free on ``device`` for the training matrix (the host's memory
    is not counted: a matrix that does not fit the card goes there)."""
    if device.type == 'cuda':
        return torch.cuda.mem_get_info(device)[0]
    return float('inf')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    parser.add_argument('--category', type=str, default='horse_21')
    parser.add_argument('--feature_dir', type=str, required=True)
    parser.add_argument('--label_dir', type=str, required=True)
    parser.add_argument('--exp_dir', type=str, default='./pixel_out')
    parser.add_argument('--train_num', type=int, default=30)
    parser.add_argument('--model_num', type=int, default=None)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--max_epochs', type=int, default=100)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def main(argv=None):
    """Train (or load) the ensemble and evaluate it; returns {'ensemble',
    'ious', 'miou', 'uncertainties': [per test image], 'trained': [member
    ids trained in this run], 'member_seconds': [per trained member],
    'rows': training rows, 'matrix_on_host': whether the training matrix
    stayed in host memory, 'predict_seconds': [per test image], 'names'}."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    setting = get_dataset_setting(args.category)
    if args.model_num is not None:
        setting['model_num'] = args.model_num
    size = setting['dim'][:2]
    ncls = setting['number_class']
    os.makedirs(args.exp_dir, exist_ok=True)

    feats, labels = list_feature_label_pairs(args.feature_dir, args.label_dir)
    if not feats:
        print('no feature/label pairs found', file=sys.stderr)
        sys.exit(1)
    tr_f, tr_l, te_f, te_l = shuffle_split(feats, labels, args.train_num, seed=args.seed)
    print(f'{len(tr_f)} train / {len(te_f)} test images')
    result = {'trained': [], 'member_seconds': [], 'rows': 0, 'matrix_on_host': False,
              'predict_seconds': []}

    # build the pixel matrix lazily: skipped entirely when every ensemble
    # member checkpoint already exists
    X = y = None

    def training_matrix():
        """The labelled rows of every training image, written into one
        matrix as each dump arrives (no second copy of it): on the device
        if it fits there with room for four images' rows (the dump being
        resized, the test image being predicted), else on the host."""
        nonlocal X, y
        if X is None:
            labels = [load_label(p, size).ravel() for p in tr_l]
            keeps = [lab != setting['ignore_label'] for lab in labels]
            n_rows = sum(int(k.sum()) for k in keeps)
            start = 0
            for rows, keep in zip(load_features(tr_f, size, device), keeps):
                if X is None:
                    row_bytes = rows.shape[1] * 4
                    fits = (n_rows + 4 * rows.shape[0]) * row_bytes <= _device_room(device)
                    X = torch.empty((n_rows, rows.shape[1]), device=device if fits else 'cpu')
                    result['matrix_on_host'] = not fits
                n = int(keep.sum())
                X[start:start + n] = rows[torch.from_numpy(keep).to(device)].to(X.device)
                start += n
            y = torch.from_numpy(np.concatenate([lab[k] for lab, k in zip(labels, keeps)]))
            y = y.to(X.device)
            result['rows'] = len(X)
            print(f'{len(X)} training pixels, dim {X.shape[1]}, on {X.device}')
        return X, y

    # train (skipping already-trained members, reference :173-178)
    ensemble = []
    for i in range(setting['model_num']):
        ckpt = os.path.join(args.exp_dir, f'model_{i}.pt')
        if os.path.exists(ckpt):
            state = torch.load(ckpt, map_location=device, weights_only=True)
            ensemble.append(PixelClassifier.from_state_dict(state, device).eval())
            print(f'model {i}: loaded existing checkpoint')
            continue
        X, y = training_matrix()
        t0 = time.perf_counter()
        member = train_one(X, y, ncls, seed=args.seed * 1000 + i, batch_size=args.batch_size,
                           max_epochs=args.max_epochs, device=device)
        torch.save(member.state_dict(), ckpt)     # waits for the device
        result['member_seconds'].append(time.perf_counter() - t0)
        result['trained'].append(i)
        ensemble.append(member)
        print(f'model {i}: trained + saved')

    # evaluate (features prefetched by the native reader pool)
    preds, gts, uncertainties = [], [], []
    for rows, path in zip(load_features(te_f, size, device), te_l):
        t0 = time.perf_counter()
        pred, u = predict_labels(ensemble, rows, tuple(size), ncls)
        result['predict_seconds'].append(time.perf_counter() - t0)
        preds.append(pred)
        gts.append(load_label(path, size))
        uncertainties.append(u)
    names = [os.path.splitext(os.path.basename(f))[0] for f in te_f]
    save_predictions(preds, args.exp_dir, args.category, names)
    ious, miou = compute_iou(preds, gts, ncls, ignore_label=setting['ignore_label'])
    print('per-class IoU:', {k: round(v, 4) for k, v in ious.items()})
    print('Overall mIoU:', round(miou, 4))
    print('Mean uncertainty:', round(float(np.mean(uncertainties)), 4))
    result.update(ensemble=ensemble, ious=ious, miou=miou, uncertainties=uncertainties,
                  names=names)
    return result


if __name__ == '__main__':
    main()
