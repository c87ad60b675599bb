#!/usr/bin/env python
"""SPair-71k semantic correspondence trainer (port of the root
``task_corres.py``):

    python -m diffusion_feature_tpu_torch.task_corres --config corres_configs/config_sdxl.json \\
        --train_anns train.json --val_anns val.json --dataset_path SPair-71k/JPEGImages

Trains the aggregation head with a CLIP-style symmetric cross-entropy over
cosine similarities and validates with PCK@0.1 (image- and bbox-relative),
the reference's task-corres.py flow: per annotation pair, frozen diffusion
features of both images, the bidirectional CE between the annotated
source/target points (:70-80), AdamW(5e-4, wd 0.01) on the aggregation
conv (logit_scale stays fixed, reference :25), validation every
``--val_every`` steps (:94-141) with a checkpoint of {step, config,
params, opt_state} (:83-91; ``torch.save`` of the state dicts).

``torch.optim.AdamW(lr, weight_decay=0.01, eps=1e-8)`` is optax's
``adamw``: p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).  The
annotation draws come from ``random.Random(seed)``, the JAX CLI's
sequence; ``--load_weight`` resumes from a checkpoint.  ``--device``
(default cuda) places the extractors and the head.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch
import torch.nn.functional as F

from .tasks.correspondence import (
    AggregationNetwork, compute_pck, find_nn_source_correspondences, load_annotation,
    points_to_idxs, rescale_points,
)
from .tasks.correspondence.utils import flatten_feats, normalize_feats

OUTPUT_SIZE = (128, 128)   # reference get_rescale_size: (128,128), (512,512)
LOAD_SIZE = (512, 512)


def clip_loss(net: AggregationNetwork, f_src: torch.Tensor, f_tgt: torch.Tensor,
              source_idx: torch.Tensor, target_idx: torch.Tensor) -> torch.Tensor:
    """Bidirectional CLIP CE (reference compute_clip_loss :70-80) over the
    flat point indices ``source_idx``/``target_idx`` (points_to_idxs).  Only
    the annotated rows of the two similarity matrices are formed: the same
    value as the JAX loss, which forms the whole (h*w)^2 matrices (1 GiB
    each in fp32 at 128^2) and then picks those rows."""
    img1 = flatten_feats(net(f_src))[0]
    img2 = flatten_feats(net(f_tgt))[0]
    # fixed CLIP temperature (reference keeps it out of the optimizer)
    scale = float(np.exp(np.float32(net.logit_scale)))
    n1, n2 = normalize_feats(img1), normalize_feats(img2)
    source_logits = scale * (n1[source_idx] @ n2.t())
    target_logits = scale * (n2[target_idx] @ n1.t())
    return (F.cross_entropy(source_logits, target_idx)
            + F.cross_entropy(target_logits, source_idx)) / 2


@torch.no_grad()
def validate(net: AggregationNetwork, val_anns, image_path):
    """(mean PCK@0.1 against the target image's size, against its bbox)
    over the annotated points of ``val_anns``."""
    pck_img_all, pck_bbox_all = [], []
    for ann in val_anns:
        sp, tp, src, tgt, _ = load_annotation(ann, LOAD_SIZE, image_path)
        f_src = net(net.extract(os.path.join(image_path, src)))
        f_tgt = net(net.extract(os.path.join(image_path, tgt)))
        _, pred = find_nn_source_correspondences(f_src, f_tgt, sp, OUTPUT_SIZE, LOAD_SIZE)
        pred = pred.cpu().numpy().astype(np.float64)
        target_size = ann['target_size']
        pred = rescale_points(pred, LOAD_SIZE, target_size)
        tp_orig = rescale_points(tp, LOAD_SIZE, target_size)
        _, pck_img, _ = compute_pck(pred, tp_orig, target_size)
        _, pck_bbox, _ = compute_pck(pred, tp_orig, target_size,
                                     target_bounding_box=ann.get('target_bounding_box'))
        pck_img_all.append(pck_img)
        pck_bbox_all.append(pck_bbox)
    pck_img = np.concatenate(pck_img_all)
    pck_bbox = np.concatenate(pck_bbox_all)
    return float(pck_img.mean()), float(pck_bbox.mean())


def save_checkpoint(path, step, config, net, opt):
    torch.save({'step': step, 'config': config, 'params': net.state_dict(),
                'opt_state': opt.state_dict()}, path)


def make_optimizer(net: AggregationNetwork, lr: float) -> torch.optim.AdamW:
    """optax's ``adamw(lr, weight_decay=0.01)`` on the head's parameters
    (the reference task-corres.py optimizer: AdamW(5e-4, weight_decay=0.01))."""
    return torch.optim.AdamW(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    parser.add_argument('--config', type=str, required=True,
                        help='task config json: list of extractor configs '
                             "({feature_len, layer, version, attention, "
                             "img_size, t})")
    parser.add_argument('--train_anns', type=str, required=True)
    parser.add_argument('--val_anns', type=str, required=True)
    parser.add_argument('--dataset_path', type=str, default='')
    parser.add_argument('--task_path', type=str, default='./corres_out')
    parser.add_argument('--lr', type=float, default=5e-4)
    parser.add_argument('--max_steps', type=int, default=5000)
    parser.add_argument('--val_every', type=int, default=500)
    parser.add_argument('--weights', type=str, default=None)
    parser.add_argument('--load_weight', type=str, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def main(argv=None):
    """Train; returns {'net', 'optimizer', 'losses': [float per step],
    'step_seconds': [host seconds per step, from loading its pair to its
    loss on the host], 'pck': [(step, pck_img, pck_bbox), ...],
    'val_seconds': [seconds per validation pass], 'start_step'}."""
    args = build_parser().parse_args(argv)
    os.makedirs(args.task_path, exist_ok=True)
    # print + flat-file logger (reference task-corres.py:26-31)
    logf = open(os.path.join(args.task_path, 'log.txt'), 'a')

    def log(s):
        print(s)
        logf.write(s + '\n')
        logf.flush()

    with open(args.config) as f:
        configs = json.load(f)
    if isinstance(configs, dict):
        configs = [configs]

    net = AggregationNetwork(configs, weights=args.weights, seed=args.seed, device=args.device)
    opt = make_optimizer(net, args.lr)
    start_step = 0
    if args.load_weight:
        ckpt = torch.load(args.load_weight, map_location=net.device, weights_only=True)
        net.load_state_dict(ckpt['params'])
        opt.load_state_dict(ckpt['opt_state'])
        start_step = ckpt['step']

    with open(args.train_anns) as f:
        train_anns = json.load(f)
    with open(args.val_anns) as f:
        val_anns = json.load(f)

    result = {'net': net, 'optimizer': opt, 'losses': [], 'step_seconds': [], 'pck': [],
              'val_seconds': [], 'start_step': start_step}
    rng = random.Random(args.seed)
    try:
        for step in range(start_step, args.max_steps):
            t0 = time.perf_counter()
            ann = train_anns[rng.randrange(len(train_anns))]
            sp, tp, src, tgt, _ = load_annotation(ann, LOAD_SIZE, args.dataset_path)
            sp_out = rescale_points(sp, LOAD_SIZE, OUTPUT_SIZE)
            tp_out = rescale_points(tp, LOAD_SIZE, OUTPUT_SIZE)
            src_idx = torch.as_tensor(points_to_idxs(sp_out, OUTPUT_SIZE), dtype=torch.long,
                                      device=net.device)
            tgt_idx = torch.as_tensor(points_to_idxs(tp_out, OUTPUT_SIZE), dtype=torch.long,
                                      device=net.device)
            f_src = net.extract(os.path.join(args.dataset_path, src))
            f_tgt = net.extract(os.path.join(args.dataset_path, tgt))
            opt.zero_grad(set_to_none=True)
            loss = clip_loss(net, f_src, f_tgt, src_idx, tgt_idx)
            loss.backward()
            opt.step()
            result['losses'].append(float(loss.detach()))
            result['step_seconds'].append(time.perf_counter() - t0)
            if step % 50 == 0:
                log(f'step {step}: loss {result["losses"][-1]:.4f}')
            if (step + 1) % args.val_every == 0:
                t0 = time.perf_counter()
                pck_img, pck_bbox = validate(net, val_anns, args.dataset_path)
                result['val_seconds'].append(time.perf_counter() - t0)
                result['pck'].append((step + 1, pck_img, pck_bbox))
                log(f'val/pck_img: {pck_img:.4f}  val/pck_bbox: {pck_bbox:.4f}')
                save_checkpoint(os.path.join(args.task_path, f'checkpoint_step_{step + 1}.pt'),
                                step + 1, configs, net, opt)
    finally:
        logf.close()
    return result


if __name__ == '__main__':
    main()
