#!/usr/bin/env python
"""Full-label segmentation trainer (port of the root ``train_segmentation.py``).

    python -m diffusion_feature_tpu_torch.train_segmentation --config seg_configs/ade_sdxl.json \\
        --train_img_dir imgs/ --train_label_dir labels/ [--val_img_dir ... --val_label_dir ...]

Replaces the reference's mmengine Runner + mmseg plugin
(segmentation/train.py + models/diffusion_segmentor.py): AdamW lr=1.6e-4
wd=0.001 under PolyLR power=0.9 eta_min=1e-4 over ``--max_iters``
(reference _base_/schedules/schedule_80k.py), a val mIoU with
sliding-window inference every ``--val_every`` and at the end, a
checkpoint (``torch.save``) with each, ``--resume`` and ``--eval_only``.

The optimiser is the JAX trainer's ``optax.adamw(polynomial_schedule(lr,
1e-4, 0.9, max_iters), weight_decay)``: betas (0.9, 0.999), eps 1e-8,
decay decoupled, on every parameter and scaled by the schedule's rate,
the rate of step i (from 0) (lr - 1e-4) * (1 - min(i, max_iters) /
max_iters)^0.9 + 1e-4.  ``torch.optim.AdamW`` with that weight decay and a
``LambdaLR`` of that rate computes the same update (p -= rate * (m_hat /
(sqrt(v_hat) + eps) + wd * p)).

Data: directories of images and integer label maps (.png or .npy)
matched by stem; inputs normalised to [-1, 1] (mean/std 127.5, reference
ade_sdxl.py:8-15); training pairs go through RandomResize 0.5-2.0, a flip,
the photometric distortion, padding with 255 and a random crop of
``--crop_size``; evaluation keeps the full image for slide inference.

Config: the JSON of ``seg_configs/`` ({"diffusion_feature": {...},
"feature_layers": [[["layer", C], ...], ...], "num_classes": 150, ...}).
``--device`` (default cuda) places the extractor and the head.

``--dp N`` (N must divide ``--batch_size``) runs one process per rank:
``torchrun --nproc_per_node N -m diffusion_feature_tpu_torch.train_segmentation
--dp N ...`` (each process on ``cuda:<LOCAL_RANK>`` when ``--device cuda``;
NCCL there, gloo on the CPU), or processes that joined a group of the
caller's backend before calling ``main``.
Every rank draws the whole batch's pairs and augmentations from the same
``random.Random(seed)`` and decodes only its rows; the segmentor takes
the whole batch's BatchNorm statistics, dropout and loss
(``tasks/segmentation/segmentor.py``), the gradients are averaged over the
ranks, and rank 0 writes the checkpoints and the log, so a step equals
the one-device step on the whole batch.  Evaluation runs whole on every
rank, as in the JAX trainer.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import time

import numpy as np
import torch

from .parallel.mesh import init_launched, make_mesh
from .tasks.scarce import compute_iou
from .tasks.segmentation import DiffusionSegmentor

#: PolyLR's floor (schedule_80k.py:6-13)
ETA_MIN = 1e-4
POLY_POWER = 0.9


def list_pairs(img_dir, label_dir):
    """(image path, label path) of every image in ``img_dir`` whose stem
    has a .png or .npy label in ``label_dir``, sorted by image path."""
    imgs = sorted(p for p in glob.glob(os.path.join(img_dir, '*'))
                  if os.path.splitext(p)[1].lower() in ('.jpg', '.jpeg', '.png', '.bmp'))
    pairs = []
    for p in imgs:
        stem = os.path.splitext(os.path.basename(p))[0]
        for ext in ('.png', '.npy'):
            lp = os.path.join(label_dir, stem + ext)
            if os.path.exists(lp):
                pairs.append((p, lp))
                break
    return pairs


def _train_draws(size, crop, rng: random.Random) -> dict:
    """The random draws of one training pair of an image of ``size`` (w, h),
    in the JAX trainer's order: RandomResize's scale, the flip, the
    photometric distortion's (brightness +-32 and contrast 0.5-1.5, each
    with p=0.5; None where skipped), the crop's corner."""
    ch, cw = crop
    scale = rng.uniform(0.5, 2.0)
    nw, nh = max(cw, int(round(size[0] * scale))), max(ch, int(round(size[1] * scale)))
    flip = rng.random() < 0.5
    brightness = rng.uniform(-32, 32) if rng.random() < 0.5 else None
    contrast = rng.uniform(0.5, 1.5) if rng.random() < 0.5 else None
    return {'size': (nw, nh), 'flip': flip, 'brightness': brightness, 'contrast': contrast,
            'y': rng.randrange(nh - ch + 1), 'x': rng.randrange(nw - cw + 1)}


def load_pair(img_path, label_path, crop, rng: random.Random, train: bool = True,
              reduce_zero_label: bool = False, decode: bool = True):
    """(image (3, H, W) float32 in [-1, 1], labels (H, W) int32).  With
    ``train``: RandomResize 0.5-2.0 (ADE20K's pipeline), a flip with p=0.5,
    the photometric distortion (PhotoMetricDistortion's essentials, on
    uint8 values), padding (labels with 255) to ``crop`` and a random crop;
    without, the full image, padded to ``crop`` at least.
    ``reduce_zero_label``: ADE20K's 0 (unlabelled) becomes 255 and classes
    1..N become 0..N-1.  Draws from ``rng`` in the JAX trainer's order;
    ``decode=False`` makes the same draws from the image's size alone and
    returns None (a dp rank's pair of another rank)."""
    from PIL import Image
    pil = Image.open(img_path)
    draws = _train_draws(pil.size, crop, rng) if train else None
    if not decode:
        return None
    pil = pil.convert('RGB')
    if label_path.endswith('.npy'):
        lab = np.load(label_path)
    else:
        lab = np.asarray(Image.open(label_path))
        if lab.ndim == 3:
            lab = lab[..., 0]
    lab = lab.astype(np.int32)
    if reduce_zero_label:
        lab = np.where(lab == 0, 255, lab - 1)
    ch, cw = crop
    if train:
        nw, nh = draws['size']
        pil = pil.resize((nw, nh), Image.BILINEAR)
        lab = np.asarray(Image.fromarray(lab.astype(np.uint16)).resize((nw, nh), Image.NEAREST),
                         dtype=np.int32)
        if draws['flip']:
            pil = pil.transpose(Image.FLIP_LEFT_RIGHT)
            lab = lab[:, ::-1]
    img = np.asarray(pil)
    if train:
        img = img.astype(np.float32)
        if draws['brightness'] is not None:
            img = img + draws['brightness']
        if draws['contrast'] is not None:
            img = img * draws['contrast']
        img = np.clip(img, 0, 255)
    H, W = img.shape[:2]
    if H < ch or W < cw:
        pad_h, pad_w = max(0, ch - H), max(0, cw - W)
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)))
        lab = np.pad(lab, ((0, pad_h), (0, pad_w)), constant_values=255)
    if train:
        y, x = draws['y'], draws['x']
        img = img[y:y + ch, x:x + cw]
        lab = lab[y:y + ch, x:x + cw]
    img = (img.astype(np.float32) - 127.5) / 127.5
    return np.ascontiguousarray(img.transpose(2, 0, 1)), lab.astype(np.int32)


def poly_rate(step: int, lr: float, max_iters: int) -> float:
    """optax ``polynomial_schedule(lr, ETA_MIN, POLY_POWER, max_iters)`` at
    ``step`` (from 0)."""
    frac = 1.0 - min(max(step, 0), max_iters) / max_iters
    return (lr - ETA_MIN) * frac ** POLY_POWER + ETA_MIN


def make_optimizer(params, lr: float, weight_decay: float, max_iters: int):
    """(optimizer, scheduler): optax's adamw under the poly schedule, as the
    module docstring derives; call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    opt = torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: poly_rate(step, lr, max_iters) / lr)
    return opt, sched


def segmentor_from_config(cfg: dict, weights=None, seed: int = 0,
                          device='cuda', mesh=None) -> DiffusionSegmentor:
    """The segmentor of a ``seg_configs/`` JSON's content (one extractor,
    or the ensemble's list with feature layers per model); ``mesh`` a dp
    mesh."""
    if isinstance(cfg['diffusion_feature'], list):   # the multi-model ensemble
        feature_layers = [[[(lid, int(c)) for lid, c in lvl] for lvl in mfl]
                          for mfl in cfg['feature_layers']]
    else:
        feature_layers = [[(lid, int(c)) for lid, c in lvl] for lvl in cfg['feature_layers']]
    return DiffusionSegmentor(
        diffusion_feature=cfg['diffusion_feature'], feature_layers=feature_layers,
        num_classes=cfg.get('num_classes', 150), head_channels=cfg.get('head_channels', 512),
        pool_scales=cfg.get('pool_scales', (1, 2)), prompt=cfg.get('prompt', ''),
        prompt_tuning=cfg.get('prompt_tuning', False), weights=weights, seed=seed,
        device=device, mesh=mesh)


#: the most gradient elements flattened into one all-reduce (256 MiB fp32)
GRAD_BUCKET = 1 << 26


def average_gradients(params, dp) -> None:
    """Each parameter's gradient replaced by its mean over the ``dp``
    ranks, through one all-reduce per bucket of at most GRAD_BUCKET
    elements flattened together (a collective per tensor would pay its
    latency hundreds of times a step)."""
    grads = [p.grad for p in params if p.grad is not None]
    while grads:
        take, n = 1, grads[0].numel()
        while take < len(grads) and n + grads[take].numel() <= GRAD_BUCKET:
            n += grads[take].numel()
            take += 1
        part, grads = grads[:take], grads[take:]
        flat = dp.all_reduce(torch.cat([g.reshape(-1) for g in part])).div_(dp.size)
        for g, piece in zip(part, flat.split([g.numel() for g in part])):
            g.copy_(piece.view_as(g))


def train_step(seg, opt, sched, images, labels, generator=None):
    """One optimiser step on a batch already on the device: the loss (with
    dropout from ``generator``), its backward, AdamW, the schedule.  Under
    dp (``seg.dp``) ``images`` and ``labels`` are this rank's rows and the
    gradients are averaged over the ranks first.  Returns (loss, parts) as
    tensors."""
    opt.zero_grad(set_to_none=True)
    loss, parts = seg.loss(images, labels, generator)
    loss.backward()
    if seg.dp is not None:
        average_gradients([p for group in opt.param_groups for p in group['params']], seg.dp)
    opt.step()
    sched.step()
    return loss, parts


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--train_img_dir', type=str, required=True)
    parser.add_argument('--train_label_dir', type=str, required=True)
    parser.add_argument('--val_img_dir', type=str, default=None)
    parser.add_argument('--val_label_dir', type=str, default=None)
    parser.add_argument('--work_dir', type=str, default='./seg_out')
    parser.add_argument('--max_iters', type=int, default=80000)
    parser.add_argument('--batch_size', type=int, default=2)
    parser.add_argument('--crop_size', type=int, default=None,
                        help="train/slide crop; defaults to the config's crop_size, else 512")
    parser.add_argument('--lr', type=float, default=1.6e-4)
    parser.add_argument('--weight_decay', type=float, default=0.001)
    parser.add_argument('--val_every', type=int, default=8000)
    parser.add_argument('--weights', type=str, default=None,
                        help='a diffusers checkpoint dir for the extractor(s)')
    parser.add_argument('--resume', type=str, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--dp', type=int, default=1,
                        help='data-parallel ranks, one process each (torchrun); must divide '
                             '--batch_size')
    parser.add_argument('--eval_only', action='store_true',
                        help='evaluate the --resume checkpoint on the val set, no training')
    parser.add_argument('--reduce_zero_label', action='store_true',
                        help="ADE20K-style labels: 0 becomes ignore (255), classes shift down")
    parser.add_argument('--device', type=str, default='cuda')
    return parser


def evaluate(seg, val_pairs, crop, stride, rng, reduce_zero_label: bool, seed: int) -> float:
    """mIoU over the val pairs, each slide-inferred alone at full size.
    The extractors' noise restarts from ``seed`` first, so a resumed
    ``--eval_only`` scores a checkpoint exactly as the run that wrote it."""
    seg.reseed_noise(seed)
    preds, gts = [], []
    for ip, lp in val_pairs:
        img, lab = load_pair(ip, lp, crop, rng, train=False, reduce_zero_label=reduce_zero_label)
        pred = seg.predict(torch.from_numpy(img)[None], mode='slide', crop_size=crop,
                           stride=stride)
        preds.append(pred[0])
        gts.append(lab)
    return compute_iou(preds, gts, seg.head.num_classes, ignore_label=255)[1]


def main(argv=None, group=None):
    """Train (or with ``--eval_only`` evaluate); returns {'seg': the
    segmentor, 'losses': [float per iteration], 'step_seconds': [host
    seconds per iteration, from loading its batch to its loss on the host,
    which waits for the optimiser step], 'miou': [(iteration, mIoU),
    ...]}.  ``group``: the process group of a ``--dp`` run's ranks
    (default: every launched rank)."""
    args = build_parser().parse_args(argv)
    mesh = None
    if args.dp > 1:
        if args.batch_size % args.dp:
            raise ValueError(f'--batch_size {args.batch_size} must divide over --dp {args.dp}')
        args.device = init_launched('gloo' if args.device == 'cpu' else 'nccl', args.device)
        mesh = make_mesh(dp=args.dp, group=group)
    lead = mesh is None or mesh.coords['dp'] == 0
    os.makedirs(args.work_dir, exist_ok=True)
    with open(args.config) as f:
        cfg = json.load(f)
    if args.crop_size is None:
        args.crop_size = int(cfg.get('crop_size', [512, 512])[0])
    # a stride above the crop would leave pixels no window visits
    stride = tuple(min(int(s), args.crop_size) for s in cfg.get('stride', [512, 512]))
    seg = segmentor_from_config(cfg, args.weights, args.seed, args.device, mesh)
    params = seg.init_state()
    opt, sched = make_optimizer(params.values(), args.lr, args.weight_decay, args.max_iters)
    start = 0
    if args.resume:
        ck = torch.load(args.resume, map_location=seg.device, weights_only=True)
        seg.load_state_dict(ck['state'])
        opt.load_state_dict(ck['optimizer'])
        sched.load_state_dict(ck['scheduler'])
        start = ck['iter']

    train_pairs = list_pairs(args.train_img_dir, args.train_label_dir)
    val_pairs = list_pairs(args.val_img_dir, args.val_label_dir) if args.val_img_dir else []
    log = print if lead else (lambda *a, **k: None)
    log(f'{len(train_pairs)} train / {len(val_pairs)} val pairs')
    crop = (args.crop_size, args.crop_size)
    result = {'seg': seg, 'losses': [], 'step_seconds': [], 'miou': []}

    if args.eval_only:
        if not val_pairs:
            raise ValueError('--eval_only needs --val_img_dir/--val_label_dir')
        if not args.resume:
            raise ValueError('--eval_only without --resume would score randomly initialised '
                             'weights')
        miou = evaluate(seg, val_pairs, crop, stride, random.Random(args.seed),
                        args.reduce_zero_label, args.seed)
        log(f'eval mIoU: {miou:.4f}')
        result['miou'].append((start, miou))
        return result
    if not train_pairs:
        raise ValueError('no training pairs found')

    rng = random.Random(args.seed)
    dropout = torch.Generator(device=seg.device).manual_seed(args.seed)
    lo, hi = (0, args.batch_size) if mesh is None else mesh.axis('dp').bounds(args.batch_size)
    for it in range(start, args.max_iters):
        t0 = time.perf_counter()
        # every rank draws the whole batch, and decodes its rows
        batch = [load_pair(*train_pairs[rng.randrange(len(train_pairs))], crop, rng,
                           reduce_zero_label=args.reduce_zero_label, decode=lo <= i < hi)
                 for i in range(args.batch_size)]
        batch = batch[lo:hi]
        images = torch.from_numpy(np.stack([b[0] for b in batch])).to(seg.device)
        labels = torch.from_numpy(np.stack([b[1] for b in batch])).to(seg.device)
        loss, parts = train_step(seg, opt, sched, images, labels, dropout)
        result['losses'].append(float(loss.detach()))
        result['step_seconds'].append(time.perf_counter() - t0)
        if it % 50 == 0:
            p = {k: round(float(v.detach()), 4) for k, v in parts.items()}
            log(f'iter {it}: loss {result["losses"][-1]:.4f} {p}')
        if (it + 1) % args.val_every == 0 or it + 1 == args.max_iters:
            if val_pairs:
                miou = evaluate(seg, val_pairs, crop, stride, rng, args.reduce_zero_label,
                                args.seed)
                log(f'iter {it + 1}: val mIoU {miou:.4f}')
                result['miou'].append((it + 1, miou))
            if lead:
                torch.save({'iter': it + 1, 'state': seg.state_dict(),
                            'optimizer': opt.state_dict(), 'scheduler': sched.state_dict()},
                           os.path.join(args.work_dir, f'iter_{it + 1}.pt'))
    return result


if __name__ == '__main__':
    main()
