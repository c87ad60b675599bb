"""Label-scarce pixel classification: an MLP ensemble over dumped features
(port of ``diffusion_feature_tpu/tasks/scarce/pixel_classifier.py``).

Reference (scarce_segmentation/segmentation/pixel_classifier.py +
task-pixel.py): per-pixel 3-layer MLP (datasetGAN lineage), ensemble of
``model_num`` members, majority-vote prediction with Jensen-Shannon
uncertainty (entropy of the mean softmax minus mean per-member entropy,
top-10% mean), per-class IoU -> mIoU.

Each member trains on the device: the training matrix is indexed where it
lies (on the device, or on the host when it does not fit there), one batch
per step in the order of the JAX package's
``np.random.RandomState(seed)`` permutations, with ``torch.optim.Adam``
(optax's ``adam``: eps 1e-8 outside the square root, no decay).  The
BatchNorm is Flax's (``tasks/segmentation/heads.BatchNorm`` on (N, C)
rows: biased batch variance, momentum 0.99), not ``nn.BatchNorm1d``.
``predict_labels`` runs the whole ensemble at once (``torch.func``'s
stacked state under ``vmap``).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..segmentation.heads import BatchNorm


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's default Dense kernel init on a (out, in) weight: a normal
    truncated at +-2 sigma with std sqrt(1 / fan_in) / 0.87962566."""
    std = (1.0 / weight.shape[1]) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class PixelClassifier(nn.Module):
    """dim -> 128 -> 32 -> C (under 30 classes) or dim -> 256 -> 128 -> C,
    ReLU + BatchNorm after each hidden layer (reference :14-36); the Flax
    module's child names.  Weights draw Flax's inits from ``generator``
    (kernels lecun-normal, biases 0, BatchNorm scale 1)."""

    def __init__(self, num_classes: int, dim: int, generator: Optional[torch.Generator] = None,
                 device='cpu'):
        super().__init__()
        self.num_classes, self.dim = num_classes, dim
        widths = (128, 32) if num_classes < 30 else (256, 128)
        ins = (dim,) + widths
        for i, w in enumerate(widths):
            setattr(self, f'dense_{i}', nn.Linear(ins[i], w, device=device))
            setattr(self, f'bn_{i}', BatchNorm(w).to(device))
        self.out = nn.Linear(widths[-1], num_classes, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            for lin in (self.dense_0, self.dense_1, self.out):
                _lecun_normal_(lin.weight, generator)
                lin.bias.zero_()

    @classmethod
    def from_state_dict(cls, state: dict, device='cpu') -> 'PixelClassifier':
        """A classifier of the widths ``state`` holds, loaded from it."""
        model = cls(state['out.weight'].shape[0], state['dense_0.weight'].shape[1], device=device)
        model.load_state_dict(state)
        return model

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f'bn_{i}')(F.relu(getattr(self, f'dense_{i}')(x)), train)
        return self.out(x)


def pixel_classifier_from_jax(variables: dict) -> dict:
    """A JAX member's ``{'params', 'batch_stats'}`` -> the state dict of a
    ``PixelClassifier``: Dense ``kernel`` (in, out) as ``weight.T``, Flax's
    BatchNorm ``scale`` as ``weight``, ``mean``/``var`` as the running
    statistics."""
    params, stats = variables['params'], variables['batch_stats']
    state = {}
    for name in ('dense_0', 'dense_1', 'out'):
        state[f'{name}.weight'] = torch.from_numpy(np.array(params[name]['kernel']).T.copy())
        state[f'{name}.bias'] = torch.from_numpy(np.array(params[name]['bias']))
    for i in range(2):
        bn = f'bn_{i}'
        state[f'{bn}.weight'] = torch.from_numpy(np.array(params[bn]['scale']))
        state[f'{bn}.bias'] = torch.from_numpy(np.array(params[bn]['bias']))
        state[f'{bn}.running_mean'] = torch.from_numpy(np.array(stats[bn]['mean']))
        state[f'{bn}.running_var'] = torch.from_numpy(np.array(stats[bn]['var']))
    return state


def _entropy(logits_or_probs: torch.Tensor, from_logits: bool) -> torch.Tensor:
    if from_logits:
        logp = F.log_softmax(logits_or_probs, dim=-1)
        p = logp.exp()
    else:
        p = logits_or_probs
        logp = p.clamp(min=1e-12).log()
    return -(p * logp).sum(dim=-1)


def train_one(features, labels, num_classes: int, seed: int, batch_size: int = 64,
              lr: float = 1e-3, max_epochs: int = 100, patience: int = 50,
              warmup_epochs: int = 3, device='cuda') -> PixelClassifier:
    """Train one ensemble member with the reference's early-stopping rule
    (task-pixel.py:116-178): after ``warmup_epochs``, stop when the batch
    loss has not improved for ``patience`` steps.  ``features`` (N, dim) and
    ``labels`` (N,) are numpy arrays or tensors, indexed where they lie (a
    matrix too large for the card stays on the host); each batch is copied
    to ``device`` as fp32, where the member trains.  The weights draw from a
    generator seeded with ``seed``; the batches follow
    ``np.random.RandomState(seed)``, as in the JAX package."""
    x = torch.as_tensor(features)
    y = torch.as_tensor(labels).to(x.device)
    model = PixelClassifier(num_classes, x.shape[-1],
                            torch.Generator(device=device).manual_seed(seed), device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    n = len(x)
    steps_per_epoch = n // batch_size
    np_rng = np.random.RandomState(seed)
    best_loss, break_count = np.inf, 0
    for epoch in range(max_epochs):
        perm = torch.from_numpy(np_rng.permutation(n)).to(x.device)
        for it in range(steps_per_epoch):
            idx = perm[it * batch_size:(it + 1) * batch_size]
            xb = x[idx].to(device, torch.float32)
            loss = F.cross_entropy(model(xb, train=True), y[idx].to(device, torch.long))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if epoch > warmup_epochs:
                value = float(loss.detach())
                if value < best_loss:
                    best_loss, break_count = value, 0
                else:
                    break_count += 1
                if break_count > patience:
                    return model.eval()
    return model.eval()


def train_ensemble(features, labels, num_classes: int, model_num: int = 10, **kw
                   ) -> List[PixelClassifier]:
    return [train_one(features, labels, num_classes, seed=i, **kw) for i in range(model_num)]


@torch.no_grad()
def predict_labels(ensemble: List[PixelClassifier], features: torch.Tensor,
                   size: Tuple[int, ...], num_classes: int):
    """Majority-vote segmentation + JS uncertainty (reference
    predict_labels :70-107) of (N, dim) ``features`` on their device, every
    member at once.  Returns (pred (size) int64 numpy array, top-10% mean
    uncertainty as a float); a vote tie goes to the lowest class id."""
    params, buffers = torch.func.stack_module_state(ensemble)
    base = copy.deepcopy(ensemble[0]).to('meta')

    def member(p, b, x):
        return torch.func.functional_call(base, (p, b), (x,), {'train': False})

    x = torch.as_tensor(features).to(params['out.weight'].device, torch.float32)
    logits = torch.vmap(member, in_dims=(0, 0, None))(params, buffers, x)   # (M, N, C)
    entropies = _entropy(logits, from_logits=True)                           # (M, N)
    mean_seg = F.softmax(logits, dim=-1).mean(dim=0)                         # (N, C)
    js = _entropy(mean_seg, from_logits=False) - entropies.mean(dim=0)
    top_k = torch.topk(js, max(1, js.shape[0] // 10)).values.mean()
    votes = F.one_hot(logits.argmax(dim=-1), num_classes).sum(dim=0)         # (N, C)
    pred = votes.argmax(dim=-1)     # torch.argmax takes the first maximum
    return pred.reshape(size).cpu().numpy(), float(top_k)


def compute_iou(preds: List[np.ndarray], gts: List[np.ndarray], num_classes: int,
                ignore_label: Optional[int] = None):
    """Per-class IoU over the dataset -> ({class: IoU} of the classes
    present in predictions or labels, mIoU), the reference task-pixel.py
    semantics: an absent class scores 0 and the mean runs over all
    ``num_classes`` (inter / (1e-8 + union))."""
    inter = np.zeros(num_classes)
    union = np.zeros(num_classes)
    for p, g in zip(preds, gts):
        p, g = np.asarray(p).ravel(), np.asarray(g).ravel()
        if ignore_label is not None:
            keep = g != ignore_label
            p, g = p[keep], g[keep]
        for c in range(num_classes):
            pi, gi = p == c, g == c
            inter[c] += np.logical_and(pi, gi).sum()
            union[c] += np.logical_or(pi, gi).sum()
    ious = inter / (1e-8 + union)
    present = union > 0
    return {c: float(ious[c]) for c in range(num_classes) if present[c]}, float(ious.mean())
