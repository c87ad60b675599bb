"""Segmentation losses (port of
``diffusion_feature_tpu/tasks/segmentation/losses.py``): cross-entropy and
Lovasz-softmax.

The reference's decode head optimises CE (weight 1.0) + LovaszLoss
(reduction='none', weight 1.0), the auxiliary head 0.4 x CE
(segmentation/configs/ade_sdxl.py:29-45).  Lovasz-softmax is Berman et
al.'s over the classes present, batch-flattened (mmseg's per_image=False).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE_INDEX = 255


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """logits (B, C, H, W), labels (B, H, W) integers.  mmseg's
    avg_non_ignore=False: the summed loss of the labelled pixels divided by
    ALL pixels, ignored ones included."""
    valid = labels != ignore_index
    ce = F.cross_entropy(logits.float(), torch.where(valid, labels, 0).long(), reduction='none')
    return (ce * valid).sum() / labels.numel()


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """The Lovasz extension's gradient with respect to the errors sorted in
    descending order, per row of ``gt_sorted`` (classes x pixels)."""
    gts = gt_sorted.sum(dim=1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(dim=1)
    union = gts + (1.0 - gt_sorted).cumsum(dim=1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)


def lovasz_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                        ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Batch-flattened Lovasz-softmax over the classes present: one Jaccard
    extension over all B*H*W pixels, averaged over the classes that some
    labelled pixel has.  Ignored pixels get zero error.  Each class's
    errors are sorted in descending order (a stable sort, so ties keep
    pixel order, as the JAX package's sort does); the Lovasz weights depend
    only on that order, so they are computed outside autograd and the
    gradient reaches the probabilities through the gather of the sorted
    errors.  The work runs on (classes, pixels) rows: the sort and the
    cumulative sums then walk each row's contiguous memory (a scan down
    the pixel axis of a (pixels, classes) tensor took 385 ms of an
    ``ade_sdxl`` step on an H100)."""
    c = logits.shape[1]
    probs = logits.float().softmax(dim=1).transpose(0, 1).reshape(c, -1)
    lb = labels.reshape(-1)
    valid = lb != ignore_index
    validf = valid.float()
    fg = (torch.arange(c, device=lb.device)[:, None] == lb).float() * validf
    errors = (fg - probs).abs() * validf
    order = torch.argsort(-errors.detach(), dim=1, stable=True)
    fg_sorted = fg.gather(1, order)
    with torch.no_grad():
        weights = _lovasz_grad(fg_sorted)
    losses = (errors.gather(1, order) * weights).sum(dim=1)
    present = fg_sorted.sum(dim=1) > 0
    return (losses * present).sum() / present.sum().clamp(min=1)


def segmentation_loss(decode_logits, aux_logits, labels, aux_weight: float = 0.4,
                      ignore_index: int = IGNORE_INDEX):
    """The reference's objective: decode CE + Lovasz, aux 0.4 x CE.
    Returns (total, {'loss_ce', 'loss_lovasz'[, 'loss_ce_aux']})."""
    loss_ce = cross_entropy_loss(decode_logits, labels, ignore_index)
    loss_lovasz = lovasz_softmax_loss(decode_logits, labels, ignore_index)
    parts = {'loss_ce': loss_ce, 'loss_lovasz': loss_lovasz}
    total = loss_ce + loss_lovasz
    if aux_logits is not None:
        loss_aux = cross_entropy_loss(aux_logits, labels, ignore_index)
        parts['loss_ce_aux'] = loss_aux
        total = total + aux_weight * loss_aux
    return total, parts
