"""Port of ``diffusion_feature_tpu/tasks/scarce/pixel_classifier.py``:
``compute_iou``, which the segmentation trainer scores with (numpy only).
The pixel classifier itself comes with the label-scarce slice (ROADMAP.md
Queue A item 16)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


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
