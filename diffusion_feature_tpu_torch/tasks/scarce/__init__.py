"""The label-scarce task (port of ``diffusion_feature_tpu/tasks/scarce``):
``compute_iou`` so far; the data, palettes and pixel classifier are
ROADMAP.md Queue A item 16."""

from .pixel_classifier import compute_iou

__all__ = ['compute_iou']
