"""The label-scarce task (port of ``diffusion_feature_tpu/tasks/scarce``):
the MLP pixel-classifier ensemble with its majority vote and JS
uncertainty, the dataset settings, splits, palettes and class names; the
CLI is ``diffusion_feature_tpu_torch.task_pixel``."""

from .pixel_classifier import (
    PixelClassifier, train_ensemble, predict_labels, compute_iou,
)
from .data import (
    get_dataset_setting, shuffle_split, get_palette, get_class_names,
)
