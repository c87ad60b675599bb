"""Segmentation on diffusion features (port of
``diffusion_feature_tpu/tasks/segmentation``): heads, losses and the
segmentor; the trainer is ``diffusion_feature_tpu_torch.train_segmentation``."""

from .heads import FCNHead, ResBlockAdapter, UPerHead
from .losses import cross_entropy_loss, lovasz_softmax_loss, segmentation_loss
from .segmentor import DiffusionSegmentor, SegHead, seg_head_from_jax

__all__ = ['FCNHead', 'ResBlockAdapter', 'UPerHead', 'cross_entropy_loss',
           'lovasz_softmax_loss', 'segmentation_loss', 'DiffusionSegmentor', 'SegHead',
           'seg_head_from_jax']
