"""Downstream tasks on diffusion features (port of
``diffusion_feature_tpu/tasks``): segmentation, SPair correspondence
(``correspondence``) and label-scarce pixel classification (``scarce``)."""
