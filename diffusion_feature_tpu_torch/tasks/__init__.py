"""Downstream tasks on diffusion features (port of
``diffusion_feature_tpu/tasks``): segmentation; ``scarce`` holds
``compute_iou`` so far.  Correspondence and the rest of the label-scarce
task are ROADMAP.md Queue A item 16."""
