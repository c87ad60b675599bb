"""diffusion_feature_tpu_torch: the PyTorch/CUDA port of diffusion_feature_tpu.

Same public surface as the JAX package (``FeatureExtractor``, ``TapSpec``):
feature extraction for the U-Nets, the DiTs and IF with the attention
store, generation, ControlNets, checkpoints, layer enumeration, and the
CLIs (``python -m diffusion_feature_tpu_torch.extract_feature``,
``generate_with_extraction``); the downstream tasks in ``tasks/`` with
their CLIs ``train_segmentation``, ``task_corres`` (SPair correspondence)
and ``task_pixel`` (label-scarce pixel classification); on one device or
on a dp/sp/tp mesh of ranks (``parallel/mesh.py``).  Imports torch and
never jax.
"""

from .taps import TapSpec  # noqa: F401
from .facade import FeatureExtractor  # noqa: F401
