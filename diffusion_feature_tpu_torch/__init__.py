"""diffusion_feature_tpu_torch: the PyTorch/CUDA port of diffusion_feature_tpu.

Same public surface as the JAX package (``FeatureExtractor``, ``TapSpec``),
for the slices ported so far: single-step feature extraction for SDXL and
SD-1.5 with the attention store, layer enumeration, and the extraction CLI
(``python -m diffusion_feature_tpu_torch.extract_feature``).  Imports torch
and never jax.
"""

from .taps import TapSpec  # noqa: F401
from .facade import FeatureExtractor  # noqa: F401
