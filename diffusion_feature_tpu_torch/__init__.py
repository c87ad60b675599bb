"""diffusion_feature_tpu_torch: the PyTorch/CUDA port of diffusion_feature_tpu.

Same public surface as the JAX package (``FeatureExtractor``, ``TapSpec``),
for the slice ported so far: SDXL single-step feature extraction.  Imports
torch and never jax.
"""

from .taps import TapSpec  # noqa: F401
from .facade import FeatureExtractor  # noqa: F401
