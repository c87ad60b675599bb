"""Native (C++) runtime pieces of the port (copies of the JAX package's
``diffusion_feature_tpu/native``): the async feature-dump writer that
overlaps disk IO with the device's work.  ``dumpio.cpp`` is the JAX
package's source byte for byte; it is compiled with ``g++`` at first use
into ``_build/`` beside this package.  Without a compiler the writer falls
back to ``np.save``."""

from .build import load_library
from .dump_writer import AsyncDumpWriter, npy_header
