"""Native (C++) runtime pieces of the port (copies of the JAX package's
``diffusion_feature_tpu/native``): the async feature-dump writer that
overlaps disk IO with the device's work, and the async ``.npy`` reader
that prefetches the label-scarce task's dumps.  ``dumpio.cpp`` and
``npyio.cpp`` are the JAX package's sources byte for byte; each is
compiled with ``g++`` at first use into ``_build/`` beside this package.
Without a compiler the writer falls back to ``np.save`` and the reader to
``np.load``."""

from .build import load_library
from .dump_writer import AsyncDumpWriter, npy_header
from .npy_reader import AsyncNpyReader, native_reader_available
