"""On-demand ``g++`` build of the native components into ``_build/`` beside
the package, cached by source hash (no pybind11: plain shared objects
loaded through ctypes)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), '_build')


def _source_path(name: str) -> str:
    return os.path.join(_SRC_DIR, name + '.cpp')


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile (once per source hash) and dlopen lib<name>.so.
    Returns None when no toolchain is available."""
    src = _source_path(name)
    if not os.path.exists(src):
        return None
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f'lib{name}-{digest}.so')
    if not os.path.exists(so):
        tmp = f'{so}.tmp.{os.getpid()}'   # unique per process: concurrent
        cmd = ['g++', '-O3', '-shared', '-fPIC', '-pthread', '-std=c++17',
               src, '-o', tmp]               # builders cannot corrupt the cache
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            return None
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None
