"""AsyncDumpWriter: .npy serialization through the native writer pool (a
copy of the JAX package's ``native/dump_writer.py``).

Builds numpy-format headers in Python (tiny) and hands (header, payload)
buffers to the C++ pool (dumpio.cpp), so writing feature dumps to disk
overlaps with the next batch's work on the device.  Falls back to
synchronous np.save when the native library is unavailable.
"""

from __future__ import annotations

import ctypes
import io
import os
import threading

import numpy as np

from .build import load_library

_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_library('dumpio')
            if lib is not None:
                lib.dw_create.restype = ctypes.c_void_p
                lib.dw_create.argtypes = [ctypes.c_int]
                lib.dw_submit.restype = ctypes.c_int
                lib.dw_submit.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.c_char_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int64]
                lib.dw_pending.restype = ctypes.c_int
                lib.dw_pending.argtypes = [ctypes.c_void_p]
                lib.dw_flush.restype = ctypes.c_int
                lib.dw_flush.argtypes = [ctypes.c_void_p]
                lib.dw_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib if lib is not None else False
    return _lib or None


def npy_header(arr: np.ndarray) -> bytes:
    """The .npy v1.0 header ``np.save`` writes for a C-contiguous array,
    from numpy's own writer, so a dump's bytes equal ``np.save``'s."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, np.lib.format.header_data_from_array_1_0(arr))
    return buf.getvalue()


class AsyncDumpWriter:
    """submit(path, array) enqueues; flush() blocks until everything is on
    disk and raises on write errors."""

    def __init__(self, n_threads: int = 4):
        self._lib = _get_lib()
        self._pool = None
        if self._lib is not None:
            self._pool = ctypes.c_void_p(self._lib.dw_create(n_threads))

    @property
    def is_native(self) -> bool:
        return self._pool is not None

    def submit(self, path: str, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        if self._pool is None:
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            np.save(path[:-4] if path.endswith('.npy') else path, arr)
            return
        header = npy_header(arr)
        rc = self._lib.dw_submit(
            self._pool, path.encode(), header, len(header),
            arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
        if rc != 0:
            raise IOError(f'dw_submit failed for {path}')

    def pending(self) -> int:
        return 0 if self._pool is None else self._lib.dw_pending(self._pool)

    def flush(self):
        if self._pool is None:
            return
        errors = self._lib.dw_flush(self._pool)
        if errors:
            raise IOError(f'{errors} feature dump(s) failed to write')

    def close(self):
        if self._pool is not None:
            self.flush()
            self._lib.dw_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
