"""AsyncNpyReader: prefetching .npy loads through the native reader pool (a
copy of the JAX package's ``native/npy_reader.py``).

The label-scarce task consumes GB-scale aggregated feature dumps (reference
scarce_segmentation/task-pixel.py:32-71 loads them serially); here file IO
and header parsing run on C++ worker threads (npyio.cpp, the JAX package's
source byte for byte) ahead of the device work that consumes each array.
Falls back to synchronous np.load when the native library is unavailable,
and for the dtypes its header parser does not take (a structured dtype).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from .build import load_library

_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_library('npyio')
            if lib is not None:
                lib.nr_create.restype = ctypes.c_void_p
                lib.nr_create.argtypes = [ctypes.c_int]
                lib.nr_submit.restype = ctypes.c_int64
                lib.nr_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.nr_wait.restype = ctypes.c_int
                lib.nr_wait.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int)]
                lib.nr_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
                lib.nr_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib if lib is not None else False
    return _lib or None


def native_reader_available() -> bool:
    return _get_lib() is not None


class AsyncNpyReader:
    """submit(path) -> handle; get(handle) -> np.ndarray.

    Handles resolve in any order; each buffer is copied out of the pool on
    get() and released.  With no native library, submit returns the path
    and get falls back to np.load.
    """

    def __init__(self, n_threads: int = 4):
        self._lib = _get_lib()
        self._pool = (self._lib.nr_create(int(n_threads))
                      if self._lib is not None else None)
        self._paths = {}   # handle -> path, for the np.load fallback

    @property
    def is_native(self) -> bool:
        return self._pool is not None

    def submit(self, path: str):
        if self._pool is None:
            return path
        jid = self._lib.nr_submit(self._pool, str(path).encode())
        if jid < 0:
            raise RuntimeError(f'nr_submit failed for {path}')
        self._paths[jid] = str(path)
        return jid

    def get(self, handle) -> np.ndarray:
        if self._pool is None:
            return np.load(handle)
        data = ctypes.c_void_p()
        nbytes = ctypes.c_int64()
        shape = (ctypes.c_int64 * 8)()
        ndim = ctypes.c_int()
        descr = ctypes.create_string_buffer(16)
        fortran = ctypes.c_int()
        rc = self._lib.nr_wait(self._pool, handle, ctypes.byref(data),
                               ctypes.byref(nbytes), shape,
                               ctypes.byref(ndim), descr,
                               ctypes.byref(fortran))
        if rc != 0:
            self._lib.nr_free(self._pool, handle)
            # The native parser only handles simple scalar descrs; a
            # legitimate exotic .npy (structured dtype, '<M8[ns]', ...)
            # fails the job cleanly — np.load it here instead of erroring
            # (see npyio.cpp parse_header).  Missing/corrupt files raise
            # from np.load with the real reason.
            path = self._paths.pop(handle, None)
            if path is not None:
                return np.load(path)
            raise IOError(f'native npy read failed (job {handle})')
        self._paths.pop(handle, None)
        try:
            dt = np.dtype(descr.value.decode())
            shp = tuple(shape[i] for i in range(ndim.value))
            if nbytes.value == 0:
                # empty payload: std::vector::data() may be NULL on the C
                # side; don't dereference it
                return np.zeros(shp, dt)
            # single copy out of the pool buffer into a writable array
            # (np.load also returns writable arrays; callers mutate in place)
            src = (ctypes.c_char * nbytes.value).from_address(data.value)
            arr = np.frombuffer(src, dtype=dt).copy()
            arr = arr.reshape(shp, order='F' if fortran.value else 'C')
        finally:
            self._lib.nr_free(self._pool, handle)
        return arr

    def read_all(self, paths: Sequence[str], window: int = None,
                 max_bytes: int = 2 << 30):
        """Yield arrays in path order, keeping at most ``window`` reads (and
        at most ~``max_bytes`` of decoded payload, sized from the files on
        disk) in flight — bounded backpressure: the GB-scale aggregated
        dumps this path exists for must not all buffer in the C++ pool at
        once while the consumer computes."""
        import os
        if window is None:
            window = 8
        paths = list(paths)
        handles = []
        sizes = []
        in_flight = 0
        nxt = 0
        for i in range(len(paths)):
            while (nxt < len(paths) and nxt - i < window
                   and (in_flight == 0 or in_flight < max_bytes)):
                try:
                    sz = os.path.getsize(paths[nxt])
                except OSError:
                    sz = 0
                handles.append(self.submit(paths[nxt]))
                sizes.append(sz)
                in_flight += sz
                nxt += 1
            arr = self.get(handles[i])
            in_flight -= sizes[i]
            yield arr

    def close(self):
        if self._pool is not None:
            self._lib.nr_destroy(self._pool)
            self._pool = None
        # drop fallback paths for handles submitted but never get()'d
        # (e.g. an abandoned read_all generator) — unbounded otherwise on
        # a long-lived reader
        self._paths.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
