"""Double-buffered host input pipeline for batch extraction (a copy of the
JAX package's ``io/prefetch.py``).

The reference CLI decodes each batch's images synchronously between model
calls (extract_feature.py:124-127), stalling the accelerator on PIL decode +
resize.  PrefetchLoader decodes ahead on worker threads with a bounded queue
so the device never waits on input IO.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Sequence, Union


class PrefetchLoader:
    """Iterate batches of loaded items ahead of consumption.

    loader(path) runs on worker threads (PIL decode releases the GIL for the
    heavy parts); batches preserve input order.  ``batch_size``: one size
    for every batch (the last may be shorter), or the sizes of the batches
    in turn (zeros allowed: a dp rank with no rows in a batch).
    """

    def __init__(self, paths: Sequence[str], batch_size: Union[int, Sequence[int]],
                 loader: Callable, depth: int = 2, n_threads: int = 2):
        if isinstance(batch_size, int):
            batch_size = [min(batch_size, len(paths) - i)
                          for i in range(0, len(paths), batch_size)]
        starts = [sum(batch_size[:k]) for k in range(len(batch_size))]
        self._batches: List[List[str]] = [list(paths[s:s + n])
                                          for s, n in zip(starts, batch_size)]
        self._loader = loader
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._n_threads = max(1, n_threads)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _load_batch(self, batch_paths: List[str]):
        if self._n_threads == 1 or len(batch_paths) == 1:
            return [self._loader(p) for p in batch_paths]
        # at most n_threads concurrent decodes (bounds peak memory)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=self._n_threads) as pool:
            return list(pool.map(self._loader, batch_paths))

    def _produce(self):
        try:
            for bp in self._batches:
                self._q.put(('ok', bp, self._load_batch(bp)))
        except Exception as e:
            self._q.put(('err', None, e))
        finally:
            self._q.put(('end', None, None))

    def __iter__(self):
        while True:
            kind, paths, payload = self._q.get()
            if kind == 'end':
                return
            if kind == 'err':
                raise payload
            yield paths, payload

    def __len__(self):
        return len(self._batches)
