"""Background frame prefetcher.

Counterpart of ``splatam_tpu/data/prefetch.py``. The reference loads frames
synchronously inside the SLAM loop (`scripts/splatam.py:663-672`), stalling
the GPU on disk I/O + JPEG decode; a one-thread lookahead queue decodes the
next frames while the device works on this one.
"""
from __future__ import annotations

import queue
import threading


class PrefetchLoader:
    """Iterates a dataset sequentially with a lookahead decode thread."""

    def __init__(self, dataset, lookahead: int = 4):
        self.dataset = dataset
        self.lookahead = lookahead
        self._q: "queue.Queue" = queue.Queue(maxsize=lookahead)
        self._thread = None
        self._err = None

    def __len__(self):
        return len(self.dataset)

    def _work(self, n):
        try:
            for i in range(n):
                self._q.put(self.dataset[i])
        except Exception as e:  # propagate to consumer
            self._err = e
            self._q.put(None)

    def __iter__(self):
        n = len(self.dataset)
        self._thread = threading.Thread(target=self._work, args=(n,), daemon=True)
        self._thread.start()
        for _ in range(n):
            item = self._q.get()
            if item is None:
                raise self._err
            yield item
