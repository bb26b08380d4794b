"""Background prefetch loader (counterpart of
``blockcopy_tpu/data/loader.py``).

A thread pool decodes and transforms upcoming clips while the card steps the
current one, in place of the reference's torch ``DataLoader(num_workers=6)``
(``test_swiftnet.py:70-80``).  In-flight work is bounded: at most
``prefetch + 1`` items are decoded or decoding at any moment, so a consumer
slower than decode cannot pile up finished clips (a full-resolution clip is
~500 MB).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator


class PrefetchLoader:
    def __init__(self, dataset, num_workers: int = 6, prefetch: int = 4,
                 max_items: int = -1):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        n = len(dataset)
        self.count = n if max_items < 0 else min(n, max_items)

    def __len__(self):
        return self.count

    def max_in_flight(self) -> int:
        """Upper bound on items decoded or decoding at any moment."""
        return max(1, self.prefetch) + 1

    def __iter__(self) -> Iterator:
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        # The queue holds futures and its capacity bounds in-flight decodes:
        # the feeder submits one item at a time, so once the queue is full it
        # blocks holding exactly one extra future.
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def feed():
            for i in range(self.count):
                if stop.is_set():
                    return
                f = pool.submit(self.dataset.__getitem__, i)
                while True:
                    try:
                        q.put(f, timeout=0.5)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
            q.put(None)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            while True:
                f = q.get()
                if f is None:
                    break
                yield f.result()
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
