"""Asynchronous host input pipeline: threaded tile sampling and collate
into a bounded queue.

Counterpart of the JAX package's ``data/prefetch.py`` (upstream feeds its
training loop from DataLoader worker processes). A persistent thread pool
builds ready batches while the card runs the step: tile sampling is
numpy/scipy work (tree queries, voxelization, augmentation) that mostly
releases the interpreter lock. Workers build numpy batches only and never
touch CUDA; the copy to the device stays in the consumer's thread.

Determinism: batch i is always built from ``default_rng([seed, i])``, so a
given (seed, batch index) yields the same batch whatever the worker count
or thread scheduling; batches are delivered in index order.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class BatchPrefetcher:
    """Produces batches ``make_batch(rng) -> batch`` ahead of consumption.

    Args:
      make_batch: builds one host batch from a numpy Generator.
      seed: base seed; batch i uses ``default_rng([seed, i])``.
      num_workers: producer threads (0 = synchronous passthrough).
      prefetch: ready batches held ahead of the consumer.
    """

    def __init__(
        self,
        make_batch: Callable[[np.random.Generator], object],
        seed: int = 0,
        num_workers: int = 2,
        prefetch: int = 4,
    ):
        self.make_batch = make_batch
        self.seed = seed
        self.num_workers = int(num_workers)
        self._next_claim = 0
        self._next_emit = 0
        self._claim_lock = threading.Lock()
        self._out: "queue.Queue" = queue.Queue(maxsize=max(int(prefetch), 1))
        self._stash: Dict[int, object] = {}
        self._stop = threading.Event()
        self._threads = []
        for _ in range(self.num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _claim(self) -> int:
        with self._claim_lock:
            i = self._next_claim
            self._next_claim += 1
            return i

    def _worker(self):
        while not self._stop.is_set():
            i = self._claim()
            rng = np.random.default_rng([self.seed, i])
            try:
                batch = self.make_batch(rng)
            except Exception as e:  # surfaced by the consumer
                batch = e
            while not self._stop.is_set():
                try:
                    self._out.put((i, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        i = self._next_emit
        self._next_emit += 1
        if self.num_workers == 0:
            return self._build(i)
        while i not in self._stash:
            j, batch = self._out.get()
            self._stash[j] = batch
        item = self._stash.pop(i)
        if isinstance(item, Exception):
            raise item
        return item

    def _build(self, i: int):
        return self.make_batch(np.random.default_rng([self.seed, i]))

    def close(self):
        self._stop.set()
        try:
            while True:
                self._out.get_nowait()
        except queue.Empty:
            pass
