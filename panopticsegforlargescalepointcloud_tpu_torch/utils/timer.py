"""Per-stage wall-clock timing (a copy of the JAX package's
``utils/timer.py``). A stage's time is host time: a stage that ends in a
device synchronize (the trainer's ``step``, which reads its metrics as
floats) includes the device work it queued."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Timer:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self.count += 1
            self._t0 = None

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class StageTimers:
    """Named timers: input / forward / cluster / merge / ..."""

    def __init__(self):
        self._timers: Dict[str, Timer] = defaultdict(Timer)

    @contextmanager
    def time(self, name: str):
        t = self._timers[name]
        t.start()
        try:
            yield
        finally:
            t.stop()

    def summary(self) -> Dict[str, float]:
        return {k: v.mean for k, v in self._timers.items()}

    def totals(self) -> Dict[str, float]:
        return {k: v.total for k, v in self._timers.items()}
