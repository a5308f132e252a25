"""The benchmark's spans: a timer for the program's ``timer(name)`` hook
and for the benchmark's own phases.

Each span synchronizes the device when it opens and when it closes, so that
its host-clock length holds the device work its phase launched, and marks
itself for the profiler (``record_function``), so that kernels can be
assigned to the phase they ran in. The spans are kept in memory. Used in
traced runs only: the synchronizations change what a step costs. With
``recording`` off, a span neither synchronizes nor is kept, and only its
mark is left: so run the profiled sub-window and the plain steps or scene
beside it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


class PhaseTimer:
    def __init__(self, sync: Callable[[], None] = torch.cuda.synchronize):
        self._sync = sync
        self.spans: List[Tuple[str, float, float]] = []
        self.recording = True

    @contextlib.contextmanager
    def __call__(self, name: str):
        recording = self.recording
        if recording:
            self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"phase::{name}"):
            try:
                yield
            finally:
                if recording:
                    self._sync()
        if recording:
            self.spans.append((name, t0, time.perf_counter()))

    def totals(self) -> Dict[str, float]:
        """Seconds per span name over the recorded spans."""
        out: Dict[str, float] = defaultdict(float)
        for name, t0, t1 in self.spans:
            out[name] += t1 - t0
        return dict(out)
