"""Device time from a ``torch.profiler`` trace of a short sub-window.

The union of kernel intervals (a copy of the port's ``trace_eval.py:
_union_us``) gives the busy time; kernels are grouped by the port's kernel
families, by the names nvcc gives them (a copy of ``trace_train.py:
_FAMILIES``), and assigned to the benchmark phase (``phase::<name>``
marks of :class:`.timing.PhaseTimer`) in whose interval they start. Idle
gaps between kernel intervals are charged to the phase the host was in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

# the port's own kernels by the names nvcc gives them: (kernel, name part)
FAMILIES = (
    ("A", "sparse_conv_mma<"),          # forward and dX, bf16
    ("A f32", "sparse_conv_tile<"),
    ("D", "sparse_conv_dw_mma<"),
    ("D f32", "sparse_conv_dw_partial_kernel<"),
    ("A, D second pass", "ordered_sum_kernel"),
    ("B", "dense_pull_blocks_kernel"),
    ("B tables", "pull_keys_kernel"),
    ("B tables", "pull_blocks_kernel"),
    ("B tables", "pull_cands_kernel"),
    ("C", "meanshift_converge_kernel<"),
)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def family(name: str) -> Optional[str]:
    return next((f for f, part in FAMILIES if part in name), None)


class Trace(NamedTuple):
    window_s: float  # wall length of the profiled sub-window
    busy_s: float  # union of kernel intervals
    kernels: List[Tuple[str, float, float]]  # (name, start us, end us)
    phases: List[Tuple[str, float, float]]  # (phase, start us, end us)
    span: Tuple[float, float] = (float("nan"), float("nan"))  # the sub-window, us

    def device_ops(self, top: int = 10) -> List[List]:
        per: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            per[name] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(per.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds between kernel intervals, and before the first and
        after the last within the sub-window, summed by the phase whose
        interval holds the gap's midpoint ("outside" where none does)."""
        first, last = self.span
        gaps, end = [], first
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if s > end:
                gaps.append((end, s))
            end = max(end, e) if end == end else e
        if last > end:
            gaps.append((end, last))
        per: Dict[str, float] = defaultdict(float)
        phases = sorted(self.phases, key=lambda p: p[1])
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            name = next((p for p, s, e in phases if s <= mid <= e), "outside")
            per[name] += (g1 - g0) / 1e6
        return [[n, v] for n, v in sorted(per.items(), key=lambda kv: -kv[1])[:top]]

    def family_in_phase(self, fam: str, phase: str) -> float:
        """Device seconds of the kernels of ``fam`` that start inside a span
        of ``phase``."""
        spans = [(s, e) for p, s, e in self.phases if p == phase]
        total = 0.0
        for name, s, e in self.kernels:
            if family(name) == fam and any(a <= s <= b for a, b in spans):
                total += (e - s) / 1e6
        return total


def _start(cuda: bool):
    """Start the profiler at its lowest level: its raw events are read
    without building the profiler's event tree, which takes minutes for a
    served scene's hundreds of thousands of events."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler, _prepare_profiler)

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    return _disable_profiler


@contextlib.contextmanager
def profiled(sync, cuda: bool = True):
    """Profile the body (CPU and, with ``cuda``, CUDA activity); yields a
    dict that holds ``trace`` (:class:`Trace`) once the body has ended.
    Times are in us."""
    from torch.autograd import DeviceType

    box = {}
    sync()
    stop = _start(cuda)
    t0, start_us = time.perf_counter(), time.time_ns() / 1e3
    try:
        yield box
        sync()
    finally:
        wall, end_us = time.perf_counter() - t0, time.time_ns() / 1e3
        events = stop().events()
    kernels, phases = [], []
    for e in events:
        if e.is_user_annotation():
            if e.name().startswith("phase::") and e.device_type() != DeviceType.CUDA:
                phases.append((e.name()[len("phase::"):], e.start_ns() / 1e3,
                               e.end_ns() / 1e3))
            continue
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3))
    busy = union_us([(s, e) for _, s, e in kernels]) / 1e6
    box["trace"] = Trace(wall, busy, kernels, phases, (start_us, end_us))
