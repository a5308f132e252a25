"""The program's own spans and counters, for the per-layer readers that read
them (``metrics/<name>.py``).

The port keeps them in one in-memory recorder (its ``utils/trace.py``),
on while the program is handed a ``timer`` hook: spans on the host's
clock ``time.time_ns()``, which ``torch.profiler`` stamps its events with,
so that a span lies over the device trace as it is. A reader takes the
process's records after the window, in one of two slices of the run, both
bounded by what :class:`.drivers.common.Layers` holds:

* counts: the records that start inside the profiled sub-window
  (``layers.trace.span``) over ``layers.trace_units``; the profiler
  changes no count;
* times: the records of the units of the plain repeat that follows the
  sub-window (the next ``trace_units`` ``train_step`` roots, or the next
  ``build_evaluator`` and ``scene``), over the units: the same inputs with
  no span synchronize and no profiler; where a served window closed before
  its plain scene, the scene before the sub-window (:func:`plain_roots`).

A program without the recorder gives None, as does a slice without the
roots asked for, and a time whose span never ran there.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, List, Optional, Sequence

TRAIN = ("train_step",)
SERVE = ("build_evaluator", "scene")


def records() -> Optional[list]:
    """The records the program's recorder holds; None where the program has
    no recorder."""
    try:
        from panopticsegforlargescalepointcloud_tpu_torch.utils import trace
    except ImportError:
        return None
    return list(trace.RECORDER.records)


def _us(ns: int) -> float:
    return ns / 1e3


def sub_window(layers, recs, roots: Sequence[str]) -> Optional[list]:
    """The records that start inside the profiled sub-window; None where it
    holds no root span named in ``roots``."""
    tr = layers.trace if layers is not None else None
    if recs is None or tr is None or not layers.trace_units:
        return None
    s0, s1 = tr.span
    inside = [r for r in recs if s0 <= _us(r.start_ns) <= s1]
    if not any(r.parent == 0 and r.name in roots for r in inside):
        return None
    return inside


def plain_roots(layers, recs, roots: Sequence[str]) -> Optional[list]:
    """The root spans of the plain repeat: of each name in ``roots``, the
    first ``trace_units`` that start after the sub-window. Where the window
    closed before its plain repeat ran (a served scene's window on a slow
    host), the last ``trace_units`` that end before the sub-window: a unit
    of the window, timed with the benchmark's phases, which synchronize at
    their own edges and not inside a ``model`` or ``ply_write`` span. None
    where there are fewer."""
    tr = layers.trace if layers is not None else None
    if recs is None or tr is None or not layers.trace_units:
        return None
    n, (s0, s1) = layers.trace_units, tr.span
    mine = {name: sorted((r for r in recs if r.parent == 0 and r.name == name),
                         key=lambda r: r.start_ns) for name in roots}
    after = {k: [r for r in v if _us(r.start_ns) > s1][:n] for k, v in mine.items()}
    before = {k: [r for r in v if _us(r.end_ns) < s0][-n:] for k, v in mine.items()}
    for part in (after, before):
        if all(len(v) == n for v in part.values()):
            return [r for name in roots for r in part[name]]
    return None


def plain_repeat(layers, recs, roots: Sequence[str]) -> Optional[list]:
    """The records of the plain repeat's units (any thread's: autograd's
    device thread records the convs' backward in the step's unit)."""
    base = plain_roots(layers, recs, roots)
    if base is None:
        return None
    units = {b.id for b in base}
    return [r for r in recs if r.unit in units]


def count(layers, part: Optional[list], counter: str) -> Optional[float]:
    """The counts of ``counter`` in a slice, per unit."""
    if part is None:
        return None
    return sum((r.counts or {}).get(counter, 0) for r in part) / layers.trace_units


def seconds(layers, part: Optional[list], match: Callable[[str], bool]) -> Optional[float]:
    """Seconds of the spans whose name ``match`` takes, in a slice, per unit;
    None where none ran there."""
    spans = [r for r in part or () if match(r.name)]
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e9 / layers.trace_units


def idle_by_span(trace, recs) -> List[List]:
    """The profiled sub-window's idle gaps (as :meth:`.trace.Trace.idle_gaps`
    finds them: between kernel intervals, and before the first and after
    the last), summed by the innermost program span that holds each gap's
    midpoint ("outside" where none does), largest first, in seconds."""
    first, last = trace.span
    gaps, end = [], first
    for s, e in sorted((s, e) for _, s, e in trace.kernels):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if last > end:
        gaps.append((end, last))
    spans = sorted((_us(r.start_ns), _us(r.end_ns), r.name) for r in recs or ()
                   if _us(r.end_ns) >= first and _us(r.start_ns) <= last)
    per = defaultdict(float)
    active, i = [], 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [a for a in active if a[1] >= mid]
        # the innermost holder started last (and, at one start, ends first)
        name = max(active, key=lambda a: (a[0], -a[1]))[2] if active else "outside"
        per[name] += (g1 - g0) / 1e6
    return [[n, v] for n, v in sorted(per.items(), key=lambda kv: -kv[1])]
