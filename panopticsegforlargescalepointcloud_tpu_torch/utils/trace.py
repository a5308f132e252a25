"""Spans and counters inside the program: one in-memory recorder.

A span is a named interval of the host's clock ``time.time_ns()``, the
clock ``torch.profiler`` stamps its events with, so that a span lies over
the device trace's kernels and idle gaps as it is. Each record holds the
span's id, its parent's id (0 for a root), its unit's id (the outermost
open span of its thread: a train step, an evaluator's build or a scene;
every span below shares it), the name, the start and end, and the counts
recorded (:func:`count`) while it was the innermost open span of its
thread. Stacks are per thread: a span of another thread (a prefetch
thread) is a root of its own there, unless it is handed the unit it works
for (autograd's device thread, which runs a conv's backward for the step
that made the conv: :func:`unit`). A span never synchronizes the device.

The recorder is on while a span opened with ``on=True`` is open: the
program opens one where it is handed a ``timer(name)`` hook (the train
step, the evaluator's build, a scene, each hooked phase). Off,
:func:`span`, :func:`phase` and :func:`host_read` return the one shared
null context and record nothing. A span opened ``alone`` (the trainer's
``data`` and ``step``) is recorded on or off, turns nothing on and is no
span's parent; its owner takes its record back with :func:`take`.

At most ``cap`` records are kept; later ones are counted in ``dropped``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

NULL = contextlib.nullcontext()
CAP = 1 << 18


class Record(NamedTuple):
    id: int
    parent: int  # 0: a root
    unit: int  # the id of the outermost open span of its thread
    name: str
    start_ns: int
    end_ns: int
    counts: Optional[Dict[str, int]]  # recorded while innermost; None: none


class _Span:
    __slots__ = ("rec", "name", "on", "alone", "id", "parent", "unit", "start", "counts",
                 "record")

    def __init__(self, rec: "Recorder", name: str, on: bool, alone: bool = False,
                 unit: int = 0):
        self.rec, self.name, self.on, self.alone = rec, name, on, alone
        self.unit = unit  # the unit handed in, where this thread has none open
        self.counts = None

    def __enter__(self):
        rec = self.rec
        if self.on:
            with rec._lock:
                rec._on += 1
        stack = rec._stack()
        self.id = next(rec._ids)
        if stack:
            top = stack[-1]
            self.parent, self.unit = top.id, top.unit
        elif self.unit:
            self.parent = self.unit
        else:
            self.parent, self.unit = 0, self.id
        if not self.alone:
            stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        if not self.alone:
            rec._stack().pop()
        self.record = Record(self.id, self.parent, self.unit, self.name, self.start, end,
                             self.counts)
        with rec._lock:
            if len(rec.records) < rec.cap:
                rec.records.append(self.record)
            else:
                rec.dropped += 1
            rec._on -= self.on
        return False


class _Phase:
    """A hooked phase: the caller's ``timer(name)`` outside, the span
    inside it, so that the span leaves out what the hook does at its
    edges."""

    __slots__ = ("hook", "span")

    def __init__(self, rec: "Recorder", timer: Callable, name: str):
        self.hook = timer(name)
        self.span = _Span(rec, name, True)

    def __enter__(self):
        self.hook.__enter__()
        return self.span.__enter__()

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        return self.hook.__exit__(*exc)


class Recorder:
    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.records: List[Record] = []
        self.dropped = 0
        self._on = 0  # spans open with on=True, on any thread
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def innermost(self) -> Optional[str]:
        """The name of this thread's innermost open span, None where none
        is open."""
        stack = self._stack()
        return stack[-1].name if stack else None

    def unit(self) -> int:
        """The unit of this thread's innermost open span; 0 where none is
        open or the recorder is off."""
        if not self._on:
            return 0
        stack = self._stack()
        return stack[-1].unit if stack else 0

    def span(self, name: str, on: bool = False, alone: bool = False, unit: int = 0):
        """A span, recorded only; with ``on`` it keeps the recorder on while
        it is open (a unit's root), else it is recorded only while the
        recorder is on. ``alone``: recorded on or off, it turns nothing on
        and no span below it takes it for a parent. ``unit`` (of
        :meth:`unit`): on a thread with no span open, the span is a child of
        that unit's root instead of a root of its own."""
        if not (on or alone or self._on):
            return NULL
        return _Span(self, name, on, alone, unit)

    def phase(self, timer: Optional[Callable], name: str):
        """A span also handed to the caller's ``timer(name)`` hook; with no
        hook, :meth:`span`."""
        if timer is None:
            return self.span(name)
        return _Phase(self, timer, name)

    def host_read(self, tag: str, n: int = 1):
        """Around ``n`` blocking transfers between the host and the device
        (a flag, a count, a pull, uploads from pageable memory): ``n``
        ``host_syncs`` counts in a ``sync::<tag>`` span, whose length is the
        host's wait."""
        if not self._on:
            return NULL
        s = _Span(self, "sync::" + tag, False)
        s.counts = {"host_syncs": n}
        return s

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to ``name`` in the innermost open span of this thread."""
        if not self._on:
            return
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + n

    def drain(self) -> List[Record]:
        """The records kept so far, which the recorder forgets."""
        with self._lock:
            out, self.records = self.records, []
        return out

    def take(self, span: _Span) -> Record:
        """The record of a closed span, which the recorder forgets; the
        other records stay."""
        with self._lock:
            recs = self.records
            for i in range(len(recs) - 1, -1, -1):
                if recs[i] is span.record:
                    del recs[i]
                    break
        return span.record


RECORDER = Recorder()
span = RECORDER.span
unit = RECORDER.unit
phase = RECORDER.phase
host_read = RECORDER.host_read
count = RECORDER.count
drain = RECORDER.drain
take = RECORDER.take
