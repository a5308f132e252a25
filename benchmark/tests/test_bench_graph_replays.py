"""The reader of the backbone graphs' replays
(``metrics/backbone_graph_replays.train.py``) on made-up records: two
replays a profiled step where the graphs run, 0 where the steps stay eager,
and None where the program has no graphs' module, no recorder or no trace."""

import importlib.util

from benchmark.drivers.common import Layers
from benchmark.tests.test_bench_program_spans import _read, _serve_records, _trace, _train_records, rec

NAME = "backbone_graph_replays.train"


def _graph_records(replayed=True):
    """Train records whose profiled steps replay the backbone's graphs: the
    forward's ``backbone_graph`` span in the step, the backward's on
    autograd's thread in the step's unit; ``replayed`` False: eager steps."""
    out = [r for r in _train_records() if r.name != "conv_backward"]
    if not replayed:
        return out
    for root in [r for r in out if r.parent == 0 and r.name == "train_step"]:
        t0 = root.start_ns // 1000
        first = t0 < 1000  # set-up's step also captures
        out += [rec("backbone_graph", t0 + 100, t0 + 120, root,
                    {"graph_replays": 1, **({"graph_captures": 1} if first else {})}),
                rec("backbone_graph_backward", t0 + 150, t0 + 160, root, {"graph_replays": 1})]
    return out


def test_backbone_graph_replays(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=2)
    # two replays a profiled step; the set-up's capture and the plain and
    # later steps are outside the sub-window
    assert _read(NAME, lay, _graph_records(), monkeypatch) == 2.0
    # eager steps: the program has the graphs, none ran
    assert _read(NAME, lay, _graph_records(False), monkeypatch) == 0.0
    # a program without the graphs' module: nothing to read
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert _read(NAME, lay, _graph_records(), monkeypatch) is None


def test_none_without_a_recorder_or_a_trace(monkeypatch):
    recs = _graph_records() + _serve_records()
    assert _read(NAME, Layers(trace=_trace(), trace_units=1), None, monkeypatch) is None
    assert _read(NAME, Layers(), recs, monkeypatch) is None
    assert _read(NAME, None, recs, monkeypatch) is None
