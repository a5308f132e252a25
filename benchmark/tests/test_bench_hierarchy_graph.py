"""The reader of the hierarchy graph's replays
(``metrics/hierarchy_graph_replays.train.py``) on made-up records: the
``hier_graph_replays`` counts of the profiled steps summed per step (the
main build's and the ScoreNet's), 0 where the builds stay eager, and None
where the program's hierarchy has no graph, and without a recorder or a
trace."""

import importlib
import types

from benchmark.drivers.common import Layers
from benchmark.tests.test_bench_program_spans import _read, _serve_records, _trace, _train_records, rec

NAME = "hierarchy_graph_replays.train"


def _graph_records(builds=2, replayed=True):
    """Train records whose profiled steps replay ``builds`` hierarchy graphs
    a step, each in a ``hierarchy_graph`` span (the set-up's step also
    captures); ``replayed`` False: eager steps."""
    out = list(_train_records())
    if not replayed:
        return out
    for root in [r for r in out if r.parent == 0 and r.name == "train_step"]:
        t0 = root.start_ns // 1000
        first = t0 < 1000
        for k in range(builds):
            out.append(rec("hierarchy_graph", t0 + 30 + 20 * k, t0 + 40 + 20 * k, root,
                           {"hier_graph_replays": 1,
                            **({"hier_graph_captures": 1} if first else {})}))
    return out


def test_hierarchy_graph_replays(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=2)
    # Setting IV: the main build and the ScoreNet's, per profiled step
    assert _read(NAME, lay, _graph_records(2), monkeypatch) == 2.0
    # Setting I: the main build alone
    assert _read(NAME, lay, _graph_records(1), monkeypatch) == 1.0
    # eager builds: the program has the graph, none ran
    assert _read(NAME, lay, _graph_records(replayed=False), monkeypatch) == 0.0


def test_other_counters_are_not_read(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=2)
    recs = _graph_records(1) + [rec("backbone_graph", 1120, 1130, None,
                                    {"graph_replays": 1, "graph_captures": 1})]
    assert _read(NAME, lay, recs, monkeypatch) == 1.0


def test_none_where_the_hierarchy_has_no_graph(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=2)
    real = importlib.import_module

    def without_graph(name, *a, **k):
        if name.endswith("ops.hierarchy"):
            return types.SimpleNamespace()
        return real(name, *a, **k)

    monkeypatch.setattr(importlib, "import_module", without_graph)
    assert _read(NAME, lay, _graph_records(2), monkeypatch) is None


def test_none_without_a_recorder_or_a_trace(monkeypatch):
    recs = _graph_records() + _serve_records()
    assert _read(NAME, Layers(trace=_trace(), trace_units=1), None, monkeypatch) is None
    assert _read(NAME, Layers(), recs, monkeypatch) is None
    assert _read(NAME, None, recs, monkeypatch) is None
