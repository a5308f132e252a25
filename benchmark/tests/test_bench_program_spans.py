"""The readers of the program's spans and counters
(``benchmark/program_spans.py`` and its ``metrics/<name>.py``) on made-up
records: the profiled sub-window's counts, the plain repeat's times, the
division by units, None where the program has no recorder or a span never
ran, and the idle gaps put down to the innermost span."""

import pytest

from benchmark import program_spans as ps
from benchmark import run, trace
from benchmark.drivers.common import Layers
from panopticsegforlargescalepointcloud_tpu_torch.utils.trace import Record

_ids = iter(range(1, 10_000))


def rec(name, t0, t1, parent=None, counts=None):
    """A record from t0 to t1 us; ``parent`` a record (None: a root)."""
    i = next(_ids)
    return Record(i, parent.id if parent else 0, parent.unit if parent else i, name,
                  int(t0 * 1e3), int(t1 * 1e3), counts)


def _trace(kernels=()):
    # the profiled sub-window runs from 1,000 to 2,000 us
    return trace.Trace(1e-3, 0.0, list(kernels), [], (1000.0, 2000.0))


def _train_records():
    out = [rec("train_step", 100, 200, counts={"host_syncs": 5})]  # set-up: before the window
    for t0, t1 in ((1100, 1400), (1500, 1900)):  # the profiled steps
        root = rec("train_step", t0, t1)
        rounds = {"grow_rounds": 3 if t0 == 1100 else 1}
        grow = rec("region_growing", t0 + 10, t0 + 90, root, rounds)
        out += [root, grow, rec("sync::grow", t0 + 20, t0 + 30, grow, {"host_syncs": 1}),
                rec("conv_backward", t0 + 150, t0 + 200, root)]  # autograd's thread
    plain = [rec("train_step", 2100, 2500), rec("train_step", 2600, 3000)]
    out += plain + [rec("sync::grow", 2200, 2210, plain[0], {"host_syncs": 1}),
                    rec("sync::batch", 2700, 2720, plain[1], {"host_syncs": 1}),
                    rec("conv_backward", 2300, 2340, plain[0]),
                    rec("conv_backward", 2800, 2860, plain[1]),
                    # another thread's unit, inside a plain step's time
                    rec("sync::other", 2400, 2500, counts={"host_syncs": 1})]
    later = rec("train_step", 3100, 3500)
    return out + [later, rec("sync::grow", 3200, 3300, later, {"host_syncs": 1}),
                  rec("conv_backward", 3300, 3400, later)]


def _serve_records(ply=True, starts=(1100, 2100)):
    out = []
    for t0 in starts:  # by default the profiled scene, then its plain repeat
        build, scene = rec("build_evaluator", t0, t0 + 300), rec("scene", t0 + 300, t0 + 800)
        out += [build, scene, rec("model", t0 + 10, t0 + 20, build),
                rec("model", t0 + 100, t0 + 150, build),
                rec("sync::model_to", t0 + 200, t0 + 260, build, {"host_syncs": 1}),
                rec("sync::pull", t0 + 400, t0 + 410, scene, {"host_syncs": 1})]
        if ply:
            report = rec("report", t0 + 600, t0 + 790, scene)
            out += [report] + [rec("ply_write", t0 + 600 + 60 * k, t0 + 650 + 60 * k, report)
                               for k in range(3)]
    return out


def _read(name, layers, recs, monkeypatch):
    monkeypatch.setattr(ps, "records", lambda: recs)
    return run.load_reader(name)(layers)


def test_sub_window_counts_per_unit(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=2)
    recs = _train_records()
    part = ps.sub_window(lay, recs, ps.TRAIN)
    assert sorted({r.start_ns // 1000 for r in part if r.parent == 0}) == [1100, 1500]
    assert len(part) == 8
    # the set-up's five and the later step's one are outside
    assert _read("host_syncs.train", lay, recs, monkeypatch) == pytest.approx(1.0)
    assert _read("grow_rounds.train", lay, recs, monkeypatch) == pytest.approx(2.0)
    # a serve slice asks for other roots
    assert ps.sub_window(lay, recs, ps.SERVE) is None


def test_plain_repeat_times_per_unit(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=2)
    recs = _train_records()
    assert [r.start_ns // 1000 for r in ps.plain_roots(lay, recs, ps.TRAIN)] == [2100, 2600]
    # the plain steps' 10 + 20 us of host reads and 40 + 60 us of conv
    # backward (on another thread, in the steps' units), over 2 steps; the
    # other unit's read inside a step's time is not the step's
    assert _read("sync_wait_ms.train", lay, recs, monkeypatch) == pytest.approx(0.015)
    assert _read("conv_backward_ms.train", lay, recs, monkeypatch) == pytest.approx(0.05)
    # fewer roots after the sub-window than units: nothing to read
    lay3 = Layers(trace=_trace(), trace_units=4)
    assert ps.plain_roots(lay3, recs, ps.TRAIN) is None
    assert _read("conv_backward_ms.train", lay3, recs, monkeypatch) is None


def test_serve_readers(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=1)
    recs = _serve_records()
    assert _read("host_syncs.serve", lay, recs, monkeypatch) == pytest.approx(2.0)
    assert _read("model_load_s.serve", lay, recs, monkeypatch) == pytest.approx(60e-6)
    assert _read("ply_write_s.serve", lay, recs, monkeypatch) == pytest.approx(150e-6)
    # no PLYs written: the span never ran
    assert _read("ply_write_s.serve", lay, _serve_records(ply=False), monkeypatch) is None


def test_serve_times_where_the_window_closed_before_the_plain_scene(monkeypatch):
    lay = Layers(trace=_trace(), trace_units=1)
    # the window's scene before the sub-window, the profiled scene, no plain
    # scene; the earlier scene's second model span is 40 us longer
    recs = _serve_records(starts=(100, 1100))
    recs = [r._replace(end_ns=r.end_ns + 40_000) if r.name == "model" and r.start_ns == 200_000
            else r for r in recs]
    assert [r.start_ns // 1000 for r in ps.plain_roots(lay, recs, ps.SERVE)] == [100, 400]
    assert _read("model_load_s.serve", lay, recs, monkeypatch) == pytest.approx(100e-6)
    assert _read("ply_write_s.serve", lay, recs, monkeypatch) == pytest.approx(150e-6)
    assert _read("host_syncs.serve", lay, recs, monkeypatch) == pytest.approx(2.0)
    # the profiled scene alone: nothing to time
    assert _read("model_load_s.serve", lay, _serve_records(starts=(1100,)), monkeypatch) is None


@pytest.mark.parametrize("name", ["host_syncs.train", "host_syncs.serve", "sync_wait_ms.train",
                                  "grow_rounds.train", "conv_backward_ms.train",
                                  "model_load_s.serve", "ply_write_s.serve"])
def test_none_without_a_recorder_or_a_trace(name, monkeypatch):
    recs = _train_records() + _serve_records()
    assert _read(name, Layers(trace=_trace(), trace_units=1), None, monkeypatch) is None
    assert _read(name, Layers(), recs, monkeypatch) is None
    assert _read(name, None, recs, monkeypatch) is None


def test_records_of_the_program_recorder():
    from panopticsegforlargescalepointcloud_tpu_torch.utils import trace as program

    program.drain()
    with program.span("train_step", on=True):
        with program.host_read("grow"):
            pass
    got = ps.records()
    program.drain()
    assert [r.name for r in got] == ["sync::grow", "train_step"]


def test_idle_gaps_by_innermost_span():
    kernels = [("k", 1100.0, 1150.0), ("k", 1300.0, 1400.0), ("k", 1600.0, 1950.0)]
    tr = _trace(kernels)
    root = rec("train_step", 1060, 1980)
    grow = rec("region_growing", 1140, 1320, root)
    recs = [root, grow, rec("sync::grow", 1200, 1280, grow, {"host_syncs": 1}),
            rec("backward", 1400, 1600, root)]
    table = dict(ps.idle_by_span(tr, recs))
    # gaps 1000-1100 (outside), 1150-1300 (mid 1225: the sync), 1400-1600
    # (mid 1500: backward), 1950-2000 (mid 1975: the step)
    assert table == pytest.approx({"outside": 100e-6, "sync::grow": 150e-6,
                                   "backward": 200e-6, "train_step": 50e-6})
    total = sum(v for _, v in tr.idle_gaps(top=None))
    assert sum(table.values()) == pytest.approx(total)
    assert dict(ps.idle_by_span(tr, None)) == pytest.approx({"outside": total})
