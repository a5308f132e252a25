"""The program's spans and counters on the chip, beyond what a run's result
line holds.

    python3 -m benchmark.tools.spans census [--seed N] [--out census.json]
    python3 -m benchmark.tools.spans report --workload <name> [--seed N]
        [--seconds S] [--out report.json]

``census``: one full train step (train-full's) and one served scene
(serve-ply's) under ``torch.cuda.set_sync_debug_mode("warn")``, with the
program's recorder on. Each synchronization the mode reports is put down to
its calling line in the repository and marked by whether the thread was
inside a ``host_read`` (its innermost span a ``sync::`` one); beside it,
the ``host_syncs`` the recorder counted. The harness's own reads (the
step's metrics as floats) stay outside the checked region.

``report``: one traced run of a cell through its driver, as ``--trace 1``
runs it, and then: the cell's per-layer metrics; the profiled
sub-window's idle gaps put down to the innermost program span
(:func:`..program_spans.idle_by_span`) against the total of
``Trace.idle_gaps(top=None)``; whether every program root of the
sub-window lies inside it; the program's counts a unit in the profiled
sub-window and in the plain repeat; the records a plain unit; the plain
unit's seconds.

Both need a CUDA card and print one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json
import os
import sys
import traceback
import warnings

import torch

from .. import program_spans as ps
from .. import run as bench_run
from ..drivers import serve, train
from ..timing import PhaseTimer

ROOT = os.getcwd()


def _hook(name):
    return contextlib.nullcontext()


def _site(stack) -> str:
    """The innermost frame of the repository, with the two above it."""
    mine = [f for f in stack if f.filename.startswith(ROOT)]
    return " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                       for f in reversed(mine[-3:])) or "(no frame of the repository)"


def census(seed: int) -> dict:
    from panopticsegforlargescalepointcloud_tpu_torch.utils import trace

    seen = collections.Counter()
    region = {"name": None}

    def show(message, category, filename, lineno, file=None, line=None):
        if region["name"] is None or "called a synchronizing" not in str(message):
            return
        inside = (trace.RECORDER.innermost() or "").startswith("sync::")
        seen[(region["name"], inside, _site(traceback.extract_stack()[:-1]))] += 1

    def checked(name, fn):
        trace.drain()
        torch.cuda.synchronize()
        region["name"] = name
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            region["name"] = None
        recs = trace.drain()
        return out, sum((r.counts or {}).get("host_syncs", 0) for r in recs)

    warnings.showwarning = show
    warnings.simplefilter("always")
    counted = {}
    config = bench_run.load_json(bench_run.HERE, "configs", "setting4-npm3d.json")
    traffic = bench_run.load_json(bench_run.HERE, "traffic", "train-full.json")
    cell = train.TrainCell(config, traffic, seed, timer=_hook)
    cell.setup()
    p = cell.p
    arrays = p["batch_arrays"](p["collate_tiles"](
        [cell.pool[t] for t in next(cell.order)], capacity=cell.capacity,
        num_tiles=cell.batch_tiles))
    metrics, counted["train step"] = checked(
        "train step", lambda: cell.step(arrays, cell.bn_momentum))
    loss = float(metrics["loss"])
    cell.release()
    config = bench_run.load_json(bench_run.HERE, "configs", "setting4-forinstance.json")
    traffic = bench_run.load_json(bench_run.HERE, "traffic", "serve-ply.json")
    scene = serve.ServeCell(config, traffic, seed, timer=_hook)
    try:
        scene.setup()
        _, counted["scene"] = checked("scene", lambda: scene.serve(0))
    finally:
        scene.close()
    rows = [dict(region=r, inside_host_read=i, syncs=n, site=s)
            for (r, i, s), n in sorted(seen.items(), key=lambda kv: (kv[0][0], -kv[1]))]
    summary = {region: dict(reported=sum(x["syncs"] for x in rows if x["region"] == region),
                            outside_host_read=sum(x["syncs"] for x in rows
                                                  if x["region"] == region
                                                  and not x["inside_host_read"]),
                            host_syncs_counted=n)
               for region, n in counted.items()}
    return dict(device=torch.cuda.get_device_name(0), loss=loss, summary=summary, rows=rows)


def report(workload: str, seed: int, seconds: float) -> dict:
    manifest = bench_run.load_json(ROOT, "BENCHMARK.json")
    cell = next(c for c in manifest["workloads"] if c["name"] == workload)
    config = bench_run.load_json(bench_run.HERE, "configs", f"{cell['config']}.json")
    traffic = bench_run.load_json(bench_run.HERE, "traffic", f"{cell['traffic']}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    out = driver.run(config, traffic, seed, seconds, timer=PhaseTimer(torch.cuda.synchronize),
                     profile=True)
    layers, recs = out.layers, ps.records()
    roots = ps.TRAIN if traffic["driver"] == "train" else ps.SERVE
    tr = layers.trace
    s0, s1 = tr.span
    sub = [r for r in recs if r.parent == 0 and r.name in roots
           and r.end_ns / 1e3 >= s0 and r.start_ns / 1e3 <= s1]
    table = ps.idle_by_span(tr, recs)
    counters = ("host_syncs", "grow_rounds")
    return dict(
        workload=workload, seed=seed,
        device=torch.cuda.get_device_name(0),
        correct_numbers=out.numbers,
        metrics={m["name"]: bench_run.load_reader(m["name"])(layers)
                 for m in bench_run.cell_metrics(manifest, cell, True)},
        idle_by_span=table, idle_by_span_total_s=sum(v for _, v in table),
        idle_gaps_total_s=sum(v for _, v in tr.idle_gaps(top=None)),
        sub_window_us=[s0, s1],
        roots_in_sub_window=[[r.name, r.start_ns / 1e3, r.end_ns / 1e3] for r in sub],
        roots_inside=all(s0 <= r.start_ns / 1e3 and r.end_ns / 1e3 <= s1 for r in sub),
        profiled={c: ps.count(layers, ps.sub_window(layers, recs, roots), c) for c in counters},
        plain={c: ps.count(layers, ps.plain_repeat(layers, recs, roots), c) for c in counters},
        plain_records_a_unit=len(ps.plain_repeat(layers, recs, roots) or ()) / layers.trace_units,
        plain_unit_s=layers.plain_unit_s, trace_units=layers.trace_units,
        dropped=_dropped(), lines=out.lines)


def _dropped() -> int:
    from panopticsegforlargescalepointcloud_tpu_torch.utils import trace

    return trace.RECORDER.dropped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("census", "report"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(bench_run.HOST_THREADS)
    torch.set_num_threads(bench_run.HOST_THREADS)
    if args.what == "census":
        result = census(args.seed)
    else:
        result = report(args.workload, args.seed, args.seconds)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
