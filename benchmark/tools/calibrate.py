"""Readings that set a cell's limits, on the chip at the cell's own size.

    python3 -m benchmark.tools.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--look-seeds 1,2,3] \\
        [--out readings.jsonl]

For each seed: the program's set-up as a run makes it (a train cell's
first steps, or a serve cell's warm scene, each through the timed path),
its state freed, then the reference in f32 and the compared numbers. For
the control seeds, the reference in fp8 put in the program's place; for
the fault seeds of a train cell, the program with half of each batch left
out. For the look seeds of a train cell, the witnesses of what the
worst leaf's gaps measure: the reference with bf16 conv operands, as the
configuration states them, against the f32 reference (``reference_bf16``),
and the program's own f32 path against it (``program_f32``); each with the
worst leaves' element-wise agreement (:func:`leaf_look`). A serve cell's
readings are given for both of its answers: the PLYs' labels (``ply``) and
the evaluator's (``labels``). One JSON line a reading, on standard output
and in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import run as bench_run
from ..drivers import serve, train
from ..reference import serve_ref
from . import faults


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def leaf_look(prog: dict, ref: dict, name: str) -> dict:
    """One leaf, program (or witness) against the reference: its size, its
    norm against the median leaf's, the cosine of the two, and the share
    of elements whose sign differs."""
    dev = ref[name].device
    p, r = prog[name].to(dev).double().flatten(), ref[name].double().flatten()
    med = float(np.median([float(v.double().norm()) for v in ref.values()]))
    den = float(p.norm() * r.norm())
    return dict(leaf=name, elements=int(r.numel()), norm_over_median=float(r.norm()) / med,
                cosine=float(p @ r) / den if den > 0 else float("nan"),
                sign_differs=float((torch.sign(p) != torch.sign(r)).double().mean()))


def look(cell, steps, ref) -> dict:
    """The compared numbers of ``steps`` (the program's where None) against
    ``ref``, and the look at their worst gradient and change leaves."""
    if steps is None:
        terms, grad, params, calls = cell.terms, cell.first_grad, cell.after, cell.calls
    else:
        terms, grad, params, calls = steps.terms, steps.first_grad, steps.params, steps.calls
    out = train.numbers(terms, grad, params, cell.init, calls, ref)
    dev = next(iter(ref.params.values())).device
    delta_p = {k: params[k].to(dev) - cell.init[k].to(dev) for k in ref.params}
    delta_r = {k: ref.params[k] - cell.init[k].to(dev) for k in ref.params}
    out["grad_look"] = leaf_look(grad, ref.first_grad, out["worst_grad_leaf"])
    out["update_look"] = leaf_look(delta_p, delta_r, out["worst_update_leaf"])
    out["update_look_step1_sign"] = leaf_look(grad, ref.first_grad, out["worst_update_leaf"])
    return out


def train_readings(config, traffic, seed, control, fault, device="cuda", witness=False):
    cell = train.TrainCell(config, traffic, seed, device=device)
    cell.setup()
    cell.release()
    if not witness:
        yield "program", train.check_steps(config, traffic, cell, device)
    else:
        ref = train.reference_steps(config, traffic, cell, device)
        yield "program", look(cell, None, ref)
        bf16 = train.reference_steps(config, traffic, cell, device, "bfloat16")
        yield "reference_bf16", look(cell, bf16, ref)
        f32 = train.TrainCell(dict(config, compute_dtype="float32"), traffic, seed,
                              device=device)
        f32.setup()
        f32.release()
        yield "program_f32", look(f32, None, train.reference_steps(config, traffic, f32, device))
    if control:
        ref = train.reference_steps(config, traffic, cell, device)
        low = train.reference_steps(config, traffic, cell, device, "float8_e4m3fn")
        yield "control", train.numbers(low.terms, low.first_grad, low.params, cell.init,
                                       low.calls, ref)
    if fault:
        undo = faults.half_batch()
        try:
            bad = train.TrainCell(config, traffic, seed, device=device)
            bad.setup()
            bad.release()
        finally:
            undo()
        yield "half_batch", train.check_steps(config, traffic, bad, device)


def serve_readings(config, traffic, seed, control, fault, device="cuda"):
    cell = serve.ServeCell(config, traffic, seed, device=device)
    try:
        cell.setup()  # its warm scene serves the sampled forest
        cell.release()
        yield "program", cell.check()
        if control:
            tiles, calls = cell.capture
            yield "control", serve_ref.control_gaps(
                config["run_config"], cell.weights, cell.forests[cell.sampled], cell.group,
                calls, device)
        sem, ins = cell.answers[cell.sampled]
        yield "stats", dict(points=int(len(sem)), dispatches=len(cell.capture[1]),
                            instances=int(len(set(np.asarray(ins).tolist()) - {-1})),
                            class_shares=[float((np.asarray(sem) == c).mean())
                                          for c in sorted(set(np.asarray(sem).tolist()))])
    finally:
        cell.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--look-seeds", type=_seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    manifest = bench_run.load_json(os.getcwd(), "BENCHMARK.json")
    cell = next(c for c in manifest["workloads"] if c["name"] == args.workload)
    config = bench_run.load_json(bench_run.HERE, "configs", f"{cell['config']}.json")
    traffic = bench_run.load_json(bench_run.HERE, "traffic", f"{cell['traffic']}.json")
    train_cell = traffic["driver"] == "train"
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            got = (train_readings(config, traffic, seed, seed in args.control_seeds,
                                  seed in args.fault_seeds, witness=seed in args.look_seeds)
                   if train_cell else
                   serve_readings(config, traffic, seed, seed in args.control_seeds,
                                  seed in args.fault_seeds))
            for kind, numbers in got:
                line = json.dumps(dict(workload=args.workload, seed=seed, kind=kind,
                                       seconds=time.perf_counter() - t0, **numbers))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
