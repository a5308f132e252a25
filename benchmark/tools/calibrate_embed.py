"""Readings that set the limits of a cell of the embed family's driver
(``train_embed``), on the chip at the cell's own size.

    python3 -m benchmark.tools.calibrate_embed --workload train-full.setting1-npm3d \\
        --seeds 1,2,3 [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out readings.jsonl]

For each seed: the program's set-up as a run makes it (its first steps
through the timed path), its state freed, then the embed reference in f32
and the compared numbers, with the mean-shift pack of step 1 (each
sample's points, valid seeds, centres and the plain loop's passes). For the
control seeds, the reference with fp8 conv operands put in the program's
place; for the fault seeds, the program with half of each batch left out
and the program whose steps leave the state unchanged
(:mod:`.faults`). One JSON line a reading, on standard output and in
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .. import run as bench_run
from ..drivers import train_embed
from . import faults
from .calibrate import _seeds


def _cell(config, traffic, seed, device):
    cell = train_embed.EmbedTrainCell(config, traffic, seed, device=device)
    cell.setup()
    cell.release()
    return cell


def readings(config, traffic, seed, control, fault, device="cuda"):
    cell = _cell(config, traffic, seed, device)
    yield "program", cell.check()
    yield "pack", train_embed.pack_stats(cell.cfg, cell.calls[0], device)
    if control:
        yield "control", train_embed.numbers(cell, cell.reference("float8_e4m3fn"),
                                             cell.reference())
    if fault:
        for name in ("half_batch", "frozen_state"):
            undo = faults.FAULTS[name]()
            try:
                bad = _cell(config, traffic, seed, device)
            finally:
                undo()
            yield name, bad.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    manifest = bench_run.load_json(os.getcwd(), "BENCHMARK.json")
    cell = next(c for c in manifest["workloads"] if c["name"] == args.workload)
    config = bench_run.load_json(bench_run.HERE, "configs", f"{cell['config']}.json")
    traffic = bench_run.load_json(bench_run.HERE, "traffic", f"{cell['traffic']}.json")
    if traffic["driver"] != "train_embed":
        raise SystemExit(f"{args.workload} does not run under the train_embed driver")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            for kind, numbers in readings(config, traffic, seed, seed in args.control_seeds,
                                          seed in args.fault_seeds):
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
