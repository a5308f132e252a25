"""The clustering stages timed on the card, the kernels B and C inside
them: region growing's ``dense_components`` and ``mean_shift``; or two
checkouts of the repo in turns.

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.bench_cluster
    python3 panopticsegforlargescalepointcloud_tpu_torch/bench_cluster.py --turns OTHER_CHECKOUT

The first form times, with ``bench_conv.cuda_ms`` (calls back to back, the
host's work and the functions' own host syncs included; the median of five
runs of ten calls):

* ``dense_components`` at T = 49,152, 24,576 and 12,288 rows on two kinds
  of operands: the flagship eval forward's own region-growing operands
  (captured from one bf16 ``make_eval_forward`` on ``build_inputs()``; the
  smaller T take its first rows) and random-class operands (the batch's
  first T rows, ids = batch * C + a random class:
  :func:`random_class_operands`), each with its B launches and host syncs
  per call;
* ``mean_shift`` at the flagship's (B 4, S 128, Np 16,384, E 5) and the
  serving tile's one and two samples, on seeded blobs, with its C launches
  and host syncs per call (since one launch runs the whole loop, the syncs
  left are those of the greedy dedup's rounds, ``_dedup_keep``);
* the flagship bf16 eval forward's ``region_growing`` and ``mean_shift``
  phases (host clock around each phase, ending in a synchronize; median of
  three forwards).

It prints the card's name and power limit, then one JSON object per record.
The second form runs the first in four processes that import the package
from OTHER_CHECKOUT (another tree of the repo, such as a parent commit
unpacked with ``git archive``), this checkout, this checkout and
OTHER_CHECKOUT, in that order, all timed by this file's code, writes every
record to ``chiprun_out/cluster_ab.json`` and prints one line per record
with each run's numbers. The functions timed have the same signatures in
both trees; this file imports the package only inside its functions.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

if __name__ == "__main__" and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    del sys.path[0]  # run as a file: the package's own folder is no import root

import numpy as np  # noqa: E402
import torch  # noqa: E402

_THIS = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(_THIS))
SIZES = (49152, 24576, 12288)


def cuda_ms(fn, repeats: int = 5) -> float:
    """The median over ``repeats`` of ``bench_conv.cuda_ms(fn, 10)`` (ms per
    call, calls back to back): these stages sync with the host, whose
    clock on a shared machine jumps by milliseconds now and then."""
    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv import cuda_ms as timed

    return statistics.median(timed(fn, 10, 1) for _ in range(repeats))


class PhaseTimer:
    """Host clock around each phase, ending in a device synchronize."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def captured_region_growing(found: list):
    """Pass every ``dense_components`` call of region growing through and
    record its arguments."""
    from panopticsegforlargescalepointcloud_tpu_torch.cluster import region_grow

    dc0 = region_grow.dense_components

    def dc(pos, ids, valid, radius, init_labels, max_iters=64):
        found.append(dict(pos=pos, ids=ids, valid=valid, radius=radius, init=init_labels,
                          max_iters=max_iters))
        return dc0(pos, ids, valid, radius, init_labels, max_iters)

    region_grow.dense_components = dc
    try:
        yield
    finally:
        region_grow.dense_components = dc0


def init_labels(cfg, pos, ids, valid):
    """Region growing's initial labels for these rows (its cell seeding)."""
    from panopticsegforlargescalepointcloud_tpu_torch.cluster.neighbors import cell_seed_labels
    from panopticsegforlargescalepointcloud_tpu_torch.cluster.region_grow import _fold_bits

    num_ids = cfg.num_samples * cfg.num_classes
    return cell_seed_labels(pos, ids, valid, cfg.cluster_radius, _fold_bits(num_ids),
                            num_ids=num_ids)


def forward_operands(cfg, captured, t: int):
    """The first T rows of the forward's first region-growing call:
    (pos, ids, valid, init)."""
    c = captured[0]
    pos, ids, valid = c["pos"][:t], c["ids"][:t].to(torch.int32), c["valid"][:t]
    return pos, ids, valid, init_labels(cfg, pos, ids, valid)


def random_class_operands(cfg, db, t: int, seed: int):
    """The batch's first T rows (by key order), ids = batch * C + a random
    class: (pos, ids, valid, init)."""
    dev = db.pos.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.nonzero(db.grid.mask).squeeze(1)[:t]
    valid = torch.zeros(t, dtype=torch.bool, device=dev)
    valid[: rows.shape[0]] = True
    idx = torch.zeros(t, dtype=torch.long, device=dev)
    idx[: rows.shape[0]] = rows
    cls = torch.randint(0, cfg.num_classes, (t,), generator=gen, device=dev, dtype=torch.int32)
    ids = (db.grid.batch[idx] * cfg.num_classes + cls).to(torch.int32)
    pos = db.pos[idx]
    return pos, ids, valid, init_labels(cfg, pos, ids, valid)


def blobs(bsz: int, np_: int, e: int, seed: int):
    """Seeded mean-shift inputs: 24 Gaussian blobs per sample (centres
    std 2, spread 0.3), 10% invalid points; x [B, Np, E] f32, valid."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(bsz, 24, e))
    pick = rng.integers(0, 24, (bsz, np_))
    x = np.take_along_axis(centers, pick[..., None], axis=1)
    x = x + 0.3 * rng.normal(size=(bsz, np_, e))
    valid = rng.random((bsz, np_)) > 0.1
    return (torch.from_numpy(x.astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


def serving_config(g: int):
    """The serving path's model config for g tiles per dispatch."""
    from panopticsegforlargescalepointcloud_tpu_torch.cli.eval import model_config
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import serving_yaml
    from panopticsegforlargescalepointcloud_tpu_torch.train.evaluator import (
        eval_tile_capacity,
        grouped_config,
    )

    run_cfg = serving_yaml()
    pcfg, _ = model_config(run_cfg)
    return grouped_config(pcfg, eval_tile_capacity(run_cfg["data"]), g)


def launches_of(kernel, fn):
    """One call of ``fn``: (launches of ``kernel``, host syncs, result). A
    host sync is an operation that waits for the device (``bool`` of a
    device tensor, ``torch.equal``, ``.item()``), counted as torch.cuda's
    sync debug mode warns of it."""
    before = kernel.launches
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return kernel.launches - before, syncs, out


def run_all(seed: int = 5):
    from panopticsegforlargescalepointcloud_tpu_torch.cluster import dense_grow
    from panopticsegforlargescalepointcloud_tpu_torch.cluster import meanshift as ms
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        build_inputs,
        flagship_config,
        random_model,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    cfg = flagship_config(num_samples=4, compute_dtype="bfloat16")
    arrays = build_inputs()
    model = random_model(cfg, seed)
    fwd = make_eval_forward(cfg, model)
    captured = []
    with captured_region_growing(captured):
        db, _ = fwd(arrays)
    recs = []
    for kind in ("forward", "random_class"):
        for t in SIZES:
            if kind == "forward":
                pos, ids, valid, init = forward_operands(cfg, captured, t)
            else:
                pos, ids, valid, init = random_class_operands(cfg, db, t, seed=3)
            call = lambda: dense_grow.dense_components(  # noqa: E731
                pos, ids, valid, cfg.cluster_radius, init)
            n, syncs, labels = launches_of(dense_grow.KERNEL, call)
            recs.append(dict(stage="dense_components", operands=kind, t=t, ms=cuda_ms(call),
                             launches=n, syncs=syncs, valid_rows=int(valid.sum()),
                             components=int(torch.unique(labels[valid]).numel())))
    for label, c in (("flagship", cfg), ("scene g=1", serving_config(1)),
                     ("scene g=2", serving_config(2))):
        x, valid = blobs(c.num_samples, c.ms_point_cap, c.embed_dim, seed=2)
        call = lambda: ms.mean_shift(x, valid, bandwidth=c.bandwidth,  # noqa: E731
                                     max_seeds=c.ms_max_seeds)
        n, syncs, res = launches_of(ms.KERNEL, call)
        recs.append(dict(stage="mean_shift", shape=label,
                         b=c.num_samples, s=c.ms_max_seeds, np=c.ms_point_cap, e=c.embed_dim,
                         ms=cuda_ms(call), launches=n, syncs=syncs,
                         clusters=res.num_clusters.tolist()))
    phases = []
    for _ in range(3):
        timer = PhaseTimer()
        make_eval_forward(cfg, model, timer=timer)(arrays)
        phases.append(timer.ms)
    for name in ("region_growing", "mean_shift"):
        vals = [p[name] for p in phases]
        recs.append(dict(stage="eval_forward_phase", phase=name,
                         ms=statistics.median(vals), runs_ms=vals))
    del db
    return recs


def key(rec):
    return (rec["stage"], rec.get("operands"), rec.get("t"), rec.get("shape"),
            rec.get("phase"))


def turns(other: str, out: str) -> int:
    """This file's first form on ``other``, this checkout, this checkout,
    ``other``, each in its own process."""
    order = [("other", other), ("this", _ROOT), ("this", _ROOT), ("other", other)]
    runs = []
    for label, root in order:
        res = subprocess.run([sys.executable, _THIS, "--root", root], stdout=subprocess.PIPE,
                             text=True, timeout=1800)
        if res.returncode != 0:
            print(f"bench_cluster: the run on {root} failed ({res.returncode})",
                  file=sys.stderr)
            return 1
        lines = res.stdout.splitlines()
        runs.append(dict(tree=label, root=root, card=lines[0],
                         records=[json.loads(x) for x in lines[1:] if x.startswith("{")]))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(runs, fh, indent=0)
    print(runs[0]["card"])
    for i, rec in enumerate(runs[0]["records"]):
        row = [run["records"][i] for run in runs]
        if any(key(r) != key(rec) for r in row):
            print("bench_cluster: the trees gave different records", file=sys.stderr)
            return 1
        per_run = ("ms", "launches", "syncs")
        line = {k: v for k, v in rec.items() if k not in per_run + ("runs_ms",)}
        line["trees"] = [run["tree"] for run in runs]
        line.update({k: [r[k] for r in row] for k in per_run if k in rec})
        print(json.dumps(line))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="import the package from this checkout of the repo")
    ap.add_argument("--turns", metavar="OTHER_CHECKOUT",
                    help="time OTHER_CHECKOUT and this checkout in turns")
    ap.add_argument("--out", default=os.path.join(_ROOT, "chiprun_out", "cluster_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_cluster: needs a CUDA device", file=sys.stderr)
        return 2
    if args.turns:
        return turns(os.path.abspath(args.turns), args.out)
    sys.path.insert(0, os.path.abspath(args.root or _ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv import card_line

    print(card_line(), flush=True)
    for rec in run_all():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
