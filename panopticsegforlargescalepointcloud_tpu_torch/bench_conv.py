"""Kernel A (forward and dX roles) and kernel D timed at every conv that the
main paths launch, on the card; or two checkouts of the repo in turns.

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.bench_conv
    python3 panopticsegforlargescalepointcloud_tpu_torch/bench_conv.py --turns OTHER_CHECKOUT

The first form records every distinct conv launch of one bf16 full train
step of the flagship (``flagship.build_inputs``: 131,072 rows; backbone and
ScoreNet) and of one eval forward of the largest 32,768-row serving tile of
the forest scene (``flagship.write_forest_scene``), then times each in bf16
through the package's wrappers with :func:`cuda_ms`: ``ms`` with the calls
issued back to back as the main paths issue them, so that a call whose
host work (checks, plan, allocations, launches) outlasts its device work is
timed at the host's rate, and ``device_ms`` with the calls queued behind a
device sleep, the device's time alone; ``library_ms`` and
``library_device_ms`` the same for one gather + ``matmul`` computing the
same function. It prints the card's name and power limit, then one JSON
object per conv.

The second form runs the first in four processes that import the package
from OTHER_CHECKOUT (another tree of the repo, such as a parent commit
unpacked with ``git archive``), this checkout, this checkout and
OTHER_CHECKOUT, in that order, all timed by this file's code, writes every
record to ``chiprun_out/conv_ab.json`` and prints one line per conv with
each run's ``ms`` and ``device_ms``. This file imports the package only
inside its functions, so that ``--root DIR`` (given to the file form)
decides which tree it times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

if __name__ == "__main__" and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    del sys.path[0]  # run as a file: the package's own folder is no import root

import torch  # noqa: E402

# published H100 SXM peaks: HBM bytes/s, dense bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

_THIS = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(_THIS))


def cuda_ms(fn, iters: int = 10, warmup: int = 2, queued: bool = False) -> float:
    """Mean ms per call of ``fn()`` over ``iters`` calls, between two CUDA
    events. The calls are issued back to back, as a caller issues them: a
    call whose host work takes longer than its device work is timed at the
    host's rate. ``queued``: the calls wait behind a device sleep of ~25 ms,
    so that the host has issued them all before the first runs, and each is
    timed at the device's rate alone."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "unknown"


@contextlib.contextmanager
def recorded_convs(found: list):
    """Pass every call of the conv kernels' wrappers through and record
    (role, map, N_in, Cin, Cout): "A" (forward), "A_dx" (A in its dX role,
    on the transpose map) and "D"."""
    from panopticsegforlargescalepointcloud_tpu_torch.ops import conv

    fwd0, dw0 = conv.sparse_conv_fwd, conv.sparse_conv_dw

    def fwd(feats, idx, weights, kernel=conv.KERNEL):
        role = "A" if kernel is conv.KERNEL else "A_dx"
        found.append((role, idx, feats.shape[0], feats.shape[1], weights.shape[2]))
        return fwd0(feats, idx, weights, kernel)

    def dw(feats, idx, g):
        found.append(("D", idx, feats.shape[0], feats.shape[1], g.shape[1]))
        return dw0(feats, idx, g)

    conv.sparse_conv_fwd, conv.sparse_conv_dw = fwd, dw
    try:
        yield
    finally:
        conv.sparse_conv_fwd, conv.sparse_conv_dw = fwd0, dw0


def distinct_convs(found, hier):
    """The distinct (role, map, N_in, Cin, Cout) of a recorded run, in order
    of first call, each map named by the level of ``hier`` it equals
    ("L2 same", "L0->L1 down", "L1->L0 up"; the ScoreNet's own hierarchy by
    its sizes)."""
    named = ([(m, f"L{lv} same") for lv, m in enumerate(hier.same_maps)]
             + [(m, f"L{lv}->L{lv + 1} down") for lv, m in enumerate(hier.down_maps)]
             + [(m, f"L{lv + 1}->L{lv} up") for lv, m in enumerate(hier.up_maps)])

    def name(idx, n_in):
        for m, label in named:
            if m.shape == idx.shape and torch.equal(m, idx):
                return label
        return f"scorer {idx.shape[0]}<-{n_in}"

    seen, convs = set(), []
    for role, idx, n_in, cin, cout in found:
        label = name(idx, n_in)
        key = (role, label, n_in, cin, cout)
        if key not in seen:
            seen.add(key)
            convs.append(dict(role=role, map=label, idx=idx, n_in=n_in, cin=cin, cout=cout))
    return convs


def train_step_convs(cfg, arrays, hier, seed: int):
    """Every distinct conv launch of one bf16 full train step of the
    flagship (forward, dX and dW of the backbone and the ScoreNet)."""
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import flagship_training
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_train_step

    state, schedule, tc = flagship_training(cfg, seed)
    step = make_train_step(cfg, state.model, state.optimizer, schedule, True, tc.grad_clip_value)
    found = []
    with recorded_convs(found):
        step(arrays, state.bn_momentum)
    return distinct_convs(found, hier)


def serving_tiles(ply: str):
    """The serving path's model config, eval-tile capacity and the tiles of
    the scene at ``ply``, largest first (``conf/eval.yaml``'s defaults)."""
    from panopticsegforlargescalepointcloud_tpu_torch.cli.eval import model_config
    from panopticsegforlargescalepointcloud_tpu_torch.data import PanopticFileDataset
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import serving_yaml
    from panopticsegforlargescalepointcloud_tpu_torch.train.evaluator import eval_tile_capacity

    run_cfg = serving_yaml()
    pcfg, spec = model_config(run_cfg)
    cap = eval_tile_capacity(run_cfg["data"])
    ds = PanopticFileDataset(spec, [ply], grid_size=0.2, radius=8.0)
    tiles = sorted((t for t, _ in ds.test_tiles(0)), key=lambda t: -len(t["coords"]))
    return pcfg, cap, tiles


def tile_forward_convs(cfg, arrays, seed: int):
    """Every distinct conv launch of one eval forward of a serving batch."""
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model
    from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
    from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize, make_eval_forward

    hier = build_hierarchy(canonicalize(*arrays).grid, cfg.num_down)
    found = []
    with recorded_convs(found):
        make_eval_forward(cfg, random_model(cfg, seed))(arrays)
    return distinct_convs(found, hier)


def conv_case(c, dt, gen):
    """Inputs for conv ``c`` in dtype ``dt`` and its calls: ``run`` (the
    kernel's wrapper), ``plain`` (its plain version), ``lib`` (one gather +
    ``matmul``), and the bytes and operations of its bound."""
    from panopticsegforlargescalepointcloud_tpu_torch.ops import conv

    role, idx, n_in, cin, cout = c["role"], c["idx"], c["n_in"], c["cin"], c["cout"]
    n_out, kvol = idx.shape
    esz = 2 if dt == torch.bfloat16 else 4
    idx_z = torch.where(idx >= 0, idx, n_in).long()
    nnz = int(((idx >= 0) & (idx < n_in)).sum())
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(dt)
    xz = torch.cat([x, x.new_zeros((1, cin))])
    if role == "D":
        g = torch.randn((n_out, cout), generator=gen, device="cuda").to(dt)
        run = lambda: conv.sparse_conv_dw(x, idx, g)  # noqa: E731
        plain = lambda: conv.sparse_conv_dw_plain(x, idx, g)  # noqa: E731
        lib = lambda: torch.matmul(xz[idx_z].reshape(n_out, kvol * cin).T, g)  # noqa: E731
        nbytes = (n_in * cin + n_out * cout) * esz + idx.numel() * 4 + kvol * cin * cout * 4
    else:
        w = (torch.randn((kvol, cin, cout), generator=gen, device="cuda")
             * (2.0 / (kvol * cout)) ** 0.5).to(dt)
        kern = conv.KERNEL if role == "A" else conv.KERNEL_DX
        run = lambda: conv.sparse_conv_fwd(x, idx, w, kern)  # noqa: E731
        plain = lambda: conv.sparse_conv_plain(x, idx, w)  # noqa: E731
        wf = w.reshape(kvol * cin, cout)
        lib = lambda: torch.matmul(xz[idx_z].reshape(n_out, kvol * cin), wf)  # noqa: E731
        nbytes = n_in * cin * esz + idx.numel() * 4 + kvol * cin * cout * esz + n_out * cout * 4
    t_b = nbytes / HBM_BPS * 1e3
    t_o = 2.0 * nnz * cin * cout / PEAK_FLOPS[dt] * 1e3
    return dict(run=run, plain=plain, lib=lib, n_out=n_out, nnz=nnz, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def time_convs(convs, where: str, seed: int = 1):
    """One bf16 record per conv: the wrapper's and the library call's ms
    (back to back) and device ms (queued)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    recs = []
    for c in convs:
        case = conv_case(c, torch.bfloat16, gen)
        recs.append(dict(
            where=where, role=c["role"], shape=f"{c['map']} {c['cin']}->{c['cout']}",
            n_out=case["n_out"], ms=cuda_ms(case["run"]),
            device_ms=cuda_ms(case["run"], queued=True),
            library_ms=cuda_ms(case["lib"], iters=3, warmup=1),
            library_device_ms=cuda_ms(case["lib"], iters=3, warmup=1, queued=True),
            bound_ms=case["bound_ms"]))
    return recs


def run_all(seed: int = 5):
    """Records of every conv of the flagship's full train step and of a
    serving tile's forward."""
    from panopticsegforlargescalepointcloud_tpu_torch.data import batch_arrays, collate_tiles
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        build_inputs,
        flagship_config,
        write_forest_scene,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
    from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize
    from panopticsegforlargescalepointcloud_tpu_torch.train.evaluator import grouped_config

    cfg = flagship_config(num_samples=4, compute_dtype="bfloat16")
    arrays = build_inputs()
    hier = build_hierarchy(canonicalize(*arrays).grid, cfg.num_down)
    recs = time_convs(train_step_convs(cfg, arrays, hier, seed), "train step")
    del hier
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "forest.ply")
        write_forest_scene(ply)
        pcfg, cap, tiles = serving_tiles(ply)
    tile_cfg = grouped_config(pcfg, cap, 1)
    tile_arrays = batch_arrays(collate_tiles(tiles[:1], capacity=cap, num_tiles=1))
    recs += time_convs(tile_forward_convs(tile_cfg, tile_arrays, 9), "serving tile")
    return recs


def turns(other: str, out: str) -> int:
    """This file's first form on ``other``, this checkout, this checkout,
    ``other``, each in its own process."""
    order = [("other", other), ("this", _ROOT), ("this", _ROOT), ("other", other)]
    runs = []
    for label, root in order:
        res = subprocess.run([sys.executable, _THIS, "--root", root], stdout=subprocess.PIPE,
                             text=True, timeout=1800)
        if res.returncode != 0:
            print(f"bench_conv: the run on {root} failed ({res.returncode})", file=sys.stderr)
            return 1
        lines = res.stdout.splitlines()
        runs.append(dict(tree=label, root=root, card=lines[0],
                         records=[json.loads(x) for x in lines[1:] if x.startswith("{")]))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(runs, fh, indent=0)
    print(runs[0]["card"])
    lines = summary(runs)
    for line in lines:
        print(json.dumps(line))
    return 0 if lines else 1


def summary(runs):
    """One line per conv: each run's ``ms``, ``device_ms`` and
    ``library_ms``, in run order; none if the runs launched different
    convs."""
    lines = []
    for i, rec in enumerate(runs[0]["records"]):
        row = [run["records"][i] for run in runs]
        if any((r["where"], r["role"], r["shape"]) != (rec["where"], rec["role"], rec["shape"])
               for r in row):
            print("bench_conv: the trees launched different convs", file=sys.stderr)
            return []
        lines.append(dict(where=rec["where"], role=rec["role"], shape=rec["shape"],
                          trees=[run["tree"] for run in runs], ms=[r["ms"] for r in row],
                          device_ms=[r["device_ms"] for r in row],
                          library_ms=[r["library_ms"] for r in row]))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="import the package from this checkout of the repo")
    ap.add_argument("--turns", metavar="OTHER_CHECKOUT",
                    help="time OTHER_CHECKOUT and this checkout in turns")
    ap.add_argument("--out", default=os.path.join(_ROOT, "chiprun_out", "conv_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_conv: needs a CUDA device", file=sys.stderr)
        return 2
    if args.turns:
        return turns(os.path.abspath(args.turns), args.out)
    sys.path.insert(0, os.path.abspath(args.root or _ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    for rec in run_all():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
