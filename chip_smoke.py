#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card (name, power limit) and builds the CUDA kernels of
   ``panopticsegforlargescalepointcloud_tpu_torch/csrc`` with ``nvcc``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: A (sparse conv), A in its dX role and D
   (conv weight gradient) at every distinct (map, Cin, Cout) that one bf16
   full train step of the flagship launches (131,072 rows; backbone and
   ScoreNet), in bf16 and f32, each also launched twice to check that it
   repeats bit for bit ("conv" lines, "determinism"); B (dense min pull
   over its candidate block pairs) against the all-pairs spec with 0
   differing rows at T = 49,152, 24,576 and 12,288 on the flagship
   forward's own region-growing rows, random-class rows and rows placed at
   the radius far from the origin ("B" lines: pairs evaluated, both
   bounds, the tables' build); C (the whole mean-shift loop in one launch)
   against the plain loop at B = 4, S = 128, Np = 16,384, E = 5 (counts and
   iteration counts exact, seeds within 1e-5), and its one-update form,
   also against the update with f32 sums; how far the loop with f32 sums
   lies from the kernel, and from itself in another order, is logged.
   Then the conv's backward (dX by A on the transpose map, dW by D) against
   autograd of the plain gather conv. Each kernel time ``ms`` is taken
   with the calls back to back, as the main paths issue them (a call whose
   host work outlasts its device work is timed at the host's rate), and
   ``device_ms`` with the calls queued behind a device sleep (the device's
   time alone).
3. Drives the first main path, the eval forward of the flagship Setting IV
   model (paper plan, in_feat 16, 9 classes, 4 tiles of synthetic
   NPM3D-scale data, 131,072 rows, seeded random weights and BN
   statistics): once in f32 with the kernels and once with the plain
   versions, which must agree; then in bf16 as shipped, timed per phase,
   with every kernel's launch count (C at most twice per forward).
4. Drives the second main path, the train step of the same model from the
   JAX package's initializers (Adam, lr 0.001, BN momentum 0.1): one f32
   full step with the kernels and one with the plain versions, which must
   agree on losses, gradients and proposals; then the shipped bf16 steps, 5
   prepare and 3 full, timed per step and per phase, with launches per step
   and peak memory.
5. Kernel E, the per-part probe of A: each part (full, index, gather,
   contig) against its plain version at the L0 same 16->16 and L1->L0 up
   64->64 maps, ``full`` bit for bit against A; then the probe's own path
   (``bench_conv_parts.run``) times every part.
6. Drives the third main path, full-scene serving through the eval CLI's
   code path (``cli/eval.py:build_evaluator``) from a port checkpoint of
   seeded random weights, on ``conf/eval.yaml``'s flagship (the same model
   on ``treeins_rad8``, 32,768-row tiles) and the JAX package's
   ``bench.py:measure_e2e`` forest: a quarter of it in f32 with the kernels
   and with the plain versions, which must agree on the labels; then the
   whole ~500k-point scene in bf16 at 1 and 2 tiles per dispatch, each run
   once warm and once timed per phase.
   A is also held against its plain version at every conv of one eval
   forward of the forest's largest 32,768-row tile ("eval tile conv").
7. Drives the fourth main path, the trainer, through the train and forward
   CLIs (``cli/train.py:main``, ``cli/forward.py:main``) with the root
   config's defaults: Setting IV on ``treeins_rad8``, paper plan,
   131,072-row batches of 4 tiles, bf16, Adam, 2 prefetch workers, seeded
   initial weights. The forest above is the train file and its quarter the
   val file; 2 epochs of 8 steps (``samples_per_epoch`` 32) with the full
   phase in epoch 2 (``prepare_epoch`` 1) and a full-split validation after
   each epoch; then the same run directory resumed to epoch 3 (start epoch
   3, the count going on from 16 to 24); then the forward CLI with that
   checkpoint over the quarter scene. Every train step must launch A, A's
   dX and D, and every full step B (and its tables) and C; every logged loss
   must be finite, ``metrics.jsonl`` must have one line per epoch and the
   forward PLY one row per scene point with labels in the class range.
   Per epoch ("trainer epoch" lines): the median s per step, the data and
   step seconds per step from the trainer's stage timers, the losses, the
   validation metrics and the peak memory; the whole record goes to
   ``chiprun_out/trainer.json``.
8. Drives the eighth path, the paper's Settings I, II, III and V
   (``flagship.SETTINGS``: ``area4_ablation_19`` / ``_14`` / ``_15`` /
   ``_3heads_6``) at the flagship's width and data (paper plan, in_feat 16,
   131,072 rows of ``build_inputs``, 4 samples, bf16, seeded weights): per
   setting 3 eval forwards (median ms, phases) and 3 prepare + 2 full train
   steps (median ms), the launches of A, dX, D, B, B's tables and C per
   forward and per step, and peak memory ("setting <n>" lines); the f32
   forward with the kernels against the plain versions for Settings I and V
   (``main_path_f32``'s tolerances); C at Setting I's own operands (the
   embedding's E = 5 columns; counts and iterations exact against the plain
   loop); B at both region-growing sources (positions and votes) of
   Settings III and V against the all-pairs spec; the embed strategies 14
   and 2 (HDBSCAN; one forward each, the HDBSCAN phase's ms, the card's
   HDBSCAN against the host's); Setting I's scene through the eval CLI
   (``models=panoptic/area4_ablation_19``): a quarter of the forest in f32,
   kernels against plain versions, then the whole forest in bf16 at g = 1
   and 2 ("setting I scene" lines). "settings summary" gathers them.
9. Drives the ninth path, the point backbones as shipped
   (``conf/models/panoptic/kpconv.yaml``, ``kpconv_deform.yaml``,
   ``pointnet2.yaml``: ``KPConvPaper``, ``KPConvPaper-Deform``,
   ``PointNet2``; no sparse conv, no ScoreNet) on the flagship batch: per
   backbone the f32 forward with the kernels against the plain versions
   (``main_path_f32``'s tolerances), 3 bf16 eval forwards (median ms,
   phases with the radius queries apart, launches, peak memory) and 3
   prepare + 2 full bf16 train steps, B, B's tables and C launched and A,
   dX and D not; the share of query rows the cell cap truncated, per
   radius query ("<model> cell cap", logged, not gated); one f32 full step
   of ``KPConvPaper-Deform`` with the kernels and one with the plain
   versions (losses within 1e-4, ``fitting_loss`` and ``repulsion_loss``
   finite and > 0, gradients within 2e-2 of max |g|);
   ``KPConvPaper``'s scene through the eval CLI (a quarter in f32 against
   the plain versions, the whole forest in bf16 at g = 2); and
   ``KPConvPaper-Deform`` through the train CLI on the forest, 2 epochs of
   4 steps ("KPConvPaper-Deform trainer epoch" lines,
   ``chiprun_out/point_trainer.json``). "point backbones summary" gathers
   them.
10. Drives the tenth path, the flagship's variants (``flagship.VARIANTS``:
   the mask head with its epoch gates open, the encoder and MLP scorers,
   region growing's edge path on all rows and on the compacted rows) on the
   flagship batch: per variant the f32 forward with the kernels against the
   plain versions under deterministic algorithms (``main_path_f32``'s
   tolerances, the edge path's proposals identical, the mask logits and the
   filter's keep decisions), 3 bf16 eval forwards and 3 prepare + 2 full
   bf16 train steps with launches (the scorers' convs on A; no B on the
   edge path) and the edge path's truncated rows and iterations beside the
   dense pull's ("<variant> forward bf16", "dense reference" lines); A, dX
   and D at the scorers' own shapes ("<variant> scorer conv"); one f32 full
   step kernels against plain for ``mask`` (a ground-free batch, heads that
   give the mask loss members) and ``encoder`` (losses within 1e-4, the
   mask loss > 0; gradients within 2e-2 of max |g| against a plain step
   that takes the kernels' step's ReLU decisions where a BN output lies
   within rounding of 0, each such flip within 1e-3 of the output's max,
   counted in "bn_sign_flips"; a bias that feeds a train-mode BN directly,
   whose gradient is 0 in exact arithmetic, within 1e-4 of the terms the
   BN cancels in it); ``mask`` served by the
   eval CLI (a quarter in f32 against plain, the forest in bf16 at g = 2)
   and trained by the train CLI across its gates ("mask trainer" lines).
   "scorers and edges summary" gathers them.
11. Drives the eleventh path, data parallelism over ``torch.distributed``
   (``data_parallel_path``): two ranks share the card over gloo, started
   by ``parallel.launch.spawn`` (a correctness run, not a scale-out
   measurement), each with 4 tiles of the flagship batch (131,072 rows,
   bf16, paper plan, seeded weights): 3 prepare + 2 full DP train steps
   ("data parallel step" lines: ms, the all-reduce's ms, each rank's
   launches of A, dX, D, B, B's tables and C, the replica checksums, which
   must be equal after every step; peak memory per rank); one f32 DP full
   step against its hand emulation on the card (each block's
   single-device gradients and BN statistics averaged by hand, the same
   clip and Adam update; weights, BN statistics and losses within 1e-5 of
   their max |value|, under deterministic algorithms); the forest served
   on the two-rank mesh from a port checkpoint against the sequential g =
   1 scene (labels identical, reports equal; seconds per phase of both);
   the trainer with ``training.num_devices`` 2 in the two ranks (1 epoch
   of 4 steps, a validation, one checkpoint epoch, the batch draws timed);
   then one DP prepare step in a one-rank NCCL group. "data parallel
   summary" gathers them.
12. Prints the whole run's seconds, one ``{"kernels": [...]}`` line (each
   kernel's launches per path, ``settings``, ``point_backbones``,
   ``scorers_edges`` and ``data_parallel`` among them) and, last, the
   ``{"ok": true, "device": {...}}`` line. Every conv record goes to
   ``chiprun_out/conv_shapes.json``.

Any failed phase ends the run with a non-zero exit code and no result line.
Without a CUDA device the script exits with code 2. Long outputs (the
``nvcc -Xptxas -v`` log) go to ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Published H100 SXM peaks: HBM bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


_log_file = None  # chiprun_out/chip_smoke.log once main() runs


def log(*a):
    """Print a line, and keep it in chiprun_out/chip_smoke.log (a remote
    runner may return only the end of the output)."""
    print(*a, flush=True)
    if _log_file is not None:
        print(*a, file=_log_file, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "unknown"


def cuda_ms(fn, iters: int = 10, warmup: int = 2, queued: bool = False) -> float:
    """Mean ms per call of ``fn()``: ``bench_conv.cuda_ms`` (calls issued back
    to back; ``queued``: behind a device sleep, the device's time alone)."""
    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv import cuda_ms as timed

    return timed(fn, iters, warmup, queued)


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel call site to its plain PyTorch version: the conv
    forward and, inside the conv's autograd Function, its dX and dW; the
    dense pull (the all-pairs spec); the mean-shift loop (for the
    kernel-against-plain comparisons of the whole forward and train step)."""
    from panopticsegforlargescalepointcloud_tpu_torch.cluster import dense_grow, meanshift
    from panopticsegforlargescalepointcloud_tpu_torch.ops import conv

    saved = (conv.sparse_conv_fwd, conv.sparse_conv_dw, dense_grow.pull_tables,
             dense_grow.min_pull, meanshift.meanshift_converge)

    def conv_plain(feats, idx, weights, kernel=None):
        return conv.sparse_conv_plain(feats, idx, weights)

    def pull_plain(qmat, smat, ids, labels, r2, tables=None):
        return dense_grow.min_pull_plain(qmat, smat, ids, labels, r2)

    conv.sparse_conv_fwd = conv_plain
    conv.sparse_conv_dw = conv.sparse_conv_dw_plain
    dense_grow.pull_tables = lambda qmat, smat, ids, r2: None  # the spec needs none
    dense_grow.min_pull = pull_plain
    meanshift.meanshift_converge = meanshift.meanshift_converge_plain
    try:
        yield
    finally:
        (conv.sparse_conv_fwd, conv.sparse_conv_dw, dense_grow.pull_tables,
         dense_grow.min_pull, meanshift.meanshift_converge) = saved


def kernels():
    """Launch counters: kernel A counts its forward and its dX role apart;
    B_keys, B_blocks and B_cands build B's pair tables."""
    from panopticsegforlargescalepointcloud_tpu_torch.cluster import dense_grow, meanshift
    from panopticsegforlargescalepointcloud_tpu_torch.ops import conv, conv_parts

    return {"A": conv.KERNEL, "A_dx": conv.KERNEL_DX, "B": dense_grow.KERNEL,
            "B_keys": dense_grow.KEYS_KERNEL, "B_blocks": dense_grow.BLOCKS_KERNEL,
            "B_cands": dense_grow.CANDS_KERNEL, "C": meanshift.KERNEL, "D": conv.KERNEL_DW,
            "E": conv_parts.KERNEL}


def reset_counts():
    for k in kernels().values():
        k.launches = 0


def read_counts():
    return {name: k.launches for name, k in kernels().items()}


# ---------------------------------------------------------------- kernel phases


def conv_shapes(cfg, hier):
    """(label, map, Cin, Cout, N_in, transpose map) at distinct convs of the
    paper plan's first levels, plus the up path's 192 -> 192 (12f -> 12f)
    conv: the backward's oracle check."""
    f = cfg.in_feat
    g = hier.grids
    s, d, u = hier.same_maps, hier.down_maps, hier.up_maps
    return [
        ("L0 same 4->16", s[0], cfg.feat_dim, f, g[0].capacity, s[0]),
        ("L0 same 16->16", s[0], f, f, g[0].capacity, s[0]),
        ("L0->L1 down 16->16", d[0], f, f, g[0].capacity, u[0]),
        ("L1 same 16->32", s[1], f, 2 * f, g[1].capacity, s[1]),
        ("L1 same 32->32", s[1], 2 * f, 2 * f, g[1].capacity, s[1]),
        ("L1->L0 up 64->64", u[0], 4 * f, 4 * f, g[1].capacity, d[0]),
        ("L5->L4 up 192->192", u[4], 12 * f, 12 * f, g[5].capacity, d[4]),
    ]


def phase_convs(convs, gen_seed: int, tag: str):
    """Kernel A (forward and dX roles) and kernel D against their plain
    versions at every recorded shape, in bf16 and f32: within 1e-4 of the
    plain result's max |value|, bit-identical on a second launch, and timed
    beside the plain version, the library call (gather + one ``matmul``)
    and the bound: ``ms`` with the calls back to back (host work counted
    where it outlasts the device's), ``device_ms`` queued (device alone)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv import conv_case
    from panopticsegforlargescalepointcloud_tpu_torch.ops import conv

    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    rows, fails = [], []
    for c in convs:
        role, idx, cin, cout = c["role"], c["idx"], c["cin"], c["cout"]
        n_out, kvol = idx.shape
        for dt in (torch.bfloat16, torch.float32):
            case = conv_case(c, dt, gen)
            run, plain, lib = case["run"], case["plain"], case["lib"]
            plan = (conv.dw_plan(n_out, kvol, cin, cout, dt) if role == "D"
                    else conv.conv_plan(n_out, cin, cout, kvol, dt))._asdict()
            got, want = run(), plain()
            again = run()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            # both sum exact products (bf16 x bf16 is exact in f32) in f32, in
            # different orders over up to 27 * Cin terms (A) or N_out rows (D)
            tol = 1e-4 * max(scale, 1e-30)
            same = bool(torch.equal(got, again))
            ok = bool(torch.isfinite(got).all()) and err <= tol and same
            rec = dict(role=role, shape=f"{c['map']} {cin}->{cout}", dtype=str(dt).split(".")[-1],
                       n_out=n_out, n_in=c["n_in"], nnz=case["nnz"], plan=plan,
                       max_abs_err=err, tol=tol, deterministic=same, ms=cuda_ms(run),
                       device_ms=cuda_ms(run, queued=True),
                       plain_ms=cuda_ms(plain, iters=2, warmup=1),
                       library_ms=cuda_ms(lib, iters=2, warmup=1),
                       library_device_ms=cuda_ms(lib, iters=2, warmup=1, queued=True),
                       bound_ms=case["bound_ms"], bound_by=case["bound_by"], ok=ok)
            rows.append(rec)
            log(tag, json.dumps(rec))
            if not ok:
                fails.append(f"{tag} {role} {rec['shape']} {rec['dtype']}: err {err} > tol {tol} "
                             f"or not deterministic ({same})")
    return rows, fails


def determinism_summary(rows):
    """Bit-identical second launches: A with an offset split and D with row
    groups must each have been checked at least once."""
    split_a = [r for r in rows if r["role"] != "D" and r["dtype"] == "bfloat16"
               and r["plan"]["splits"] > 1]
    grouped_d = [r for r in rows if r["role"] == "D" and r["plan"]["groups"] > 1]
    res = dict(a_split_shapes=len(split_a),
               a_split_identical=all(r["deterministic"] for r in split_a),
               d_grouped_shapes=len(grouped_d),
               d_grouped_identical=all(r["deterministic"] for r in grouped_d),
               all_identical=all(r["deterministic"] for r in rows))
    log("determinism", json.dumps(res))
    ok = (res["a_split_shapes"] > 0 and res["d_grouped_shapes"] > 0 and res["all_identical"])
    return [] if ok else [f"determinism: {res}"]


def phase_backward(cfg, hier, gen_seed: int):
    """The conv's backward on the card (dX by A on the transpose map, dW by
    D) against autograd of the plain gather conv, whose gather VJP is a
    scatter-add and needs no transpose map: the transpose identity on the
    flagship's real maps. f32."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.ops.conv import (
        sparse_conv,
        sparse_conv_plain,
    )

    dev = hier.same_maps[0].device
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    fails, res = [], []
    for label, nbr, cin, cout, n_in, nbr_t in conv_shapes(cfg, hier):
        x = torch.randn((n_in, cin), generator=gen, device=dev)
        w = torch.randn((27, cin, cout), generator=gen, device=dev) * math.sqrt(2.0 / (27 * cout))
        g = torch.randn((nbr.shape[0], cout), generator=gen, device=dev)
        xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
        got = torch.autograd.grad(sparse_conv(xk, nbr, wk, nbr_t), (xk, wk), g)
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = torch.autograd.grad(sparse_conv_plain(xp, nbr, wp), (xp, wp), g)
        torch.cuda.synchronize()
        rec = dict(shape=label)
        for name, a, b in (("dx", got[0], want[0]), ("dw", got[1], want[1])):
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            # f32 sums in another order (scatter-add atomics on the oracle side)
            tol = 1e-4 * max(scale, 1e-30)
            rec[name] = dict(max_abs_err=err, scale=scale)
            if not (bool(torch.isfinite(a).all()) and err <= tol):
                fails.append(f"backward {label} {name}: err {err} > tol {tol}")
        res.append(rec)
    log("conv backward vs scatter-add autograd", json.dumps(res))
    return fails


def boundary_operands(t: int, radius: float, seed: int):
    """Rows placed against the skip's margin, on the card: pairs at distance
    r (1 + d), d in {-1e-6, -3e-7, 0, 3e-7, 1e-6}, the anchors in a cube
    centred 23 m from the origin and sized for ~30 rows per m^3, so that
    many pairs cross the blocks of the row order; 6 ids, a tenth of the rows
    alone in their id, 5% invalid. Returns (pos, ids, valid)."""
    import torch

    rng = np.random.default_rng(seed)
    half = t // 2
    side = (half / 30.0) ** (1.0 / 3.0)
    centre = rng.normal(size=3)
    centre *= 23.0 / np.linalg.norm(centre)
    anchor = centre + rng.uniform(-side / 2, side / 2, (half, 3))
    d = rng.normal(size=(half, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    scale = radius * (1.0 + rng.choice([-1e-6, -3e-7, 0.0, 3e-7, 1e-6], half))
    pos = np.concatenate([anchor, anchor + d * scale[:, None]]).astype(np.float32)
    pid = rng.integers(0, 6, half)
    ids = np.concatenate([pid, pid]).astype(np.int32)
    lone = rng.random(t) < 0.1
    ids[lone] = 100 + np.arange(int(lone.sum()))
    perm = rng.permutation(t)
    valid = rng.random(t) > 0.05
    return (torch.from_numpy(pos[perm]).cuda(), torch.from_numpy(ids[perm]).cuda(),
            torch.from_numpy(valid).cuda())


def pull_cases(cfg, db, captured):
    """(kind, T, pos, ids, valid, init) of every pull check: the forward's
    own region-growing rows, random-class rows and boundary rows at T =
    49,152, 24,576 and 12,288."""
    from panopticsegforlargescalepointcloud_tpu_torch.bench_cluster import (
        SIZES,
        forward_operands,
        init_labels,
        random_class_operands,
    )

    cases = []
    for t in SIZES:
        cases.append(("forward", t) + forward_operands(cfg, captured, t))
        cases.append(("random_class", t) + random_class_operands(cfg, db, t, seed=3))
        pos, ids, valid = boundary_operands(t, cfg.cluster_radius, seed=t)
        cases.append(("boundary", t, pos, ids, valid, init_labels(cfg, pos, ids, valid)))
    return cases


def forward_region_growing(cfg, arrays, seed: int):
    """The region-growing operands of one bf16 eval forward of the flagship
    (``bench_cluster.captured_region_growing``)."""
    from panopticsegforlargescalepointcloud_tpu_torch.bench_cluster import (
        captured_region_growing,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    captured = []
    with captured_region_growing(captured):
        make_eval_forward(cfg, random_model(cfg, seed))(arrays)
    return captured


def phase_tables(qmat, smat, ids, r2: float, tables):
    """B's three table kernels against their plain versions on the same
    inputs: keys, block order, id runs and candidate lists all equal (the
    kernels round as the plain operations do); each timed back to back and
    queued, beside its plain version and its bound (bytes each input read
    once and each output written once; the candidate test's 22 operations
    per run pair of two blocks that both hold rows)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cluster import dense_grow as dg

    t = ids.shape[0]
    nb = t // dg.BR
    inv_cell = 1.0 / r2 ** 0.5
    lo = torch.where(dg._valid_rows(qmat, smat)[:, None], smat[:3].T, float("inf")).amin(dim=0)
    key = dg.row_keys(qmat, smat, ids, lo, inv_cell)
    key_plain = dg._keys_plain(qmat, smat, ids, lo, inv_cell)
    perm = torch.argsort(key, stable=True)
    runs = dg.block_runs(qmat, smat, ids, perm)
    runs_plain = dg._blocks_plain(qmat, smat, ids, perm)
    cand, ncand = dg.block_cands(*runs[4:], nb, r2)
    cand_plain, ncand_plain = dg._cands_plain(*runs_plain[4:], nb, r2)
    torch.cuda.synchronize()
    first = torch.arange(nb, device=ids.device)[None, :] < ncand_plain[:, None]
    same = dict(keys=bool(torch.equal(key, key_plain)),
                runs=all(bool(torch.equal(a, b)) for a, b in zip(runs, runs_plain)),
                ncand=bool(torch.equal(ncand, ncand_plain)),
                cand=bool(torch.equal(torch.where(first, cand, -1),
                                      torch.where(first, cand_plain, -1))),
                pull_tables=bool(torch.equal(tables.perm, runs[3])
                                 and torch.equal(tables.ncand, ncand)))
    live_runs = (runs[6] <= runs[7]).reshape(nb, dg._SEGS).sum(dim=1).float()
    run_pairs = float(live_runs.sum()) ** 2
    ns = nb * dg._SEGS
    parts = {
        "keys": (lambda: dg.row_keys(qmat, smat, ids, lo, inv_cell),
                 lambda: dg._keys_plain(qmat, smat, ids, lo, inv_cell), 32 * t, 0.0),
        "blocks": (lambda: dg.block_runs(qmat, smat, ids, perm),
                   lambda: dg._blocks_plain(qmat, smat, ids, perm), 84 * t + 36 * ns, 0.0),
        "cands": (lambda: dg.block_cands(*runs[4:], nb, r2),
                  lambda: dg._cands_plain(*runs_plain[4:], nb, r2),
                  36 * ns + 4 * (int(ncand.sum()) + nb), 22.0 * run_pairs),
    }
    rec = dict(equal=same, ok=all(same.values()))
    for name, (run, plain, bytes_, ops) in parts.items():
        t_b, t_o = bytes_ / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
        rec[name] = dict(ms=cuda_ms(run, iters=10), device_ms=cuda_ms(run, iters=10, queued=True),
                         plain_ms=cuda_ms(plain, iters=2, warmup=1), library_ms=None,
                         bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
    return rec, ([] if rec["ok"] else [f"tables differ from their plain versions: {same}"])


def phase_pull(cfg, kind: str, t: int, pos, ids, valid, init, tag: str = "B"):
    """Kernel B against the all-pairs spec ``min_pull_plain``: 0 differing
    rows. Times one pull with the tables built (as ``dense_components``
    issues it), the table build itself, and the spec; logs the pairs the
    kernel evaluates (its work) and two bounds: ``bound_ms``, the operands
    read once and the operations of the pairs these inputs need (same id,
    d2 <= r2, counted by the spec's own pair test), and
    ``all_pairs_bound_ms``, the operations of all T^2 pairs, the TPU
    kernel's work."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cluster.dense_grow import (
        _operands,
        min_pull,
        min_pull_plain,
        pairs_evaluated,
        pull_tables,
        qualifying_pairs,
    )

    qmat, smat = _operands(pos, valid)
    ids = ids.to(torch.int32).contiguous()
    labels = init.float().contiguous()
    r2 = float(cfg.cluster_radius) ** 2
    tables = pull_tables(qmat, smat, ids, r2)
    tab_rec, tab_fails = phase_tables(qmat, smat, ids, r2, tables)
    got = min_pull(qmat, smat, ids, labels, r2, tables)
    want = min_pull_plain(qmat, smat, ids, labels, r2)
    torch.cuda.synchronize()
    same = (got == want) | (torch.isinf(got) & torch.isinf(want))
    ndiff = int((~same).sum())
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    pull = lambda: min_pull(qmat, smat, ids, labels, r2, tables)  # noqa: E731
    build = lambda: pull_tables(qmat, smat, ids, r2)  # noqa: E731
    pairs = pairs_evaluated(tables)
    needed = qualifying_pairs(qmat, smat, ids, r2)
    # per row: (q0, q1, q2, qn) and (x, y, z, pn) in block order, id, label,
    # out; per pair 3 multiplies and 4 adds
    bytes_ = 44 * t
    t_b = bytes_ / HBM_BPS * 1e3
    t_o = 7.0 * needed / F32_FLOPS * 1e3
    rec = dict(operands=kind, t=t, valid_rows=int(valid.sum()), differing_rows=ndiff,
               tables=tab_rec,
               max_abs_err=err, pairs_evaluated=pairs, pairs_share=pairs / (t * t),
               pairs_needed=needed, pairs_needed_share=needed / (t * t),
               evaluated_bound_ms=max(t_b, 7.0 * pairs / F32_FLOPS * 1e3),
               max_candidates=int(tables.ncand.max()),
               ms=cuda_ms(pull, iters=20), device_ms=cuda_ms(pull, iters=20, queued=True),
               tables_ms=cuda_ms(build, iters=5), tables_device_ms=cuda_ms(build, iters=5,
                                                                           queued=True),
               plain_ms=cuda_ms(lambda: min_pull_plain(qmat, smat, ids, labels, r2), iters=2,
                                warmup=1),
               library_ms=None, bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               all_pairs_bound_ms=7.0 * t * t / F32_FLOPS * 1e3, ok=ndiff == 0)
    log(tag, json.dumps(rec))
    fails = [] if rec["ok"] else [f"{tag} {kind} T={t}: {ndiff} of {t} rows differ"]
    return rec, fails + [f"{tag} {kind} T={t}: {m}" for m in tab_fails]


def shift_iter_f32(seeds, x, pvalid, bw2: float):
    """One update as the JAX package's ``_shift_iter`` writes it, with f32
    sums (``shift_iter_plain`` sums in f64 and rounds once)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cluster.meanshift import _pair_d2

    within = (_pair_d2(seeds, x) <= bw2) & pvalid[:, None, :]
    w = within.float()
    cnt = w.sum(dim=-1)
    new = (w @ x) / cnt.clamp(min=1.0)[..., None]
    return torch.where((cnt > 0)[..., None], new, seeds), cnt


def loop_agreement(a, b):
    """Seeds whose counts or iteration counts differ between two runs of
    the loop (seeds, counts, iterations), and the largest seed difference."""
    return dict(counts_differ=int((a[1] != b[1]).sum()),
                iterations_differ=int((a[2] != b[2]).sum()),
                max_abs_err=float((a[0] - b[0]).abs().max()))


def f32_reference(seeds, svalid, x, pvalid, bandwidth: float, max_iter: int, got):
    """The kernel's loop against the loop with f32 sums (``shift_iter_f32``)
    on the card (cuBLAS's order) and on the host (the CPU BLAS's order),
    and the two f32 orders against each other: how far f32 sums alone move
    the loop's result."""
    from unittest import mock

    from panopticsegforlargescalepointcloud_tpu_torch.cluster import meanshift

    with mock.patch.object(meanshift, "shift_iter_plain", shift_iter_f32):
        card = meanshift.meanshift_converge_plain(seeds, svalid, x, pvalid, bandwidth, max_iter)
        host = meanshift.meanshift_converge_plain(
            *(a.cpu() for a in (seeds, svalid, x, pvalid)), bandwidth, max_iter)
    card, host, got = ([a.cpu() for a in r] for r in (card, host, got))
    return dict(kernel_vs_f32_card=loop_agreement(got, card),
                kernel_vs_f32_host=loop_agreement(got, host),
                f32_card_vs_f32_host=loop_agreement(card, host))


def phase_meanshift(bsz: int, s: int, np_: int, e: int, bandwidth: float, seed: int,
                    tag: str = "C", max_iter: int = 100):
    """Kernel C against its plain versions on seeded blobs
    (:func:`check_meanshift`)."""
    from panopticsegforlargescalepointcloud_tpu_torch.bench_cluster import blobs
    from panopticsegforlargescalepointcloud_tpu_torch.cluster.meanshift import _bin_seeds

    x, pvalid = blobs(bsz, np_, e, seed)
    seeds, svalid = _bin_seeds(x, pvalid, bandwidth, s)
    return check_meanshift(seeds.contiguous(), svalid, x, pvalid, bandwidth, tag, max_iter)


def check_meanshift(seeds, svalid, x, pvalid, bandwidth: float, tag: str = "C",
                    max_iter: int = 100):
    """Kernel C against its plain versions on these operands: the whole loop
    (``meanshift_converge`` against ``meanshift_converge_plain``: counts
    exact at every seed, iteration counts equal, seeds within 1e-5) and one
    update (``meanshift_update`` against ``shift_iter_plain`` and against
    ``shift_iter_f32``: counts exact, seeds within 1e-5). The kernel and
    ``shift_iter_plain`` sum in f64 and round once (see
    ``csrc/meanshift.cu``), so the seeds agree to the bit unless an f64 sum
    falls on an f32 rounding boundary; ``f32_reference`` logs how far the
    f32-sum loop is from the kernel and from itself in another order. Times
    the loop; the bound counts the points once and, per seed, (iterations
    + 1) x Np pairs of 3E + 4 operations."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cluster.meanshift import (
        meanshift_converge,
        meanshift_converge_plain,
        meanshift_update,
        shift_iter_plain,
    )

    bsz, s, e = seeds.shape
    np_ = x.shape[1]
    got, gcnt, giters = meanshift_converge(seeds, svalid, x, pvalid, bandwidth, max_iter)
    want, wcnt, witers = meanshift_converge_plain(seeds, svalid, x, pvalid, bandwidth,
                                                  max_iter)
    one, ocnt = meanshift_update(seeds, x, pvalid, bandwidth)
    wone, wocnt = shift_iter_plain(seeds, x, pvalid, float(bandwidth) ** 2)
    torch.cuda.synchronize()
    cnt_ok = bool(torch.equal(gcnt, wcnt))
    iters_ok = bool(torch.equal(giters, witers))
    err = float((got - want).abs().max())
    seeds_ok = err <= 1e-5
    one_f32, ocnt_f32 = shift_iter_f32(seeds, x, pvalid, float(bandwidth) ** 2)
    one_err = float((one - wone).abs().max())
    one_err_f32 = float((one - one_f32).abs().max())
    one_ok = (bool(torch.equal(ocnt, wocnt)) and one_err <= 1e-5
              and bool(torch.equal(ocnt, ocnt_f32)) and one_err_f32 <= 1e-5)
    run = lambda: meanshift_converge(seeds, svalid, x, pvalid, bandwidth, max_iter)  # noqa: E731
    it = giters[svalid].float()
    pair_iters = float(((giters + 1) * svalid).sum()) * np_
    bytes_ = (bsz * np_ * (e * 4 + 1) + bsz * s * (2 * e * 4 + 1 + 4 + 4))
    t_b = bytes_ / HBM_BPS * 1e3
    t_o = pair_iters * (3 * e + 4) / F32_FLOPS * 1e3
    rec = dict(b=bsz, s=s, np=np_, e=e, counts_equal=cnt_ok, iterations_equal=iters_ok,
               max_abs_err=err, one_update_counts_equal=bool(torch.equal(ocnt, wocnt)),
               one_update_max_abs_err=one_err,
               one_update_f32_counts_equal=bool(torch.equal(ocnt, ocnt_f32)),
               one_update_f32_max_abs_err=one_err_f32,
               f32_reference=f32_reference(seeds, svalid, x, pvalid, bandwidth, max_iter,
                                           (got, gcnt, giters)),
               iterations_max=int(giters.max()), iterations_mean=float(it.mean()),
               valid_seeds=int(svalid.sum()), valid_points=int(pvalid.sum()),
               ms=cuda_ms(run, iters=10), device_ms=cuda_ms(run, iters=10, queued=True),
               plain_ms=cuda_ms(lambda: meanshift_converge_plain(
                   seeds, svalid, x, pvalid, bandwidth, max_iter), iters=2, warmup=1),
               library_ms=None, bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               ok=cnt_ok and iters_ok and seeds_ok and one_ok)
    log(tag, json.dumps(rec))
    fails = [] if rec["ok"] else [f"{tag}: counts equal {cnt_ok}, iterations equal "
                                  f"{iters_ok}, max err {err}, one update ok {one_ok}"]
    return rec, fails


# ------------------------------------------------------------------- main path


class PhaseTimer:
    """Host clock around each phase, ending in a device synchronize."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def cluster_kernels(cfg):
    """The kernels a forward with clustering of ``cfg`` launches besides A:
    B and its tables where it grows regions by the dense pull (the edge
    path launches none), C where it runs mean shift."""
    return ((["B", "B_keys", "B_blocks", "B_cands"]
             if cfg.rg_sources and cfg.rg_dense_enabled else [])
            + (["C"] if cfg.use_meanshift else []))


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (``index_add_`` and the gathers'
    backward without atomics), so that two f32 runs of a point backbone
    differ only where the kernels differ: its GEMMs and reductions leave
    no rounding to the order of atomic adds, which the deformable KPConv
    amplifies past the checks' tolerances. Ops without a deterministic
    version warn instead of raising."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def conv_kernels(cfg, backward: bool = False):
    """A (and in a train step A's dX and D) where the backbone is a sparse
    UNet; a point backbone launches none of them."""
    if cfg.is_point_backbone:
        return []
    return ["A", "A_dx", "D"] if backward else ["A"]


@contextlib.contextmanager
def radius_query_phase(timer):
    """Time each radius query of a point backbone as a phase of its own
    (``radius_queries``, nested in ``backbone_heads``)."""
    from panopticsegforlargescalepointcloud_tpu_torch.models import point_backbones

    fn0 = point_backbones.radius_query

    def fn(*args, **kwargs):
        with timer("radius_queries"):
            return fn0(*args, **kwargs)

    point_backbones.radius_query = fn
    try:
        yield
    finally:
        point_backbones.radius_query = fn0


def check_output(cfg, db, out):
    import torch

    n = db.grid.capacity
    shapes = {
        "semantic_logits": (n, cfg.num_classes), "offset_logits": (n, 3),
        "embed_logits": (n, cfg.embed_dim), "backbone_feats": (n, cfg.in_feat),
    }
    fails = []
    if cfg.use_score_net:
        shapes["cluster_scores"] = (cfg.total_props,)
    elif out.cluster_scores is not None:
        fails.append("scores from a model without a score net")
    if not cfg.has_offset and bool(out.offset_logits.any()):
        fails.append("offsets from a model without an offset head")
    for k, shp in shapes.items():
        v = getattr(out, k)
        if tuple(v.shape) != shp or not bool(torch.isfinite(v).all()):
            fails.append(f"{k}: shape {tuple(v.shape)} (want {shp}) or non-finite values")
    probs = out.semantic_logits[db.grid.mask].float().exp().sum(-1)
    if not bool(torch.allclose(probs, torch.ones_like(probs), atol=1e-3)):
        fails.append("semantic log-probs do not normalize")
    return fails


def main_path_f32(cfg32, arrays, seed: int, tag: str = "main path f32 kernel vs plain"):
    """f32 forward with the kernels and with the plain versions on the card."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    model = random_model(cfg32, seed)
    fwd = make_eval_forward(cfg32, model)
    _, k_out = fwd(arrays)
    with plain_kernels():
        db, p_out = fwd(arrays)
    torch.cuda.synchronize()
    fails = check_output(cfg32, db, k_out)
    res = {}
    for k in ("semantic_logits", "offset_logits", "embed_logits", "backbone_feats"):
        a, b = getattr(k_out, k), getattr(p_out, k)
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        # 70 f32 convs, each summing in another order than the plain GEMMs
        tol = 1e-3 * max(scale, 1e-30)
        res[k] = dict(max_abs_err=err, scale=scale, ok=err <= tol)
        if err > tol:
            fails.append(f"f32 {k}: err {err} > {tol}")
    same = float((k_out.proposals.prop_id == p_out.proposals.prop_id).float().mean())
    res["membership_rows_identical"] = same
    res["valid_proposals"] = int(k_out.proposals.prop_valid.sum())
    if same < 0.999:
        fails.append(f"f32 membership rows identical {same} < 0.999")
    if k_out.cluster_scores is not None:
        sc = (k_out.cluster_scores - p_out.cluster_scores).abs().max()
        res["scores_max_abs_err"] = float(sc)
    log(tag, json.dumps(res))
    return fails


def main_path_bf16(cfg, arrays, seed: int, repeats: int, hier_overflow):
    """The shipped bf16 forward: launch counts of one run, then timings.
    ``hier_overflow`` comes from the hierarchy built on the same inputs."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    model = random_model(cfg, seed)
    fwd = make_eval_forward(cfg, model)
    fwd(arrays)  # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    reset_counts()
    db, out = fwd(arrays)
    torch.cuda.synchronize()
    launches = read_counts()
    fails = check_output(cfg, db, out)
    fails += [f"kernel {n} not launched on the eval forward"
              for n in ["A"] + cluster_kernels(cfg) if launches[n] <= 0]
    # the whole mean-shift loop is one launch of C (one mean_shift call)
    if launches["C"] > 2:
        fails.append(f"kernel C launched {launches['C']} times on the eval forward (> 2)")
    # the forward runs under no_grad: no backward kernel may launch
    fails += [f"backward kernel {n} launched on the eval forward" for n in ("A_dx", "D")
              if launches[n] != 0]
    totals = []
    timers = []
    for _ in range(repeats):
        timer = PhaseTimer()
        tfwd = make_eval_forward(cfg, model, timer=timer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tfwd(arrays)
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        timers.append(timer.ms)
    plain_total = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(arrays)
        torch.cuda.synchronize()
        plain_total.append((time.perf_counter() - t0) * 1e3)
    res = dict(
        ms_per_forward_untimed_phases=plain_total,
        ms_per_forward_with_phase_syncs=totals,
        phases_ms=timers,
        hier_overflow=hier_overflow,
        cluster_overflow=int(out.cluster_overflow),
        scorer_overflow=int(out.scorer_overflow),
        valid_proposals=int(out.proposals.prop_valid.sum()),
        valid_rows=int(db.grid.mask.sum()),
        launches_per_forward=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log("main path bf16", json.dumps(res))
    return launches, fails


@contextlib.contextmanager
def bn_probe(model, record=None, align=None):
    """Forward hooks on every MaskedBatchNorm of ``model`` (most feed a ReLU
    gate, whose decision is the output's sign) for :func:`train_step_f32`. ``record`` collects each
    call's output by module name, in call order. ``align`` (the ``record``
    of another step): where this output and the recorded one lie on either
    side of 0, the output takes the recorded value, moved by a detached
    difference (this step's backward with the other step's gate
    decisions). Yields {"flips": {"module[call]": (elements, largest move
    / the output's max |value|)}, "bias_terms": {bias: per-channel scale}},
    the scale of each bias that feeds a BN directly (a biased PointMLP
    Dense): (|scale| / σ) · Σ |∂L/∂y| over the BN's valid rows, the size of
    the terms that the BN's backward cancels in that bias's gradient."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.models.modules import PointMLP
    from panopticsegforlargescalepointcloud_tpu_torch.models.norm import MaskedBatchNorm

    fed = {}  # BN -> the bias that feeds it
    for n, m in model.named_modules():
        if isinstance(m, PointMLP):
            fed.update({f"{n}.MaskedBatchNorm_{i}": f"{n}.Dense_{i}.bias"
                        for i in range(len(m.channels))
                        if getattr(m, f"Dense_{i}").bias is not None})
    seen = {"flips": {}, "bias_terms": {}}
    calls = {}

    def hook(name):
        def fn(mod, args, out):
            i = calls[name] = calls.get(name, -1) + 1
            if record is not None:
                record.setdefault(name, []).append(out.detach().clone())
            if name in fed and out.requires_grad:
                x, m = args[0].detach().float(), args[1].float()[:, None]
                cnt = m.sum().clamp(min=1.0)
                mean = (x * m).sum(0) / cnt
                gain = mod.scale.detach().abs() * torch.rsqrt(
                    ((x - mean) ** 2 * m).sum(0) / cnt + mod.epsilon)
                out.register_hook(lambda g: seen["bias_terms"].__setitem__(
                    fed[name], gain * (g.float() * m).abs().sum(0)))
            if align is None:
                return None
            ref = align[name][i]
            flip = (ref > 0) != (out > 0)
            if bool(flip.any()):
                o = out.detach()
                moved = (ref - o).abs()[flip].max() / o.abs().max().clamp(min=1e-30)
                seen["flips"][f"{name}[{i}]"] = (int(flip.sum()), float(moved))
            return out + torch.where(flip, ref - out, torch.zeros_like(out)).detach()
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, MaskedBatchNorm)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def train_step_f32(cfg32, arrays, seed: int, tag: str = "train step f32 kernel vs plain",
                   grads_file: str = "train_f32_grads.json", prepare=None,
                   align_gates: bool = False):
    """One f32 full train step with the kernels and one with the plain
    versions, from the same weights: losses, every gradient and the
    proposals of the train-mode forward must agree. A third step, plain,
    from input features moved by about one f32 ulp, measures how far f32
    rounding alone moves the gradients: the backward runs through 35
    train-mode BN layers at 131,072 rows and is ill-conditioned.
    ``prepare(model)``, where given, sets weights of the initialized model
    before each step.

    A bias that feeds a train-mode BN directly has a gradient that is 0 in
    exact arithmetic, so its max |g| is rounding: it is held instead to
    |g| <= 1e-4 of the terms that the BN cancels in it (:func:`bn_probe`),
    in both steps.

    ``align_gates``: a fourth step, plain, with the kernels' step's ReLU
    decisions (:func:`bn_probe`): a BN output on the other side of 0 than
    in the kernels' step takes that step's value, and every such flip must
    lie within the forward's tolerance, 1e-3 of the output's max |value|
    (a gate within rounding of 0: a flipped gate passes a row's gradient in
    one step and not in the other, and train-mode BN's backward can carry
    that far into a weight gradient whose terms cancel). The gradients are
    then held against this step; the plain step's distance is logged
    beside it.
    Returns (failures, {loss term: (kernels, plain)})."""
    import numpy as np
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import flagship_training
    from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
    from panopticsegforlargescalepointcloud_tpu_torch.train import (
        canonicalize,
        make_train_step,
        panoptic_forward,
    )

    nudged = list(arrays)
    noise = np.random.default_rng(seed).standard_normal(arrays[3].shape)
    nudged[3] = (arrays[3] * (1.0 + 2.0**-23 * noise)).astype(np.float32)
    runs = {}
    record = {} if align_gates else None
    probes = [("kernels", contextlib.nullcontext, arrays, dict(record=record)),
              ("plain", plain_kernels, arrays, {}),
              ("plain_nudged", plain_kernels, tuple(nudged), {})]
    if align_gates:
        probes.append(("plain_aligned", plain_kernels, arrays, dict(align=record)))
    for name, ctx, arr, hooks in probes:
        state, schedule, tc = flagship_training(cfg32, seed)
        if prepare is not None:
            prepare(state.model)
        with ctx():
            with torch.no_grad():
                db = canonicalize(*arr)
                hier = build_hierarchy(db.grid, cfg32.num_down)
                twin = copy.deepcopy(state.model).train()
                props = panoptic_forward(cfg32, twin, db, hier, True, state.bn_momentum).proposals
            step = make_train_step(cfg32, state.model, state.optimizer, schedule, True,
                                   tc.grad_clip_value)
            with bn_probe(state.model, **hooks) as seen:
                metrics = step(arr, state.bn_momentum)
        torch.cuda.synchronize()
        runs[name] = (metrics, {n: p.grad for n, p in state.model.named_parameters()}, props,
                      seen)
    record = None
    (km, kg, kp, kseen), (pm, pg, pp, pseen) = runs["kernels"], runs["plain"]
    ng = runs["plain_nudged"][1]
    fails = []
    losses = {}
    for k in pm:
        a, b = float(km[k]), float(pm[k])
        losses[k] = (a, b)
        # f32 through 90 convs and their backward, summed in other orders
        if not (math.isfinite(a) and abs(a - b) <= 1e-4 * max(abs(b), 1.0)):
            fails.append(f"f32 train step {k}: kernels {a} vs plain {b}")
    flips = runs["plain_aligned"][3]["flips"] if align_gates else {}
    fails += [f"f32 train step: {m} flips a gate by {moved} of its max |value| (> 1e-3)"
              for m, (_, moved) in flips.items() if moved > 1e-3]
    ref = runs["plain_aligned"][1] if align_gates else pg
    stats = {}
    for n, b in pg.items():
        a = kg[n]
        scale = float(b.abs().max())
        stats[n] = dict(max_rel=float((a - b).abs().max()) / max(scale, 1e-30),
                        nudged_max_rel=float((ng[n] - b).abs().max()) / max(scale, 1e-30))
        if align_gates:
            stats[n]["aligned_max_rel"] = (float((a - ref[n]).abs().max())
                                           / max(float(ref[n].abs().max()), 1e-30))
        if n in kseen["bias_terms"]:
            over = [float((g.abs() / seen["bias_terms"][n].clamp(min=1e-30)).max())
                    for g, seen in ((a, kseen), (b, pseen))]
            stats[n]["over_bn_terms"] = over
            ok = max(over) <= 1e-4
        else:
            # 2e-2 of the tensor's max |g|: the nudged plain step moves single
            # gradients by up to about 1e-2 (measured here, "nudged_max_rel"),
            # and the kernels round differently in each of 90 convs
            ok = stats[n]["aligned_max_rel" if align_gates else "max_rel"] <= 2e-2
        if not (bool(torch.isfinite(a).all()) and ok):
            fails.append(f"f32 train step grad {n}: {stats[n]}")
    with open(os.path.join(OUT_DIR, grads_file), "w") as fh:
        json.dump(stats, fh, indent=0)
    summary = {}
    for key in ("max_rel", "nudged_max_rel") + (("aligned_max_rel",) if align_gates else ()):
        vals = sorted(v[key] for v in stats.values())
        worst = max(stats, key=lambda n: stats[n][key])
        summary[key] = dict(median=vals[len(vals) // 2], max=vals[-1], worst=worst)
    same = float((kp.prop_id == pp.prop_id).float().mean())
    if same < 0.999:
        fails.append(f"f32 train step membership rows identical {same} < 0.999")
    log(tag, json.dumps(dict(
        losses=losses, grads_over_max=summary, bn_sign_flips=flips,
        zero_gradient_biases={n: stats[n] for n in kseen["bias_terms"]},
        membership_rows_identical=same, valid_proposals=int(kp.prop_valid.sum()))))
    return fails, losses


def train_steps_bf16(cfg, arrays, seed: int, n_prepare: int = 5, n_full: int = 3,
                     tag: str = "train steps bf16"):
    """The shipped bf16 train steps at full width: ``n_prepare`` prepare
    steps, then ``n_full`` full steps, from the JAX package's init. The first
    step of each phase is its warm-up; the others are timed per step and per
    phase. Counts are reset just before the first step and read after the
    last; every step's own launches are kept, and each step must launch
    every kernel of its phase."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import flagship_training
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_train_step

    state, schedule, tc = flagship_training(cfg, seed)
    fails, res = [], {}
    reset_counts()
    for phase, n, clustering in (("prepare", n_prepare, False), ("full", n_full, True)):
        torch.cuda.reset_peak_memory_stats()
        step_ms, timers, per_step, metrics = [], [], [], []
        for i in range(n):
            timer = PhaseTimer()
            step = make_train_step(cfg, state.model, state.optimizer, schedule, clustering,
                                   tc.grad_clip_value, timer=timer if i > 0 else None)
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(arrays, state.bn_momentum)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            per_step.append({k: v - before[k] for k, v in read_counts().items()})
            if i == 0:
                warm_ms = dt
            else:
                step_ms.append(dt)
                timers.append(timer.ms)
            metrics.append({k: float(v) for k, v in m.items()})
        for j, m in enumerate(metrics):
            bad = [k for k, v in m.items() if not math.isfinite(v)]
            if bad:
                fails.append(f"bf16 {phase} step {j}: non-finite {bad}")
        res[phase] = dict(
            ms_per_step_median=statistics.median(step_ms) if step_ms else None,
            ms_per_step=step_ms, warmup_ms=warm_ms, phases_ms=timers,
            launches_per_step=per_step,
            losses=[m["loss"] for m in metrics],
            last_metrics=metrics[-1],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        need = conv_kernels(cfg, backward=True) + (cluster_kernels(cfg) if clustering else [])
        fails += [f"kernel {k} not launched in bf16 {phase} step {j}"
                  for j, counts in enumerate(per_step) for k in need if counts[k] <= 0]
        fails += [f"kernel {k} launched {counts[k]} times in bf16 {phase} step {j}"
                  for j, counts in enumerate(per_step) for k in ("A", "A_dx", "D")
                  if k not in need and counts[k] != 0]
        fails += [f"kernel C launched {counts['C']} times in bf16 {phase} step {j} (> 2)"
                  for j, counts in enumerate(per_step) if counts["C"] > 2]
    launches = read_counts()
    log(tag, json.dumps(res))
    return launches, res, fails


# ---------------------------------------------------------------- kernel E


def phase_parts(cfg, hier, gen_seed: int):
    """Kernel E against its plain versions at the probe's two shapes, bf16
    and f32: ``index`` bit for bit, the others within 1e-4 of max |out|
    (f32 sums in another order), ``full`` bit for bit against kernel A."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv_parts import shapes
    from panopticsegforlargescalepointcloud_tpu_torch.ops.conv import sparse_conv_fwd
    from panopticsegforlargescalepointcloud_tpu_torch.ops.conv_parts import (
        PARTS,
        sparse_conv_part,
        sparse_conv_part_plain,
    )

    dev = hier.same_maps[0].device
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    rows, fails = [], []
    for label, nbr, cin, cout, n_in, same in shapes(hier, cfg.in_feat):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((n_in, cin), generator=gen, device=dev).to(dt)
            w = (torch.randn((27, cin, cout), generator=gen, device=dev)
                 * math.sqrt(2.0 / (27 * cout))).to(dt)
            for part in PARTS:
                if part == "contig" and not same:
                    continue
                got = sparse_conv_part(part, x, nbr, w)
                want = sparse_conv_part_plain(part, x, nbr, w)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = 0.0 if part == "index" else 1e-4 * max(float(want.abs().max()), 1e-30)
                ok = bool(torch.isfinite(got).all()) and err <= tol
                rec = dict(shape=label, dtype=str(dt).split(".")[-1], part=part,
                           max_abs_err=err, tol=tol, ok=ok)
                if part == "full":
                    rec["equals_A"] = bool(torch.equal(got, sparse_conv_fwd(x, nbr, w)))
                    ok = ok and rec["equals_A"]
                if part == "full" and label.startswith("L0") and dt == torch.bfloat16:
                    rec["plain_ms"] = cuda_ms(lambda: sparse_conv_part_plain(part, x, nbr, w),
                                              iters=3, warmup=1)
                rows.append(rec)
                log("E", json.dumps(rec))
                if not ok:
                    fails.append(f"E {label} {rec['dtype']} {part}: {rec}")
    return rows, fails


def probe_path(cfg, hier):
    """The probe's own path (``bench_conv_parts.run``, the entry point of
    ``python3 -m ...bench_conv_parts``): every part timed at both shapes."""
    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv_parts import run

    recs = run(hier, cfg.in_feat)
    for rec in recs:
        log("E probe", json.dumps(rec))
    return recs


# ------------------------------------------------------------ full-scene serving


def serving_checkpoint(ckpt_dir: str, seed: int, models=None, **budget_overrides) -> None:
    """A port checkpoint of ``flagship.random_model`` weights whose run
    config is ``conf/eval.yaml``'s (with the model yaml ``models`` where
    given, plus ``budget_overrides``)."""
    from panopticsegforlargescalepointcloud_tpu_torch.cli.eval import model_config
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model, serving_yaml
    from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint

    run_cfg = serving_yaml(models)
    run_cfg["budget_overrides"] = dict(budget_overrides)
    model = random_model(model_config(run_cfg)[0], seed)
    ModelCheckpoint(ckpt_dir, run_config=run_cfg).save_best_models_under_current_metrics(
        {"state_dict": model.state_dict()}, None, {})


def scene_labels(out_dir: str):
    from panopticsegforlargescalepointcloud_tpu_torch.data.ply import read_ply

    sem = read_ply(os.path.join(out_dir, "Semantic_results_forEval_0.ply"))["preds"]
    ins = read_ply(os.path.join(out_dir, "Instance_Results_forEval0.ply"))["preds"]
    return sem.astype(np.int64), ins.astype(np.int64)


def partition_agreement(a, b) -> float:
    """Share of points whose label in ``b`` is the one that ``a``'s label
    maps to (each label of ``a`` mapped to its most-overlapping label of
    ``b``), the smaller of the two directions: 1.0 when the two
    partitions are the same up to relabelling."""
    def one_way(x, y):
        pairs, counts = np.unique(np.stack([x, y]), axis=1, return_counts=True)
        best = {}
        for (lx, ly), c in zip(pairs.T, counts):
            if c > best.get(lx, (0, None))[0]:
                best[lx] = (c, ly)
        return sum(c for c, _ in best.values()) / len(x)

    return min(one_way(a, b), one_way(b, a))


def scene_f32(tmp: str, seed: int, models=None, tag: str = "scene f32", overrides=None):
    """A quarter of the forest through the eval CLI's path in f32, once
    with the kernels and once with the plain versions: per-point semantic
    labels >= 99.9% identical, the instance partition identical up to
    relabelling on >= 99% of points. ``min_score`` 0 keeps every cluster
    that survives NMS and the size filter (random weights score most
    clusters below the shipped 0.5), so that there are instances to
    compare. ``overrides``: the model's config fields beside the yaml's
    (the checkpoint's budget overrides)."""
    from panopticsegforlargescalepointcloud_tpu_torch.cli.eval import build_evaluator
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import write_forest_scene

    ply = os.path.join(tmp, "forest_quarter.ply")
    points = write_forest_scene(ply, quarter=True)
    key = tag.replace(" ", "_")
    ckpt = os.path.join(tmp, f"ckpt_{key}")
    serving_checkpoint(ckpt, seed, models, compute_dtype="float32", min_score=0.0,
                       **(overrides or {}))
    over = [f"models=panoptic/{models}"] if models else []
    labels = {}
    for name, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
        out = os.path.join(tmp, f"{key}_{name}")
        ev, run_kwargs, _, _ = build_evaluator([f"checkpoint_dir={ckpt}",
                                                f"data.files.test=[{ply}]",
                                                "tiles_per_dispatch=1"] + over)
        with ctx():
            rep = ev.run(out_dir=out, **run_kwargs)[0]
        labels[name] = (scene_labels(out), rep)
    (ks, ki), krep = labels["kernels"]
    (ps, pi), prep = labels["plain"]
    res = dict(points=points, semantic_identical=float((ks == ps).mean()),
               instance_partition_agreement=partition_agreement(ki, pi),
               instances=[int(len(np.unique(x[x >= 0]))) for x in (ki, pi)],
               meanPQ=[krep["meanPQ"], prep["meanPQ"]], mIoU=[krep["mIoU"], prep["mIoU"]])
    log(f"{tag} kernel vs plain", json.dumps(res))
    fails = [] if min(res["instances"]) > 0 else [f"{tag}: no instances to compare"]
    if res["semantic_identical"] < 0.999:
        fails.append(f"{tag} semantic labels identical {res['semantic_identical']} < 0.999")
    if res["instance_partition_agreement"] < 0.99:
        fails.append(f"{tag} instance partition agreement "
                     f"{res['instance_partition_agreement']} < 0.99")
    return fails


def scene_bf16(tmp: str, seed: int, groups=(1, 2), models=None, tag: str = "scene",
               overrides=None, phased: bool = True):
    """The whole forest (~500k points) through the eval CLI's path in bf16,
    as shipped, from a port checkpoint: per tiles_per_dispatch g, one warm
    run, then one timed run without phase syncs (counts reset just before
    it and read just after) and, with ``phased``, one with them (the phase
    split). ``overrides``: as :func:`scene_f32`'s."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cli.eval import build_evaluator
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import write_forest_scene

    ply = os.path.join(tmp, "forest.ply")
    points = write_forest_scene(ply)
    key = tag.replace(" ", "_")
    ckpt = os.path.join(tmp, f"ckpt_{key}_bf16")
    serving_checkpoint(ckpt, seed, models, **(overrides or {}))
    over = [f"models=panoptic/{models}"] if models else []
    fails, res = [], {}
    launches = None
    for g in groups:
        args = [f"checkpoint_dir={ckpt}", f"data.files.test=[{ply}]",
                f"tiles_per_dispatch={g}"] + over
        t0 = time.perf_counter()
        ev, run_kwargs, _, _ = build_evaluator(args)
        setup_s = time.perf_counter() - t0
        if launches is None:
            launches = {k: 0 for k in conv_kernels(ev.pcfg) + cluster_kernels(ev.pcfg)}
        out = os.path.join(tmp, f"{key}_bf16_g{g}")
        ev.run(out_dir=out, **run_kwargs)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rep = ev.run(out_dir=out, **run_kwargs)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        timer = PhaseTimer()
        wall_phased = None
        if phased:
            tev, _, _, _ = build_evaluator(args, timer=timer)
            t0 = time.perf_counter()
            tev.run(out_dir=out, **run_kwargs)
            wall_phased = time.perf_counter() - t0
        tiles = len(ev.dataset.test_tiles(0))
        for k in launches:
            launches[k] += counts[k]
            if counts[k] <= 0:
                fails.append(f"kernel {k} not launched in the {tag} bf16 at g={g}")
        if "A" not in launches and counts["A"] != 0:
            fails.append(f"kernel A launched {counts['A']} times in the {tag} bf16 at g={g}")
        if counts["C"] > 2 * -(-tiles // g):
            fails.append(f"kernel C launched {counts['C']} times in the {tag} bf16 at g={g} "
                         f"(> 2 per dispatch)")
        sem, ins = scene_labels(out)
        res[f"g{g}"] = dict(
            s_per_scene=wall, points_per_s=points / wall, s_per_scene_with_phase_syncs=wall_phased,
            setup_s=setup_s, tiles=tiles, dispatches=-(-tiles // g), points=points,
            phases_s={k: v / 1e3 for k, v in timer.ms.items()},
            launches_per_scene={k: counts[k] for k in launches},
            cluster_overflow=ev.last_overflow["cluster_overflow"],
            scorer_overflow=ev.last_overflow["scorer_overflow"],
            rg_graph_trunc=ev.last_overflow["rg_graph_trunc"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            instances=int(len(np.unique(ins[ins >= 0]))),
            meanPQ=rep["meanPQ"], mIoU=rep["mIoU"], F1=rep["F1"],
        )
        log(f"{tag} bf16 g={g}", json.dumps(res[f"g{g}"]))
        if not all(math.isfinite(rep[k]) for k in ("meanPQ", "mIoU", "F1", "vote_miou")):
            fails.append(f"{tag} bf16 g={g}: non-finite report {rep}")
        if len(sem) != points:
            fails.append(f"{tag} bf16 g={g}: {len(sem)} labels for {points} points")
    if len(groups) > 1:
        a, b = (scene_labels(os.path.join(tmp, f"{key}_bf16_g{g}")) for g in groups[:2])
        res["g2_vs_g1_semantic_identical"] = float((a[0] == b[0]).mean())
        res["g2_vs_g1_instance_partition_agreement"] = partition_agreement(a[1], b[1])
    log(f"{tag} summary", json.dumps(res))
    return launches, res, fails


def eval_tile_shapes(tmp: str):
    """Kernels A, B and C held against their plain versions and timed at the
    serving path's shapes: A at every conv of one eval forward of the
    forest's largest 32,768-row eval tile, B at T = 12,288 (one tile per
    dispatch) and 24,576 (two), C at B = 1 and 2 samples. Returns A's
    records and the failures."""
    from panopticsegforlargescalepointcloud_tpu_torch.bench_cluster import random_class_operands
    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv import (
        serving_tiles,
        tile_forward_convs,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.data import batch_arrays, collate_tiles
    from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize
    from panopticsegforlargescalepointcloud_tpu_torch.train.evaluator import grouped_config

    pcfg, cap, tiles = serving_tiles(os.path.join(tmp, "forest.ply"))
    fails, rows = [], []
    for g in (1, 2):
        cfg = grouped_config(pcfg, cap, g)
        arrays = batch_arrays(collate_tiles(tiles[:g], capacity=cap * g, num_tiles=g))
        db = canonicalize(*arrays)
        if g == 1:
            rows, f = phase_convs(tile_forward_convs(cfg, arrays, 9), gen_seed=9,
                                  tag="eval tile conv")
            fails += f
        t = cfg.resolved_point_cap(db.grid.capacity)
        fails += phase_pull(cfg, "random_class", t, *random_class_operands(cfg, db, t, seed=3),
                            tag=f"eval tile B g={g}")[1]
        fails += phase_meanshift(g, cfg.ms_max_seeds, cfg.ms_point_cap, cfg.embed_dim,
                                 cfg.bandwidth, seed=3, tag=f"eval tile C g={g}")[1]
    return rows, fails


# ------------------------------------------------------------ the paper's settings


@contextlib.contextmanager
def captured(module, name: str, found: list):
    """Pass every call of ``module.name`` through and record its arguments
    (tensors cloned before the call)."""
    fn0 = getattr(module, name)

    def fn(*args, **kwargs):
        found.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
        return fn0(*args, **kwargs)

    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, fn0)


def setting_forward(cfg, arrays, seed: int, name: str, repeats: int = 3, tag=None):
    """One setting's bf16 eval forward at the flagship's width: the launches
    of one run (counts set to 0 just before it, read just after; the region
    growing and mean-shift operands recorded), then ``repeats`` runs timed
    whole and ``repeats`` with a phase split (a point backbone's radius
    queries a phase of their own)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.bench_cluster import (
        captured_region_growing,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.cluster import meanshift
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    model = random_model(cfg, seed)
    fwd = make_eval_forward(cfg, model)
    fwd(arrays)  # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30  # held before the forward
    torch.cuda.reset_peak_memory_stats()
    rg, ms = [], []
    reset_counts()
    with captured_region_growing(rg), captured(meanshift, "meanshift_converge", ms):
        db, out = fwd(arrays)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = tag or f"setting {name}"
    need = conv_kernels(cfg) + cluster_kernels(cfg)
    fails = [f"{tag}: {m}" for m in check_output(cfg, db, out)]
    fails += [f"{tag}: kernel {k} not launched on the eval forward" for k in need
              if launches[k] <= 0]
    fails += [f"{tag}: kernel {k} launched {launches[k]} times on the eval forward"
              for k in ("A", "B", "C", "A_dx", "D") if k not in need and launches[k] != 0]
    if launches["C"] > 1:
        fails.append(f"{tag}: kernel C launched {launches['C']} times (one mean-shift run)")
    whole, phased = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(arrays)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    for _ in range(repeats):
        timer = PhaseTimer()
        with (radius_query_phase(timer) if cfg.is_point_backbone
              else contextlib.nullcontext()):
            make_eval_forward(cfg, model, timer=timer)(arrays)
        phased.append(timer.ms)
    rec = dict(ms_per_forward=whole, ms_median=statistics.median(whole), phases_ms=phased,
               launches_per_forward=launches, peak_mem_gib=peak, base_mem_gib=base,
               valid_proposals=int(out.proposals.prop_valid.sum()),
               proposal_slots=int(out.proposals.prop_valid.shape[0]),
               cluster_overflow=int(out.cluster_overflow),
               rg_graph_trunc=int(out.rg_graph_trunc),
               scorer_overflow=(None if out.scorer_overflow is None
                                else int(out.scorer_overflow)),
               region_growing_calls=len(rg), mean_shift_dims=[m[2].shape[2] for m in ms])
    log(f"{tag} forward bf16", json.dumps(rec))
    return rec, launches, rg, ms, fails


def hdbscan_forward(cfg, arrays, seed: int, name: str):
    """One bf16 eval forward of an HDBSCAN strategy after a warm one, timed
    per phase (counts set to 0 just before it, read just after); the
    HDBSCAN runs of the first op are held against the same function on the
    CPU: partitions within 1% of the points (the card's and the host's
    Gram products round differently)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cluster import hdbscan
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model
    from panopticsegforlargescalepointcloud_tpu_torch.models import pointgroup3heads
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    model = random_model(cfg, seed)
    make_eval_forward(cfg, model)(arrays)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer()
    fwd = make_eval_forward(cfg, model, timer=timer)
    runs = []
    reset_counts()
    with captured(pointgroup3heads, "hdbscan_labels", runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db, out = fwd(arrays)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    tag = f"hdbscan {name}"
    fails = [f"{tag}: {m}" for m in check_output(cfg, db, out)]
    fails += [f"{tag}: kernel {k} launched {launches[k]} times" for k in ("B", "C", "A_dx", "D")
              if launches[k] != 0]
    if launches["A"] <= 0:
        fails.append(f"{tag}: kernel A not launched")
    x, valid = runs[0][0][:4], runs[0][1][:4]  # the first op's first 4 samples
    kw = dict(min_samples=cfg.hd_min_samples, min_cluster_size=cfg.hd_min_cluster_size,
              epsilon=cfg.hd_epsilon, max_clusters=cfg._op_max_clusters(cfg.embed_ops[0]),
              selection=cfg.hd_selection)
    card = hdbscan.hdbscan_labels(x, valid, **kw)
    host = hdbscan.hdbscan_labels(x.cpu(), valid.cpu(), **kw)
    agree = 1.0
    for i in range(x.shape[0]):
        v = valid[i].cpu()
        if bool(v.any()):
            agree = min(agree, partition_agreement(card.labels[i].cpu()[v].numpy(),
                                                   host.labels[i][v].numpy()))
    rec = dict(ms_per_forward=ms, hdbscan_ms=timer.ms.get("hdbscan"), phases_ms=timer.ms,
               hdbscan_calls=len(runs), hdbscan_samples=[int(r[0].shape[0]) for r in runs],
               points_per_sample=int(x.shape[1]), valid_points=int(valid.sum()),
               clusters=card.num_clusters.tolist(), host_clusters=host.num_clusters.tolist(),
               card_vs_host_partition_agreement=agree,
               valid_proposals=int(out.proposals.prop_valid.sum()),
               cluster_overflow=int(out.cluster_overflow), launches_per_forward=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{tag} forward bf16", json.dumps(rec))
    if agree < 0.99:
        fails.append(f"{tag}: card vs host partition agreement {agree} < 0.99")
    return rec, launches, fails


def settings_path(tmp: str, arrays, seed: int):
    """The eighth path: the paper's Settings I, II, III and V at the
    flagship's width (paper plan, in_feat 16, 131,072 rows of
    ``build_inputs``, 4 samples, bf16, seeded weights): per setting 3 eval
    forwards and 3 prepare + 2 full train steps with their launches;
    kernel against plain version in f32 for the forwards of I and V; C at
    Setting I's own operands (the embedding's 5 columns); B at both
    region-growing sources of III and V; then the embed strategies 14 and 2
    (HDBSCAN) and Setting I's scene through the eval CLI. Returns (launches
    of the path's counted runs, records, failures)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.bench_cluster import forward_operands
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import SETTINGS, flagship_config

    fails, res = [], {}
    total = {k: 0 for k in kernels()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    for name in ("I", "II", "III", "V"):
        cfg = flagship_config(num_samples=4, compute_dtype="bfloat16", models=SETTINGS[name])
        rec, counts, rg, ms, f = setting_forward(cfg, arrays, seed, name)
        fails += f
        add(counts)
        if name == "I":
            for m in ms:
                c_rec, f = check_meanshift(*m[:5], tag="setting I C", max_iter=m[5])
                fails += f
                res["C_setting_I"] = c_rec
                if c_rec["e"] > 5:
                    fails.append(f"setting I: C ran at E = {c_rec['e']} (> 5)")
        for src, c in zip(cfg.rg_sources, rg):
            t = min(cfg.resolved_point_cap(len(arrays[0])), c["pos"].shape[0])
            b_rec, f = phase_pull(cfg, f"forward_{src}", t, *forward_operands(cfg, [c], t),
                                  tag=f"setting {name} B {src}")
            fails += f
            res.setdefault("B", {})[f"{name}_{src}"] = {
                k: b_rec[k] for k in ("t", "differing_rows", "pairs_evaluated", "ms",
                                      "device_ms", "plain_ms", "bound_ms")}
        if name in ("I", "V"):
            fails += main_path_f32(dataclasses.replace(cfg, compute_dtype="float32"), arrays,
                                   seed, tag=f"setting {name} f32 kernel vs plain")
        launches, tres, f = train_steps_bf16(cfg, arrays, seed, n_prepare=3, n_full=2,
                                             tag=f"setting {name} train steps bf16")
        fails += f
        add(launches)
        res[name] = dict(
            forward_ms=rec["ms_median"], forward_phases_ms=rec["phases_ms"][-1],
            prepare_ms=tres["prepare"]["ms_per_step_median"],
            full_ms=tres["full"]["ms_per_step_median"],
            launches_per_forward={k: v for k, v in counts.items() if v},
            launches_per_prepare_step={k: v for k, v in
                                       tres["prepare"]["launches_per_step"][-1].items() if v},
            launches_per_full_step={k: v for k, v in
                                    tres["full"]["launches_per_step"][-1].items() if v},
            peak_mem_gib=dict(forward=rec["peak_mem_gib"],
                              prepare=tres["prepare"]["peak_mem_gib"],
                              full=tres["full"]["peak_mem_gib"]),
            valid_proposals=rec["valid_proposals"], cluster_overflow=rec["cluster_overflow"],
            mean_shift_dims=rec["mean_shift_dims"])
        torch.cuda.empty_cache()
    for ct in (14, 2):
        cfg = flagship_config(num_samples=4, compute_dtype="bfloat16", models=SETTINGS["I"],
                              cluster_type=ct)
        rec, counts, f = hdbscan_forward(cfg, arrays, seed, f"embed {ct}")
        fails += f
        add(counts)
        res[f"embed{ct}"] = {k: rec[k] for k in ("ms_per_forward", "hdbscan_ms",
                                                 "hdbscan_samples", "valid_proposals",
                                                 "card_vs_host_partition_agreement",
                                                 "peak_mem_gib")}
        torch.cuda.empty_cache()
    fails += scene_f32(tmp, seed, models=SETTINGS["I"], tag="setting I scene f32")
    scene_launches, scene_res, f = scene_bf16(tmp, seed, models=SETTINGS["I"],
                                              tag="setting I scene")
    fails += f
    add(scene_launches)
    res["scene_I"] = {g: ({k: r[k] for k in ("s_per_scene", "points_per_s", "phases_s",
                                             "launches_per_scene", "instances", "meanPQ")}
                          if isinstance(r, dict) else r) for g, r in scene_res.items()}
    log("settings summary", json.dumps(res))
    return total, res, fails


# ------------------------------------------------------------------ the trainer


class StepRecorder:
    """Wraps every train step the trainer builds (``train.trainer``'s
    ``make_train_step``): per call, the phase, the schedule count before
    it, the host time to its end (the step ends in a device synchronize),
    its own kernel launches and its peak device memory."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def installed(self):
        import torch

        from panopticsegforlargescalepointcloud_tpu_torch.train import trainer as trainer_mod

        make = trainer_mod.make_train_step

        def make_recorded(cfg, model, optimizer, schedule, with_clustering, **kw):
            step = make(cfg, model, optimizer, schedule, with_clustering, **kw)

            def recorded(arrays, bn_momentum):
                before = read_counts()
                count = optimizer.param_groups[0].get("count", 0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                metrics = step(arrays, bn_momentum)
                torch.cuda.synchronize()
                self.calls.append(dict(
                    phase="full" if with_clustering else "prepare", count=count,
                    s=time.perf_counter() - t0,
                    launches={k: v - before[k] for k, v in read_counts().items()},
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))
                return metrics

            return recorded

        trainer_mod.make_train_step = make_recorded
        try:
            yield self
        finally:
            trainer_mod.make_train_step = make


def epoch_rows(run_dir: str, calls, steps_per_epoch: int, starts=(1,)):
    """Per epoch: the median s per step, the data and step seconds per step
    (``StageTimers``' running means in ``metrics.jsonl``, unrolled; a
    trainer that starts at an epoch of ``starts`` starts its timers anew),
    the losses, the peak memory of its steps and its validation metrics."""
    from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint

    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        lines = [json.loads(line) for line in fh]
    val = ModelCheckpoint(run_dir).stats.get("val", [])
    rows, prev, start = [], {}, 1
    for e, line in enumerate(lines, 1):
        mine = calls[(e - 1) * steps_per_epoch:e * steps_per_epoch]
        if e in starts:
            prev, start = {"data": 0.0, "step": 0.0}, e
        n = (e - start + 1) * steps_per_epoch  # steps behind the running means
        tot = {k: line[f"train_time_{k}"] * n for k in prev}
        rows.append(dict(
            epoch=e, phase=mine[0]["phase"] if mine else None, steps=len(mine),
            s_per_step_median=statistics.median(c["s"] for c in mine) if mine else None,
            data_s_per_step=(tot["data"] - prev["data"]) / steps_per_epoch,
            step_s_per_step=(tot["step"] - prev["step"]) / steps_per_epoch,
            loss=line.get("train_loss"), semantic_loss=line.get("train_semantic_loss"),
            score_loss=line.get("train_score_loss"), lr=line.get("train_lr"),
            peak_mem_gib=max((c["peak_mem_gib"] for c in mine), default=None),
            val=val[e - 1] if e - 1 < len(val) else None))
        prev = tot
    return lines, rows


def trainer_path(tmp: str):
    """The seventh path: ``cli/train.py:main`` with the root config's
    defaults (Setting IV on ``treeins_rad8``, paper plan, 131,072-row
    batches of 4 tiles, bf16, Adam, 2 prefetch workers) on the
    ``measure_e2e`` forest (train: the whole scene; val: its quarter), 2
    epochs of 8 steps with the full phase in epoch 2 and a full-split
    validation after each; then a resume of the same run directory to epoch
    3; then ``cli/forward.py`` with that checkpoint over the quarter scene.
    Counts are reset just before the first run and read after the forward."""
    from panopticsegforlargescalepointcloud_tpu_torch.cli import forward as cli_forward
    from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
    from panopticsegforlargescalepointcloud_tpu_torch.data.ply import read_ply
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import write_forest_scene
    from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint

    train_ply, val_ply = os.path.join(tmp, "train.ply"), os.path.join(tmp, "val.ply")
    write_forest_scene(train_ply)
    val_points = write_forest_scene(val_ply, quarter=True)
    run_dir = os.path.join(tmp, "run")
    args = [f"data.files.train=[{train_ply}]", f"data.files.val=[{val_ply}]",
            f"checkpoint_dir={run_dir}", "training.samples_per_epoch=32",
            "models.PointGroup-PAPER.prepare_epoch=1", "pretty_print=False"]
    fails, res = [], {}
    recorder = StepRecorder()
    reset_counts()
    with recorder.installed():
        t0 = time.perf_counter()
        trainer = cli_train.main(args + ["training.epochs=2"])
        res["train_s"] = time.perf_counter() - t0
        spe = trainer.steps_per_epoch
        first = len(recorder.calls)
        count_saved = ModelCheckpoint(run_dir).get_optimizer_state()["param_groups"][0]["count"]
        t0 = time.perf_counter()
        resumed = cli_train.main(args + ["training.epochs=3"])
        res["resume_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    written = cli_forward.main([f"checkpoint_dir={run_dir}", f"data.files.test=[{val_ply}]",
                                f"out_dir={os.path.join(tmp, 'fwd')}"])
    res["forward_s"] = time.perf_counter() - t0
    launches = read_counts()
    lines, rows = epoch_rows(run_dir, recorder.calls, spe, starts=(1, resumed.start_epoch))
    res.update(steps_per_epoch=spe, epochs=rows, launches=launches, steps=recorder.calls,
               resume=dict(start_epoch=resumed.start_epoch, count_saved=count_saved,
                           count_first_resumed_step=recorder.calls[first]["count"]
                           if len(recorder.calls) > first else None,
                           count_after=resumed.optimizer.param_groups[0]["count"],
                           step_after=resumed.state.step))
    for row in rows:
        log("trainer epoch", json.dumps(row))
    # every logged loss finite
    for line in lines:
        bad = [k for k, v in line.items() if k.startswith("train_") and not math.isfinite(v)]
        if bad:
            fails.append(f"trainer: non-finite {bad} at step {line['step']}")
    if len(lines) != 3:
        fails.append(f"trainer: metrics.jsonl has {len(lines)} lines for 3 epochs")
    # kernels: A, dX and D in every step; B (and its tables) and C in every full step
    for i, c in enumerate(recorder.calls):
        need = ["A", "A_dx", "D"] + (["B", "B_keys", "B_blocks", "B_cands", "C"]
                                      if c["phase"] == "full" else [])
        fails += [f"trainer: kernel {k} not launched in step {i} ({c['phase']})"
                  for k in need if c["launches"][k] <= 0]
    phases = [c["phase"] for c in recorder.calls]
    if phases != ["prepare"] * spe + ["full"] * (2 * spe):
        fails.append(f"trainer: step phases {phases}")
    r = res["resume"]
    if not (r["start_epoch"] == 3 and r["count_saved"] == 2 * spe
            == r["count_first_resumed_step"] and r["count_after"] == 3 * spe == r["step_after"]):
        fails.append(f"trainer: the resume does not continue the count: {r}")
    ply = read_ply(written[val_ply])
    sem, ins = ply["pred_sem"].astype(np.int64), ply["pred_ins"].astype(np.int64)
    res["forward"] = dict(rows=len(sem), points=val_points, classes=np.unique(sem).tolist(),
                          instances=int(len(np.unique(ins[ins >= 0]))))
    if len(sem) != val_points or len(ins) != val_points:
        fails.append(f"forward: {len(sem)} rows for {val_points} points")
    if sem.min() < 0 or sem.max() >= resumed.pcfg.num_classes or ins.min() < -1:
        fails.append(f"forward: labels out of range {res['forward']}")
    log("trainer summary", json.dumps({k: v for k, v in res.items() if k not in ("epochs",
                                                                               "steps")}))
    with open(os.path.join(OUT_DIR, "trainer.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return launches, res, fails


# ------------------------------------------------------------- point backbones


def cell_cap_shares(cfg, arrays):
    """Per radius query of ``cfg``'s point backbone on the flagship batch:
    the share of valid query rows whose 27-cell scan ``point_cell_cap``
    truncated (a logged diagnostic: does the shipped cap bind?)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cluster.neighbors import (
        cell_cap_truncated,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.models.pointgroup3heads import (
        make_backbone,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.models.point_backbones import (
        level_positions,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
    from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize

    with torch.no_grad():
        db = canonicalize(*arrays)
        hier = build_hierarchy(db.grid, cfg.num_down)
        ps, masks = level_positions(db.pos, hier)
        batches = [g.batch for g in hier.grids]
        net = make_backbone(cfg)
        queries = []  # (label, query level, support level, radius)
        if cfg.backbone == "kpconv":
            for lvl in range(cfg.point_levels + 1):
                queries.append((f"L{lvl} self", lvl, lvl, net.radius(lvl)))
                if lvl < cfg.point_levels:
                    queries.append((f"L{lvl + 1} from L{lvl}", lvl + 1, lvl, net.radius(lvl)))
        else:
            for lvl in range(cfg.point_levels):
                for r in getattr(net, f"sa{lvl}").radii:
                    queries.append((f"SA L{lvl + 1} from L{lvl}", lvl + 1, lvl, r))
                queries.append((f"FP L{lvl} from L{lvl + 1}", lvl, lvl + 1,
                                getattr(net, f"fp{lvl}").radius))
        out = {}
        for label, q, sup, r in queries:
            n = cell_cap_truncated(ps[q], batches[q], masks[q], ps[sup], batches[sup],
                                   masks[sup], radius=r, cell_cap=cfg.point_cell_cap)
            rows = int(masks[q].sum())
            out[f"{label} r={r:.3g}"] = dict(rows=rows, truncated=int(n),
                                              share=int(n) / max(rows, 1))
    return out


def point_trainer_path(tmp: str):
    """``KPConvPaper-Deform`` through ``cli/train.py`` on the forest (train:
    the whole scene; val: its quarter): 2 epochs of 4 steps
    (``samples_per_epoch`` 16, ``prepare_epoch`` 1), a full-split
    validation after each. Every logged loss finite, the regularizers
    ``fitting_loss`` and ``repulsion_loss`` among them and > 0; one
    ``metrics.jsonl`` line per epoch; B (and its tables) and C in every
    full step, A, dX and D in none. Counts are reset just before the run
    and read just after it."""
    from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import write_forest_scene

    train_ply, val_ply = os.path.join(tmp, "pb_train.ply"), os.path.join(tmp, "pb_val.ply")
    write_forest_scene(train_ply)
    write_forest_scene(val_ply, quarter=True)
    run_dir = os.path.join(tmp, "run_kpconv_deform")
    args = [f"data.files.train=[{train_ply}]", f"data.files.val=[{val_ply}]",
            f"checkpoint_dir={run_dir}", "models=panoptic/kpconv_deform",
            "model_name=KPConvPaper-Deform", "training.samples_per_epoch=16",
            "models.KPConvPaper-Deform.prepare_epoch=1", "pretty_print=False",
            "training.epochs=2"]
    fails, res = [], {}
    recorder = StepRecorder()
    reset_counts()
    with recorder.installed():
        t0 = time.perf_counter()
        trainer = cli_train.main(args)
        res["train_s"] = time.perf_counter() - t0
    launches = read_counts()
    spe = trainer.steps_per_epoch
    lines, rows = epoch_rows(run_dir, recorder.calls, spe)
    for row in rows:
        row.update(fitting_loss=lines[row["epoch"] - 1].get("train_fitting_loss"),
                   repulsion_loss=lines[row["epoch"] - 1].get("train_repulsion_loss"))
        log("KPConvPaper-Deform trainer epoch", json.dumps(row))
    if len(lines) != 2:
        fails.append(f"point trainer: metrics.jsonl has {len(lines)} lines for 2 epochs")
    for line in lines:
        bad = [k for k, v in line.items() if k.startswith("train_") and not math.isfinite(v)]
        if bad:
            fails.append(f"point trainer: non-finite {bad} at step {line['step']}")
        for k in ("train_fitting_loss", "train_repulsion_loss"):
            if not line.get(k, 0) > 0:
                fails.append(f"point trainer: {k} {line.get(k)} at step {line['step']}")
    for i, c in enumerate(recorder.calls):
        need = ["B", "B_keys", "B_blocks", "B_cands", "C"] if c["phase"] == "full" else []
        fails += [f"point trainer: kernel {k} not launched in step {i} ({c['phase']})"
                  for k in need if c["launches"][k] <= 0]
        fails += [f"point trainer: kernel {k} launched in step {i}" for k in ("A", "A_dx", "D")
                  if c["launches"][k] != 0]
    phases = [c["phase"] for c in recorder.calls]
    if phases != ["prepare"] * spe + ["full"] * spe:
        fails.append(f"point trainer: step phases {phases}")
    res.update(steps_per_epoch=spe, epochs=rows, launches=launches, steps=recorder.calls)
    with open(os.path.join(OUT_DIR, "point_trainer.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return launches, res, fails


def point_backbones_path(tmp: str, arrays, seed: int):
    """The ninth path: the point backbones as shipped
    (``conf/models/panoptic/kpconv.yaml``, ``kpconv_deform.yaml``,
    ``pointnet2.yaml``) on the flagship batch (131,072 rows of
    ``build_inputs``, 4 samples, the 0.12 m NPM3D data yaml, seeded
    weights). Per backbone: the f32 forward with the kernels against the
    plain versions (``main_path_f32``'s tolerances), 3 bf16 eval forwards
    (median ms, phases with the radius queries apart, launches, peak
    memory), 3 prepare + 2 full bf16 train steps, and the share of query
    rows the cell cap truncated. Then one f32 full step of
    ``KPConvPaper-Deform`` with the kernels and one with the plain
    versions (the f32 comparisons under :func:`deterministic`);
    ``KPConvPaper``'s scene through the eval CLI (a quarter in f32 against
    the plain versions, the whole forest in bf16 at g = 2); and
    ``KPConvPaper-Deform`` through the train CLI. B, B's tables and C must
    launch where clustering runs, A, dX and D never. Returns (launches of
    the path's counted runs, records, failures)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        POINT_BACKBONES,
        flagship_config,
    )

    fails, res = [], {}
    total = {k: 0 for k in kernels()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    for models, name in POINT_BACKBONES.items():
        cfg = flagship_config(num_samples=4, compute_dtype="bfloat16", models=models)
        with deterministic():
            fails += main_path_f32(dataclasses.replace(cfg, compute_dtype="float32"), arrays,
                                   seed, tag=f"{name} f32 kernel vs plain")
        rec, counts, _, _, f = setting_forward(cfg, arrays, seed, name, tag=name)
        fails += f
        add(counts)
        launches, tres, f = train_steps_bf16(cfg, arrays, seed, n_prepare=3, n_full=2,
                                             tag=f"{name} train steps bf16")
        fails += f
        add(launches)
        shares = cell_cap_shares(cfg, arrays)
        log(f"{name} cell cap", json.dumps(shares))
        phases = rec["phases_ms"][-1]
        res[name] = dict(
            forward_ms=rec["ms_median"], forward_phases_ms=phases,
            radius_query_share_of_backbone=(phases.get("radius_queries", 0.0)
                                            / max(phases.get("backbone_heads", 0.0), 1e-9)),
            prepare_ms=tres["prepare"]["ms_per_step_median"],
            full_ms=tres["full"]["ms_per_step_median"],
            launches_per_forward={k: v for k, v in counts.items() if v},
            launches_per_full_step={k: v for k, v in
                                    tres["full"]["launches_per_step"][-1].items() if v},
            peak_mem_gib=dict(forward=rec["peak_mem_gib"],
                              prepare=tres["prepare"]["peak_mem_gib"],
                              full=tres["full"]["peak_mem_gib"]),
            valid_proposals=rec["valid_proposals"], cluster_overflow=rec["cluster_overflow"],
            cell_cap_truncated_share={k: v["share"] for k, v in shares.items()},
            internal_losses={k: tres["full"]["last_metrics"][k] for k in
                             ("fitting_loss", "repulsion_loss")
                             if k in tres["full"]["last_metrics"]})
        torch.cuda.empty_cache()
    cfg32 = flagship_config(num_samples=4, compute_dtype="float32", models="kpconv_deform")
    with deterministic():
        f, losses = train_step_f32(cfg32, arrays, seed,
                                   tag="KPConvPaper-Deform train step f32 kernel vs plain",
                                   grads_file="kpconv_deform_f32_grads.json")
    fails += f
    for k in ("fitting_loss", "repulsion_loss"):
        if not (k in losses and all(math.isfinite(v) and v > 0 for v in losses[k])):
            fails.append(f"KPConvPaper-Deform f32 step: {k} {losses.get(k)}")
    res["deform_f32_step_losses"] = losses
    torch.cuda.empty_cache()
    fails += scene_f32(tmp, seed, models="kpconv", tag="KPConvPaper scene f32")
    scene_launches, scene_res, f = scene_bf16(tmp, seed, groups=(2,), models="kpconv",
                                              tag="KPConvPaper scene")
    fails += f
    add(scene_launches)
    res["scene_kpconv"] = {g: {k: r[k] for k in ("s_per_scene", "points_per_s", "phases_s",
                                                 "launches_per_scene", "instances", "meanPQ",
                                                 "peak_mem_gib")}
                           for g, r in scene_res.items()}
    trainer_launches, tr_res, f = point_trainer_path(tmp)
    fails += f
    add(trainer_launches)
    res["trainer_kpconv_deform"] = dict(
        train_s=tr_res["train_s"],
        s_per_step={r["phase"]: r["s_per_step_median"] for r in tr_res["epochs"]},
        peak_mem_gib=max(r["peak_mem_gib"] or 0 for r in tr_res["epochs"]))
    log("point backbones summary", json.dumps(res))
    return total, res, fails


# ------------------------------------ the scorers, the mask head and the edge path


@contextlib.contextmanager
def edge_iterations(found: list):
    """Record the iteration count of every edge-path propagation
    (``cluster/region_grow.py:_grow_on_edges`` logs it at debug level)."""
    import logging

    from panopticsegforlargescalepointcloud_tpu_torch.cluster import region_grow

    class Handler(logging.Handler):
        def emit(self, record):
            found.append(record.args[0])

    handler, level = Handler(), region_grow.log.level
    region_grow.log.addHandler(handler)
    region_grow.log.setLevel(logging.DEBUG)
    try:
        yield found
    finally:
        region_grow.log.removeHandler(handler)
        region_grow.log.setLevel(level)


def variant_f32(cfg32, arrays, seed: int, name: str):
    """A variant's f32 eval forward with the kernels and with the plain
    versions, under PyTorch's deterministic algorithms: heads within 1e-3 of
    max |value|; on the dense pull >= 99.9% of membership rows identical, on
    the edge path the proposals identical (only A differs); the scores of
    the proposals whose members agree within 1e-3 of max |score|. With the
    mask head, the member mask logits within 1e-3 of max |logit|, and a
    keep decision of the score-feature filter may differ only where |logit|
    < 1e-4 of max |logit| (the filter is a step at logit 0); the proposals
    holding such a row leave the score comparison."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    model = random_model(cfg32, seed)
    fwd = make_eval_forward(cfg32, model)
    with deterministic():
        _, k_out = fwd(arrays)
        with plain_kernels():
            db, p_out = fwd(arrays)
    torch.cuda.synchronize()
    tag = f"{name} f32 kernel vs plain"
    fails = [f"{tag}: {m}" for m in check_output(cfg32, db, k_out)]
    res = {}
    for k in ("semantic_logits", "offset_logits", "embed_logits", "backbone_feats"):
        a, b = getattr(k_out, k), getattr(p_out, k)
        scale, err = float(b.abs().max()), float((a - b).abs().max())
        res[k] = dict(max_abs_err=err, scale=scale)
        if err > 1e-3 * max(scale, 1e-30):
            fails.append(f"{tag} {k}: err {err} > 1e-3 * {scale}")
    kp, pp = k_out.proposals, p_out.proposals
    rows_same = kp.prop_id == pp.prop_id
    res["membership_rows_identical"] = float(rows_same.float().mean())
    res["valid_proposals"] = int(kp.prop_valid.sum())
    if not cfg32.rg_dense_enabled and cfg32.rg_sources:
        same = all(bool(torch.equal(getattr(kp, f), getattr(pp, f))) for f in kp._fields)
        res["proposals_identical"] = same
        if not same:
            fails.append(f"{tag}: the edge path's proposals differ")
    elif res["membership_rows_identical"] < 0.999:
        fails.append(f"{tag}: membership rows identical {res['membership_rows_identical']}")
    excluded = torch.zeros_like(kp.prop_valid)
    for props in (kp, pp):
        bad = props.prop_id[~rows_same]
        excluded[bad[bad >= 0].long()] = True
    if k_out.mask_scores is not None:
        both = rows_same & k_out.mask_row_valid & p_out.mask_row_valid
        a, b = k_out.mask_scores[both], p_out.mask_scores[both]
        scale, err = float(b.abs().max()), float((a - b).abs().max())
        thre = cfg32.mask_filter_score_feature_thre
        flips = (torch.sigmoid(a) >= thre) != (torch.sigmoid(b) >= thre)
        edge = b.abs() < 1e-4 * scale
        res["mask_logits"] = dict(max_abs_err=err, scale=scale, keep_flips=int(flips.sum()),
                                  flips_off_the_edge=int((flips & ~edge).sum()),
                                  kept_share=float((torch.sigmoid(b) >= thre).float().mean()))
        if err > 1e-3 * max(scale, 1e-30):
            fails.append(f"{tag} mask logits: err {err} > 1e-3 * {scale}")
        if int((flips & ~edge).sum()):
            fails.append(f"{tag}: keep decisions differ away from logit 0 {res['mask_logits']}")
        flipped = kp.prop_id[both][flips]
        excluded[flipped[flipped >= 0].long()] = True
    if k_out.cluster_scores is not None:
        ok = kp.prop_valid & ~excluded
        a, b = k_out.cluster_scores[ok], p_out.cluster_scores[ok]
        scale = float(p_out.cluster_scores.abs().max())
        err = float((a - b).abs().max()) if bool(ok.any()) else 0.0
        res["scores"] = dict(max_abs_err=err, scale=scale, compared=int(ok.sum()),
                             excluded=int((kp.prop_valid & excluded).sum()))
        if err > 1e-3 * max(scale, 1e-30):
            fails.append(f"{tag} scores: err {err} > 1e-3 * {scale}")
    log(tag, json.dumps(res))
    return fails


def supervised_heads(model):
    """Heads under which the mask loss has members to supervise on the
    ground-free batch of :func:`scorers_edges_path`: every row one thing
    class (2), votes a few mm from the positions (not at them: the
    offsets' norm has no gradient at 0), mask logits biased positive, so
    that region growing's proposals are the planted instances and keep an
    IoU > 0.5 under the mask-based IoU."""
    import torch

    with torch.no_grad():
        model.semantic_out.bias[2] += 8.0
        model.offset_out.weight.mul_(1e-3)
        model.offset_out.bias.fill_(1e-3)
        model.mask_score_b.bias += 3.0


def gate_keys_trainer(tmp: str):
    """``cli/train.py`` with the mask head on the forest (train: the whole
    scene; val: its quarter), 3 epochs of 4 steps, ``prepare_epoch`` 1, the
    score-feature filter from epoch 2 (start 1), the mask-based IoU from
    epoch 3 (start 2): epoch 1 prepare, epochs 2 and 3 full steps of two
    gate states, three distinct steps over the run. Every logged loss
    finite, ``mask_loss`` in the full epochs, one ``metrics.jsonl`` line per
    epoch. Counts are reset just before the run and read just after it."""
    from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import write_forest_scene

    train_ply, val_ply = os.path.join(tmp, "mask_train.ply"), os.path.join(tmp, "mask_val.ply")
    write_forest_scene(train_ply)
    write_forest_scene(val_ply, quarter=True)
    run_dir = os.path.join(tmp, "run_mask")
    m = "models.PointGroup-PAPER"
    args = [f"data.files.train=[{train_ply}]", f"data.files.val=[{val_ply}]",
            f"checkpoint_dir={run_dir}", "training.samples_per_epoch=16", "training.epochs=3",
            f"{m}.prepare_epoch=1", f"{m}.mask_supervise=True",
            f"{m}.use_mask_filter_score_feature=True",
            f"{m}.use_mask_filter_score_feature_start_epoch=1",
            f"{m}.cal_iou_based_on_mask=True", f"{m}.cal_iou_based_on_mask_start_epoch=2",
            "pretty_print=False"]
    fails, res = [], {}
    recorder = StepRecorder()
    reset_counts()
    with recorder.installed():
        t0 = time.perf_counter()
        trainer = cli_train.main(args)
        res["train_s"] = time.perf_counter() - t0
    launches = read_counts()
    spe = trainer.steps_per_epoch
    lines, rows = epoch_rows(run_dir, recorder.calls, spe)
    pcfg = trainer.pcfg
    per_epoch = ["prepare" if e <= pcfg.prepare_epoch else list(pcfg.gates(e))
                 for e in range(1, 4)]
    built = [list(k) for k in trainer._full_steps]
    res.update(steps_per_epoch=spe, step_keys_per_epoch=per_epoch, full_step_keys=built,
               eval_forward_keys=[list(k) for k in trainer._eval_fwds], launches=launches)
    for row in rows:
        row["mask_loss"] = lines[row["epoch"] - 1].get("train_mask_loss")
        log("mask trainer epoch", json.dumps(row))
    if len({str(k) for k in per_epoch}) != 3 or built != [[True, False], [True, True]]:
        fails.append(f"mask trainer: gate keys {per_epoch}, built {built}")
    if res["eval_forward_keys"] != built:
        fails.append(f"mask trainer: validation forwards {res['eval_forward_keys']}")
    if len(lines) != 3:
        fails.append(f"mask trainer: metrics.jsonl has {len(lines)} lines for 3 epochs")
    for line in lines:
        bad = [k for k, v in line.items() if k.startswith("train_") and not math.isfinite(v)]
        if bad:
            fails.append(f"mask trainer: non-finite {bad} at step {line['step']}")
    if any("train_mask_loss" not in line for line in lines[1:]):
        fails.append("mask trainer: no mask_loss in a full epoch")
    for i, c in enumerate(recorder.calls):
        need = ["A", "A_dx", "D"] + (["B", "C"] if c["phase"] == "full" else [])
        fails += [f"mask trainer: kernel {k} not launched in step {i} ({c['phase']})"
                  for k in need if c["launches"][k] <= 0]
    log("mask trainer summary", json.dumps({k: v for k, v in res.items()}))
    return launches, res, fails


def scorers_edges_path(tmp: str, arrays, seed: int):
    """The tenth path: the flagship (``area4_ablation_3heads_5``, paper
    plan, 131,072 rows of ``build_inputs``, 4 samples, bf16, seeded
    weights) in its variants ``flagship.VARIANTS``: ``mask`` (the mask head
    with both epoch gates open), ``encoder`` and ``mlp`` (the ScoreNet's
    other forms), ``edge_all`` and ``edge_cap`` (region growing's edge path
    on all rows and on the compacted rows). Per variant: the f32 forward
    with the kernels against the plain versions (:func:`variant_f32`), 3
    bf16 eval forwards (phases, launches, peak memory; for the edge
    variants the graph's truncated rows and the propagation's iterations,
    beside the dense pull's), 3 prepare + 2 full bf16 train steps; launch
    checks: the encoder's and the mask head's convs add A launches to the
    backbone's, the MLP scorer's forward launches A as the backbone alone,
    the edge variants launch no B. Then one f32 full step with the kernels
    and one with the plain versions for ``mask`` (on a ground-free batch of
    the flagship's width under :func:`supervised_heads`, so that the mask
    loss has members) and ``encoder``; ``mask`` served by the eval CLI (a
    quarter of the forest in f32 against the plain versions, the whole
    forest in bf16 at g = 2) and trained by the train CLI
    (:func:`gate_keys_trainer`). Returns (launches of the path's counted
    runs, records, failures)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        VARIANTS,
        build_inputs,
        flagship_config,
        random_model,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward

    fails, res = [], {}
    total = {k: 0 for k in kernels()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # the dense pull's reference: the flagship as shipped, and the backbone's
    # own A launches (a forward without clustering)
    base = flagship_config(num_samples=4, compute_dtype="bfloat16")
    dense, counts, _, _, f = setting_forward(base, arrays, seed, "dense", tag="dense reference")
    fails += f
    add(counts)
    dense_calls = len(base.rg_sources)
    res["dense"] = dict(forward_ms=dense["ms_median"], phases_ms=dense["phases_ms"][-1],
                        iterations=counts["B"] / 2 / dense_calls, launches=counts)
    reset_counts()
    make_eval_forward(base, random_model(base, seed), with_clustering=False)(arrays)
    torch.cuda.synchronize()
    backbone_a = read_counts()["A"]
    add(read_counts())
    for name in VARIANTS:
        cfg = flagship_config(num_samples=4, compute_dtype="bfloat16", variant=name)
        fails += variant_f32(dataclasses.replace(cfg, compute_dtype="float32"), arrays, seed,
                             name)
        iters = []
        with edge_iterations(iters):
            rec, counts, _, _, f = setting_forward(cfg, arrays, seed, name, tag=name)
        fails += f
        add(counts)
        if name in ("encoder", "mask") and counts["A"] <= backbone_a:
            fails.append(f"{name}: A launched {counts['A']} times, the backbone alone "
                         f"{backbone_a}: the scorer's convs did not launch it")
        if name == "mlp" and counts["A"] != backbone_a:
            fails.append(f"mlp: A launched {counts['A']} times, the backbone alone {backbone_a}")
        if name.startswith("edge"):
            fails += [f"{name}: kernel {k} launched {counts[k]} times on the edge path"
                      for k in ("B", "B_keys", "B_blocks", "B_cands") if counts[k]]
            if not iters:
                fails.append(f"{name}: no edge propagation ran")
        launches, tres, f = train_steps_bf16(cfg, arrays, seed, n_prepare=3, n_full=2,
                                             tag=f"{name} train steps bf16")
        fails += f
        add(launches)
        if name.startswith("edge"):
            fails += [f"{name}: kernel {k} launched in a full step" for k in ("B", "B_keys")
                      if launches[k]]
        phases = rec["phases_ms"][-1]
        res[name] = dict(
            forward_ms=rec["ms_median"], forward_phases_ms=phases,
            prepare_ms=tres["prepare"]["ms_per_step_median"],
            full_ms=tres["full"]["ms_per_step_median"],
            launches_per_forward={k: v for k, v in counts.items() if v},
            launches_per_full_step={k: v for k, v in
                                    tres["full"]["launches_per_step"][-1].items() if v},
            backbone_a=backbone_a,
            peak_mem_gib=dict(forward=rec["peak_mem_gib"],
                              prepare=tres["prepare"]["peak_mem_gib"],
                              full=tres["full"]["peak_mem_gib"]),
            valid_proposals=rec["valid_proposals"], cluster_overflow=rec["cluster_overflow"],
            scorer_overflow=rec["scorer_overflow"], rg_graph_trunc=rec["rg_graph_trunc"],
            full_step_metrics={k: tres["full"]["last_metrics"].get(k) for k in
                               ("mask_loss", "score_loss", "rg_graph_trunc", "loss")},
            edge_iterations=sorted(set(iters)) or None,
            region_growing_ms=phases.get("region_growing"),
            dense_region_growing_ms=res["dense"]["phases_ms"].get("region_growing"),
            dense_iterations=res["dense"]["iterations"])
        torch.cuda.empty_cache()
    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv import train_step_convs
    from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
    from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize

    # A (forward and dX) and D at the scorers' own shapes, against the plain versions
    hier = build_hierarchy(canonicalize(*arrays).grid, base.num_down)
    for name in ("encoder", "mask"):
        cfg = flagship_config(num_samples=4, compute_dtype="bfloat16", variant=name)
        convs = [c for c in train_step_convs(cfg, arrays, hier, seed)
                 if c["map"].startswith("scorer")]
        rows, f = phase_convs(convs, gen_seed=7, tag=f"{name} scorer conv")
        fails += f
        res[f"{name}_scorer_convs"] = dict(count=len(rows), worst_rel=max(
            r["max_abs_err"] / max(r["tol"] * 1e4, 1e-30) for r in rows))
        torch.cuda.empty_cache()
    supervised = build_inputs(n_ground=0, n_instances=60)
    for name, batch, prepare in (("mask", supervised, supervised_heads),
                                 ("encoder", arrays, None)):
        cfg32 = flagship_config(num_samples=4, compute_dtype="float32", variant=name)
        with deterministic():
            f, losses = train_step_f32(cfg32, batch, seed,
                                       tag=f"{name} train step f32 kernel vs plain",
                                       grads_file=f"{name}_f32_grads.json", prepare=prepare,
                                       align_gates=True)
        fails += f
        res[f"{name}_f32_step_losses"] = losses
        if name == "mask" and not all(math.isfinite(v) and v > 0
                                      for v in losses.get("mask_loss", (0.0,))):
            fails.append(f"mask f32 step: mask_loss {losses.get('mask_loss')}")
        torch.cuda.empty_cache()
    fails += scene_f32(tmp, seed, tag="mask scene f32", overrides=VARIANTS["mask"])
    scene_launches, scene_res, f = scene_bf16(tmp, seed, groups=(2,), tag="mask scene",
                                              overrides=VARIANTS["mask"], phased=False)
    fails += f
    add(scene_launches)
    res["scene_mask"] = {g: {k: r[k] for k in ("s_per_scene", "points_per_s",
                                                "launches_per_scene", "instances", "meanPQ",
                                                "peak_mem_gib", "scorer_overflow")}
                         for g, r in scene_res.items()}
    trainer_launches, tr_res, f = gate_keys_trainer(tmp)
    fails += f
    add(trainer_launches)
    res["trainer_mask"] = dict(train_s=tr_res["train_s"], keys=tr_res["step_keys_per_epoch"])
    log("scorers and edges summary", json.dumps(res))
    return total, res, fails


# --------------------------------------------------------------- data parallel


class NamedTimer:
    """Host clock, between device synchronizes, around the phases ``names``
    only; every other phase runs as without a timer."""

    def __init__(self, names):
        self.names = set(names)
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        if name not in self.names:
            yield
            return
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def rank_arrays(stacked, rank: int, device):
    """Block ``rank`` of the [D, ...] arrays as tensors on ``device``."""
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a[rank])).to(device) for a in stacked)


def dp_train_steps(mesh, stacked, seed: int, n_prepare: int = 3, n_full: int = 2):
    """This rank's data-parallel bf16 train steps of the flagship from the
    JAX package's init (seeded, replicated): ``n_prepare`` prepare steps,
    then ``n_full`` full steps (the first of each phase its warm-up); per
    step the host ms, the all-reduce's ms, this rank's launches and the
    replica checksum; per phase the peak memory."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        flagship_config,
        flagship_training,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.parallel import (
        make_parallel_train_step,
        replica_checksum,
        replicate,
        shard_batch,
    )

    cfg = flagship_config(num_samples=4, compute_dtype="bfloat16")
    state, schedule, tc = flagship_training(cfg, seed, device=mesh.device)
    replicate(mesh, state.model)
    arrays = shard_batch(mesh, stacked)
    fails, steps, peak = [], [], {}
    before_all = read_counts()
    for phase, n, clustering in (("prepare", n_prepare, False), ("full", n_full, True)):
        torch.cuda.reset_peak_memory_stats()
        for i in range(n):
            timer = NamedTimer(["all_reduce"])
            step = make_parallel_train_step(cfg, state.model, state.optimizer, schedule, mesh,
                                            clustering, tc.grad_clip_value, timer=timer,
                                            grad_accum=tc.grad_accum)
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(arrays, state.bn_momentum)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v - before[k] for k, v in read_counts().items()}
            metrics = {k: float(v) for k, v in m.items()}
            steps.append(dict(phase=phase, warmup=i == 0, ms=ms,
                              all_reduce_ms=timer.ms.get("all_reduce"),
                              launches={k: counts[k] for k in DP_KERNELS},
                              loss=metrics["loss"], checksum=replica_checksum(state.model)))
            bad = [k for k, v in metrics.items() if not math.isfinite(v)]
            if bad:
                fails.append(f"rank {mesh.rank} DP {phase} step {i}: non-finite {bad}")
            need = conv_kernels(cfg, backward=True) + (cluster_kernels(cfg) if clustering else [])
            fails += [f"rank {mesh.rank} DP {phase} step {i}: kernel {k} not launched"
                      for k in need if counts[k] <= 0]
        peak[phase] = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: v - before_all[k] for k, v in read_counts().items()}
    return dict(steps=steps, peak_mem_gib=peak), launches, fails


def dp_f32_check(mesh, stacked, seed: int):
    """One f32 data-parallel full step of the flagship with the kernels, and
    on rank 0 its hand emulation: the single-device step's gradients and
    BN statistics on each block (``make_loss_and_grads``), summed and
    halved, then the same clip and optimizer math on the same start. Both
    under PyTorch's deterministic algorithms (warnings of ops that have no
    deterministic version are kept). Rank 0 returns each tensor's distance
    over its max |value| (weights, BN statistics) and the losses' relative
    distance; the other ranks return None."""
    import warnings

    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        flagship_config,
        flagship_training,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.models import PointGroup3HeadsNet
    from panopticsegforlargescalepointcloud_tpu_torch.parallel import (
        make_parallel_train_step,
        replicate,
        shard_batch,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.parallel.mesh import bn_statistics
    from panopticsegforlargescalepointcloud_tpu_torch.train import (
        make_loss_and_grads,
        make_optimizer,
        optimizer_step,
    )

    cfg = flagship_config(num_samples=4, compute_dtype="float32")
    state, schedule, tc = flagship_training(cfg, seed, device=mesh.device)
    replicate(mesh, state.model)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    mom = state.bn_momentum
    with deterministic(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = make_parallel_train_step(cfg, state.model, state.optimizer, schedule, mesh, True,
                                        tc.grad_clip_value, grad_accum=tc.grad_accum)
        got = {k: float(v) for k, v in step(shard_batch(mesh, stacked), mom).items()}
        if not mesh.is_root:
            return None
        dev = mesh.device
        grads, stats, losses = [], [], []
        for s in range(mesh.size):
            model = PointGroup3HeadsNet(cfg).to(dev)
            model.load_state_dict(start)
            met = make_loss_and_grads(cfg, model, True, device=dev)(
                rank_arrays(stacked, s, dev), mom, None)
            grads.append([p.grad.detach().clone() for p in model.parameters()])
            stats.append([b.clone() for b in bn_statistics(model)])
            losses.append({k: float(v) for k, v in met.items()})
            del model
        emu = PointGroup3HeadsNet(cfg).to(dev)
        emu.load_state_dict(start)
        opt = make_optimizer(tc.optimizer, emu.parameters(), tc.weight_decay)
        with torch.no_grad():
            for p, *gs in zip(emu.parameters(), *grads):
                p.grad = sum(gs[1:], gs[0]) / mesh.size
            if tc.grad_clip_value is not None:
                torch.nn.utils.clip_grad_value_(list(emu.parameters()), tc.grad_clip_value)
            optimizer_step(opt, schedule, tc.grad_accum)
            for b, *ss in zip(bn_statistics(emu), *stats):
                b.copy_(sum(ss[1:], ss[0]) / mesh.size)
        torch.cuda.synchronize()
    dp, em = state.model.state_dict(), emu.state_dict()
    rel = {}
    for k, v in dp.items():
        scale = float(v.abs().max())
        rel[k] = float((v - em[k]).abs().max()) / (scale if scale > 0 else 1.0)
    stat_names = {k for k in dp if k.rsplit(".", 1)[-1] in ("mean", "var")}
    want = {k: sum(l[k] for l in losses) / mesh.size for k in losses[0] if k != "hier_overflow"}
    loss_rel = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
    return dict(
        weights_max_rel=max(v for k, v in rel.items() if k not in stat_names),
        bn_max_rel=max(v for k, v in rel.items() if k in stat_names),
        worst=sorted(rel.items(), key=lambda kv: -kv[1])[:3],
        tensors=len(rel), identical=sum(v == 0 for v in rel.values()),
        losses_max_rel=max(loss_rel.values()), loss=got["loss"],
        nondeterministic_ops=sorted({str(w.message)[:120] for w in caught}))


def dp_scene(mesh, tmp: str, ckpt: str, ply: str):
    """The forest served from the port checkpoint ``ckpt`` through the eval
    CLI's evaluator on the mesh (one tile per rank): one warm run, one run
    timed per phase; then, on rank 0, the sequential scene at 1 tile per
    dispatch of the same checkpoint, timed per phase, and its labels
    against the mesh scene's."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cli.eval import build_evaluator

    args = [f"checkpoint_dir={ckpt}", f"data.files.test=[{ply}]", "tiles_per_dispatch=1"]
    out = os.path.join(tmp, "dp_scene_mesh")
    ev, run_kwargs, _, _ = build_evaluator(args, mesh=mesh)
    ev.run(out_dir=out, **run_kwargs)  # warm
    timer = PhaseTimer()
    tev, _, _, _ = build_evaluator(args, timer=timer, mesh=mesh)
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = tev.run(out_dir=out, **run_kwargs)
    torch.cuda.synchronize()
    res = dict(mesh=dict(s_per_scene=time.perf_counter() - t0,
                         phases_s={k: v / 1e3 for k, v in timer.ms.items()},
                         tiles=len(tev.dataset.test_tiles(0))))
    launches = {k: v - before[k] for k, v in read_counts().items()}
    if not mesh.is_root:
        return res, launches, []
    seq_timer = PhaseTimer()
    sev, _, _, _ = build_evaluator(args + [f"device={mesh.device}"], timer=seq_timer)
    seq_out = os.path.join(tmp, "dp_scene_seq")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = sev.run(out_dir=seq_out, **run_kwargs)
    torch.cuda.synchronize()
    res["sequential_g1"] = dict(s_per_scene=time.perf_counter() - t0,
                                phases_s={k: v / 1e3 for k, v in seq_timer.ms.items()})
    (ms, mi), (ss, si) = scene_labels(out), scene_labels(seq_out)
    res.update(points=len(ms), semantic_identical=float((ms == ss).mean()),
               instance_identical=float((mi == si).mean()),
               instance_partition_agreement=partition_agreement(mi, si),
               instances=int(len(np.unique(mi[mi >= 0]))),
               reports_equal=reps == seq, meanPQ=reps[0]["meanPQ"], mIoU=reps[0]["mIoU"])
    fails = []
    if res["semantic_identical"] != 1.0 or res["instance_identical"] != 1.0:
        fails.append(f"mesh scene differs from the sequential g=1 scene: {res}")
    if not reps == seq:
        fails.append("mesh scene's report differs from the sequential one")
    return res, launches, fails


def dp_trainer(mesh, tmp: str, ply: str, val_ply: str):
    """``cli/train.py:train`` in this rank: the root config's flagship with
    ``training.num_devices`` 2 on the forest (val: its quarter), 1 epoch of
    4 steps of 2 x 4 tiles, a validation; rank 0 checks one checkpoint
    epoch and one ``metrics.jsonl`` line. Each batch draw (all D device
    batches, in the prefetch threads) is timed."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.cli.train import train
    from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import CONF_DIR
    from panopticsegforlargescalepointcloud_tpu_torch.train import trainer as trainer_mod
    from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint

    run_dir = os.path.join(tmp, "dp_run")
    cfg = load_config(CONF_DIR, [
        f"data.files.train=[{ply}]", f"data.files.val=[{val_ply}]", f"checkpoint_dir={run_dir}",
        f"training.num_devices={mesh.size}", "training.epochs=1",
        f"training.samples_per_epoch={4 * 4 * mesh.size}", "pretty_print=False"])
    make_batch, draws = trainer_mod.Trainer._make_batch, []

    def timed_batch(self, rng):
        t = time.perf_counter()
        out = make_batch(self, rng)
        draws.append(time.perf_counter() - t)
        return out

    before = read_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer_mod.Trainer._make_batch = timed_batch
    t0 = time.perf_counter()
    try:
        summary = train(mesh, cfg, run_dir)
    finally:
        trainer_mod.Trainer._make_batch = make_batch
    res = dict(s=time.perf_counter() - t0, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               draw_s=draws, **summary)
    launches = {k: v - before[k] for k, v in read_counts().items()}
    fails = [f"rank {mesh.rank} DP trainer: kernel {k} not launched"
             for k in ("A", "A_dx", "D") if launches[k] <= 0]
    if summary["steps_per_epoch"] != 4 or summary["step"] != 4:
        fails.append(f"rank {mesh.rank} DP trainer: {summary}")
    if mesh.is_root:
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            lines = [json.loads(line) for line in fh]
        ck = ModelCheckpoint(run_dir)
        res.update(metrics_lines=len(lines), start_epoch=ck.start_epoch,
                   val=ck.stats["val"], loss=lines[-1].get("train_loss"),
                   time_data=lines[-1].get("train_time_data"),
                   time_step=lines[-1].get("train_time_step"))
        if len(lines) != 1 or ck.start_epoch != 2 or len(ck.stats["val"]) != 1:
            fails.append(f"DP trainer wrote {len(lines)} log lines, start epoch "
                         f"{ck.start_epoch}, {len(ck.stats['val'])} validations")
        if not math.isfinite(lines[-1].get("train_loss", float("nan"))):
            fails.append(f"DP trainer: non-finite loss {lines[-1]}")
    return res, launches, fails


# kernels whose launches path 11 reports
DP_KERNELS = ("A", "A_dx", "D", "B", "B_keys", "B_blocks", "B_cands", "C")


def dp_rank(mesh, tmp: str, stacked, ckpt: str, ply: str, val_ply: str, seed: int):
    """One rank of path 11 (two ranks sharing the card over gloo): the DP
    train steps, the f32 check, mesh serving and the DP trainer. Returns
    the records, the launches of the counted runs (steps, the timed mesh
    scene, the trainer; not the f32 check, the warm scene or the
    sequential scene) and the failures."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    total = {k: 0 for k in kernels()}
    fails, res = [], dict(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device))
    for name, fn in (("steps", lambda: dp_train_steps(mesh, stacked, seed)),
                     ("scene", lambda: dp_scene(mesh, tmp, ckpt, ply)),
                     ("trainer", lambda: dp_trainer(mesh, tmp, ply, val_ply))):
        t0 = time.perf_counter()
        res[name], launches, f = fn()
        res[f"{name}_wall_s"] = time.perf_counter() - t0
        fails += f
        for k in total:
            total[k] += launches[k]
        if name == "steps":
            t0 = time.perf_counter()
            res["f32"] = dp_f32_check(mesh, stacked, seed + 2)
            res["f32_wall_s"] = time.perf_counter() - t0
    return dict(res=res, launches=total, fails=fails)


def nccl_rank(mesh, stacked, seed: int):
    """One data-parallel prepare step of the flagship in a one-rank NCCL
    group (the code path the NCCL backend runs; no second card here)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        flagship_config,
        flagship_training,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.parallel import (
        make_parallel_train_step,
        replicate,
        shard_batch,
    )

    cfg = flagship_config(num_samples=4, compute_dtype="bfloat16")
    state, schedule, tc = flagship_training(cfg, seed, device=mesh.device)
    replicate(mesh, state.model)
    timer = NamedTimer(["all_reduce"])
    step = make_parallel_train_step(cfg, state.model, state.optimizer, schedule, mesh, False,
                                    tc.grad_clip_value, timer=timer, grad_accum=tc.grad_accum)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(shard_batch(mesh, stacked), state.bn_momentum)
    torch.cuda.synchronize()
    return dict(backend=mesh.backend, world_size=mesh.size, ms=(time.perf_counter() - t0) * 1e3,
                all_reduce_ms=timer.ms.get("all_reduce"), loss=float(m["loss"]),
                launches=read_counts())


def data_parallel_path(tmp: str, seed: int):
    """The eleventh path: data parallelism over ``torch.distributed``. Two
    ranks share the card over gloo (started by ``parallel.launch.spawn``;
    a correctness run, not a scale-out measurement): per rank 4 tiles of
    the flagship batch (131,072 rows, bf16, paper plan; rank r's batch
    from ``build_inputs(seed=r)``), 3 prepare + 2 full DP train steps
    with equal replica checksums after every step; the f32 DP step against
    its hand emulation (weights, BN statistics and losses within 1e-5 of
    their max |value|); the forest served on the two-rank mesh against the
    sequential g = 1 scene (labels identical); the DP trainer (1 epoch of 4
    steps, a validation, one checkpoint). Then one DP prepare step in a
    one-rank NCCL group. Returns (launches of the counted runs, summed over
    the ranks, records, failures)."""
    import torch

    from panopticsegforlargescalepointcloud_tpu_torch.flagship import (
        build_inputs,
        write_forest_scene,
    )
    from panopticsegforlargescalepointcloud_tpu_torch.parallel import spawn

    stacked = tuple(np.stack(p) for p in zip(build_inputs(seed=0), build_inputs(seed=1)))
    ply, val_ply = os.path.join(tmp, "dp_forest.ply"), os.path.join(tmp, "dp_quarter.ply")
    write_forest_scene(ply)
    write_forest_scene(val_ply, quarter=True)
    ckpt = os.path.join(tmp, "ckpt_dp")
    serving_checkpoint(ckpt, seed)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = spawn(dp_rank, ["cuda:0", "cuda:0"], tmp, stacked, ckpt, ply, val_ply, seed,
                  timeout_s=600)
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = spawn(nccl_rank, ["cuda:0"], tuple(a[:1] for a in stacked), seed, timeout_s=600)[0]
    nccl_s = time.perf_counter() - t0
    fails = [f for r in ranks for f in r["fails"]]
    launches = {k: sum(r["launches"][k] for r in ranks) + nccl["launches"][k]
                for k in kernels()}
    card = card_line()
    res = dict(card=card, ranks_on_one_card=2, gloo_wall_s=gloo_s, nccl_wall_s=nccl_s)
    a, b = (r["res"] for r in ranks)
    for i, (sa, sb) in enumerate(zip(a["steps"]["steps"], b["steps"]["steps"])):
        row = dict(step=i, phase=sa["phase"], warmup=sa["warmup"],
                   ms=[sa["ms"], sb["ms"]], all_reduce_ms=[sa["all_reduce_ms"], sb["all_reduce_ms"]],
                   loss=sa["loss"], checksums_equal=sa["checksum"] == sb["checksum"],
                   launches=[sa["launches"], sb["launches"]])
        log("data parallel step", json.dumps(row))
        if not row["checksums_equal"] or sa["loss"] != sb["loss"]:
            fails.append(f"DP step {i}: replicas differ ({sa['checksum']} / {sb['checksum']})")
    steps = a["steps"]["steps"]
    if len(steps) != 5 or len(b["steps"]["steps"]) != 5:
        fails.append(f"DP steps: {len(steps)} and {len(b['steps']['steps'])} of 5")
    res["steps"] = {
        phase: dict(ms_median=statistics.median(
                        s["ms"] for r in (a, b) for s in r["steps"]["steps"]
                        if s["phase"] == phase and not s["warmup"]),
                    all_reduce_ms_median=statistics.median(
                        s["all_reduce_ms"] for r in (a, b) for s in r["steps"]["steps"]
                        if s["phase"] == phase and not s["warmup"]),
                    peak_mem_gib=[r["steps"]["peak_mem_gib"][phase] for r in (a, b)])
        for phase in ("prepare", "full")}
    f32 = a["f32"]
    log("data parallel f32 vs emulation", json.dumps(f32))
    if max(f32["weights_max_rel"], f32["bn_max_rel"], f32["losses_max_rel"]) > 1e-5:
        fails.append(f"DP f32 step vs hand emulation beyond 1e-5: {f32}")
    res["f32"] = {k: f32[k] for k in ("weights_max_rel", "bn_max_rel", "losses_max_rel",
                                      "identical", "tensors")}
    scene = dict(a["scene"], rank1=b["scene"]["mesh"])
    log("data parallel scene", json.dumps(scene))
    res["scene"] = {k: scene[k] for k in ("semantic_identical", "instance_identical",
                                          "instance_partition_agreement")}
    res["scene"].update(mesh_s=scene["mesh"]["s_per_scene"],
                        sequential_s=scene["sequential_g1"]["s_per_scene"])
    trainer = dict(a["trainer"], rank1_s=b["trainer"]["s"],
                   checksums_equal=a["trainer"]["checksum"] == b["trainer"]["checksum"])
    log("data parallel trainer", json.dumps(trainer))
    if not trainer["checksums_equal"]:
        fails.append("DP trainer: replicas differ after the epoch")
    res["trainer"] = {k: trainer[k] for k in ("s", "step", "metrics_lines", "start_epoch",
                                              "checksums_equal", "peak_mem_gib")}
    res["trainer"]["draw_s_median"] = [statistics.median(r["res"]["trainer"]["draw_s"])
                                       for r in ranks]
    log("nccl step", json.dumps(nccl))
    if nccl["backend"] != "nccl" or not math.isfinite(nccl["loss"]):
        fails.append(f"NCCL step: {nccl}")
    fails += [f"NCCL step: kernel {k} not launched" for k in ("A", "A_dx", "D")
              if nccl["launches"][k] <= 0]
    res["nccl"] = {k: nccl[k] for k in ("backend", "ms", "all_reduce_ms", "loss")}
    res["launches"] = {k: launches[k] for k in DP_KERNELS}
    res["wall_s"] = {k: [r["res"][f"{k}_wall_s"] for r in ranks]
                     for k in ("steps", "f32", "scene", "trainer")}
    log("data parallel summary", json.dumps(res))
    return launches, res, fails


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from panopticsegforlargescalepointcloud_tpu_torch import _cuda
    from panopticsegforlargescalepointcloud_tpu_torch.flagship import build_inputs, flagship_config
    from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
    from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize

    t_start = time.perf_counter()
    log(card_line())
    t0 = time.perf_counter()
    _cuda.build(verbose=True)
    _cuda.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    global _log_file
    _log_file = open(os.path.join(OUT_DIR, "chip_smoke.log"), "w")
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as fh:
        fh.write(_cuda.build_log)

    fails = []
    cfg = flagship_config(num_samples=4, compute_dtype="bfloat16")
    log("config:", json.dumps(dataclasses.asdict(cfg)))
    arrays = build_inputs()
    db = canonicalize(*arrays)
    hier = build_hierarchy(db.grid, cfg.num_down)
    t = cfg.resolved_point_cap(db.grid.capacity)

    from panopticsegforlargescalepointcloud_tpu_torch.bench_conv import train_step_convs

    convs = train_step_convs(cfg, arrays, hier, seed=5)
    conv_rows, f = phase_convs(convs, gen_seed=1, tag="conv")
    fails += f + determinism_summary(conv_rows)
    del convs
    fails += phase_backward(cfg, hier, gen_seed=6)
    b_rec = None
    for case in pull_cases(cfg, db, forward_region_growing(cfg, arrays, seed=5)):
        rec, f = phase_pull(cfg, *case)
        fails += f
        if case[:2] == ("forward", t):
            b_rec = rec
    c_rec, f = phase_meanshift(cfg.num_samples, cfg.ms_max_seeds, cfg.ms_point_cap,
                               cfg.embed_dim, cfg.bandwidth, seed=2)
    fails += f
    e_rows, f = phase_parts(cfg, hier, gen_seed=8)
    fails += f
    log(f"kernel phases done: {time.perf_counter() - t0:.1f} s")
    reset_counts()  # kernel-phase launches do not count for the main paths

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    fails += main_path_f32(cfg32, arrays, seed=5)
    eval_launches, f = main_path_bf16(cfg, arrays, seed=5, repeats=3,
                                      hier_overflow=hier.overflow.tolist())
    fails += f
    fails += train_step_f32(cfg32, arrays, seed=5)[0]
    train_launches, train_res, f = train_steps_bf16(cfg, arrays, seed=5)
    fails += f
    valid_rows = int(db.grid.mask.sum())
    log("train step summary", json.dumps({
        phase: dict(ms_per_step=r["ms_per_step_median"],
                    rows_per_s=valid_rows / (r["ms_per_step_median"] * 1e-3),
                    valid_rows=valid_rows, hier_overflow=hier.overflow.tolist(),
                    cluster_overflow=r["last_metrics"].get("cluster_overflow"),
                    peak_mem_gib=r["peak_mem_gib"], launches_per_step=r["launches_per_step"])
        for phase, r in train_res.items()}))
    log(f"eval forward and train paths done: {time.perf_counter() - t0:.1f} s")

    reset_counts()
    probe_recs = probe_path(cfg, hier)
    probe_launches = read_counts()["E"]
    if probe_launches <= 0:
        fails.append("kernel E not launched on the probe's path")
    with tempfile.TemporaryDirectory() as tmp:
        fails += scene_f32(tmp, seed=5)
        log(f"scene f32 done: {time.perf_counter() - t0:.1f} s")
        scene_launches, _, f = scene_bf16(tmp, seed=5)
        fails += f
        tile_rows, f = eval_tile_shapes(tmp)
        fails += f
        log(f"scene bf16 done: {time.perf_counter() - t0:.1f} s")
        trainer_launches, _, f = trainer_path(tmp)
        fails += f
        log(f"trainer path done: {time.perf_counter() - t0:.1f} s")
        settings_launches, settings_res, f = settings_path(tmp, arrays, seed=5)
        fails += f
        log(f"settings path done: {time.perf_counter() - t0:.1f} s")
        point_launches, _, f = point_backbones_path(tmp, arrays, seed=5)
        fails += f
        log(f"point backbones path done: {time.perf_counter() - t0:.1f} s")
        scorer_launches, _, f = scorers_edges_path(tmp, arrays, seed=5)
        fails += f
        log(f"scorers and edges path done: {time.perf_counter() - t0:.1f} s")
        dp_launches, _, f = data_parallel_path(tmp, seed=5)
        fails += f
    log(f"data parallel path done: {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(OUT_DIR, "conv_shapes.json"), "w") as fh:
        json.dump({"train_step": conv_rows, "eval_tile": tile_rows}, fh, indent=0)

    def rep(role):  # the kernel line's shape: L0 same 16->16, bf16
        return next(r for r in conv_rows if r["role"] == role and r["dtype"] == "bfloat16"
                    and r["shape"] == "L0 same 16->16")

    a_rep, d_rep = rep("A"), rep("D")
    a_err = max(r["max_abs_err"] for r in conv_rows + tile_rows if r["role"] != "D")
    d_err = max(r["max_abs_err"] for r in conv_rows if r["role"] == "D")

    ks = kernels()
    entries = []
    for key, rec, err in (("A", a_rep, a_err), ("B", b_rec, b_rec["max_abs_err"]),
                          ("C", c_rec, c_rec["max_abs_err"]), ("D", d_rep, d_err)):
        k = ks[key]
        # counts of both main paths' counted runs; A's dX launches are its own
        # backward role of the same kernel
        by_path = {"eval_forward": eval_launches[key], "train_steps": train_launches[key],
                   "trainer": trainer_launches[key], "settings": settings_launches[key],
                   "point_backbones": point_launches[key], "scorers_edges": scorer_launches[key],
                   "data_parallel": dp_launches[key]}
        if key == "A":
            by_path["train_steps_dx"] = train_launches["A_dx"]
            by_path["trainer_dx"] = trainer_launches["A_dx"]
            by_path["settings_dx"] = settings_launches["A_dx"]
            by_path["point_backbones_dx"] = point_launches["A_dx"]
            by_path["scorers_edges_dx"] = scorer_launches["A_dx"]
            by_path["data_parallel_dx"] = dp_launches["A_dx"]
        if key in scene_launches:
            by_path["scene_eval"] = scene_launches[key]
        entries.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
            ms=rec["ms"], device_ms=rec["device_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        ))
        # B: the work its tables leave (T = 49,152, the forward's own rows)
        # beside the all-pairs bound; C: the iterations its bound counts
        extra = {"B": ("t", "pairs_evaluated", "pairs_share", "all_pairs_bound_ms",
                       "tables_ms", "tables_device_ms"),
                 "C": ("iterations_max", "iterations_mean")}.get(key, ())
        entries[-1].update({f: rec[f] for f in extra})
        if key == "C":  # C at Setting I's own operands: the embedding's columns
            entries[-1]["setting_I"] = {f: settings_res["C_setting_I"][f] for f in (
                "b", "s", "np", "e", "counts_equal", "iterations_equal", "max_abs_err",
                "iterations_max", "ms", "device_ms", "plain_ms", "bound_ms")}
    # B's table kernels, at the forward's own rows (T = 49,152)
    for key, part in (("B_keys", "keys"), ("B_blocks", "blocks"), ("B_cands", "cands")):
        k, rec = ks[key], b_rec["tables"][part]
        by_path = {"eval_forward": eval_launches[key], "train_steps": train_launches[key],
                   "scene_eval": scene_launches[key], "trainer": trainer_launches[key],
                   "settings": settings_launches[key], "point_backbones": point_launches[key],
                   "scorers_edges": scorer_launches[key], "data_parallel": dp_launches[key]}
        entries.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=0.0 if b_rec["tables"]["ok"] else None, ms=rec["ms"],
            device_ms=rec["device_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None))
    # E: the probe's full part at its own shape (L0 same 16->16, bf16); every
    # part's time rides along
    e_rep = next(r for r in probe_recs if r["part"] == "full" and r["dtype"] == "bfloat16")
    e_plain = next(r["plain_ms"] for r in e_rows if "plain_ms" in r)
    k = ks["E"]
    entries.append(dict(
        name=k.name, route="cuda", source=k.source, replaces=k.replaces,
        launches=probe_launches,
        launches_by_path={"probe": probe_launches, "scorers_edges": scorer_launches["E"]},
        max_abs_err=max(r["max_abs_err"] for r in e_rows), ms=e_rep["ms"],
        device_ms=e_rep["device_ms"], plain_ms=e_plain, bound_ms=e_rep["bound_ms"],
        bound_by=e_rep["bound_by"], library_ms=None,
        parts=[{key: r[key] for key in ("shape", "dtype", "part", "ms", "device_ms",
                                        "ns_per_tile_offset", "bound_ms")} for r in probe_recs],
    ))
    if fails:
        for msg in fails:
            print("FAIL:", msg, file=sys.stderr)
        return 1
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if _log_file is not None:
            _log_file.close()
    sys.exit(rc)
