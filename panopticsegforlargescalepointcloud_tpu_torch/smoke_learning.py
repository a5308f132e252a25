"""Learning evidence: train the tiny model on a synthetic forest and show
that its full-scene panoptic metrics beat the untrained model's
(counterpart of the JAX package's ``scripts/smoke_learning.py``).

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.smoke_learning \\
        [--epochs 48] [--steps 10] [--out smoke_learning_report_torch.json] [--device cpu]

Three 16 m forest plots (6 trees, 3,000 ground points each) from numpy seed
11; the tiny plan (in_feat 8, 2 tiles of 8,192 rows a batch, 6 m
cylinders), Adam at lr 0.001, ``epochs`` x ``steps`` train steps with the
full phase after epoch 8; the full-scene evaluator on the same plots
before and after training. Region growing takes half the rows as its
budget (``rg_point_cap`` 0.5): the port has the dense path only. Writes
``{"untrained": {...}, "trained": {...}, ...}`` with the per-epoch losses,
the step times and the device, and exits non-zero unless the trained mIoU
beats the untrained one and the trained F1 reaches ``--min-f1``. Runs on
``cuda`` unless ``--device cpu``; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import subprocess
import tempfile
import time

import numpy as np
import torch

from .data import TREEINS_SPEC, PanopticFileDataset, batch_arrays, collate_tiles
from .data.ply import write_ply
from .device import resolve_device
from .models import PanopticConfig, PointGroup3HeadsNet
from .train.evaluator import FullSceneEvaluator
from .train.optim import make_optimizer
from .train.step import init_params, make_train_step

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CAPACITY = 8192
KEYS = ["mIoU", "F1", "meanPQ", "mPrec", "mRec", "mMUCov"]


def make_forest_ply(path, rng, n_trees=6, extent=16.0):
    pts, sem, tid = [], [], []
    for t in range(n_trees):
        c = rng.uniform(2, extent - 2, 2)
        k = 300
        xy = c + rng.normal(scale=0.6, size=(k, 2))
        z = rng.uniform(0, 8, (k, 1))
        pts.append(np.concatenate([xy, z], 1))
        sem.append(np.full(k, 2))
        tid.append(np.full(k, t))
    k = 3000
    ground = np.stack([rng.uniform(0, extent, k), rng.uniform(0, extent, k),
                       rng.normal(scale=0.05, size=k)], 1)
    pts.append(ground)
    sem.append(np.full(k, 1))
    tid.append(np.full(k, -1))
    write_ply(path, [np.concatenate(pts).astype(np.float32),
                     np.concatenate(sem).astype(np.int32),
                     np.concatenate(tid).astype(np.int32)],
              ["x", "y", "z", "semantic_seg", "treeID"])


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "unknown"


def run(epochs: int = 48, steps: int = 10, device=None, seed: int = 0) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(11)
    tmp = tempfile.mkdtemp()
    files = []
    for i in range(3):
        p = osp.join(tmp, f"forest{i}.ply")
        make_forest_ply(p, rng)
        files.append(p)
    ds = PanopticFileDataset(TREEINS_SPEC, files, grid_size=0.2, radius=6.0, keep_raw=True,
                             rng=rng)
    cfg = PanopticConfig(
        num_classes=2, stuff_classes=(0,), backbone="tiny", feat_dim=4, in_feat=8,
        num_samples=2, max_instances=16, max_props_rg=32, ms_max_seeds=64,
        ms_max_clusters=16, ms_point_cap=4096, cluster_radius=0.3, min_cluster_points=20,
        prepare_epoch=8, rg_point_cap=0.5,
    )
    model = init_params(PointGroup3HeadsNet(cfg), torch.Generator().manual_seed(seed)).to(dev)
    opt = make_optimizer("Adam", model.parameters())

    def batch():
        tiles = [ds.sample_train_tile(rng) for _ in range(cfg.num_samples)]
        return batch_arrays(collate_tiles(tiles, capacity=CAPACITY, num_tiles=cfg.num_samples))

    ecfg = dataclasses.replace(cfg, num_samples=1)

    def full_eval(tag):
        t0 = time.perf_counter()
        ev = FullSceneEvaluator(ecfg, model, ds, capacity=CAPACITY, device=dev)
        reports = ev.run(out_dir=osp.join(tmp, f"eval_{tag}"), ply_output=False)
        out = {k: float(np.mean([r[k] for r in reports])) for k in KEYS}
        out["seconds"] = time.perf_counter() - t0
        return out

    untrained = full_eval("untrained")
    print("untrained:", untrained, flush=True)
    lr = lambda count: 1e-3  # noqa: E731 - constant, as optax.adam(1e-3)
    prep = make_train_step(cfg, model, opt, lr, with_clustering=False, device=dev)
    full = make_train_step(cfg, model, opt, lr, with_clustering=True, device=dev)
    losses, step_s, data_s = [], {"prepare": [], "full": []}, 0.0
    for epoch in range(1, epochs + 1):
        phase = "full" if epoch > cfg.prepare_epoch else "prepare"
        step = full if phase == "full" else prep
        ep = []
        for _ in range(steps):
            t0 = time.perf_counter()
            arrays = batch()
            t1 = time.perf_counter()
            ep.append(float(step(arrays)["loss"]))  # the float waits for the device
            data_s += t1 - t0
            step_s[phase].append(time.perf_counter() - t1)
        losses.append(float(np.mean(ep)))
        print(f"epoch {epoch}: loss={losses[-1]:.4f}", flush=True)
    trained = full_eval("trained")
    print("trained:", trained, flush=True)
    n = epochs * steps
    return {
        "untrained": untrained, "trained": trained, "epochs": epochs, "steps_per_epoch": steps,
        "epoch_losses": losses,
        "s_per_step_median": {k: float(np.median(v)) for k, v in step_s.items() if v},
        "data_s_per_step": data_s / max(n, 1),
        "device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
        "card": card() if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=48)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--min-f1", type=float, default=0.3)
    ap.add_argument("--out", default=osp.join(ROOT, "smoke_learning_report_torch.json"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    report = run(args.epochs, args.steps, args.device)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    un, tr = report["untrained"], report["trained"]
    if not tr["mIoU"] > un["mIoU"]:
        print(f"FAIL: trained mIoU {tr['mIoU']:.3f} <= untrained {un['mIoU']:.3f}")
        return 1
    # detection, not only semantics: clustering -> ScoreNet -> NMS must find
    # instances at IoU 0.5
    if tr["F1"] < args.min_f1 or not (tr["mPrec"] > 0 and tr["mRec"] > 0):
        print(f"FAIL: trained F1 {tr['F1']:.3f} < {args.min_f1} or no precision/recall")
        return 1
    print("OK: learning confirmed (semantics + instance detection)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
