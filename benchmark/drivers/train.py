"""Closed-loop train steps of the port.

Set-up draws the tile pool from the seed and the initial weights from the
traffic's weight seed, builds one train step (model, Adam, lr schedule) with the port's
``make_train_step``, and drives it through its first steps, the batches
that the reference follows after the window, then warm-up steps. The
window then runs steps back to back: each takes the next tiles of a seeded
order over the pool (a new permutation each pass), collates them with the
port's ``collate_tiles`` and ``batch_arrays``, takes one step and reads its
metrics as floats.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from .. import counts, inputs
from ..capture import ForwardCapture
from ..reference import compare, stages, train_ref
from ..weights import draw_state, state_shapes
from .common import Layers, Outcome, forward_count


def _program():
    from panopticsegforlargescalepointcloud_tpu_torch.config import (
        panoptic_config_from_yaml, training_config_from_yaml)
    from panopticsegforlargescalepointcloud_tpu_torch.data import batch_arrays, collate_tiles
    from panopticsegforlargescalepointcloud_tpu_torch.models import PointGroup3HeadsNet
    from panopticsegforlargescalepointcloud_tpu_torch.train import make_train_step
    from panopticsegforlargescalepointcloud_tpu_torch.train.optim import (
        make_lr_schedule, make_optimizer)
    return dict(panoptic_config_from_yaml=panoptic_config_from_yaml,
                training_config_from_yaml=training_config_from_yaml,
                batch_arrays=batch_arrays, collate_tiles=collate_tiles,
                PointGroup3HeadsNet=PointGroup3HeadsNet, make_train_step=make_train_step,
                make_lr_schedule=make_lr_schedule, make_optimizer=make_optimizer)


def tile_order(seed: int, pool: int, per_batch: int):
    """Endless batches of tile indices: each pass over the pool is a new
    seeded permutation, cut into batches."""
    rng = np.random.default_rng([int(seed), 1])
    while True:
        perm = rng.permutation(pool)
        for i in range(0, pool - per_batch + 1, per_batch):
            yield [int(t) for t in perm[i:i + per_batch]]


def model_config(p, run_config: dict, num_samples: int, compute_dtype: str):
    return p["panoptic_config_from_yaml"](
        run_config, backbone=str(run_config.get("backbone", "paper")),
        num_samples=num_samples, compute_dtype=compute_dtype,
        **run_config.get("budget_overrides", {}))[0]


class TrainCell:
    def __init__(self, config: dict, traffic: dict, seed: int, timer=None, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.timer, self.device = timer, device
        self.p = _program()

    # ------------------------------------------------------------------ set-up
    def setup(self) -> None:
        p, tr, run_config = self.p, self.traffic, self.config["run_config"]
        self.batch_tiles = int(tr["batch_tiles"])
        self.capacity = int(run_config["data"]["voxel_capacity"])
        self.pool = inputs.tile_pool([self.seed, 0], int(tr["pool_tiles"]), **tr["tile"])
        self.order = tile_order(self.seed, len(self.pool), self.batch_tiles)
        cfg = model_config(p, run_config, self.batch_tiles, self.config["compute_dtype"])
        tc = p["training_config_from_yaml"](run_config)
        model = p["PointGroup3HeadsNet"](cfg)
        # the model's weights are the traffic's, the same for every seed: a
        # draw per seed changes how much clustering and ScoreNet work a step has
        self.init = {k: v.cpu() for k, v in draw_state(
            state_shapes(model), tr["weights_seed"], tr["weights"], self.device).items()}
        model.load_state_dict(self.init, strict=True)
        model.to(self.device)
        self.optimizer = p["make_optimizer"](tc.optimizer, model.parameters(), tc.weight_decay)
        schedule = p["make_lr_schedule"](tc.scheduler, tc.scheduler_params, tc.lr,
                                          tc.steps_per_epoch)
        self.model, self.bn_momentum = model, tc.bn_momentum
        self.step = p["make_train_step"](cfg, model, self.optimizer, schedule,
                                         bool(tr["with_clustering"]), tc.grad_clip_value,
                                         device=self.device, timer=self.timer)
        names = {q: n for n, q in model.named_parameters()}
        # the steps the reference follows, through the window's own call and feed
        self.check_batches: List[List[int]] = []
        self.terms: List[Dict[str, float]] = []
        with ForwardCapture() as capture:
            for i in range(int(tr["check_steps"])):
                tiles = next(self.order)
                self.check_batches.append(tiles)
                self.terms.append(self.take(tiles))
                if i == 0:
                    self.first_grad = train_ref.adam_first_grad(self.optimizer, names)
        self.calls = capture.calls
        self.after = {n: q.detach().clone() for n, q in model.named_parameters()}
        for _ in range(int(tr["warmup_steps"])):
            self.take(next(self.order))
        self._sync()

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def _span(self, name):
        return self.timer(name) if self.timer is not None else contextlib.nullcontext()

    def take(self, tiles: List[int]) -> Dict[str, float]:
        p = self.p
        with self._span("collate"):
            arrays = p["batch_arrays"](p["collate_tiles"](
                [self.pool[t] for t in tiles], capacity=self.capacity,
                num_tiles=self.batch_tiles))
        metrics = self.step(arrays, self.bn_momentum)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------ window
    def window(self, seconds: float, profile: bool = False) -> Outcome:
        """Steps until ``seconds`` have passed; the step in flight finishes.
        With ``profile``, the third to fifth steps are traced, with the
        spans' synchronizations off, then their batches are taken again
        with no span and no profiler (the plain step time); both are left
        out of the layers' totals."""
        from ..trace import profiled

        out = Outcome()
        layers = Layers()
        steps, failed, batches = 0, 0, []
        prof_batches, trace_box, profiled_s, plain_s = [], None, 0.0, 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if profile and steps == 2:
                self.timer.recording = False
                prof_batches = [next(self.order) for _ in range(3)]
                tp = time.perf_counter()
                with profiled(self._sync, self.device != "cpu") as trace_box:
                    for tiles in prof_batches:
                        failed += int(not np.isfinite(self.take(tiles)["loss"]))
                tq = time.perf_counter()
                for tiles in prof_batches:
                    failed += int(not np.isfinite(self.take(tiles)["loss"]))
                self._sync()
                tr = time.perf_counter()
                steps += 2 * len(prof_batches)
                profiled_s, plain_s = tr - tp, tr - tq
                self.timer.recording = True
                continue
            tiles = next(self.order)
            failed += int(not np.isfinite(self.take(tiles)["loss"]))
            batches.append(tiles)
            steps += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        out.attempted, out.failed = steps, failed
        out.metrics["train_step_ms"] = 1e3 * elapsed / steps
        out.lines.append(f"train window: {steps} steps in {elapsed} s")
        if self.timer is not None:
            layers.units = len(batches)
            layers.phases = self.timer.totals()
            layers.window_s = elapsed - profiled_s
            layers.model_ops = 3.0 * sum(self.batch_ops(b) for b in batches)
            if trace_box is not None:
                layers.trace = trace_box["trace"]
                layers.trace_units = len(prof_batches)
                layers.plain_unit_s = plain_s / len(prof_batches)
                layers.conv_bound_s = sum(self.batch_count(b).conv_bound_s
                                          for b in prof_batches)
                out.lines.append(
                    f"profiled steps: {len(prof_batches)} in {layers.trace.window_s} s, device "
                    f"busy {layers.trace.busy_s} s; the same steps plain: {plain_s} s")
        out.layers = layers
        return out

    def _count(self, batch: np.ndarray, coords: np.ndarray) -> counts.ForwardCount:
        return forward_count(self.config, batch, coords)

    def batch_count(self, tiles: List[int]) -> counts.ForwardCount:
        """The frozen count of one batch's forward, from the tiles'
        coordinates as the collate keeps them (the rows past the capacity
        cut)."""
        bs, cs, left = [], [], self.capacity
        for i, t in enumerate(tiles):
            c = self.pool[t]["coords"][:max(left, 0)]
            left -= len(c)
            bs.append(np.full(len(c), i))
            cs.append(c)
        return self._count(np.concatenate(bs), np.concatenate(cs))

    def batch_ops(self, tiles: List[int]) -> float:
        """The model operations of one batch's forward: the samples' counts
        add up, so each (tile, rows kept) is counted once and cached."""
        cache = self.__dict__.setdefault("_ops", {})
        total, left = 0.0, self.capacity
        for t in tiles:
            kept = max(min(len(self.pool[t]["coords"]), left), 0)
            left -= kept
            if (t, kept) not in cache:
                c = self.pool[t]["coords"][:kept]
                cache[(t, kept)] = self._count(np.zeros(len(c), np.int64), c).model_ops
            total += cache[(t, kept)]
        return total

    # ------------------------------------------------------------------- check
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.step = self.model = self.optimizer = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        return check_steps(self.config, self.traffic, self, self.device)


def reference_steps(config: dict, traffic: dict, cell, device: str,
                    compute_dtype: str = "float32") -> train_ref.Steps:
    """The reference's steps over the cell's first batches, from its
    initial weights, taking the program's proposals."""
    with_clustering = bool(traffic["with_clustering"])
    return train_ref.run_steps(
        config["run_config"], cell.init, [[cell.pool[t] for t in b] for b in cell.check_batches],
        cell.capacity, with_clustering, compute_dtype, device,
        [c["proposals"] for c in cell.calls] if with_clustering else None)


def check_steps(config: dict, traffic: dict, cell, device: str) -> Dict[str, float]:
    ref = reference_steps(config, traffic, cell, device)
    out = numbers(cell.terms, cell.first_grad, cell.after, cell.init, cell.calls, ref)
    if traffic["with_clustering"]:
        cfg = train_ref.model_config(config["run_config"], num_samples=cell.batch_tiles,
                                     compute_dtype="float32")
        out["clustering_mismatch"] = max(stages.clustering_mismatch(cfg, c, device)
                                         for c in cell.calls)
    return out


def numbers(terms, first_grad, after, init, calls, ref: train_ref.Steps) -> Dict[str, float]:
    """The numbers of the program's first steps (``terms``: each step's
    loss terms; ``calls``: each step's forward) against the reference's:
    step 1's heads and scores; the losses' worst gap over the steps and
    step 1's; the worst and the median leaf's gap of the first gradient;
    the worst and the median moved leaf's gap of the change over the
    steps. The cell's limits file says which are compared."""
    moved = compare.moved_leaves(ref.first_grad)
    dev = next(iter(ref.params.values())).device
    delta_p = {k: after[k].to(dev) - init[k].to(dev) for k in ref.params}
    delta_r = {k: ref.params[k] - init[k].to(dev) for k in ref.params}
    grads = compare.leaf_gaps({k: v.to(dev) for k, v in first_grad.items()}, ref.first_grad)
    upd = compare.leaf_gaps(delta_p, delta_r, keep=moved)
    losses = [t["loss"] for t in terms]
    out = {"heads_gap": stages.heads_gap(calls[0], ref.calls[0]),
           "loss_gap": compare.loss_gap(losses, ref.losses),
           "grad_gap": max(grads.values()), "update_gap": max(upd.values())}
    score = stages.score_gap(calls[0], ref.calls[0])
    if score is not None:
        out["score_gap"] = score
    out.update({"loss1_gap": compare.loss_gap(losses[:1], ref.losses[:1]),
                "grad_gap_median": float(np.median(list(grads.values()))),
                "update_gap_median": float(np.median(list(upd.values()))),
                "worst_grad_leaf": max(grads, key=grads.get),
                "worst_update_leaf": max(upd, key=upd.get)})
    return out


def run(config: dict, traffic: dict, seed: int, seconds: float, timer=None,
        profile: bool = False, device: str = "cuda") -> Outcome:
    cell = TrainCell(config, traffic, seed, timer, device)
    cell.setup()
    setup_end = time.perf_counter()
    if timer is not None:
        timer.spans.clear()
    out = cell.window(seconds, profile)
    out.setup_end = setup_end
    out.memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    cell.release()
    t_check = time.perf_counter()
    out.numbers = cell.check()
    out.lines.append(f"reference check took {time.perf_counter() - t_check} s")
    return out
