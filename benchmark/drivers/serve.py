"""Closed-loop full scenes through the port's eval CLI path.

Set-up writes the forests drawn from the seed as PLY files, draws the
served weights from the traffic's weight seed and writes them as a port checkpoint (``ModelCheckpoint``)
whose run config is the configuration, then serves one warm scene. The
window serves the forests in turn, one at a time: each scene is the eval
CLI's ``build_evaluator`` on that forest's file (checkpoint load, PLY read
and grid sampling) and ``FullSceneEvaluator.run`` into that forest's
output directory, which its later scenes overwrite. The scene in flight at
the deadline finishes and counts.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import inputs
from ..capture import ForwardCapture
from ..reference import serve_ref
from ..reference.plain.data.ply import read_ply
from ..weights import draw_state, state_shapes
from .common import Layers, Outcome, forward_count

PLY_SEMANTIC = "Semantic_results_forEval_0.ply"
PLY_INSTANCE = "Instance_Results_forEval0.ply"


def _program():
    from panopticsegforlargescalepointcloud_tpu_torch.cli.eval import build_evaluator, model_config
    from panopticsegforlargescalepointcloud_tpu_torch.models import PointGroup3HeadsNet
    from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint
    return dict(build_evaluator=build_evaluator, model_config=model_config,
                PointGroup3HeadsNet=PointGroup3HeadsNet, ModelCheckpoint=ModelCheckpoint)


class ServeCell:
    def __init__(self, config: dict, traffic: dict, seed: int, timer=None, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.timer, self.device = timer, device
        self.p = _program()
        self.answers: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.capture = None
        self.tmp = None

    def _span(self, name):
        return self.timer(name) if self.timer is not None else contextlib.nullcontext()

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------ set-up
    def setup(self) -> None:
        p, tr, run_config = self.p, self.traffic, self.config["run_config"]
        self.tmp = tempfile.mkdtemp(prefix="bench-serve-")
        self.forests, self.points = [], []
        for i in range(int(tr["forests"])):
            path = os.path.join(self.tmp, f"forest_{i}.ply")
            self.points.append(inputs.write_forest(path, [self.seed, i], **tr["scene"]))
            self.forests.append(path)
        template = p["PointGroup3HeadsNet"](p["model_config"](run_config)[0])
        # the served weights are the traffic's, the same for every seed: a draw
        # per seed changes how many proposals and instances a scene has
        self.weights = {k: v.cpu() for k, v in draw_state(
            state_shapes(template), tr["weights_seed"], tr["weights"], self.device).items()}
        self.ckpt = os.path.join(self.tmp, "ckpt")
        p["ModelCheckpoint"](self.ckpt, run_config=run_config).save_best_models_under_current_metrics(
            {"state_dict": self.weights}, None, {"train": {"loss": 1.0}})
        # the forest whose last served scene is compared, drawn from the seed
        self.sampled = int(np.random.default_rng([self.seed, 2]).integers(len(self.forests)))
        for i in range(int(tr["warm_scenes"])):
            self.serve((self.sampled + i) % len(self.forests))
        self._sync()

    def out_dir(self, f: int) -> str:
        return os.path.join(self.tmp, f"out_{f}")

    @property
    def group(self) -> int:
        """Tiles a dispatch: the traffic's where it sets them, else the
        configuration's."""
        return int(self.traffic.get("tiles_per_dispatch", self.config["cli"]["tiles_per_dispatch"]))

    def overrides(self, f: int) -> List[str]:
        cli = self.config["cli"]
        make_submission = bool(self.traffic["make_submission"])
        return [f"checkpoint_dir={self.ckpt}", f"data.files.test=[{self.forests[f]}]",
                f"out_dir={self.out_dir(f)}", f"tiles_per_dispatch={self.group}",
                f"voting_runs={cli['voting_runs']}", f"weight_name={cli['weight_name']}",
                f"tracker_options.make_submission={make_submission}",
                f"device={self.device}"]

    def serve(self, f: int) -> None:
        """One scene of forest ``f``, as the eval CLI serves it (less its
        manifest and printed reports); its labels are kept as the answer,
        and for the sampled forest its tiles and each dispatch's rows and
        outputs (:class:`..capture.ForwardCapture`: copies on the device,
        which the check reads once the window has closed)."""
        with self._span("load"):
            evaluator, run_kwargs, out_dir, _ = self.p["build_evaluator"](
                self.overrides(f), timer=self.timer)
        predict = evaluator.predict

        def keep(*args, **kwargs):
            sem, ins, acc = predict(*args, **kwargs)
            self.answers[f] = (sem, ins)
            return sem, ins, acc

        evaluator.predict = keep
        if f != self.sampled:
            evaluator.run(out_dir=out_dir, **run_kwargs)
            return
        tiles = []
        test_tiles = evaluator.dataset.test_tiles

        def keep_tiles(*args, **kwargs):
            tiles[:] = test_tiles(*args, **kwargs)
            return tiles

        evaluator.dataset.test_tiles = keep_tiles
        with ForwardCapture() as capture:
            evaluator.run(out_dir=out_dir, **run_kwargs)
        self.capture = (list(tiles), capture.calls)

    # ------------------------------------------------------------------ window
    def window(self, seconds: float, profile: bool = False) -> Outcome:
        """Scenes until ``seconds`` have passed; the scene in flight
        finishes. With ``profile``, the second scene is traced, with the
        spans' synchronizations off, and the third serves the same forest
        with no span and no profiler (the plain scene time); both are left
        out of the layers' totals."""
        from ..trace import profiled

        out = Outcome()
        layers = Layers()
        served, scene_s, points = [], [], 0
        trace_box, prof_forest, profiled_s, plain_s = None, None, 0.0, 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(served)
            # traced, the forests go 0, 1, 1, 2, 0, ...: the profiled scene's
            # forest is served again plain
            f = (i - (1 if profile and i >= 2 else 0)) % len(self.forests)
            ts = time.perf_counter()
            if profile and i in (1, 2):
                self.timer.recording = False
                if i == 1:
                    with profiled(self._sync, self.device != "cpu") as trace_box:
                        self.serve(f)
                    prof_forest = f
                else:
                    self.serve(f)
                self.timer.recording = True
            else:
                self.serve(f)
            self._sync()
            dt = time.perf_counter() - ts
            if profile and i == 1:
                profiled_s = dt
            elif profile and i == 2:
                plain_s = dt
            served.append(f)
            scene_s.append(dt)
            points += self.points[f]
        elapsed = time.perf_counter() - t0
        out.attempted = len(served)
        out.metrics["serve_points_per_s"] = points / elapsed
        self.served = served
        out.lines.append(f"serve window: {len(served)} scenes, {points} points in {elapsed} s; "
                         f"scene seconds {scene_s}")
        if self.timer is not None:
            skipped = {1, 2} if profile else set()
            real = [f for i, f in enumerate(served) if i not in skipped]
            layers.units = len(real)
            layers.phases = self.timer.totals()
            layers.window_s = elapsed - profiled_s - plain_s
            ops = {f: self.forest_count(f) for f in set(served)}
            layers.model_ops = sum(ops[f][0] for f in real)
            if trace_box is not None:
                layers.trace = trace_box["trace"]
                layers.trace_units = 1
                layers.plain_unit_s = plain_s
                layers.conv_bound_s = ops[prof_forest][1]
                out.lines.append(f"profiled scene: {layers.trace.window_s} s, device busy "
                                 f"{layers.trace.busy_s} s; the same forest plain: {plain_s} s")
        out.layers = layers
        return out

    def forest_count(self, f: int) -> Tuple[float, float]:
        """(model operations, conv bound seconds) of one scene of forest
        ``f``: the frozen count over its tiles as the reference's copy of
        the dataset cuts them, each dispatch of g tiles counted over its
        real tiles."""
        tiles = serve_ref.scene_dataset(self.config["run_config"], self.forests[f]).test_tiles(0)
        g = self.group
        ops = bound = 0.0
        for start in range(0, len(tiles), g):
            group = [t for t, _ in tiles[start:start + g]]
            batch = np.concatenate([np.full(len(t["coords"]), i) for i, t in enumerate(group)])
            coords = np.concatenate([t["coords"] for t in group])
            c = forward_count(self.config, batch, coords)
            ops += c.model_ops
            bound += c.conv_bound_s
        return ops, bound

    # ------------------------------------------------------------------- check
    def release(self) -> None:
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def program_answer(self, f: int) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """The labels the user got for forest ``f``: the PLYs' where the
        scene writes them, else the evaluator's; and, with PLYs, the
        largest gap between their positions and the forest's raw points."""
        if not self.traffic["make_submission"]:
            sem, ins = self.answers[f]
            return np.asarray(sem), np.asarray(ins), {}
        sp = read_ply(os.path.join(self.out_dir(f), PLY_SEMANTIC))
        ip = read_ply(os.path.join(self.out_dir(f), PLY_INSTANCE))
        raw = read_ply(self.forests[f])
        want = np.stack([raw["x"], raw["y"], raw["z"]], 1).astype(np.float32)
        gap = 0.0
        for ply in (sp, ip):
            got = np.stack([ply["x"], ply["y"], ply["z"]], 1).astype(np.float32)
            gap = max(gap, float(np.abs(got - want).max()) if got.shape == want.shape
                      else float("inf"))
        return sp["preds"], ip["preds"], {"ply_position_gap": gap}

    def check(self) -> Dict[str, float]:
        """The sampled forest's last served scene, judged stage by stage
        (:func:`..reference.serve_ref.judge_scene`), its labels as the user
        got them."""
        f = self.sampled
        sem_p, ins_p, extra = self.program_answer(f)
        tiles, calls = self.capture
        out = serve_ref.judge_scene(
            self.config["run_config"], self.weights, self.forests[f], self.group, tiles, calls,
            (sem_p, ins_p), self.device)
        out.update(extra)
        return out

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None


def run(config: dict, traffic: dict, seed: int, seconds: float, timer=None,
        profile: bool = False, device: str = "cuda") -> Outcome:
    cell = ServeCell(config, traffic, seed, timer, device)
    try:
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
    finally:
        cell.close()
