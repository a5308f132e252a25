"""Full-scene evaluator: the engine of the eval CLI.

Counterpart of the JAX package's ``train/evaluator.py``. Per test file:
deterministic cylinder tiling -> the eval forward per dispatch of g tiles
-> one pull of the dispatch's outputs to the host -> per tile, in tile
order, semantic vote accumulation and NMS'd clusters -> block merging into
the raw cloud -> finalise (full-res projection, stuff masking, distance
cutoff, min-size filter) -> PLY exports + the ``final_eval`` PQ report.

On a data-parallel mesh (``mesh=``, one tile per rank and dispatch) every
rank tiles the file and forwards its tile of each group of D; the outputs
reach rank 0 on the host, which merges them in tile order, so that the
scene equals the sequential one, and writes the reports and PLYs.

Host work runs after each dispatch's forward, not under it: the port's
forward synchronizes inside region growing and mean shift, so the JAX
package's one-deep pipeline would not hide it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import os.path as osp
from typing import Callable, Dict, List, Optional

import numpy as np

from ..data import PanopticFileDataset, batch_arrays, collate_tiles
from ..data.ply import to_eval_ply, to_ins_ply
from ..device import resolve_device
from ..eval.extract import COUNTERS, dispatch_outputs, host_part, pull
from ..eval.merge import SceneAccumulator
from ..eval.panoptic_quality import final_eval
from ..models.pointgroup3heads import PanopticConfig, PointGroup3HeadsNet
from .step import make_eval_forward

log = logging.getLogger(__name__)


def eval_tile_capacity(data_cfg) -> int:
    """Per-tile row budget for eval: the data yaml's ``eval_voxel_capacity``,
    clamped to the training ``voxel_capacity`` (warns when the clamp
    binds)."""
    vcap = int(data_cfg.get("voxel_capacity", 65536))
    want = int(data_cfg.get("eval_voxel_capacity") or vcap)
    if want > vcap:
        log.warning(
            "eval_voxel_capacity=%d clamped to training voxel_capacity=%d: "
            "tiles larger than %d rows will be truncated (overflow counters "
            "report it); retrain or raise voxel_capacity to honor the "
            "configured eval tile size",
            want, vcap, vcap,
        )
    return min(want, vcap)


def grouped_config(pcfg: PanopticConfig, capacity: int, g: int) -> PanopticConfig:
    """The forward's configuration for g tiles per dispatch: the whole-batch
    region-growing budgets scale with g (the per-tile row cap is resolved
    first, then multiplied, so that g tiles get exactly g per-tile caps);
    per-sample budgets scale through ``num_samples``."""
    if g == 1:
        return pcfg
    return dataclasses.replace(
        pcfg,
        num_samples=g,
        max_props_rg=pcfg.max_props_rg * g,
        rg_point_cap=(pcfg.resolved_point_cap(capacity) * g if pcfg.rg_point_cap else 0),
    )


class FullSceneEvaluator:
    def __init__(
        self,
        pcfg: PanopticConfig,
        model: PointGroup3HeadsNet,
        dataset: PanopticFileDataset,
        capacity: int = 65536,
        tiles_per_dispatch: int = 1,
        device=None,
        timer: Optional[Callable] = None,
        mesh=None,
    ):
        """``model`` carries its weights. ``tiles_per_dispatch`` = g: g
        tiles ride one forward as a g-sample batch; per-tile results equal
        g = 1 while the clustering budgets do not bind (clustering is
        per-sample, the shared region-growing budget scales with g, and
        proposals are split by ``prop_batch`` before NMS and merging).
        Runs on ``cuda`` unless ``device="cpu"``. ``timer(name)``, when
        given, wraps each phase: tiling, collate, the forward's own phases
        (hierarchy, backbone_heads, region_growing, mean_shift, scorenet),
        extract (device IoU, the pull, NMS), merge, finalise, report.

        ``mesh`` (:class:`..parallel.Mesh`): one tile per rank through
        :func:`..parallel.make_parallel_eval_forward`, on the mesh's device
        (``device`` is not used); needs ``tiles_per_dispatch`` 1. Every
        rank calls :meth:`run`; rank 0 returns the reports and writes the
        files, the other ranks return None."""
        if pcfg.num_samples != 1:
            raise ValueError("full-scene eval takes a num_samples=1 config; "
                             "tiles_per_dispatch sets the batch")
        if not dataset.keep_raw:
            raise ValueError("full-scene eval labels the raw clouds: build the dataset "
                             "with keep_raw=True")
        self.pcfg = pcfg
        self.dataset = dataset
        self.capacity = capacity
        self.group = max(int(tiles_per_dispatch), 1)
        self.mesh = mesh
        self.timer = timer
        self.fcfg = grouped_config(pcfg, capacity, self.group)
        if mesh is not None:
            from ..parallel import make_parallel_eval_forward, replicate

            if self.group != 1:
                raise ValueError("a mesh serves one tile per rank: tiles_per_dispatch must be 1")
            self.device = mesh.device
            self._pfwd = make_parallel_eval_forward(pcfg, replicate(mesh, model), mesh,
                                                    timer=timer)
        else:
            self.device = resolve_device(device)
            self._fwd = make_eval_forward(self.fcfg, model, device=self.device, timer=timer)
        self.last_overflow = dict.fromkeys(COUNTERS, 0)

    def _phase(self, name):
        return self.timer(name) if self.timer is not None else contextlib.nullcontext()

    def run(
        self,
        out_dir: str = ".",
        ply_output: bool = True,
        th_merge: Optional[float] = None,
        voting_runs: int = 1,
    ) -> List[Dict[str, float]]:
        """Predict every test file and write its report (and, with
        ``ply_output``, its PLYs) into ``out_dir``; returns the reports."""
        root = self.mesh is None or self.mesh.is_root
        if root:
            os.makedirs(out_dir, exist_ok=True)
        self.last_overflow = dict.fromkeys(COUNTERS, 0)
        reports = []
        for fi in range(len(self.dataset.files)):
            sem, ins, acc = self.predict(fi, th_merge, voting_runs)
            if not root:
                continue
            with self._phase("report"):
                reports.append(self._report(fi, self.dataset.raw_clouds[fi], sem, ins, acc,
                                            out_dir, ply_output))
        return reports if root else None

    def predict(self, fi: int, th_merge: Optional[float] = None, voting_runs: int = 1):
        """(semantic, instance, accumulator) of test file ``fi``: per-point
        labels of its raw cloud after block merging (threshold ``th_merge``,
        0.1 by default) and finalise. On a mesh every rank calls it; the
        ranks but rank 0 get (None, None, None)."""
        th = 0.1 if th_merge is None else th_merge
        raw = self.dataset.raw_clouds[fi]
        acc = SceneAccumulator(raw["pos"], self.pcfg.num_classes)
        runs = max(int(voting_runs), 1)
        for vote in range(runs):
            # each voting run re-tiles with a shifted grid origin
            with self._phase("tiling"):
                tiles = self.dataset.test_tiles(fi, grid_shift=vote / runs)
            if vote == 0:
                log.info("file %d: %d tiles x %d votes", fi, len(tiles), runs)
            if self.mesh is not None:
                self._predict_mesh(acc, tiles, th, seed_base=vote * len(tiles))
                continue
            g = self.group
            for start in range(0, len(tiles), g):
                group = tiles[start:start + g]
                # the last group pads by repeating its final tile; padded
                # samples are computed but never accumulated
                padded = group + [group[-1]] * (g - len(group))
                with self._phase("collate"):
                    vb = collate_tiles([t for t, _ in padded],
                                       capacity=self.capacity * g, num_tiles=g)
                # the embed family's subsets: one counter per (vote, tile),
                # so each tile of a group draws what it draws at g = 1
                # (padded repeat samples draw past-the-end counters)
                db, out = self._fwd(batch_arrays(vb),
                                    subset_seed=vote * len(tiles) + start + np.arange(g))
                self._accumulate_dispatch(acc, db, out, [ids for _, ids in group], th)
        if self.mesh is not None and not self.mesh.is_root:
            return None, None, None
        with self._phase("finalise"):
            sem, ins = acc.finalise(
                stuff_classes=self.pcfg.stuff_classes,
                distance_cutoff=1.0,
                min_instance_size=10,
            )
        return sem, ins, acc

    def _report(self, fi, raw, sem, ins, acc, out_dir, ply_output):
        gt_sem = raw["y"]
        gt_ins = raw["instance_labels"]
        if ply_output:
            # reference-exporter-compatible files (ASCII, int16 preds/gt)
            # and the colored instance dump
            to_eval_ply(osp.join(out_dir, f"Semantic_results_forEval_{fi}.ply"),
                        raw["pos"], sem, gt_sem)
            to_eval_ply(osp.join(out_dir, f"Instance_Results_forEval{fi}.ply"),
                        raw["pos"], ins, gt_ins)
            to_ins_ply(osp.join(out_dir, f"Instance_results_withColor_{fi}.ply"),
                       raw["pos"], ins)
        report = final_eval(
            sem,
            ins,
            gt_sem,
            gt_ins,
            num_classes_raw=self.pcfg.num_classes,
            thing_classes_raw=self.dataset.spec.thing_classes,
            stuff_classes_raw=self.dataset.spec.stuff_classes,
            output_file=osp.join(out_dir, f"Evaluation_{fi}"),
        )
        report["vote_miou"] = acc.vote_miou(gt_sem, self.pcfg.num_classes)
        log.info("file %d: PQ=%.3f F1=%.3f mIoU=%.3f",
                 fi, report["meanPQ"], report["F1"], report["mIoU"])
        return report

    def _predict_mesh(self, acc, tiles, th, seed_base):
        """One tile per rank and dispatch, groups of D tiles in order; the
        last group pads with its last tile (computed, never accumulated).
        Each tile's subset counter is ``seed_base`` + its index, as in the
        sequential path. Rank 0 merges the gathered outputs in tile order."""
        d, rank = self.mesh.size, self.mesh.rank
        for start in range(0, len(tiles), d):
            group = tiles[start:start + d]
            padded = group + [group[-1]] * (d - len(group))
            with self._phase("collate"):
                vb = collate_tiles([padded[rank][0]], capacity=self.capacity, num_tiles=1)
            outs = self._pfwd(batch_arrays(vb), subset_seed=seed_base + start + rank)
            if outs is None:
                continue
            for host, (_, tile_full_ids) in zip(outs, group):
                self._merge_host(acc, host, [tile_full_ids], th)

    def _accumulate_dispatch(self, acc, db, out, ids_list, th):
        """Pull one dispatch's outputs to the host in one copy and
        accumulate its real tiles in order (``ids_list``: per-tile
        full-cloud index arrays; padded repeat samples are skipped)."""
        with self._phase("extract"):
            host = pull(dispatch_outputs(db, out))  # one device-to-host copy
        self._merge_host(acc, host, ids_list, th)

    def _merge_host(self, acc, host, ids_list, th):
        """NMS and block merging of one dispatch's pulled outputs
        (:func:`..eval.extract.dispatch_outputs`), tile by tile."""
        with self._phase("extract"):
            props = {k[2:]: v for k, v in host.items() if k.startswith("p_")}
            for k in self.last_overflow:
                self.last_overflow[k] += int(host.get(k, 0))
            # with g > 1 each tile takes only its own proposals, the padded
            # repeat samples' included: none of theirs reach a real tile
            tile_clusters = [
                host_part(props, ti if self.group > 1 else None,
                          nms_threshold=self.pcfg.nms_threshold,
                          min_cluster_points=self.pcfg.min_cluster_points,
                          min_score=self.pcfg.min_score)
                for ti in range(len(ids_list))
            ]
        with self._phase("merge"):
            for ti, (tile_full_ids, (clusters, kept)) in enumerate(
                    zip(ids_list, tile_clusters)):
                sel = host["mask"] & (host["batch"] == ti)
                self._accumulate(acc, sel, host["origin"], host["sem"], clusters, kept,
                                 props.get("scores"), tile_full_ids, th)

    def _accumulate(self, acc, mask, origin, sem, clusters_rows, kept, scores_np,
                    tile_full_ids, th):
        row_to_sub = np.cumsum(mask) - 1  # canonical row -> position in the valid subset
        clusters_sub = [row_to_sub[c] for c in clusters_rows]
        kept_scores = (np.asarray([scores_np[k] for k in kept])
                       if kept and scores_np is not None else None)
        acc.add_tile(origin[mask], sem[mask], tile_full_ids, clusters_sub, kept_scores,
                     th_merge=th)
