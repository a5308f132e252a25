"""The reference's served scene: the plain copy's dataset (PLY read, grid
sampling, tiling), model, clustering, block merging and finalise, in f32
with TF32 off (or with fp8 conv operands for the precision control), from
the benchmark's weights and forest file.

:func:`judge_scene` checks a scene the program served stage by stage
(:mod:`.stages`): its tiles against the copy's, each dispatch's heads and
scores against the copy's forward (which takes the program's proposals),
the program's proposals against the copy's clustering of the program's
heads, and the program's labels against the copy's extraction, block
merging and finalise of the program's dispatch outputs."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from .plain.config import panoptic_config_from_yaml
from .plain.data import PanopticFileDataset, batch_arrays, collate_tiles
from .plain.eval.extract import COUNTERS
from .plain.eval.merge import SceneAccumulator
from .plain.models import PointGroup3HeadsNet
from .plain.train.evaluator import FullSceneEvaluator, eval_tile_capacity
from .stages import Follow, clustering_mismatch, proposals_of, same_rows
from .train_ref import model_config, no_tf32


def scene_dataset(run_config: dict, path: str) -> PanopticFileDataset:
    """The copy's dataset of the one file ``path``, as the eval CLI builds it."""
    data = run_config["data"]
    spec = panoptic_config_from_yaml(run_config)[1]
    return PanopticFileDataset(
        spec, [path], grid_size=float(data.get("grid_size", 0.2)),
        radius=float(data.get("radius", 8)), processed_dir=None,
        sampling_format=str(data.get("sampling_format", "cylinder")),
        test_transforms=data.get("test_transform") or data.get("test_transforms"),
        pre_collate_transform=data.get("pre_collate_transform"), keep_raw=True)


def _evaluator(run_config, weights, path, g, compute_dtype, device):
    pcfg = dataclasses.replace(model_config(run_config, compute_dtype=compute_dtype),
                               num_samples=1)
    model = PointGroup3HeadsNet(pcfg)
    model.load_state_dict({k: v.to("cpu") for k, v in weights.items()}, strict=True)
    return FullSceneEvaluator(pcfg, model, scene_dataset(run_config, path),
                              eval_tile_capacity(run_config["data"]), tiles_per_dispatch=g,
                              device=device)


def same_tiles(prog: List, ref: List) -> float:
    """The share of tiles (of the longer list) that differ in any array
    or in their origin ids."""
    bad = abs(len(prog) - len(ref))
    for (pt, pi), (rt, ri) in zip(prog, ref):
        same = np.array_equal(pi, ri) and set(pt) == set(rt) and all(
            np.array_equal(np.asarray(pt[k]), np.asarray(rt[k])) for k in rt)
        bad += not same
    return bad / max(len(prog), len(ref), 1)


def forward_records(ev, tiles, calls, device) -> List[Dict]:
    """The copy's forward of each dispatch, as the evaluator groups the
    tiles, taking the program's proposals of that dispatch."""
    g = ev.group
    out = []
    with Follow([c["proposals"] for c in calls]) as follow:
        for start in range(0, len(tiles), g):
            group = tiles[start:start + g]
            padded = group + [group[-1]] * (g - len(group))
            vb = collate_tiles([t for t, _ in padded], capacity=ev.capacity * g, num_tiles=g)
            ev._fwd(batch_arrays(vb))
    out.extend(follow.calls)
    return out


def stage_gaps(prog_calls: List[Dict], ref_calls: List[Dict]) -> Dict[str, float]:
    """The heads' and the scores' relative gaps over a whole scene: each
    head's (and the scores') squared differences and squared norms summed
    over every dispatch, the worst head's gap (1 where any dispatch ran on
    other rows)."""
    if len(prog_calls) != len(ref_calls):
        return {"heads_gap": 1.0, "score_gap": 1.0}
    num = {k: 0.0 for k in ("sem", "off", "emb", "scores")}
    den = dict(num)
    for p, r in zip(prog_calls, ref_calls):
        if not same_rows(p, r):
            return {"heads_gap": 1.0, "score_gap": 1.0}
        m = r["mask"]
        for k in ("sem", "off", "emb"):
            num[k] += float((p[k].to(m.device)[m].double() - r[k][m].double()).square().sum())
            den[k] += float(r[k][m].double().square().sum())
        if r["scores"] is not None:
            v = r["proposals"]["prop_valid"]
            num["scores"] += float((p["scores"].to(v.device)[v].double()
                                    - r["scores"][v].double()).square().sum())
            den["scores"] += float(r["scores"][v].double().square().sum())
    gap = {k: (num[k] / den[k]) ** 0.5 if den[k] > 0 else float(num[k] > 0) for k in num}
    return {"heads_gap": max(gap["sem"], gap["off"], gap["emb"]), "score_gap": gap["scores"]}


def labels_from(ev, raw_pos, tiles, calls, device) -> Tuple[np.ndarray, np.ndarray]:
    """The copy's extraction, block merging and finalise over the given
    dispatch outputs (the program's), as ``FullSceneEvaluator.predict``
    runs them."""
    dev = torch.device(device)
    acc = SceneAccumulator(raw_pos, ev.pcfg.num_classes)
    th = 0.1 if ev.pcfg.block_merge_th is None else ev.pcfg.block_merge_th
    g = ev.group
    for i, start in enumerate(range(0, len(tiles), g)):
        c = calls[i]
        grid = SimpleNamespace(mask=c["mask"].to(dev), batch=c["batch"].to(dev),
                               capacity=int(c["mask"].shape[0]))
        db = SimpleNamespace(grid=grid, origin_id=c["origin"].to(dev))
        out = SimpleNamespace(semantic_logits=c["sem"].to(dev),
                              proposals=proposals_of(c["proposals"], dev),
                              cluster_scores=None if c["scores"] is None else c["scores"].to(dev),
                              **{k: (None if c["counters"].get(k) is None else
                                     torch.as_tensor(c["counters"][k], device=dev))
                                 for k in COUNTERS})
        ev._accumulate_dispatch(acc, db, out, [ids for _, ids in tiles[start:start + g]], th)
    return acc.finalise(stuff_classes=ev.pcfg.stuff_classes, distance_cutoff=1.0,
                        min_instance_size=10)


def judge_scene(run_config: dict, weights, path: str, g: int, prog_tiles: List,
                prog_calls: List[Dict], prog_labels: Tuple[np.ndarray, np.ndarray],
                device: str = "cuda", compute_dtype: str = "float32") -> Dict[str, float]:
    """The compared numbers of one scene the program served."""
    if device != "cpu":
        no_tf32()
    ev = _evaluator(run_config, weights, path, g, compute_dtype, device)
    tiles = ev.dataset.test_tiles(0)
    out = {"tiling_mismatch": same_tiles(prog_tiles, tiles)}
    with torch.no_grad():
        ref_calls = forward_records(ev, tiles, prog_calls, device)
    out.update(stage_gaps(prog_calls, ref_calls))
    out["clustering_mismatch"] = max(clustering_mismatch(ev.fcfg, c, device) for c in prog_calls)
    sem, ins = labels_from(ev, ev.dataset.raw_clouds[0]["pos"], tiles, prog_calls, device)
    ps, pi = (np.asarray(a) for a in prog_labels)
    out["label_mismatch"] = (float(np.mean((ps != sem) | (pi != ins)))
                             if ps.shape == sem.shape and pi.shape == ins.shape else 1.0)
    return out


def control_gaps(run_config: dict, weights, path: str, g: int, prog_calls: List[Dict],
                 device: str = "cuda") -> Dict[str, float]:
    """The precision control: the copy's forward with fp8 conv operands in
    the program's place, against the copy's in f32, each taking the
    program's proposals."""
    no_tf32() if device != "cpu" else None
    recs = {}
    for dt in ("float32", "float8_e4m3fn"):
        ev = _evaluator(run_config, weights, path, g, dt, device)
        with torch.no_grad():
            recs[dt] = forward_records(ev, ev.dataset.test_tiles(0), prog_calls, device)
    return stage_gaps(recs["float8_e4m3fn"], recs["float32"])
