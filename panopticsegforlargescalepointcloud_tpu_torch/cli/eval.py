"""Full-scene evaluation CLI, the counterpart of the repo's root ``eval.py``:

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.cli.eval \\
        checkpoint_dir=outputs/run1 weight_name=latest \\
        "data.files.test=[path/to/plot.ply]" out_dir=eval_outputs [device=cpu]

Rebuilds the model from the checkpoint's stored run config (only what is
typed on the command line overrides its ``data`` group), tiles each test
file into cylinders, runs the eval forward per dispatch of
``tiles_per_dispatch`` tiles, merges the tiles' instances, and writes
``eval_manifest.json``, the Semantic/Instance_results_forEval PLYs and one
``Evaluation_<i>.txt`` PQ report per file, then prints the JSON reports.
Runs on ``cuda`` unless ``device=cpu``; without a GPU it raises.

``num_devices=D`` (D > 1) serves one tile per rank on D ranks
(:mod:`..parallel`): the first D cards, refused beyond the visible ones, or
D CPU ranks with ``device=cpu``; ``tiles_per_dispatch`` then defaults to 1
(a mesh takes no other). Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in
the environment) the CLI joins that group; otherwise it starts the ranks.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
from typing import Callable, List, Optional

from ..config import explicit_overrides, load_config, panoptic_config_from_yaml
from ..data import PanopticFileDataset
from ..models import PointGroup3HeadsNet
from ..parallel import launch
from ..train.checkpoint import ModelCheckpoint
from ..train.evaluator import FullSceneEvaluator, eval_tile_capacity

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "conf")

# tiles per single-GPU dispatch: 2, from the H100 measurement of g = 1
# against g = 2 on the 500k-point forest scene (PERF.md, "tiles per
# dispatch"); tiles_per_dispatch=1 dispatches strictly tile by tile
DEFAULT_TILES_PER_DISPATCH = 2


def model_config(run_cfg):
    """(PanopticConfig with num_samples 1, DatasetSpec) of a checkpoint's
    run config: its ``backbone`` and ``budget_overrides`` keys apply."""
    pcfg, spec, _ = panoptic_config_from_yaml(
        run_cfg, backbone=str(run_cfg.get("backbone", "paper")),
        **run_cfg.get("budget_overrides", {}))
    return dataclasses.replace(pcfg, num_samples=1), spec


def build_evaluator(overrides: List[str], timer: Optional[Callable] = None, mesh=None):
    """(evaluator, run kwargs, out_dir, test files) from CLI overrides;
    with ``mesh`` (:class:`..parallel.Mesh`) this rank's evaluator of a
    mesh."""
    cfg = load_config(CONF_DIR, overrides, root="eval.yaml")
    ckpt_dir = cfg.get("checkpoint_dir")
    if not ckpt_dir:
        raise SystemExit("checkpoint_dir=... is required")
    ckpt = ModelCheckpoint(ckpt_dir)
    # the checkpoint's run config rebuilds the model; composed data-group
    # defaults must not clobber its dataset spec, only typed overrides do
    run_cfg = dict(ckpt.run_config) or cfg
    run_cfg.setdefault("data", {})
    run_cfg["data"].update(explicit_overrides(overrides).get("data", {}))
    pcfg, spec = model_config(run_cfg)

    files = run_cfg["data"].get("files", {}).get("test") or run_cfg["data"].get("fold")
    if not files or not isinstance(files, list):
        raise SystemExit("data.files.test='[...ply]' is required")
    data = run_cfg["data"]
    dataset = PanopticFileDataset(
        spec,
        files,
        grid_size=float(data.get("grid_size", 0.2)),
        radius=float(data.get("radius", 8)),
        processed_dir=data.get("processed_dir"),
        sampling_format=str(data.get("sampling_format", "cylinder")),
        test_transforms=data.get("test_transform") or data.get("test_transforms"),
        pre_collate_transform=data.get("pre_collate_transform"),
        keep_raw=True,
    )
    model = PointGroup3HeadsNet(pcfg)
    weights = ckpt.get_weights(str(cfg.get("weight_name", "latest")))
    model.load_state_dict(weights["state_dict"], strict=True)
    default_g = DEFAULT_TILES_PER_DISPATCH if mesh is None else 1
    evaluator = FullSceneEvaluator(
        pcfg, model, dataset, eval_tile_capacity(data),
        tiles_per_dispatch=int(cfg.get("tiles_per_dispatch", default_g)),
        device=cfg.get("device"), timer=timer, mesh=mesh,
    )
    run_kwargs = dict(
        ply_output=bool(cfg.get("tracker_options", {}).get("make_submission", True)),
        # the model config's block-merge threshold, as the JAX CLI passes it
        th_merge=pcfg.block_merge_th,
        voting_runs=int(cfg.get("voting_runs", 1)),
    )
    return evaluator, run_kwargs, str(cfg.get("out_dir", "eval_outputs")), files


def evaluate(mesh, overrides: List[str]):
    """Build the evaluator and run it; on a mesh, in every rank (rank 0
    writes the files and returns the reports, the others return None)."""
    evaluator, run_kwargs, out_dir, files = build_evaluator(overrides, mesh=mesh)
    root = mesh is None or mesh.is_root
    if root:
        # manifest: eval index -> source file (evaluation_stats_FOR.py
        # groups plots by forest region)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "eval_manifest.json"), "w") as f:
            json.dump({str(i): os.path.basename(p) for i, p in enumerate(files)}, f)
    reports = evaluator.run(out_dir=out_dir, **run_kwargs)
    if root:
        print(json.dumps(reports, indent=2))
    return reports


def mesh_devices(num_devices: int, device) -> List:
    """The ranks' devices for ``num_devices``; more than the visible cards
    ends the CLI with the refusal."""
    try:
        return launch.visible_devices(num_devices, device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    overrides = [a for a in (sys.argv[1:] if argv is None else argv) if "=" in a]
    cfg = load_config(CONF_DIR, overrides, root="eval.yaml")
    nd = int(cfg.get("num_devices", 1))
    if nd == 1:
        return evaluate(None, overrides)
    devices = mesh_devices(nd, cfg.get("device"))
    if launch.in_torchrun():
        mesh = launch.from_env(devices)
        try:
            return evaluate(mesh, overrides)
        finally:
            launch.shutdown()
    return launch.spawn(evaluate, devices, overrides)[0]


if __name__ == "__main__":
    main()
