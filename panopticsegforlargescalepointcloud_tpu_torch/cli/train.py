"""Training CLI, the counterpart of the repo's root ``train.py``:

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.cli.train \\
        data=panoptic/treeins_rad8 models=panoptic/area4_ablation_3heads_5 \\
        model_name=PointGroup-PAPER training=treeins training.epochs=150 \\
        "data.files.train=[path/to/a.ply]" "data.files.val=[path/to/b.ply]" [device=cpu]

``models=`` takes any model yaml of ``conf/models/panoptic``: the paper's
Settings I-V are ``area4_ablation_19``, ``_14``, ``_15``, ``_3heads_5`` and
``_3heads_6``; the point backbones ``kpconv``, ``kpconv_deform`` and
``pointnet2`` go with ``model_name=KPConvPaper``, ``KPConvPaper-Deform``
and ``PointNet2``. Composes
``conf/config.yaml`` with the overrides, writes it to
``<run_dir>/config_composed.yaml`` and trains; the run directory holds the
checkpoint ``model.pt`` and the run log ``metrics.jsonl``. It is
``checkpoint_dir`` (or ``training.checkpoint_dir``) when given, and a run
there resumes from its checkpoint; else a new
``outputs/<job_name>/<job_name>-<model_name>-<timestamp>``. Without data
files it trains on synthetic planted-instance tiles. Runs on ``cuda``
unless ``device=cpu``; without a GPU it raises.

``training.num_devices=D`` (D > 1; 0: every visible card) trains data
parallel on D ranks (:mod:`..parallel`; ``batch_size`` per device): the
first D cards, refused beyond the visible ones, or D CPU ranks with
``device=cpu``. Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the
environment) the CLI joins that group; otherwise it starts the ranks.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import List, Optional

import yaml

from ..config import load_config
from ..parallel import launch
from ..train.trainer import Trainer
from .eval import CONF_DIR, mesh_devices


def run_dir_of(cfg) -> str:
    run_dir = cfg.get("checkpoint_dir") or cfg.get("training", {}).get("checkpoint_dir")
    if not run_dir:
        job = str(cfg.get("job_name", "benchmark"))
        stamp = time.strftime("%Y%m%d_%H%M%S")
        run_dir = os.path.join("outputs", job, f"{job}-{cfg.get('model_name', 'model')}-{stamp}")
        logging.info("run dir: %s", run_dir)
    return run_dir


def main(argv: Optional[List[str]] = None):
    """The :class:`Trainer` after training on one device; on D ranks the
    ranks' summaries (:func:`train`), or under ``torchrun`` this rank's."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    overrides = [a for a in (sys.argv[1:] if argv is None else argv) if "=" in a]
    cfg = load_config(CONF_DIR, overrides)
    nd = int(cfg.get("training", {}).get("num_devices", 1))
    devices = [cfg.get("device")] if nd == 1 else mesh_devices(nd, cfg.get("device"))
    # under torchrun every rank runs this function: rank 0 names the run dir
    mesh = launch.from_env(devices) if len(devices) > 1 and launch.in_torchrun() else None
    try:
        run_dir = run_dir_of(cfg)
        if mesh is not None:
            from ..parallel.mesh import broadcast_object

            run_dir = broadcast_object(mesh, run_dir)
        if mesh is None or mesh.is_root:
            if cfg.get("pretty_print"):
                print(yaml.dump({k: v for k, v in cfg.items() if k != "models"}))
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "config_composed.yaml"), "w") as f:
                yaml.safe_dump(cfg, f, default_flow_style=None)
        if len(devices) == 1:
            return train(None, cfg, run_dir)
        if mesh is not None:
            return train(mesh, cfg, run_dir)
        return launch.spawn(train, devices, cfg, run_dir)
    finally:
        if mesh is not None:
            launch.shutdown()


def train(mesh, cfg, run_dir: str):
    """Build the trainer and train: the :class:`Trainer` on one device; on
    a mesh, in every rank, this rank's summary (rank, mini-batches taken,
    steps per epoch, start epoch, :func:`..parallel.replica_checksum`)."""
    trainer = Trainer(
        cfg,
        capacity=int(cfg.get("data", {}).get("voxel_capacity", 65536)),
        backbone=str(cfg.get("backbone", "paper")),
        checkpoint_dir=run_dir,
        device=cfg.get("device"),
        mesh=mesh,
    )
    try:
        trainer.train()
    finally:
        trainer.close()
    if mesh is None:
        return trainer
    from ..parallel import replica_checksum

    return dict(rank=mesh.rank, step=trainer.state.step,
                steps_per_epoch=trainer.steps_per_epoch, start_epoch=trainer.start_epoch,
                checksum=replica_checksum(trainer.model))


if __name__ == "__main__":
    main()
