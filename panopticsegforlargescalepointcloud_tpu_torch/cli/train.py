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
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import List, Optional

import yaml

from ..config import load_config
from ..train.trainer import Trainer
from .eval import CONF_DIR


def run_dir_of(cfg) -> str:
    run_dir = cfg.get("checkpoint_dir") or cfg.get("training", {}).get("checkpoint_dir")
    if not run_dir:
        job = str(cfg.get("job_name", "benchmark"))
        stamp = time.strftime("%Y%m%d_%H%M%S")
        run_dir = os.path.join("outputs", job, f"{job}-{cfg.get('model_name', 'model')}-{stamp}")
        logging.info("run dir: %s", run_dir)
    return run_dir


def main(argv: Optional[List[str]] = None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    overrides = [a for a in (sys.argv[1:] if argv is None else argv) if "=" in a]
    cfg = load_config(CONF_DIR, overrides)
    if cfg.get("pretty_print"):
        print(yaml.dump({k: v for k, v in cfg.items() if k != "models"}))
    run_dir = run_dir_of(cfg)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config_composed.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, default_flow_style=None)
    trainer = Trainer(
        cfg,
        capacity=int(cfg.get("data", {}).get("voxel_capacity", 65536)),
        backbone=str(cfg.get("backbone", "paper")),
        checkpoint_dir=run_dir,
        device=cfg.get("device"),
    )
    try:
        trainer.train()
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
