"""Optional Weights & Biases / TensorBoard logging (a copy of the JAX
package's ``utils/wandb_utils.py``).

Both sinks are import-gated: if the package is missing or logging is
disabled every call is a no-op, and metrics still land in the local jsonl
run log ``<run_dir>/metrics.jsonl``, the primary record."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)


class WandbLogger:
    def __init__(
        self,
        enabled: bool = False,
        project: str = "panoptic-tpu",
        config: Optional[Dict[str, Any]] = None,
        run_dir: str = ".",
        tags: Optional[list] = None,
        tensorboard: bool = False,
    ):
        self._wandb = None
        self._tb = None
        self._jsonl = os.path.join(run_dir, "metrics.jsonl")
        os.makedirs(run_dir, exist_ok=True)
        if enabled:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, config=config or {}, tags=tags or [])
            except Exception as e:  # no package / no network
                log.warning("wandb unavailable (%s); falling back to jsonl", e)
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=os.path.join(run_dir, "tensorboard")
                )
            except Exception as e:
                log.warning("tensorboard unavailable (%s); jsonl only", e)

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        rec = {"ts": time.time(), "step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self._jsonl, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                # stage-qualified names ("train/loss") become TB sections,
                # matching the reference tracker's publish naming
                self._tb.add_scalar(k, float(v), global_step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
