"""Checkpointing with named weight sets.

Counterpart of the JAX package's ``train/checkpoint.py`` (the reference's
ModelCheckpoint semantics): one file holds several named weight sets
(``latest`` plus ``best_<metric>`` for every tracked metric, each with its
improvement direction), the optimizer state, the full run config (so eval
can rebuild the dataset and the model from the checkpoint alone) and the
per-stage stats history, whose length is the resume epoch counter.

Serialization: ``torch.save`` of plain dicts, lists, floats and CPU tensors
(a model's ``state_dict``), loaded with ``torch.load(weights_only=True)``,
which executes no code from the file. A JAX ``.ckpt`` reaches the port
through its numpy trees and :func:`..weights.params_from_flax`.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, List, Optional

import torch

# metric -> comparison direction, mirroring the tracker metric funcs
# (the JAX package's DEFAULT_METRIC_FUNCS)
DEFAULT_METRIC_FUNCS = {
    "miou": "max",
    "macc": "max",
    "acc": "max",
    "loss": "min",
    "map": "max",
    "cov": "max",
    "wcov": "max",
    "mIPre": "max",
    "mIRec": "max",
    "F1": "max",
}


def _to_host(tree):
    """Tensors anywhere in a nest of dicts/lists -> detached CPU tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree


class ModelCheckpoint:
    """Single-file checkpoint with `latest` + `best_<metric>` weight sets."""

    def __init__(
        self,
        ckpt_dir: str,
        name: str = "model",
        selection_stage: str = "val",
        metric_funcs: Optional[Dict[str, str]] = None,
        run_config: Optional[Dict[str, Any]] = None,
    ):
        self.ckpt_dir = ckpt_dir
        self.name = name
        self.selection_stage = selection_stage
        self.metric_funcs = dict(metric_funcs or DEFAULT_METRIC_FUNCS)
        os.makedirs(ckpt_dir, exist_ok=True)
        self.path = osp.join(ckpt_dir, name + ".pt")
        if osp.exists(self.path):
            self._data = torch.load(self.path, map_location="cpu", weights_only=True)
        else:
            self._data = {
                "models": {},
                "optimizer": None,
                "stats": {"train": [], "val": [], "test": []},
                "run_config": run_config or {},
                "best_metrics": {},
            }
        if run_config:
            self._data["run_config"] = run_config

    @property
    def start_epoch(self) -> int:
        return len(self._data["stats"]["train"]) + 1

    @property
    def run_config(self) -> Dict[str, Any]:
        return self._data["run_config"]

    @property
    def weight_names(self) -> List[str]:
        return list(self._data["models"])

    @property
    def stats(self) -> Dict[str, List[Dict[str, float]]]:
        """Per stage, the metrics of each epoch saved so far."""
        return self._data["stats"]

    @property
    def best_metrics(self) -> Dict[str, float]:
        return self._data["best_metrics"]

    def get_weights(self, name: str = "latest"):
        if name not in self._data["models"]:
            avail = list(self._data["models"])
            raise KeyError(f"weight set {name!r} not found (have {avail})")
        return self._data["models"][name]

    def get_optimizer_state(self):
        return self._data["optimizer"]

    def save_best_models_under_current_metrics(
        self,
        weights: Dict[str, Any],
        optimizer_state: Any,
        stage_metrics: Dict[str, Dict[str, float]],
    ) -> List[str]:
        """Update `latest`, append stats, and refresh `best_<metric>` sets for
        every improved metric of the selection stage. ``weights`` is a dict
        such as ``{"state_dict": model.state_dict()}``; ``optimizer_state``
        an optimizer's ``state_dict()`` (or None). Returns the list of
        improved metric names."""
        weights = _to_host(weights)
        self._data["models"]["latest"] = weights
        self._data["optimizer"] = _to_host(optimizer_state)
        for stage, metrics in stage_metrics.items():
            self._data["stats"].setdefault(stage, []).append(
                {k: float(v) for k, v in metrics.items()}
            )
        improved = []
        sel = stage_metrics.get(self.selection_stage, {})
        for metric, value in sel.items():
            direction = None
            for key, d in self.metric_funcs.items():
                if metric.endswith(key):
                    direction = d
                    break
            if direction is None:
                continue
            best_key = f"best_{metric}"
            prev = self._data["best_metrics"].get(metric)
            better = (
                prev is None
                or (direction == "max" and value > prev)
                or (direction == "min" and value < prev)
            )
            if better:
                self._data["best_metrics"][metric] = float(value)
                self._data["models"][best_key] = weights
                improved.append(metric)
        self._flush()
        return improved

    def _flush(self):
        tmp = self.path + ".tmp"
        torch.save(self._data, tmp)
        os.replace(tmp, self.path)
