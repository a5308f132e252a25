"""Prediction visualization dumps (a copy of the JAX package's
``eval/visualizer.py``).

Saves per-sample PLYs with positions, gt/pred semantics, gt/pred instance
ids, offsets and embeddings, the primary debugging artifact of this
pipeline family.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from ..data.ply import write_ply


class Visualizer:
    def __init__(self, out_dir: str = "viz", num_samples_per_epoch: int = 2):
        self.out_dir = out_dir
        self.budget = num_samples_per_epoch
        self._saved_this_epoch = 0
        self._epoch = -1

    def begin_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._saved_this_epoch = 0

    def maybe_save(
        self,
        pos: np.ndarray,
        mask: np.ndarray,
        y: np.ndarray,
        pred_sem: np.ndarray,
        instance_labels: Optional[np.ndarray] = None,
        pred_instance: Optional[np.ndarray] = None,
        offsets: Optional[np.ndarray] = None,
        embeds: Optional[np.ndarray] = None,
    ) -> Optional[str]:
        if self._saved_this_epoch >= self.budget:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        m = mask.astype(bool)
        cols = [pos[m], y[m].astype(np.int32), pred_sem[m].astype(np.int32)]
        names = ["x", "y", "z", "gt_sem", "pred_sem"]
        if instance_labels is not None:
            cols.append(instance_labels[m].astype(np.int32))
            names.append("gt_ins")
        if pred_instance is not None:
            cols.append(pred_instance[m].astype(np.int32))
            names.append("pred_ins")
        if offsets is not None:
            cols.append((pos[m] + offsets[m]).astype(np.float32))
            names += ["shift_x", "shift_y", "shift_z"]
        if embeds is not None:
            e = embeds[m].astype(np.float32)
            cols.append(e)
            names += [f"embed{i + 1}" for i in range(e.shape[1])]
        path = osp.join(
            self.out_dir, f"data_e{self._epoch}_{self._saved_this_epoch}.ply"
        )
        write_ply(path, cols, names)
        self._saved_this_epoch += 1
        return path
