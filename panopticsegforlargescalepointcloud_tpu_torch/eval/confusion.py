"""Confusion matrix (numpy, host-side) - semantics of the reference
``metrics/confusion_matrix.py`` (bincount update, IoU/OA/mAcc getters). A
copy of the JAX package's ``eval/confusion.py``."""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.m = np.zeros((num_classes, num_classes), dtype=np.int64)

    def count_predicted_batch(self, gt: np.ndarray, pred: np.ndarray) -> None:
        """gt/pred: int arrays in [0, C). Caller filters ignore labels."""
        assert gt.min() >= 0 and gt.max() < self.num_classes
        idx = gt.astype(np.int64) * self.num_classes + pred.astype(np.int64)
        self.m += np.bincount(idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes
        )

    def get_intersection_union_per_class(self):
        """Returns (iou [C], present [C]) - present = class seen in gt or pred."""
        tp = np.diag(self.m).astype(np.float64)
        gt = self.m.sum(1).astype(np.float64)
        pred = self.m.sum(0).astype(np.float64)
        union = gt + pred - tp
        present = union > 0
        iou = np.where(present, tp / np.maximum(union, 1e-8), 1.0)
        return iou, present

    def get_average_intersection_union(self, missing_as_one: bool = False) -> float:
        iou, present = self.get_intersection_union_per_class()
        if missing_as_one:
            return float(iou.mean())
        if not present.any():
            return 0.0
        return float(iou[present].mean())

    def get_overall_accuracy(self) -> float:
        total = self.m.sum()
        return float(np.diag(self.m).sum() / total) if total else 0.0

    def get_mean_class_accuracy(self) -> float:
        gt = self.m.sum(1)
        present = gt > 0
        if not present.any():
            return 0.0
        acc = np.diag(self.m)[present] / gt[present]
        return float(acc.mean())
