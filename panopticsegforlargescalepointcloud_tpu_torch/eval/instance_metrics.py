"""Batch-level instance metrics for validation tracking.

A copy of the JAX package's ``eval/instance_metrics.py`` (numpy): the
semantics of the upstream tracker's ``_compute_acc`` (tp/fp/acc against the
ground truth by max-IoU matching and modal-class agreement),
``_compute_eval`` (MUCov/MWCov/mPrec/mRec/F1 grouped by modal predicted
class) and the VOC-style ``InstanceAPMeter``/``voc_ap``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np


def _modal(x: np.ndarray) -> int:
    vals, counts = np.unique(x, return_counts=True)
    return int(vals[np.argmax(counts)])


def _iou_matrix(pred_masks: np.ndarray, gt_masks: np.ndarray) -> np.ndarray:
    inter = pred_masks.astype(np.float64) @ gt_masks.T.astype(np.float64)
    union = pred_masks.sum(1)[:, None] + gt_masks.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def compute_acc(
    clusters: List[np.ndarray],
    predicted_labels: np.ndarray,
    instance_labels: np.ndarray,
    gt_sem: np.ndarray,
    batch: np.ndarray,
    num_instances_total: int,
    iou_threshold: float = 0.5,
) -> Tuple[float, float, float]:
    """Returns (tp_rate, fp_rate, acc) like _compute_acc: a cluster is tp if
    its best-IoU GT instance (within its sample) clears the threshold AND the
    modal gt class of that instance equals the cluster's modal predicted
    class."""
    if not clusters:
        return 0.0, 0.0, 0.0
    n = len(instance_labels)
    tp = 0
    for cl in clusters:
        s = batch[cl[0]]
        smask = batch == s
        inst_s = instance_labels.copy()
        inst_s[~smask] = 0
        best_iou, best_id = 0.0, 0
        for g in np.unique(inst_s):
            if g <= 0:
                continue
            gmask = inst_s == g
            inter = np.intersect1d(cl, np.where(gmask)[0]).size
            union = len(cl) + gmask.sum() - inter
            iou = inter / max(union, 1)
            if iou > best_iou:
                best_iou, best_id = iou, g
        if best_iou < iou_threshold:
            continue
        gt_mask = inst_s == best_id
        gt_class = _modal(gt_sem[gt_mask])
        pred_class = _modal(predicted_labels[cl])
        if gt_class == pred_class:
            tp += 1
    fp = len(clusters) - tp
    acc = tp / len(clusters)
    denom = max(num_instances_total, 1)
    return tp / denom, fp / denom, acc


def compute_eval(
    clusters: List[np.ndarray],
    predicted_labels: np.ndarray,
    instance_labels: np.ndarray,
    gt_sem: np.ndarray,
    batch: np.ndarray,
    num_classes: int,
    thing_classes: Sequence[int],
    iou_threshold: float = 0.5,
) -> Tuple[float, float, float, float, float]:
    """Returns (cov, wcov, mPrec, mRec, F1) over classes that actually have GT
    instances (the reference averages over ins_classcount & present classes)."""
    n = len(predicted_labels)
    pts_in_pred: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    for cl in clusters:
        m = np.zeros(n, bool)
        m[cl] = True
        pts_in_pred[_modal(predicted_labels[m])].append(m)

    pts_in_gt: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    have: List[int] = []
    for s in np.unique(batch[batch >= 0]):
        smask = batch == s
        for g in np.unique(instance_labels[smask]):
            if g <= 0:
                continue
            m = (instance_labels == g) & smask
            c = _modal(gt_sem[m])
            if c < 0:
                continue
            pts_in_gt[c].append(m)
            have.append(c)

    classes = sorted(set(thing_classes) & set(have))
    if not classes:
        return 0.0, 0.0, 0.0, 0.0, 0.0

    covs, wcovs, precs, recs = [], [], [], []
    for c in classes:
        gts = pts_in_gt[c]
        preds = pts_in_pred[c]
        if not preds:
            covs.append(0.0)
            wcovs.append(0.0)
            precs.append(0.0)
            recs.append(0.0)
            continue
        gt_m = np.stack(gts)
        pr_m = np.stack(preds)
        iou = _iou_matrix(pr_m, gt_m)
        best_per_gt = iou.max(0)
        covs.append(float(best_per_gt.mean()))
        sizes = gt_m.sum(1)
        wcovs.append(float((best_per_gt * sizes).sum() / sizes.sum()))
        best_per_pred = iou.max(1)
        tp = float((best_per_pred >= iou_threshold).sum())
        precs.append(tp / len(preds))
        recs.append(tp / len(gts))

    cov, wcov = float(np.mean(covs)), float(np.mean(wcovs))
    mprec, mrec = float(np.mean(precs)), float(np.mean(recs))
    f1 = 2 * mprec * mrec / (mprec + mrec) if (mprec + mrec) else 0.0
    return cov, wcov, mprec, mrec, f1


class _Instance(NamedTuple):
    classname: int
    score: float
    indices: np.ndarray
    scan_id: int

    def iou(self, other: "_Instance") -> float:
        inter = np.intersect1d(self.indices, other.indices).size
        union = np.union1d(self.indices, other.indices).size
        return inter / max(union, 1)


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """All-points interpolated AP (VOC style)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class InstanceAPMeter:
    """Per-class AP at an IoU threshold over accumulated scans."""

    def __init__(self):
        self._preds: Dict[int, List[_Instance]] = defaultdict(list)
        self._gts: Dict[int, Dict[int, List[_Instance]]] = defaultdict(
            lambda: defaultdict(list)
        )

    def add(self, preds: List[_Instance], gts: List[_Instance]) -> None:
        for p in preds:
            self._preds[p.classname].append(p)
        for g in gts:
            self._gts[g.classname][g.scan_id].append(g)

    def _eval_class(self, classname: int, iou_threshold: float):
        preds = sorted(
            self._preds.get(classname, []), key=lambda i: i.score, reverse=True
        )
        gts = self._gts.get(classname, {})
        total_gt = sum(len(v) for v in gts.values())
        if total_gt == 0:
            return None, None, None
        matched = {sid: np.zeros(len(v), bool) for sid, v in gts.items()}
        tp = np.zeros(len(preds))
        fp = np.zeros(len(preds))
        for i, p in enumerate(preds):
            cands = gts.get(p.scan_id, [])
            best, best_j = -1.0, -1
            for j, g in enumerate(cands):
                iou = p.iou(g)
                if iou > best:
                    best, best_j = iou, j
            if best >= iou_threshold and not matched[p.scan_id][best_j]:
                tp[i] = 1
                matched[p.scan_id][best_j] = True
            else:
                fp[i] = 1
        rec = np.cumsum(tp) / total_gt
        prec = np.cumsum(tp) / np.maximum(np.cumsum(tp) + np.cumsum(fp), 1e-9)
        return rec, prec, voc_ap(rec, prec)

    def eval(self, iou_threshold: float = 0.5):
        recs, precs, aps = {}, {}, {}
        for c in self._gts:
            r, p, ap = self._eval_class(c, iou_threshold)
            if r is None:
                continue
            recs[c], precs[c], aps[c] = r, p, ap
        return recs, precs, aps
