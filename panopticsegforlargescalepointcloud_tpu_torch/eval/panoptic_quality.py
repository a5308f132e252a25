"""Full-scene panoptic evaluation: the PQ/SQ/RQ/PQ-dagger + MUCov/MWCov +
mPrec/mRec/F1 + semantic report. A copy of the JAX package's
``eval/panoptic_quality.py``.

Semantics of the reference's dataset-level ``final_eval``
(upstream ``torch_points3d/datasets/panoptic/treeins.py:99-510`` and
``npm3d.py:99-...``), generalized over the class layout:

* labels are shifted +1 so "unclassified" (-1) becomes class 0; reports run
  over ``num_classes_raw + 1`` shifted classes;
* points where neither gt nor pred semantic is a thing class are excluded
  from the instance stage (the ``idxc`` filter);
* instance groups take their class from the mode of (pred_sem | gt_sem);
* things: prec/rec @ IoU 0.5 -> RQ, SQ = mean matched IoU, PQ = SQ*RQ,
  PQ-dagger = PQ; stuff: RQ = [class IoU >= 0.5], SQ = class IoU,
  PQ-dagger = class IoU;
* F1 from mean prec/rec over thing classes.

The O(P*G) double loops of the reference are replaced by a vectorized
contingency table over (pred instance, gt instance) pairs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _compact_instances(ins: np.ndarray, sem: np.ndarray, num_classes: int):
    """Compact instance ids (ins >= 0) and derive per-instance class + size.

    Class = mode of the member semantic labels; ties take the smallest class,
    matching ``scipy.stats.mode`` (which the dense formulation used) and the
    reference's per-group vote (treeins.py:154-166). Returns
    (inverse [N] local id or -1, cls [I], size [I])."""
    live = ins >= 0
    uniq, inv_live = np.unique(ins[live], return_inverse=True)
    inverse = np.full(ins.shape, -1, np.int64)
    inverse[live] = inv_live
    n_inst = len(uniq)
    counts = np.zeros((n_inst, num_classes), np.int64)
    np.add.at(counts, (inv_live, sem[live]), 1)
    cls = counts.argmax(1)  # first max = smallest class on ties
    return inverse, cls, counts.sum(1)


def _cov_prec_rec(
    p_ins: np.ndarray,
    p_sem: np.ndarray,
    g_ins: np.ndarray,
    g_sem: np.ndarray,
    num_classes: int,
    at: float = 0.5,
):
    """MUCov/MWCov per class + tp/fp lists + matched-IoU sums.

    Sparse contingency formulation: instance overlaps come from one bincount
    over co-labeled rows (O(N + overlapping pairs)), replacing dense
    [P, N] x [N, G] float64 mask matmuls (the upstream double loop over
    clusters x instances is the same quadratic shape,
    ``torch_points3d/datasets/panoptic/treeins.py:225-320``).
    Pairs never sharing a point have IoU 0 exactly as the dense form."""
    C = num_classes
    p_inv, p_cls, p_size = _compact_instances(p_ins, p_sem, C)
    g_inv, g_cls, g_size = _compact_instances(g_ins, g_sem, C)
    n_p, n_g = len(p_cls), len(g_cls)

    both = (p_inv >= 0) & (g_inv >= 0)
    if both.any() and n_g:
        keys = p_inv[both] * n_g + g_inv[both]
        uk, cnt = np.unique(keys, return_counts=True)
        pair_p, pair_g = uk // n_g, uk % n_g
    else:
        pair_p = pair_g = cnt = np.zeros(0, np.int64)

    mucov = np.full(C, np.nan)
    mwcov = np.full(C, np.nan)
    total_gt = np.zeros(C)
    tps: List[List[float]] = [[] for _ in range(C)]
    fps: List[List[float]] = [[] for _ in range(C)]
    iou_tp = np.zeros(C)

    # pair IoU (class-independent); per-class stages only consult pairs whose
    # two instances were both voted into that class, like the dense per-class
    # mask matrices did
    union = p_size[pair_p] + g_size[pair_g] - cnt
    pair_iou = cnt / np.maximum(union, 1e-9)
    same_class = p_cls[pair_p] == g_cls[pair_g]

    # best same-class match per gt / per pred
    best_gt = np.zeros(n_g)
    np.maximum.at(best_gt, pair_g[same_class], pair_iou[same_class])
    best_pred = np.zeros(n_p)
    np.maximum.at(best_pred, pair_p[same_class], pair_iou[same_class])

    for c in range(C):
        gc = np.where(g_cls == c)[0]
        pc = np.where(p_cls == c)[0]
        total_gt[c] = len(gc)
        if len(gc) and len(pc):
            bg = best_gt[gc]
            mucov[c] = bg.mean()
            mwcov[c] = float((bg * g_size[gc]).sum() / g_size[gc].sum())
            tp = (best_pred[pc] >= at).astype(float)
            tps[c] = tp.tolist()
            fps[c] = (1.0 - tp).tolist()
            iou_tp[c] = float(best_pred[pc][best_pred[pc] >= at].sum())
        elif len(gc) and not len(pc):
            mucov[c] = 0.0
            mwcov[c] = 0.0
        elif len(pc) and not len(gc):
            tps[c] = [0.0] * len(pc)
            fps[c] = [1.0] * len(pc)
    return mucov, mwcov, total_gt, tps, fps, iou_tp


def final_eval(
    pre_sem: np.ndarray,
    pre_ins: np.ndarray,
    gt_sem: np.ndarray,
    gt_ins: np.ndarray,
    num_classes_raw: int,
    thing_classes_raw: Sequence[int],
    stuff_classes_raw: Sequence[int],
    output_file: Optional[str] = None,
    at: float = 0.5,
) -> Dict[str, float]:
    """Compute the full report. Raw label conventions follow the pipeline:
    semantic in [0, C) with -1 = unclassified; instance ids with -1/0 = none
    (pred uses -1, gt uses 0 like the reference exporters)."""
    C = num_classes_raw + 1  # shifted space, 0 = unclassified
    things = [c + 1 for c in thing_classes_raw]
    stuff = [c + 1 for c in stuff_classes_raw]
    sem_classcount = sorted(things + stuff)

    pred_sem_c = np.asarray(pre_sem).reshape(-1).astype(np.int64) + 1
    gt_sem_c = np.asarray(gt_sem).reshape(-1).astype(np.int64) + 1
    pred_ins_c = np.asarray(pre_ins).reshape(-1).astype(np.int64)
    gt_ins_c = np.asarray(gt_ins).reshape(-1).astype(np.int64)
    # gt instance 0 = none -> -1 for the grouping stage
    gt_ins_c = np.where(gt_ins_c == 0, -1, gt_ins_c)

    # ---------- semantic ----------
    gt_classes = np.bincount(gt_sem_c, minlength=C).astype(np.float64)
    pos_classes = np.bincount(pred_sem_c, minlength=C).astype(np.float64)
    tp_classes = np.bincount(
        gt_sem_c[gt_sem_c == pred_sem_c], minlength=C
    ).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou_list = tp_classes / (gt_classes + pos_classes - tp_classes)
    iou_list = np.nan_to_num(iou_list)
    oacc = tp_classes.sum() / max(pos_classes.sum(), 1e-9)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc_per = tp_classes / gt_classes
    macc = float(np.nan_to_num(acc_per[sem_classcount]).mean())
    miou = float(iou_list[sem_classcount].sum() / len(sem_classcount))

    # ---------- instance filter (idxc) ----------
    gt_is_thing = np.isin(gt_sem_c, things)
    pred_is_thing = np.isin(pred_sem_c, things)
    idxc = gt_is_thing | pred_is_thing
    p_ins, g_ins = pred_ins_c[idxc], gt_ins_c[idxc]
    p_sem, g_sem = pred_sem_c[idxc], gt_sem_c[idxc]

    mucov, mwcov, total_gt, tps, fps, iou_tp = _cov_prec_rec(
        p_ins, p_sem, g_ins, g_sem, C, at
    )

    precision = np.zeros(C)
    recall = np.zeros(C)
    RQ = np.zeros(C)
    SQ = np.zeros(C)
    PQ = np.zeros(C)
    PQStar = np.zeros(C)
    for c in things:
        tp = float(np.sum(tps[c]))
        fp = float(np.sum(fps[c]))
        rec = tp / total_gt[c] if total_gt[c] else 0.0
        prec = tp / (tp + fp) if (tp + fp) else 0.0
        precision[c], recall[c] = prec, rec
        RQ[c] = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
        SQ[c] = iou_tp[c] / tp if tp else 0.0
        PQ[c] = SQ[c] * RQ[c]
        PQStar[c] = PQ[c]
    for c in stuff:
        if iou_list[c] >= 0.5:
            RQ[c], SQ[c] = 1.0, iou_list[c]
        else:
            RQ[c], SQ[c] = 0.0, 0.0
        PQ[c] = SQ[c] * RQ[c]
        PQStar[c] = iou_list[c]

    mprec = float(precision[things].mean())
    mrec = float(recall[things].mean())
    f1 = 2 * mprec * mrec / (mprec + mrec) if (mprec + mrec) else 0.0

    metrics = {
        "oAcc": float(oacc),
        "mAcc": macc,
        "mIoU": miou,
        "mMUCov": float(np.nanmean(mucov[things])) if len(things) else 0.0,
        "mMWCov": float(np.nanmean(mwcov[things])) if len(things) else 0.0,
        "mPrec": mprec,
        "mRec": mrec,
        "F1": float(f1),
        "meanRQ": float(RQ[sem_classcount].mean()),
        "meanSQ": float(SQ[sem_classcount].mean()),
        "meanPQ": float(PQ[sem_classcount].mean()),
        "meanPQStar": float(PQStar[sem_classcount].mean()),
        "meanRQ_things": float(RQ[things].mean()),
        "meanSQ_things": float(SQ[things].mean()),
        "meanPQ_things": float(PQ[things].mean()),
        "meanRQ_stuff": float(RQ[stuff].mean()) if stuff else 0.0,
        "meanSQ_stuff": float(SQ[stuff].mean()) if stuff else 0.0,
        "meanPQ_stuff": float(PQ[stuff].mean()) if stuff else 0.0,
    }
    for c in sem_classcount:
        metrics[f"IoU_{c - 1}"] = float(iou_list[c])
    for c in things:
        metrics[f"PQ_{c - 1}"] = float(PQ[c])
        metrics[f"Prec_{c - 1}"] = float(precision[c])
        metrics[f"Rec_{c - 1}"] = float(recall[c])

    if output_file:
        with open(output_file + ".txt", "a") as f:
            f.write("Semantic Segmentation oAcc: {}\n".format(metrics["oAcc"]))
            f.write("Semantic Segmentation mAcc: {}\n".format(metrics["mAcc"]))
            f.write("Semantic Segmentation IoU: {}\n".format(iou_list.tolist()))
            f.write("Semantic Segmentation mIoU: {}\n".format(metrics["mIoU"]))
            f.write("Instance Segmentation mMUCov: {}\n".format(metrics["mMUCov"]))
            f.write("Instance Segmentation mMWCov: {}\n".format(metrics["mMWCov"]))
            f.write("Instance Segmentation mPrecision: {}\n".format(metrics["mPrec"]))
            f.write("Instance Segmentation mRecall: {}\n".format(metrics["mRec"]))
            f.write("Instance Segmentation F1 score: {}\n".format(metrics["F1"]))
            f.write("Instance Segmentation meanRQ: {}\n".format(metrics["meanRQ"]))
            f.write("Instance Segmentation meanSQ: {}\n".format(metrics["meanSQ"]))
            f.write("Instance Segmentation meanPQ: {}\n".format(metrics["meanPQ"]))
            f.write(
                "Instance Segmentation mean PQ star: {}\n".format(metrics["meanPQStar"])
            )
            f.write(
                "Instance Segmentation meanPQ (things): {}\n".format(
                    metrics["meanPQ_things"]
                )
            )
            f.write(
                "Instance Segmentation meanPQ (stuff): {}\n".format(
                    metrics["meanPQ_stuff"]
                )
            )
    return metrics
