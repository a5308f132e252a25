"""Full-scene stitching: semantic vote accumulation + instance block merging.

Semantics of the reference tracker's test path
(``metrics/panoptic_tracker_pointgroup_treeins.py``):
* per-tile vote accumulation into the full subsampled cloud keyed by
  ``origin_id`` (:256-257);
* ``get_cur_ins_pre_label`` (:348-361): per-point instance id over the tile's
  subsampled points, proposals written in ascending score order so the
  highest-scoring proposal wins contested points;
* ``block_merging`` (:363-479): project tile instance ids to the tile's
  full-resolution points by 1-NN, then adopt an existing scene-level id when
  the IoU against already-labeled points exceeds the merge threshold (the
  reference hard-codes 0.1 at :474), else assign a fresh id;
* ``finalise`` (:564-693): vote-argmax semantics, 1-NN full-res projection,
  stuff masking, 1 m nearest-distance cutoff, <10-point instance removal.

All host-side numpy + scipy cKDTree (this is out of the training hot path;
the reference also runs it on host). A copy of the JAX package's
``eval/merge.py``; like there, no pipeline calls ``block_merging_by_score``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def cur_ins_pre_label(
    clusters: List[np.ndarray], scores: Optional[np.ndarray], num_points: int
) -> np.ndarray:
    """Per-point instance id over the tile (ascending-score overwrite)."""
    out = -np.ones(num_points, dtype=np.int64)
    if not clusters:
        return out
    order = np.argsort(scores) if scores is not None else np.arange(len(clusters))
    for i, j in enumerate(order):
        out[clusters[j]] = i
    return out


def block_merging(
    full_pos: np.ndarray,
    tile_full_ids: np.ndarray,
    tile_sub_ids: np.ndarray,
    pre_sub_ins: np.ndarray,
    all_pre_ins: np.ndarray,
    max_instance: int,
    th_merge: float = 0.1,
) -> Tuple[np.ndarray, int]:
    """Merge one tile's instance prediction into the scene-level labeling.

    Args:
      full_pos: [Nfull, 3] positions of the scene's (subsampled) cloud.
      tile_full_ids: indices of ALL the tile's points in the scene cloud.
      tile_sub_ids: indices of the tile's *subsampled/voxelized* points.
      pre_sub_ins: [len(tile_sub_ids)] per-subpoint instance ids (-1 none).
      all_pre_ins: [Nfull] running scene labeling (-1 none) - updated copy
        returned.
      max_instance: running id counter.
    Returns:
      (all_pre_ins, max_instance)
    """
    all_pre_ins = all_pre_ins.copy()
    if not np.any(pre_sub_ins != -1):
        return all_pre_ins, max_instance

    # project sub -> full tile points by 1-NN
    tree = cKDTree(full_pos[tile_sub_ids])
    _, nn = tree.query(full_pos[tile_full_ids], k=1, workers=-1)
    pre_ins = pre_sub_ins[nn]

    t_num_clusters = int(pre_ins.max()) + 1
    labeled = all_pre_ins[tile_full_ids] != -1
    if not labeled.any():
        mask_valid = pre_ins != -1
        all_pre_ins[tile_full_ids[mask_valid]] = pre_ins[mask_valid] + max_instance
        return all_pre_ins, max_instance + t_num_clusters
    if labeled.all():
        return all_pre_ins, max_instance

    # Scene-wide per-label sizes, updated incrementally as clusters are
    # assigned within this tile (the reference re-scans the whole scene per
    # (cluster, old label) pair - O(clusters x labels x N); with counts the
    # IoU is exact in O(cluster size): union = |old| + |new| - inter).
    budget = max_instance + t_num_clusters + 2
    label_counts = np.bincount(
        all_pre_ins[all_pre_ins != -1], minlength=budget
    ).astype(np.int64)
    if len(label_counts) < budget:
        label_counts = np.pad(label_counts, (0, budget - len(label_counts)))

    for ii in range(t_num_clusters):
        new_idx = tile_full_ids[pre_ins == ii]
        if new_idx.size == 0:
            continue
        old_of_new = all_pre_ins[new_idx]
        not_old = new_idx[old_of_new == -1]
        has_old = old_of_new[old_of_new != -1]
        if has_old.size == 0:
            all_pre_ins[not_old] = max_instance + 1
            max_instance += 1
            label_counts[max_instance] += not_old.size
        elif not_old.size == 0:
            continue
        else:
            inter = np.bincount(has_old, minlength=len(label_counts))
            old_labels = np.unique(has_old)
            ious = inter[old_labels] / np.maximum(
                label_counts[old_labels] + new_idx.size - inter[old_labels], 1
            )
            best = int(np.argmax(ious))  # first max == reference's strict >
            best_iou, best_label = float(ious[best]), int(old_labels[best])
            if best_iou > th_merge:
                all_pre_ins[not_old] = best_label
                label_counts[best_label] += not_old.size
            else:
                all_pre_ins[not_old] = max_instance + 1
                max_instance += 1
                label_counts[max_instance] += not_old.size
    return all_pre_ins, max_instance


def block_merging_by_score(
    all_clusters: List[np.ndarray],
    all_scores: Optional[np.ndarray],
    new_clusters: List[np.ndarray],
    new_scores: Optional[np.ndarray],
    full_pos: np.ndarray,
    tile_full_ids: np.ndarray,
    tile_sub_ids: np.ndarray,
    nms_threshold: float = 0.3,
) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """Score-ordered NMS merge - the reference's alternative merger
    (``panoptic_tracker_pointgroup_treeins.py:493-562``; present but not
    enabled in its pipeline, the call at :287 is commented out).

    Scene state is a list of full-res clusters + scores; a new tile's
    clusters are 1-NN-projected to full resolution, appended, and the pool is
    pruned by greedy score-ordered NMS at IoU ``nms_threshold``. (The
    reference computes IoU only between index-adjacent proposal pairs - an
    artifact of its abandoned loop; here the IoU is the true pairwise one.)
    """
    if not new_clusters:
        return all_clusters, all_scores
    tree = cKDTree(full_pos[tile_sub_ids])
    _, nn = tree.query(full_pos[tile_full_ids], k=1, workers=-1)
    projected = []
    for cl in new_clusters:
        sel = np.isin(nn, cl)
        projected.append(tile_full_ids[sel])
    pool = list(all_clusters) + projected
    if all_scores is None:
        scores = np.asarray(new_scores, np.float64)
    else:
        scores = np.concatenate([np.asarray(all_scores), np.asarray(new_scores)])
    order = np.argsort(-scores)
    kept: List[int] = []
    kept_sets: List[np.ndarray] = []
    for idx in order:
        c = pool[idx]
        ok = True
        for kc in kept_sets:
            inter = np.intersect1d(c, kc, assume_unique=False).size
            union = c.size + kc.size - inter
            if union and inter / union > nms_threshold:
                ok = False
                break
        if ok:
            kept.append(idx)
            kept_sets.append(c)
    return [pool[i] for i in kept], scores[kept]


class SceneAccumulator:
    """Running full-scene state for one test file (votes + instance labels)."""

    def __init__(self, full_pos: np.ndarray, num_classes: int):
        self.pos = full_pos
        n = len(full_pos)
        self.votes = np.zeros((n, num_classes), np.float32)
        self.prediction_count = np.zeros(n, np.int32)
        self.ins_pre = -np.ones(n, np.int64)
        self.max_instance = 0

    def add_tile(
        self,
        origin_ids: np.ndarray,
        semantic_logits: np.ndarray,
        tile_full_ids: np.ndarray,
        clusters: List[np.ndarray],
        scores: Optional[np.ndarray],
        th_merge: float = 0.1,
    ) -> None:
        """origin_ids: scene row per subsampled tile point; clusters index
        into the tile's subsampled rows."""
        self.votes[origin_ids] += semantic_logits
        self.prediction_count[origin_ids] += 1
        pre_sub = cur_ins_pre_label(clusters, scores, len(origin_ids))
        self.ins_pre, self.max_instance = block_merging(
            self.pos,
            tile_full_ids,
            origin_ids,
            pre_sub,
            self.ins_pre,
            self.max_instance,
            th_merge,
        )

    def finalise(
        self,
        full_pos: Optional[np.ndarray] = None,
        stuff_classes: Tuple[int, ...] = (),
        distance_cutoff: float = 1.0,
        min_instance_size: int = 10,
    ):
        """Project to full resolution and apply the reference's filters.

        ``full_pos``: the original (pre-voxelization) cloud; defaults to the
        accumulator's own cloud.
        Returns (sem_pred [N], ins_pred [N]) in raw label conventions
        (-1 = no instance).
        """
        if full_pos is None:
            full_pos = self.pos
        has_pred = self.prediction_count > 0
        if not has_pred.any():
            return (
                np.zeros(len(full_pos), np.int64),
                -np.ones(len(full_pos), np.int64),
            )
        # semantic: 1-NN vote interpolation to full res (knn_interpolate k=1);
        # queries fan out over all host cores (pure reads, ~4-8x on the
        # 500k-pt scene finalise)
        tree = cKDTree(self.pos[has_pred])
        _, nn = tree.query(full_pos, k=1, workers=-1)
        full_votes = self.votes[has_pred][nn]
        sem = np.argmax(full_votes, axis=1).astype(np.int64)

        # instances: 1-NN from labeled points with distance cutoff
        has_ins = self.ins_pre != -1
        ins = -np.ones(len(full_pos), np.int64)
        if has_ins.any():
            tree2 = cKDTree(self.pos[has_ins])
            d, nn2 = tree2.query(full_pos, k=1, workers=-1)
            ins = self.ins_pre[has_ins][nn2]
            ins[d > distance_cutoff] = -1
        # stuff gets no instance id
        if len(stuff_classes):
            ins[np.isin(sem, np.asarray(stuff_classes))] = -1
        # drop tiny instances (one lookup-table pass, not a per-label scan)
        labs, counts = np.unique(ins[ins != -1], return_counts=True)
        small = labs[counts < min_instance_size]
        if len(small):
            ins[np.isin(ins, small)] = -1
        return sem, ins

    def vote_miou(self, gt: np.ndarray, num_classes: int) -> float:
        from .confusion import ConfusionMatrix

        has = self.prediction_count > 0
        pred = np.argmax(self.votes[has], 1)
        g = gt[has]
        ok = g >= 0
        c = ConfusionMatrix(num_classes)
        c.count_predicted_batch(g[ok], pred[ok])
        return c.get_average_intersection_union() * 100.0
