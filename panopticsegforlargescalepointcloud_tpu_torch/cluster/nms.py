"""Proposal NMS and instance extraction on the device.

Counterpart of the JAX package's ``cluster/nms.py`` (the reference's
``PanopticResults.get_instances``): pairwise proposal IoU from the
membership-matrix product [P, N] @ [N, P], greedy score-descending NMS at
0.3, then the min-size and min-score filters. The product is one
``torch.matmul``, as the JAX package leaves it to XLA outside any Pallas
kernel; its entries are point counts, exact in f32 below 2^24.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.pointgroup3heads import Proposals


def member_ok(props: Proposals, mask_scores=None) -> torch.Tensor:
    """[M] the membership rows that count: valid, and where the mask head's
    logits ``mask_scores`` [M] are given, above -0.5 (the reference's
    member filter, ``structure_3heads.py:38``)."""
    ok = props.member_valid & (props.prop_id >= 0)
    return ok if mask_scores is None else ok & (mask_scores > -0.5)


def proposal_masks(props: Proposals, num_props: int, num_points: int,
                   mask_scores=None) -> torch.Tensor:
    """Dense [P, N] f32 0/1 membership matrix of the counted members
    (:func:`member_ok`)."""
    ok = member_ok(props, mask_scores) & (props.point_idx >= 0)
    flat = (props.prop_id.long() * num_points + props.point_idx.long())[ok]
    m = torch.zeros(num_props * num_points, dtype=torch.float32, device=ok.device)
    m[flat] = 1.0
    return m.reshape(num_props, num_points)


def pairwise_iou(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(IoU [P, P], sizes [P]) of 0/1 membership rows, in f32."""
    inter = masks @ masks.T
    sizes = masks.sum(dim=1)
    union = sizes[:, None] + sizes[None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)
    return iou, sizes


def greedy_nms(ious: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               threshold: float = 0.3) -> torch.Tensor:
    """Greedy score-descending NMS; returns the keep mask [P]. A loop over
    the P proposals with vectorized suppression, on the device."""
    p = scores.shape[0]
    order = torch.argsort(torch.where(valid, scores, float("-inf")), descending=True,
                          stable=True)
    keep = torch.zeros(p, dtype=torch.bool, device=scores.device)
    suppressed = torch.zeros_like(keep)
    for t in range(p):
        i = order[t]
        active = valid[i] & ~suppressed[i]
        keep[i] = active
        row = (ious[i] > threshold) & active
        row[i] = False
        suppressed |= row
    return keep


def get_instances(props: Proposals, scores: torch.Tensor, num_points: int,
                  mask_scores=None, nms_threshold: float = 0.3, min_cluster_points: int = 100,
                  min_score: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS + filters; returns (keep [P] bool, masks [P, N]): the mask
    logits' member filter (:func:`member_ok`), pairwise-IoU NMS at
    ``nms_threshold``, then size > ``min_cluster_points`` and score >
    ``min_score``."""
    masks = proposal_masks(props, scores.shape[0], num_points, mask_scores)
    ious, sizes = pairwise_iou(masks)
    keep = greedy_nms(ious, scores, props.prop_valid, nms_threshold)
    keep = keep & (sizes > min_cluster_points) & (scores > min_score)
    return keep, masks
