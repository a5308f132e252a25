"""Panoptic losses: semantic NLL, offset L1 + cosine, discriminative
embedding loss, the ScoreNet's IoU-target BCE and the mask head's BCE.

Counterparts of the JAX package's ``models/losses.py``. Proposals are the
padded membership table (:class:`.pointgroup3heads.Proposals`) and instances
are compact per-sample ids in [1, K], so every reduction is a segment op.
All reductions are f32.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.scatter import segment_mean, segment_sum

IGNORE_LABEL = -1


def semantic_nll_loss(log_probs: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                      class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean NLL over valid rows with label != IGNORE_LABEL; with
    ``class_weights`` [C], torch's weighted form sum(w[y] nll) / sum(w[y])."""
    ok = valid & (labels != IGNORE_LABEL)
    safe = labels.clamp(min=0).long()
    nll = -torch.gather(log_probs.float(), 1, safe[:, None])[:, 0]
    if class_weights is not None:
        w = torch.where(ok, class_weights.float()[safe], 0.0)
        return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)
    nll = torch.where(ok, nll, 0.0)
    return nll.sum() / torch.clamp(ok.float().sum(), min=1.0)


def offset_loss(pred_offsets: torch.Tensor, gt_offsets: torch.Tensor,
                instance_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """L1 + cosine-direction vote loss over instance points, each divided
    by their count (PointGroup eqs. 2-3)."""
    m = instance_mask.float()
    total = m.sum()
    pred = pred_offsets.float()
    gt = gt_offsets.float()
    pt_dist = (pred - gt).abs().sum(dim=-1)
    norm_loss = (pt_dist * m).sum() / (total + 1e-6)
    gt_unit = gt / (torch.linalg.norm(gt, dim=-1)[:, None] + 1e-8)
    pr_unit = pred / (torch.linalg.norm(pred, dim=-1)[:, None] + 1e-8)
    direction_diff = -(gt_unit * pr_unit).sum(dim=-1)
    dir_loss = (direction_diff * m).sum() / (total + 1e-6)
    return {"offset_norm_loss": norm_loss, "offset_dir_loss": dir_loss}


def discriminative_loss(embed: torch.Tensor, instance_labels: torch.Tensor,
                        batch: torch.Tensor, instance_mask: torch.Tensor, num_samples: int,
                        max_instances: int, delta_v: float = 0.5, delta_d: float = 1.5,
                        param_var: float = 1.0, param_dist: float = 1.0,
                        param_reg: float = 0.001) -> Dict[str, torch.Tensor]:
    """Pull / push / regularize embedding loss with L1 distances, per
    sample, then the mean over samples that hold instance points.

    embed [N, E]; instance_labels [N] compact ids in [1, K] (0 = none);
    batch [N]; instance_mask [N] bool; num_samples B and max_instances K."""
    e = embed.float()
    b_count, k_count = num_samples, max_instances
    seg = torch.where(instance_mask, batch * k_count + (instance_labels - 1),
                      torch.full_like(batch, -1))
    n_seg = b_count * k_count
    mu = segment_mean(e, seg, n_seg)  # [B*K, E]
    counts = segment_sum(instance_mask.float(), seg, n_seg)
    present = counts > 0

    # index_select: its backward is an index_add, where the backward of
    # advanced indexing sorts and walks the many rows of each instance
    mu_per_point = mu.index_select(0, seg.clamp(min=0).long())
    d = (e - mu_per_point).abs().sum(dim=-1)
    d = torch.square(torch.clamp(d - delta_v, min=0.0))
    var_per_inst = segment_sum(torch.where(instance_mask, d, 0.0), seg, n_seg) / (counts + 1e-8)
    var_per_inst = var_per_inst.reshape(b_count, k_count)
    present_bk = present.reshape(b_count, k_count)
    n_inst = present_bk.float().sum(dim=1)
    l_var_s = var_per_inst.sum(dim=1) / torch.clamp(n_inst, min=1.0)

    mu_bk = mu.reshape(b_count, k_count, -1)
    pd = (mu_bk[:, :, None, :] - mu_bk[:, None, :, :]).abs().sum(dim=-1)  # [B, K, K]
    push = torch.square(torch.clamp(2.0 * delta_d - pd, min=0.0))
    eye = torch.eye(k_count, dtype=torch.bool, device=e.device)
    pair_ok = present_bk[:, :, None] & present_bk[:, None, :] & ~eye[None]
    n_pairs = pair_ok.float().sum(dim=(1, 2))
    l_dist_s = torch.where(
        n_inst > 1,
        torch.where(pair_ok, push, 0.0).sum(dim=(1, 2)) / torch.clamp(n_pairs, min=1.0),
        0.0,
    )

    reg = mu_bk.abs().sum(dim=-1)  # [B, K]
    l_reg_s = torch.where(present_bk, reg, 0.0).sum(dim=1) / torch.clamp(n_inst, min=1.0)

    has_inst = n_inst > 0
    l_var_s = torch.where(has_inst, l_var_s, 0.0)
    l_reg_s = torch.where(has_inst, l_reg_s, 0.0)
    loss_s = param_var * l_var_s + param_dist * l_dist_s + param_reg * l_reg_s
    denom = torch.clamp(has_inst.float().sum(), min=1.0)
    return {
        "ins_loss": loss_s.sum() / denom,
        "ins_var_loss": (param_var * l_var_s).sum() / denom,
        "ins_dist_loss": (param_dist * l_dist_s).sum() / denom,
        "ins_reg_loss": (param_reg * l_reg_s).sum() / denom,
    }


def instance_iou(proposals, instance_labels: torch.Tensor, batch: torch.Tensor,
                 num_samples: int, max_instances: int,
                 member_pass: torch.Tensor | None = None) -> torch.Tensor:
    """IoU [P, B*K] between every proposal and every GT instance (GT
    instance of a row: batch * K + label - 1); 0 for absent instances and
    invalid proposals. ``member_pass`` [M] bool (the mask-based IoU): the
    members where it is false leave the intersection and the proposal's
    size; GT sizes stay."""
    p = proposals.prop_valid.shape[0]
    n_gt = num_samples * max_instances
    pt = proposals.point_idx.clamp(min=0).long()
    lbl = instance_labels[pt]
    bat = batch[pt]
    member_ok = proposals.member_valid & (proposals.prop_id >= 0)
    if member_pass is not None:
        member_ok = member_ok & member_pass
    minus1 = torch.full_like(proposals.prop_id, -1)
    gt_of_member = torch.where(member_ok & (lbl > 0), bat * max_instances + (lbl - 1), minus1)
    pair = torch.where(gt_of_member >= 0,
                       proposals.prop_id.long() * n_gt + gt_of_member.long(),
                       torch.full_like(gt_of_member, -1, dtype=torch.long))
    inter = segment_sum(torch.ones(pair.shape, dtype=torch.float32, device=pair.device),
                        pair, p * n_gt).reshape(p, n_gt)
    prop_size = segment_sum(member_ok.float(), torch.where(member_ok, proposals.prop_id, minus1), p)
    gt_seg = torch.where(instance_labels > 0, batch * max_instances + (instance_labels - 1),
                         torch.full_like(batch, -1))
    gt_size = segment_sum(torch.ones(gt_seg.shape, dtype=torch.float32, device=gt_seg.device),
                          gt_seg, n_gt)
    union = prop_size[:, None] + gt_size[None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)
    return torch.where(proposals.prop_valid[:, None], iou, 0.0)


def _clip_probs(p: torch.Tensor) -> torch.Tensor:
    """``p`` clipped to [1e-7, 1 - 1e-7] as ``jnp.clip`` clips it: a max then
    a min, whose gradients split at a tie, so a probability that sits on a
    bound (a saturated sigmoid rounds to 1 - 1e-7 in f32) passes half its
    gradient, where ``torch.clamp`` would pass all of it."""
    lo = torch.full((), 1e-7, dtype=torch.float32, device=p.device)
    return torch.minimum(torch.maximum(p.float(), lo), 1.0 - lo)


def instance_iou_loss(ious: torch.Tensor, cluster_scores: torch.Tensor,
                      prop_valid: torch.Tensor, min_iou_threshold: float = 0.25,
                      max_iou_threshold: float = 0.75) -> torch.Tensor:
    """BCE(score, shat), shat the clamped linear ramp of each proposal's max
    IoU (PointGroup eq. 7), averaged over valid proposals."""
    max_iou = ious.max(dim=1).values
    shat = torch.clamp((max_iou - min_iou_threshold) / (max_iou_threshold - min_iou_threshold),
                       0.0, 1.0)
    s = _clip_probs(cluster_scores)
    bce = -(shat * torch.log(s) + (1.0 - shat) * torch.log(1.0 - s))
    m = prop_valid.float()
    return (bce * m).sum() / torch.clamp(m.sum(), min=1.0)


def mask_loss(ious: torch.Tensor, proposals, mask_scores_sigmoid: torch.Tensor,
              instance_labels: torch.Tensor, max_instances: int,
              member_scored: torch.Tensor | None = None) -> torch.Tensor:
    """Per-member BCE of the mask probability against membership in the
    proposal's best GT instance (the first of equal IoUs, as ``argmax``
    picks it), for proposals whose best IoU exceeds 0.5; the others weigh
    0. Normalized over all counted members (``F.binary_cross_entropy``
    with ``weight=``). ``member_scored`` [M] bool leaves out the members
    without a scorer row, whose gathered logit is another row's."""
    max_iou, arg = ious.max(dim=1).values, torch.argmax(ious, dim=1)
    best_label = (arg % max_instances + 1).to(instance_labels.dtype)
    supervised = (max_iou > 0.5) & proposals.prop_valid  # [P]
    pid = proposals.prop_id.clamp(min=0).long()
    member_ok = proposals.member_valid & (proposals.prop_id >= 0)
    if member_scored is not None:
        member_ok = member_ok & member_scored
    sup_m = supervised[pid] & member_ok
    tgt = (instance_labels[proposals.point_idx.clamp(min=0).long()] == best_label[pid]).float()
    s = _clip_probs(mask_scores_sigmoid)
    bce = -(tgt * torch.log(s) + (1.0 - tgt) * torch.log(1.0 - s))
    return (bce * sup_m.float()).sum() / torch.clamp(member_ok.float().sum(), min=1.0)
