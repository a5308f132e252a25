"""Instance extraction: membership IoU on the device, greedy NMS on the host.

Counterpart of the JAX package's ``eval/extract.py:extract_clusters`` (the
reference's ``PanopticResults.get_instances``), with the same result. The
JAX version builds a dense bool [p, N] mask and its [p, N] @ [N, p] product
on the host for every tile; here :func:`device_part` builds the masks and
the pairwise IoU on the device (``cluster/nms.py``), and the host receives
the [P, P] IoU, the scores and the membership table, where the greedy
score-descending loop and the filters run as in the JAX code. Counts are
integers below 2^24, so the f32 IoU equals the numpy one bit for bit.

The evaluator computes :func:`device_part` once per dispatch (proposals of
different tiles share no rows, so their IoU is 0 and a tile's block is what
a per-tile computation gives), pulls it with the rest of the dispatch, and
calls :func:`host_part` per tile.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cluster.nms import member_ok, pairwise_iou, proposal_masks
from ..models.pointgroup3heads import Proposals
from ..utils import trace


def device_part(props: Proposals, scores: Optional[torch.Tensor], num_points: int,
                mask_scores: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The device tensors the host extraction needs: the membership table
    (``prop_id`` -1 where the member does not count: invalid, or filtered
    by the mask logits ``mask_scores``, :func:`..cluster.nms.member_ok`),
    per-proposal validity and sample, the scores and, with scores, the
    [P, P] IoU."""
    ok = member_ok(props, mask_scores)
    out = dict(
        prop_id=torch.where(ok, props.prop_id, torch.full_like(props.prop_id, -1)),
        point_idx=props.point_idx,
        prop_valid=props.prop_valid,
        prop_batch=props.prop_batch,
    )
    if scores is not None:
        masks = proposal_masks(props, props.prop_valid.shape[0], num_points, mask_scores)
        out["iou"], _ = pairwise_iou(masks)
        out["scores"] = scores
    return out


# the forward's counters the evaluator sums over a scene
COUNTERS = ("cluster_overflow", "scorer_overflow", "rg_graph_trunc")


def dispatch_outputs(db, out) -> Dict[str, torch.Tensor]:
    """The device tensors one dispatch's tiles need on the host: the
    canonical rows' mask, sample and origin, the semantic logits, the
    forward's counters (those it has: no ScoreNet, no scorer overflow; no
    region growing, no graph truncation) and :func:`device_part` under
    ``p_`` names."""
    fetch = {"mask": db.grid.mask, "batch": db.grid.batch, "origin": db.origin_id,
             "sem": out.semantic_logits}
    fetch.update({k: getattr(out, k) for k in COUNTERS if getattr(out, k) is not None})
    dev = device_part(out.proposals, out.cluster_scores, db.grid.capacity)
    fetch.update({"p_" + k: v for k, v in dev.items()})
    return fetch


def host_part(h: Dict[str, np.ndarray], tile: Optional[int] = None,
              nms_threshold: float = 0.3, min_cluster_points: int = 100,
              min_score: float = 0.5) -> Tuple[List[np.ndarray], List[int]]:
    """Greedy NMS and filters on the pulled :func:`device_part` arrays.
    ``tile``: keep only the proposals of that sample (grouped dispatch).
    Returns (clusters, kept_prop_ids); clusters are arrays of point rows.
    Without scores every proposal is returned unfiltered, matching the
    reference's early exit."""
    pid_all = h["prop_id"]
    ok = pid_all >= 0
    valid = h["prop_valid"]
    if tile is not None:
        ok = ok & (h["prop_batch"][np.maximum(pid_all, 0)] == tile)
        valid = valid & (h["prop_batch"] == tile)
    pid = pid_all[ok]
    pts = h["point_idx"][ok]
    valid_props = np.where(valid)[0]
    order = np.argsort(pid, kind="stable")
    pid_s, pts_s = pid[order], pts[order]
    starts = np.searchsorted(pid_s, valid_props)
    ends = np.searchsorted(pid_s, valid_props + 1)
    members = {int(p): pts_s[s:e] for p, s, e in zip(valid_props, starts, ends) if e > s}
    if not members:
        return [], []
    if "scores" not in h:
        keys = sorted(members)
        return [members[p] for p in keys], keys

    prop_ids = sorted(members)
    iou = h["iou"][np.ix_(prop_ids, prop_ids)]
    sc = np.asarray([h["scores"][pr] for pr in prop_ids])
    suppressed = np.zeros(len(prop_ids), bool)
    picked = []
    for i in np.argsort(-sc):
        if suppressed[i]:
            continue
        picked.append(i)
        suppressed |= iou[i] > nms_threshold
        suppressed[i] = True
    clusters, kept = [], []
    for i in picked:
        m = members[prop_ids[i]]
        if len(m) > min_cluster_points and sc[i] > min_score:
            clusters.append(m)
            kept.append(prop_ids[i])
    return clusters, kept


def pull(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Move a dict of tensors to the host in one device-to-host copy: the
    tensors are packed into one byte buffer (each piece padded to 8 bytes)
    and split again into numpy views of their dtypes and shapes."""
    names = list(tensors)
    parts, meta = [], []
    for name in names:
        t = tensors[name].detach().contiguous()
        b = t.reshape(-1).view(torch.uint8)
        pad = -b.numel() % 8
        parts.append(b if not pad else torch.cat([b, b.new_zeros(pad)]))
        meta.append((t.dtype, tuple(t.shape), b.numel() + pad))
    if parts:
        with trace.host_read("pull"):
            buf = torch.cat(parts).cpu().numpy()
    else:
        buf = np.zeros(0, np.uint8)
    out, ofs = {}, 0
    for name, (dt, shape, nbytes) in zip(names, meta):
        np_dt = torch.empty(0, dtype=dt).numpy().dtype
        count = int(np.prod(shape, dtype=np.int64))
        out[name] = np.frombuffer(buf, dtype=np_dt, count=count, offset=ofs).reshape(shape)
        ofs += nbytes
    return out


def extract_clusters(props: Proposals, scores: Optional[torch.Tensor], num_points: int,
                     mask_scores: Optional[torch.Tensor] = None, nms_threshold: float = 0.3,
                     min_cluster_points: int = 100,
                     min_score: float = 0.5) -> Tuple[List[np.ndarray], List[int]]:
    """Returns (clusters, kept_prop_ids) for proposals on any device; the
    JAX package's host ``extract_clusters`` on the same inputs gives the same
    result. ``mask_scores``: the mask head's member logits (members at or
    below -0.5 leave their proposal)."""
    h = pull(device_part(props, scores, num_points, mask_scores))
    return host_part(h, None, nms_threshold, min_cluster_points, min_score)
