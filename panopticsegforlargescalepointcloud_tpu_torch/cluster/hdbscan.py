"""HDBSCAN-style density grouping, batched over samples (counterpart of the
JAX package's ``cluster/hdbscan.py``; the JAX package has no Pallas kernel
here, so this is plain PyTorch on the device).

Per sample of ``points`` [B, Np, D]:

1. pairwise distances, each point's core distance (the ``min_samples``-th
   nearest, itself included) and the mutual reachability
   ``max(d(a, b), core_a, core_b)``;
2. the exact minimum spanning tree of that graph by Boruvka rounds (masked
   [Np, Np] minimum per component, unions by hook and compress), each merge
   edge recorded;
3. flat clusters: ``selection="eom"`` replays the weight-sorted tree edges
   as the condensed tree's excess-of-mass rule (the root never selected, as
   the reference's ``allow_single_cluster=False``); ``"gap"`` cuts once at
   the first large relative gap of the sorted weights and keeps the
   components;
4. clusters under ``min_cluster_size`` become noise; the others take ids by
   size, at most ``max_clusters``.

Every step is the JAX package's, with its tie rules: ``argmin`` and sorts
keep the lower index (``stable=True``), empty segments reduce to the
dtype's identity. The excess-of-mass replay is sequential over the edges,
one small step of [B, Np] operations per edge; it stops after the last
finite edge of the batch (the steps past it change nothing).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_INF = 3.4e38
_I32_MAX = 2**31 - 1


class HdbscanResult(NamedTuple):
    labels: torch.Tensor  # [B, Np] int32 cluster id per point (-1 noise / pad)
    num_clusters: torch.Tensor  # [B] int32


def _pairwise_d(x: torch.Tensor) -> torch.Tensor:
    """[B, Np, D] -> [B, Np, Np] Euclidean distances through the Gram matrix."""
    sq = (x * x).sum(dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _seg_min(vals: torch.Tensor, seg: torch.Tensor, n_seg: int, init) -> torch.Tensor:
    """Per-row segment minimum: vals, seg [B, M] -> [B, n_seg]; empty
    segments hold ``init`` (the identity of ``jax.ops.segment_min``)."""
    out = torch.full((vals.shape[0], n_seg), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(1, seg.long(), vals, reduce="amin", include_self=True)


def _seg_count(mask: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    out = torch.zeros((mask.shape[0], n_seg), dtype=torch.int32, device=mask.device)
    return out.scatter_add(1, seg.long(), mask.to(torch.int32))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, idx.long())


def _boruvka(mr: torch.Tensor, valid: torch.Tensor, rounds: int):
    """Boruvka components over the finite (< 3.4e38) entries of ``mr``
    [B, n, n] (INF on the diagonal, on invalid rows and columns). Returns
    (comp [B, n] min-id component per point, padding n; (weights, u, v) each
    [B, rounds, n]: the merge edges recorded per round, INF / 0 padded; a
    mutual pick records once, by the smaller component id)."""
    b, n, _ = mr.shape
    dev = mr.device
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    comp = torch.where(valid, idx, torch.full_like(idx, n))
    ws, us, vs = [], [], []
    for _ in range(rounds):
        comp_safe = comp.clamp(max=n - 1)
        same = comp[:, :, None] == comp[:, None, :]
        best_w, best_j = torch.where(same, torch.full_like(mr, _INF), mr).min(dim=2)
        best_j = best_j.to(torch.int32)
        comp_w = _seg_min(best_w, comp, n + 1, float("inf"))[:, :n]
        has_edge = comp_w < _INF
        is_best = (best_w <= _take(comp_w, comp_safe)) & (comp < n) & (best_w < _INF)
        rep = _seg_min(torch.where(is_best, idx, torch.full_like(idx, n)), comp, n + 1,
                       _I32_MAX)[:, :n]
        rep_safe = rep.clamp(max=n - 1)
        pick = _take(best_j, rep_safe)
        target = torch.where(has_edge & (rep < n), _take(comp, pick), idx)
        mutual = _take(target, target.clamp(max=n - 1)) == idx
        rec = has_edge & (~mutual | (idx < target))
        ws.append(torch.where(rec, comp_w, torch.full_like(comp_w, _INF)))
        us.append(torch.where(rec, rep_safe, torch.zeros_like(rep_safe)))
        vs.append(torch.where(rec, pick, torch.zeros_like(pick)))
        lab = idx
        tgt = target.long()
        for _ in range(16):
            lab = torch.minimum(lab, torch.gather(lab, 1, tgt))
            lab = lab.scatter_reduce(1, tgt, lab, reduce="amin", include_self=True)
            lab = torch.minimum(lab, torch.gather(lab, 1, lab.long()))
        comp = torch.where(comp < n, _take(lab, comp_safe), torch.full_like(comp, n))
    return comp, (torch.stack(ws, 1), torch.stack(us, 1), torch.stack(vs, 1))


def _cut_threshold(weights: torch.Tensor, epsilon: float, gap_ratio: float) -> torch.Tensor:
    """[B, E] recorded weights -> [B] cut: the midpoint of the first gap in
    the top half of the sorted weights with w_hi > gap_ratio * w_lo and
    w_hi > epsilon, INF where none qualifies; at least ``epsilon``."""
    w = torch.sort(weights, dim=1, stable=True).values
    finite = w < _INF
    cnt = finite.to(torch.int32).sum(dim=1, keepdim=True)
    pos_hi = torch.arange(1, w.shape[1], dtype=torch.int32, device=w.device)[None, :]
    w_lo, w_hi = w[:, :-1], w[:, 1:]
    ok = (finite[:, 1:] & (w_hi > gap_ratio * torch.clamp(w_lo, min=1e-12))
          & (w_hi > epsilon) & (w_lo > 0) & (2 * pos_hi >= cnt))
    i = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
    tau = torch.where(_take(ok, i), 0.5 * (_take(w_lo, i) + _take(w_hi, i)),
                      torch.full_like(_take(w_lo, i), _INF))[:, 0]
    return torch.clamp(tau, min=epsilon)


def _rank_ids(sizes: torch.Tensor, keep: torch.Tensor, max_clusters: int):
    """Compact ids by size, largest first (ties to the lower id): per root,
    its rank where kept and within ``max_clusters``, else -1."""
    b, n = sizes.shape
    order = torch.argsort(-sizes, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=sizes.device).expand(b, n).contiguous())
    return torch.where(keep & (rank < max_clusters), rank.to(torch.int32),
                       torch.full_like(sizes, -1, dtype=torch.int32))


def _eom_labels(ew, eu, ev, valid, min_cluster_size: int, epsilon: float,
                max_clusters: int):
    """Condensed-tree excess-of-mass selection over the recorded MST edges
    (each [B, E]), replayed leaf to root in increasing weight. Per live
    component: its size, the lambda mass of its condensed node and the
    summed stability of its selected descendants; when two components of
    at least ``min_cluster_size`` points merge at d >= ``epsilon``, each
    node's stability ``mass - size / d`` is compared with its descendants'
    and the larger side is kept (a selected node labels its members with
    its root id). Returns (labels [B, Np], num [B])."""
    b, n = valid.shape
    dev = valid.device
    mcs = min_cluster_size
    order = torch.argsort(ew, dim=1, stable=True)
    take = min(ew.shape[1], n + 16)
    ew, eu, ev = (torch.gather(a, 1, order)[:, :take] for a in (ew, eu, ev))
    # steps past the batch's last finite edge change nothing: stop there
    steps = int((ew < _INF).sum(dim=1).max()) if b else 0
    root = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n).contiguous()
    size = valid.to(torch.int32)
    lam_mass = torch.zeros((b, n), dtype=torch.float32, device=dev)
    sel_stab = torch.zeros_like(lam_mass)
    sel_label = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    eu, ev = eu.long(), ev.long()
    for t in range(steps):
        w = ew[:, t:t + 1]
        ra = torch.gather(root, 1, eu[:, t:t + 1])
        rb = torch.gather(root, 1, ev[:, t:t + 1])
        ia, ib = ra.long(), rb.long()
        ok = (w < _INF) & (ra != rb)
        rc = torch.minimum(ia, ib)
        sa, sb = torch.gather(size, 1, ia), torch.gather(size, 1, ib)
        ma, mb = torch.gather(lam_mass, 1, ia), torch.gather(lam_mass, 1, ib)
        ssa, ssb = torch.gather(sel_stab, 1, ia), torch.gather(sel_stab, 1, ib)
        lam = 1.0 / torch.clamp(w, min=1e-12)
        real_a, real_b = sa >= mcs, sb >= mcs
        both = ok & real_a & real_b
        eval_sel = both & (w >= epsilon)
        stab_a = ma - sa.float() * lam
        stab_b = mb - sb.float() * lam
        in_a, in_b = root == ra, root == rb
        sel_label = torch.where(eval_sel & (stab_a >= ssa) & in_a, ra, sel_label)
        sel_label = torch.where(eval_sel & (stab_b >= ssb) & in_b, rb, sel_label)
        sab = sa + sb
        fsab = sab.float()
        new_mass = torch.where(
            eval_sel, fsab * lam,
            torch.where(both, ma + mb,
                        torch.where(real_a | real_b,
                                    torch.where(real_a, ma, mb)
                                    + torch.where(real_a, sb, sa).float() * lam,
                                    torch.where(sab >= mcs, fsab * lam,
                                                torch.zeros_like(lam)))))
        new_sel = torch.where(eval_sel,
                              torch.maximum(stab_a, ssa) + torch.maximum(stab_b, ssb),
                              ssa + ssb)
        root = torch.where(ok & (in_a | in_b), rc.to(torch.int32), root)
        size = size.scatter(1, rc, torch.where(ok, sab, torch.gather(size, 1, rc)))
        lam_mass = lam_mass.scatter(1, rc, torch.where(ok, new_mass,
                                                       torch.gather(lam_mass, 1, rc)))
        sel_stab = sel_stab.scatter(1, rc, torch.where(ok, new_sel,
                                                       torch.gather(sel_stab, 1, rc)))
    sel_label = torch.where(valid, sel_label, torch.full_like(sel_label, -1))
    has = sel_label >= 0
    sizes = _seg_count(has, torch.where(has, sel_label, torch.full_like(sel_label, n)),
                       n + 1)[:, :n]
    new_id = _rank_ids(sizes, sizes > 0, max_clusters)
    labels = torch.where(has, _take(new_id, sel_label.clamp(min=0)),
                         torch.full_like(sel_label, -1))
    return labels, (new_id >= 0).to(torch.int32).sum(dim=1)


def _compact_labels(comp, valid, min_cluster_size: int, max_clusters: int):
    b, n = comp.shape
    sizes = _seg_count(valid, torch.where(valid, comp, torch.full_like(comp, n)),
                       n + 1)[:, :n]
    keep = sizes >= min_cluster_size
    new_id = _rank_ids(torch.where(keep, sizes, torch.full_like(sizes, -1)), keep,
                       max_clusters)
    labels = torch.where(valid, _take(new_id, comp.clamp(max=n - 1)),
                         torch.full_like(comp, -1))
    return labels, (new_id >= 0).to(torch.int32).sum(dim=1)


def hdbscan_labels(points: torch.Tensor, valid: torch.Tensor, min_samples: int = 5,
                   min_cluster_size: int = 15, epsilon: float = 0.006,
                   max_clusters: int = 32, gap_ratio: float = 1.5,
                   selection: str = "eom") -> HdbscanResult:
    """Batched density grouping of ``points`` [B, Np, D] (rows where
    ``valid`` [B, Np] is false take no part). ``selection`` "eom" (the
    exact excess-of-mass rule) or "gap" (one global cut, a second Boruvka)."""
    if selection not in ("eom", "gap"):
        raise ValueError(f"selection {selection!r} is not 'eom' or 'gap'")
    b, n, _ = points.shape
    rounds = max(int(math.ceil(math.log2(max(n, 2)))) + 1, 4)
    eye = torch.eye(n, dtype=torch.bool, device=points.device)[None]
    d = _pairwise_d(points.float())
    pair_ok = valid[:, :, None] & valid[:, None, :]
    inf = torch.full_like(d, _INF)
    d = torch.where(pair_ok, d, inf)
    k = min(min_samples, n)
    # core distance: the k-th smallest distance with the self distance 0
    core = torch.topk(torch.where(eye, torch.zeros_like(d), d), k, dim=2,
                      largest=False, sorted=True).values[:, :, k - 1]
    core = torch.where(valid, core, torch.full_like(core, _INF))
    mr = torch.maximum(torch.where(eye, inf, d),
                       torch.maximum(core[:, :, None], core[:, None, :]))
    mr = torch.where(pair_ok, mr, inf)
    del d, inf
    _, (weights, eu, ev) = _boruvka(mr, valid, rounds)
    if selection == "eom":
        labels, num = _eom_labels(weights.reshape(b, -1), eu.reshape(b, -1),
                                  ev.reshape(b, -1), valid, min_cluster_size, epsilon,
                                  max_clusters)
    else:
        tau = _cut_threshold(weights.reshape(b, -1), epsilon, gap_ratio)
        mr_cut = torch.where(mr <= tau[:, None, None], mr, torch.full_like(mr, _INF))
        comp, _ = _boruvka(mr_cut, valid, rounds)
        labels, num = _compact_labels(comp, valid, min_cluster_size, max_clusters)
    return HdbscanResult(labels=labels, num_clusters=num)
