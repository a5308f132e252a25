"""The reference's judgement of each stage of the program's forward.

Clustering turns the heads into integer proposals, and a rounding of the
heads can move a point across a radius or a cluster boundary: with seeded
random weights, which are far from confident, bf16 and f32 heads give
different proposals on many seeds, and everything after them (the
ScoreNet's inputs, the score loss and its gradient, the served instances)
differs by more than any rounding. So the reference follows the program's
state at that one stage and checks the stages on either side by
themselves:

* the heads (semantic log-probabilities, offsets, embeddings) against the
  reference's own, computed from the same inputs and weights
  (:func:`heads_gap`);
* the clustering: the plain copy's ``build_proposals`` on the program's
  heads must give the program's proposals (:func:`clustering_mismatch`);
* from there on the reference takes the program's proposals
  (:class:`Follow`): the scores, the losses and gradients, and on the
  served path the extraction, block merging and finalise.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from .plain.eval.extract import COUNTERS
from .plain.models.pointgroup3heads import Proposals, build_proposals
from .plain.train import step as plain_step

PROPOSAL_FIELDS = ("point_idx", "prop_id", "member_valid", "prop_valid", "prop_batch",
                   "prop_type")


def record(db, out) -> Dict:
    """One forward's rows and outputs (the plain copy's, or the program's
    for :class:`benchmark.capture.ForwardCapture`), detached copies on their
    device; the overflow counters stay tensors, so that recording never
    waits for the device."""
    def keep(t):
        return None if t is None else t.detach().clone()
    rec = {"pos": db.pos, "batch": db.grid.batch, "mask": db.grid.mask, "origin": db.origin_id,
           "coords": db.grid.coords, "sem": out.semantic_logits, "off": out.offset_logits,
           "emb": out.embed_logits, "scores": out.cluster_scores}
    rec = {k: keep(v) for k, v in rec.items()}
    props = out.proposals
    rec["proposals"] = (None if props is None else
                        {k: keep(getattr(props, k)) for k in PROPOSAL_FIELDS})
    rec["counters"] = {k: keep(torch.as_tensor(getattr(out, k))) for k in COUNTERS
                       if getattr(out, k, None) is not None}
    return rec


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """||prog - ref|| / ||ref||, in f64."""
    p, r = prog.double(), ref.to(prog.device).double()
    den = float(r.norm())
    return float((p - r).norm()) / den if den > 0 else float((p - r).norm() > 0)


def same_rows(prog: Dict, ref: Dict) -> bool:
    """Whether both forwards ran on the same canonical rows."""
    return all(torch.equal(prog[k].to(ref[k].device), ref[k])
               for k in ("mask", "batch", "coords", "origin"))


def heads_gap(prog: Dict, ref: Dict) -> float:
    """The worst of the three heads' relative gaps over the valid rows (1
    where the rows differ)."""
    if not same_rows(prog, ref):
        return 1.0
    m = ref["mask"]
    return max(rel_gap(prog[k].to(m.device)[m], ref[k][m]) for k in ("sem", "off", "emb"))


def proposals_of(tensors: Dict[str, torch.Tensor], device) -> Proposals:
    return Proposals(**{k: tensors[k].to(device) for k in PROPOSAL_FIELDS})


def clustering_mismatch(cfg, prog: Dict, device) -> float:
    """The share of proposal-table entries where the plain copy's
    clustering of the program's rows and heads differs from the program's
    proposals."""
    dev = torch.device(device)
    args = [prog[k].to(dev) for k in ("pos", "off", "emb", "sem", "batch", "mask")]
    with torch.no_grad():
        props, _, _ = build_proposals(cfg, *args)
    want = prog["proposals"]
    bad = total = 0
    for k in PROPOSAL_FIELDS:
        a, b = getattr(props, k), want[k].to(dev)
        total += b.numel()
        bad += b.numel() if a.shape != b.shape else int((a != b).sum())
    return bad / max(total, 1)


def score_gap(prog: Dict, ref: Dict) -> Optional[float]:
    """The scores' relative gap over the valid proposals (None without
    scores)."""
    if prog["scores"] is None or ref["scores"] is None:
        return None
    valid = ref["proposals"]["prop_valid"]
    return rel_gap(prog["scores"].to(valid.device)[valid], ref["scores"][valid])


class Follow(contextlib.AbstractContextManager):
    """Inside it, the plain copy's forwards are recorded (``calls``) and
    their clustering hands on the given proposals in turn (``inject``, one
    table per forward) in place of its own."""

    def __init__(self, inject: Optional[List[Dict[str, torch.Tensor]]] = None):
        self.inject = list(inject) if inject is not None else None
        self.calls: List[Dict] = []

    def __enter__(self):
        self._forward, self._build = plain_step.panoptic_forward, plain_step.build_proposals
        forward = self._forward

        def panoptic_forward(cfg, model, db, hier, *a, **kw):
            out = forward(cfg, model, db, hier, *a, **kw)
            with torch.no_grad():
                self.calls.append(record(db, out))
            return out

        def given(cfg, pos, *a, **kw):
            props = proposals_of(self.inject.pop(0), pos.device)
            zero = torch.zeros((), dtype=torch.int32, device=pos.device)
            return props, zero, zero

        plain_step.panoptic_forward = panoptic_forward
        if self.inject is not None:
            plain_step.build_proposals = given
        return self

    def __exit__(self, *exc):
        plain_step.panoptic_forward, plain_step.build_proposals = self._forward, self._build
        return None
