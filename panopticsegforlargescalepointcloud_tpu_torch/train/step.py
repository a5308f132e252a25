"""Eval forward of a batch of tiles (counterpart of the JAX package's
``train/step.py``: ``canonicalize``, the eval half of ``panoptic_forward``
and ``make_eval_forward``).

The port runs eagerly; ``make_eval_forward`` returns a plain function of the
batch arrays. The model carries its own weights (load them with
:func:`..weights.params_from_flax` and ``load_state_dict``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.pointgroup3heads import (
    PanopticConfig,
    PanopticOutput,
    PointGroup3HeadsNet,
    _phase,
    build_proposals,
    scorer_inputs,
)
from ..ops.hierarchy import Hierarchy, build_hierarchy
from ..ops.scatter import segment_max
from ..ops.sparse import SparseGrid, make_grid


class DeviceBatch(NamedTuple):
    """The batch arrays permuted into key-sorted SparseGrid row order."""

    grid: SparseGrid
    feats: torch.Tensor
    pos: torch.Tensor
    y: torch.Tensor
    instance_labels: torch.Tensor
    instance_mask: torch.Tensor
    vote_label: torch.Tensor
    origin_id: torch.Tensor


def _as_tensor(a, device):
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.array(a))  # a copy: callers may pass read-only views
    return a.to(device)


def canonicalize(coords, batch, mask, feats, pos, y, instance_labels, vote_label,
                 origin_id, device=None) -> DeviceBatch:
    """Build the canonical grid and permute the point arrays to its order.

    Inputs are numpy arrays or tensors (the JAX package's ``batch_arrays``
    order). Where two input rows share a voxel, the later row's values are
    kept, deterministically."""
    dev = resolve_device(device)
    coords, batch, mask, feats, pos, y, instance_labels, vote_label, origin_id = (
        _as_tensor(a, dev) for a in
        (coords, batch, mask, feats, pos, y, instance_labels, vote_label, origin_id))
    grid, inverse = make_grid(batch, coords, mask)
    n = coords.shape[0]
    tgt = torch.where(mask, inverse, torch.full_like(inverse, -1))
    # one winner per voxel (the last input row): unique scatter targets
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    winner = segment_max(rows, tgt, n, fill=-1)
    src = winner.clamp(min=0).long()
    has = winner >= 0

    def reorder(arr, fill):
        out = arr[src]
        shape = (n,) + (1,) * (arr.dim() - 1)
        return torch.where(has.reshape(shape), out, torch.full_like(out, fill))

    inst = reorder(instance_labels, 0)
    return DeviceBatch(
        grid=grid,
        feats=reorder(feats, 0),
        pos=reorder(pos, 0),
        y=reorder(y, -1),
        instance_labels=inst,
        instance_mask=(inst > 0) & grid.mask,
        vote_label=reorder(vote_label, 0),
        origin_id=reorder(origin_id, -1),
    )


@torch.no_grad()
def panoptic_forward(cfg: PanopticConfig, model: PointGroup3HeadsNet, db: DeviceBatch,
                     hier: Hierarchy, timer: Optional[Callable] = None) -> PanopticOutput:
    """Backbone + heads, then proposals and ScoreNet scores. ``timer(name)``,
    when given, returns a context manager wrapped around each phase."""
    with _phase(timer, "backbone_heads"):
        x, sem, off, emb = model.backbone_heads(db.feats, hier)
    props, cluster_overflow = build_proposals(
        cfg, db.pos, off, emb, sem, db.grid.batch, db.grid.mask, timer=timer)
    with _phase(timer, "scorenet"):
        sg, shier, sfeats, _, scorer_overflow = scorer_inputs(cfg, props, db.grid.coords, x)
        scores = model.score(sfeats, shier, sg.batch, cfg.total_props)
    return PanopticOutput(
        semantic_logits=sem,
        offset_logits=off,
        embed_logits=emb,
        backbone_feats=x,
        proposals=props,
        cluster_scores=scores,
        scorer_overflow=scorer_overflow,
        cluster_overflow=cluster_overflow,
    )


def make_eval_forward(cfg: PanopticConfig, model: PointGroup3HeadsNet, device=None,
                      timer: Optional[Callable] = None):
    """Inference: ``fwd(arrays) -> (DeviceBatch, PanopticOutput)``,
    with ``arrays`` in the JAX package's ``batch_arrays`` order. Runs on
    ``cuda`` unless ``device="cpu"``; moves the model there in eval mode."""
    dev = resolve_device(device)
    model.to(dev).eval()

    def fwd(arrays):
        with _phase(timer, "hierarchy"):
            db = canonicalize(*arrays, device=dev)
            hier = build_hierarchy(db.grid, cfg.num_down, device=dev)
        return db, panoptic_forward(cfg, model, db, hier, timer)

    return fwd
