"""Eval forward and train step of a batch of tiles (counterpart of the JAX
package's ``train/step.py``: ``canonicalize``, ``panoptic_forward``,
``TrainState``, ``init_state``, ``make_train_step`` and
``make_eval_forward``).

The port runs eagerly; ``make_eval_forward`` and ``make_train_step`` return
plain functions of the batch arrays. The model carries its own weights (load
them with :func:`..weights.params_from_flax` and ``load_state_dict``) and,
as module state, the BN running statistics that a train step updates.

The train step comes in the JAX package's two phases: the *prepare* step
(backbone + heads + point losses) and the *full* step (plus clustering, the
ScoreNet and its score loss).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.modules import ResBlock, SparseConv
from ..models.norm import MaskedBatchNorm
from ..models.point_backbones import KPConvDeformableLayer, KPConvLayer
from ..models.pointgroup3heads import (
    PanopticConfig,
    PanopticOutput,
    PointGroup3HeadsNet,
    _phase,
    build_proposals,
    panoptic_losses,
    scorer_inputs,
)
from ..ops.hierarchy import Hierarchy, build_hierarchy
from ..ops.scatter import segment_max, segment_mean
from ..ops.sparse import SparseGrid, make_grid
from .optim import Schedule, make_optimizer, optimizer_step


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


def panoptic_forward(cfg: PanopticConfig, model: PointGroup3HeadsNet, db: DeviceBatch,
                     hier: Hierarchy, with_clustering: bool = True, momentum=0.1,
                     timer: Optional[Callable] = None, subset_seed=None,
                     epoch: Optional[int] = None) -> PanopticOutput:
    """Backbone + heads, then (``with_clustering``) proposals and their
    scores: the ScoreNet's (``scorer_type`` "unet", "encoder" or "mlp"; with
    the mask head also each member's mask logit, gathered through its
    scorer row, and whether it has one), the semantic certainty
    (``scorer_type`` "": the largest class probability of the members' mean
    log-probabilities) or none (``use_score_net`` false). The model's mode
    decides the BN statistics (``model.train()``: batch statistics, running
    statistics updated with ``momentum``, and the deformable KPConv's
    regularizers in ``internal_losses``) and the caller's grad mode whether
    a graph is built. Clustering runs on detached heads; the scores keep
    their gradient to the backbone. ``subset_seed``: the embed family's
    subset counter (:func:`..models.pointgroup3heads.build_proposals`).
    ``timer(name)``, when given, returns a context manager wrapped around
    each phase. ``epoch``: the mask head's epoch gates
    (:meth:`..models.pointgroup3heads.PanopticConfig.gates`; None opens
    them)."""
    with _phase(timer, "backbone_heads"):
        x, sem, off, emb, internal = model.backbone_heads(db.feats, hier, momentum,
                                                          pos=db.pos)
    internal = internal or None
    if not with_clustering:
        return PanopticOutput(semantic_logits=sem, offset_logits=off, embed_logits=emb,
                              backbone_feats=x, internal_losses=internal)
    props, cluster_overflow, graph_trunc = build_proposals(
        cfg, db.pos, off.detach(), emb.detach(), sem.detach(), db.grid.batch, db.grid.mask,
        timer=timer, subset_seed=subset_seed)
    scores = scorer_overflow = member_mask = mask_row_valid = None
    if cfg.use_score_net and not cfg.scorer_type:
        # semantic certainty (the reference's _compute_score without a scorer)
        ok = props.member_valid & (props.prop_id >= 0)
        seg = torch.where(ok, props.prop_id, torch.full_like(props.prop_id, -1))
        mean_logp = segment_mean(sem[props.point_idx.clamp(min=0).long()] * ok[:, None],
                                 seg, cfg.total_props)
        scores = torch.exp(mean_logp).max(dim=-1).values
        scores = torch.where(props.prop_valid, scores, torch.zeros_like(scores))
    elif cfg.use_score_net:
        with _phase(timer, "scorenet"):
            sg, shier, sfeats, member_row, scorer_overflow = scorer_inputs(
                cfg, props, db.grid.coords, x)
            scores, mask_logits = model.score(sfeats, shier, sg.batch, cfg.total_props,
                                              momentum, epoch)
            if mask_logits is not None:
                # a member dropped from the scorer grid has no row (-1): it
                # must not borrow row 0's logit
                mask_row_valid = member_row >= 0
                member_mask = mask_logits[member_row.clamp(min=0).long()]
    return PanopticOutput(
        semantic_logits=sem,
        offset_logits=off,
        embed_logits=emb,
        backbone_feats=x,
        proposals=props,
        cluster_scores=scores,
        mask_scores=member_mask,
        mask_row_valid=mask_row_valid,
        scorer_overflow=scorer_overflow,
        cluster_overflow=cluster_overflow,
        rg_graph_trunc=graph_trunc,
        internal_losses=internal,
    )


def make_eval_forward(cfg: PanopticConfig, model: PointGroup3HeadsNet, device=None,
                      timer: Optional[Callable] = None, with_clustering: bool = True,
                      epoch: Optional[int] = None):
    """Inference: ``fwd(arrays, subset_seed=None) -> (DeviceBatch,
    PanopticOutput)``, with ``arrays`` in the JAX package's ``batch_arrays``
    order. The embed family's random subsets take ``subset_seed`` (an int,
    or one per sample; 0 when not given); the other families ignore it.
    Runs on ``cuda`` unless ``device="cpu"``; moves the model there and runs
    it in eval mode. ``with_clustering=False`` stops after the heads (the
    trainer's validation before the full phase). ``epoch``: the mask head's
    epoch gates, as in training at that epoch; None (serving) opens them."""
    dev = resolve_device(device)
    model.to(dev)
    embed = cfg.model_family == "embed"

    @torch.no_grad()
    def fwd(arrays, subset_seed=None):
        model.eval()
        with _phase(timer, "hierarchy"):
            db = canonicalize(*arrays, device=dev)
            hier = build_hierarchy(db.grid, cfg.num_down, device=dev)
        seed = (0 if subset_seed is None else subset_seed) if embed else None
        return db, panoptic_forward(cfg, model, db, hier, with_clustering, timer=timer,
                                    subset_seed=seed, epoch=epoch)

    return fwd


# --------------------------------------------------------------------- training

# flax's truncated normal draws in [-2, 2] standard deviations of an
# untruncated normal and rescales by this factor to keep the variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, fan: int, gen: torch.Generator):
    std = math.sqrt(scale / fan) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initializers, as distributions: sparse-conv kernels
    and the ResBlock 1x1 shortcuts variance-scaling 2.0 over fan-out,
    truncated normal (``modules.py:conv_init``); KPConv kernels [P, Cin,
    Cout] (and the deformable offsets') flax's xavier normal (1.0 over the
    mean of fan-in P·Cin and fan-out P·Cout, truncated), offset bias 0; the
    other dense layers flax's lecun normal (1.0 over fan-in, truncated) with
    zero bias; BN scale 1, bias 0, statistics 0 and 1."""
    shortcuts = {id(m.Dense_0) for m in model.modules()
                 if isinstance(m, ResBlock) and hasattr(m, "Dense_0")}
    for m in model.modules():
        if isinstance(m, SparseConv):
            kvol, _, cout = m.kernel.shape
            _variance_scaling_(m.kernel, 2.0, kvol * cout, generator)
        elif isinstance(m, (KPConvLayer, KPConvDeformableLayer)):
            for w in m.parameters(recurse=False):
                if w.dim() == 3:  # kernel, offset_kernel
                    p, cin, cout = w.shape
                    _variance_scaling_(w, 1.0, p * (cin + cout) / 2.0, generator)
                else:  # offset_bias
                    w.zero_()
        elif isinstance(m, nn.Linear):
            if id(m) in shortcuts:
                _variance_scaling_(m.weight, 2.0, m.out_features, generator)
            else:
                _variance_scaling_(m.weight, 1.0, m.in_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MaskedBatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    return model


@dataclasses.dataclass
class TrainState:
    """The model (weights and BN running statistics), its optimizer and the
    torch-convention BN momentum the next step uses. ``step`` counts the
    mini-batches taken, as the JAX package's ``TrainState.step``; the
    schedule's count of updates is the optimizer's ``count``
    (:func:`.optim.optimizer_step`); the two differ under gradient
    accumulation."""

    model: PointGroup3HeadsNet
    optimizer: torch.optim.Optimizer
    bn_momentum: float = 0.1

    @property
    def step(self) -> int:
        return int(self.optimizer.param_groups[0].get("calls", 0))


def init_state(cfg: PanopticConfig, generator: torch.Generator, optimizer: str = "Adam",
               weight_decay: float = 0.0, bn_momentum: float = 0.1, device=None) -> TrainState:
    """A model initialized from ``generator``, on ``device`` (``cuda``
    unless ``device="cpu"``), and its optimizer."""
    dev = resolve_device(device)
    model = init_params(PointGroup3HeadsNet(cfg), generator).to(dev)
    return TrainState(model, make_optimizer(optimizer, model.parameters(), weight_decay),
                      bn_momentum)


def make_loss_and_grads(cfg: PanopticConfig, model: PointGroup3HeadsNet, with_clustering: bool,
                        class_weights=None, device=None, timer: Optional[Callable] = None,
                        epoch: Optional[int] = None):
    """``grads_of(arrays, bn_momentum, subset_seed) -> metrics``: the train
    step's forward in training mode (BN running statistics updated in
    place), its losses and backward, leaving every parameter's gradient in
    ``p.grad``: a parameter off this phase's path (the ScoreNet in the
    prepare step) gets a zero gradient, as under ``jax.grad``, so that the
    optimizer updates every parameter at every step. ``metrics`` holds every
    loss term, ``loss`` and ``hier_overflow`` as 0-dim tensors on the
    device. ``subset_seed``: the embed family's subset counter (None: the
    fixed subsets). :func:`make_train_step` and the data-parallel step
    (:func:`..parallel.make_parallel_train_step`) finish it."""
    dev = resolve_device(device)
    model.to(dev)
    cw = None if class_weights is None else torch.as_tensor(class_weights, dtype=torch.float32,
                                                            device=dev)
    params = list(model.parameters())

    def grads_of(arrays, bn_momentum, subset_seed) -> Dict[str, torch.Tensor]:
        model.train()
        with torch.no_grad(), _phase(timer, "hierarchy"):
            db = canonicalize(*arrays, device=dev)
            hier = build_hierarchy(db.grid, cfg.num_down, device=dev)
        for p in params:
            p.grad = None
        out = panoptic_forward(cfg, model, db, hier, with_clustering, bn_momentum, timer,
                               subset_seed=subset_seed, epoch=epoch)
        with _phase(timer, "losses"):
            total, losses = panoptic_losses(cfg, out, db.y, db.vote_label, db.instance_labels,
                                            db.instance_mask, db.grid.batch, db.grid.mask, cw,
                                            epoch)
        with _phase(timer, "backward"):
            total.backward()
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["hier_overflow"] = hier.overflow.sum()
        return metrics

    return grads_of


def make_train_step(cfg: PanopticConfig, model: PointGroup3HeadsNet,
                    optimizer: torch.optim.Optimizer, schedule: Schedule,
                    with_clustering: bool, grad_clip_value: float | None = None,
                    class_weights=None, device=None, timer: Optional[Callable] = None,
                    grad_accum: int = 1, epoch: Optional[int] = None):
    """``step(arrays, bn_momentum) -> metrics``: one forward in training
    mode, the losses, the backward (:func:`make_loss_and_grads`) and
    :func:`.optim.optimizer_step`: one optimizer update at
    ``schedule(count)``, or with ``grad_accum`` k > 1 one update every k-th
    call with the mean of the k clipped gradients. The weights, the
    optimizer state and the BN running statistics (these on every call) are
    updated in place. ``metrics`` holds every loss term, ``loss`` and
    ``hier_overflow`` as 0-dim tensors on the device. Runs on ``cuda``
    unless ``device="cpu"``; moves the model there. ``grad_clip_value``
    clips each gradient element to [-v, v]. ``timer(name)``, when given,
    wraps each phase (hierarchy, backbone_heads, region_growing,
    mean_shift, scorenet, losses, backward, optimizer). ``epoch``: the mask
    head's epoch gates (None opens them); the trainer builds one step per
    gate state."""
    grads_of = make_loss_and_grads(cfg, model, with_clustering, class_weights, device, timer,
                                   epoch)
    params = list(model.parameters())

    def step(arrays, bn_momentum=0.1) -> Dict[str, torch.Tensor]:
        # the embed family's subsets are drawn from the count of
        # mini-batches taken, as the JAX step passes ``state.step``
        count = int(optimizer.param_groups[0].get("calls", 0))
        metrics = grads_of(arrays, bn_momentum, count)
        with torch.no_grad(), _phase(timer, "optimizer"):
            if grad_clip_value is not None:
                torch.nn.utils.clip_grad_value_(params, grad_clip_value)
            optimizer_step(optimizer, schedule, grad_accum)
        return metrics

    return step
