"""The embed family's full train step and the reference's steps over the
benchmark's batches: a frozen copy of the port's ``train/step.py``
(``panoptic_forward``, ``make_loss_and_grads``, ``make_train_step``) on the
embed copy's model, with the plain copy's canonical grid, maps and Adam,
in f32 with TF32 off (or with fp8 conv operands, for the precision
control)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..plain.config import training_config_from_yaml
from ..plain.data import batch_arrays, collate_tiles
from ..plain.models.pointgroup3heads import PanopticOutput
from ..plain.ops.hierarchy import Hierarchy, build_hierarchy
from ..plain.train.optim import make_lr_schedule, make_optimizer, optimizer_step
from ..plain.train.step import DeviceBatch, canonicalize
from ..stages import proposals_of, record
from ..train_ref import Steps, adam_first_grad, no_tf32
from .model import EmbedConfig, PointGroupEmbedNet, build_proposals, embed_config_from_yaml
from .model import panoptic_losses


def panoptic_forward(cfg: EmbedConfig, model: PointGroupEmbedNet, db: DeviceBatch,
                     hier: Hierarchy, momentum=0.1,
                     proposals: Optional[Dict[str, torch.Tensor]] = None) -> PanopticOutput:
    """Backbone + heads, then the proposals: the copy's own clustering of
    the detached heads, or ``proposals`` (a table of
    :func:`..stages.record`) handed on in its place. No scores: the
    configuration has no ScoreNet."""
    x, sem, off, emb, _ = model.backbone_heads(db.feats, hier, momentum, pos=db.pos)
    if proposals is None:
        props, overflow, trunc = build_proposals(cfg, db.pos, off.detach(), emb.detach(),
                                                 sem.detach(), db.grid.batch, db.grid.mask)
    else:
        props = proposals_of(proposals, db.pos.device)
        overflow = trunc = torch.zeros((), dtype=torch.int32, device=db.pos.device)
    return PanopticOutput(semantic_logits=sem, offset_logits=off, embed_logits=emb,
                          backbone_feats=x, proposals=props, cluster_overflow=overflow,
                          rg_graph_trunc=trunc)


def make_train_step(cfg: EmbedConfig, model: PointGroupEmbedNet,
                    optimizer: torch.optim.Optimizer, schedule,
                    grad_clip_value: float | None = None, device="cuda",
                    on_forward: Optional[Callable] = None):
    """``step(arrays, bn_momentum, proposals=None) -> metrics``: the full
    step's forward in training mode, its losses, the backward (every
    parameter off the path, the ScoreNet's, gets a zero gradient, as under
    ``jax.grad``) and one optimizer update. ``on_forward(db, out)`` sees
    each forward."""
    dev = torch.device(device)
    model.to(dev)
    params = list(model.parameters())

    def step(arrays, bn_momentum=0.1, proposals=None) -> Dict[str, torch.Tensor]:
        model.train()
        with torch.no_grad():
            db = canonicalize(*arrays, device=dev)
            hier = build_hierarchy(db.grid, cfg.num_down, device=dev)
        for p in params:
            p.grad = None
        out = panoptic_forward(cfg, model, db, hier, bn_momentum, proposals)
        if on_forward is not None:
            on_forward(db, out)
        total, losses = panoptic_losses(cfg, out, db.y, db.vote_label, db.instance_labels,
                                        db.instance_mask, db.grid.batch, db.grid.mask)
        total.backward()
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if grad_clip_value is not None:
                torch.nn.utils.clip_grad_value_(params, grad_clip_value)
            optimizer_step(optimizer, schedule, 1)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["hier_overflow"] = hier.overflow.sum()
        return metrics

    return step


def run_steps(run_config: dict, weights: Dict[str, torch.Tensor], batches: List[List[dict]],
              capacity: int, compute_dtype: str = "float32", device: str = "cuda",
              proposals: Optional[List[Dict]] = None) -> Steps:
    """Train from ``weights`` over ``batches`` (lists of tile dicts), one
    full step each, as the configuration states, with ``compute_dtype``
    conv operands; with ``proposals`` (one table a step) the steps take
    those in place of their own clustering (no loss term reads them)."""
    if device != "cpu":
        no_tf32()
    num = len(batches[0])
    cfg = embed_config_from_yaml(run_config, num_samples=num, compute_dtype=compute_dtype)
    tc = training_config_from_yaml(run_config)
    model = PointGroupEmbedNet(cfg)
    model.load_state_dict({k: v.to("cpu") for k, v in weights.items()}, strict=True)
    model.to(device)
    optimizer = make_optimizer(tc.optimizer, model.parameters(), tc.weight_decay)
    schedule = make_lr_schedule(tc.scheduler, tc.scheduler_params, tc.lr, tc.steps_per_epoch)
    calls: List[Dict] = []

    def on_forward(db, out):
        with torch.no_grad():
            calls.append(record(db, out))

    step = make_train_step(cfg, model, optimizer, schedule, tc.grad_clip_value, device,
                           on_forward)
    names = {p: n for n, p in model.named_parameters()}
    terms, first = [], None
    for i, tiles in enumerate(batches):
        arrays = batch_arrays(collate_tiles(tiles, capacity=capacity, num_tiles=num))
        given = None if proposals is None else proposals[i]
        terms.append({k: float(v) for k, v in step(arrays, tc.bn_momentum, given).items()})
        if i == 0:
            first = adam_first_grad(optimizer, names)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return Steps([t["loss"] for t in terms], terms, first, params, calls)
