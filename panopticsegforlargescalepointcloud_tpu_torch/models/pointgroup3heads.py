"""PointGroup3Heads: backbone + semantic/offset/embed heads + UNet ScoreNet.

Counterpart of the JAX package's ``models/pointgroup3heads.py`` for the 3heads
family: ``backbone_heads``, ``score`` (UNet scorer), ``build_proposals``
(region growing on the configured sources + mean shift on embeddings),
``scorer_inputs`` (the ScoreNet grid, whose batch field is the proposal id
and whose coords are centered per proposal) and ``panoptic_losses``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..cluster.meanshift import mean_shift, pack_by_sample
from ..cluster.region_grow import region_grow_folded
from ..ops.hashing import BitLayout
from ..ops.hierarchy import Hierarchy, build_hierarchy
from ..ops.scatter import scatter_drop, segment_max, segment_min
from ..ops.sparse import make_grid
from .losses import (
    discriminative_loss,
    instance_iou,
    instance_iou_loss,
    offset_loss,
    semantic_nll_loss,
)
from .modules import PointMLP
from .plans import paper_backbone_plan, scorer_unet_plan, tiny_backbone_plan
from .unet import SparseUNet


@dataclasses.dataclass(frozen=True)
class PanopticConfig:
    """Static model + clustering configuration (the model YAML). Field
    meanings and defaults follow the JAX package's PanopticConfig; only the
    fields of the eval forward are kept. There is no switch that selects a
    kernel: on the card the kernels are the path."""

    num_classes: int
    stuff_classes: Tuple[int, ...]
    feat_dim: int = 4
    in_feat: int = 16
    embed_dim: int = 5
    model_family: str = "3heads"
    cluster_type: int = 5
    bandwidth: float = 0.6
    cluster_radius: float = 0.3
    prepare_epoch: int = 30
    scorer_type: str = "unet"
    use_score_net: bool = True
    mask_supervise: bool = False
    min_iou_threshold: float = 0.25
    max_iou_threshold: float = 0.75
    block_merge_th: float = 0.01  # full-scene block merging's IoU threshold
    # loss weights (PointGroup-PAPER yaml loss_weights)
    w_semantic: float = 1.0
    w_offset_norm: float = 0.1
    w_offset_dir: float = 0.1
    w_score: float = 1.0
    w_embed: float = 1.0
    num_samples: int = 4
    max_instances: int = 64  # K, instance ids per sample
    max_props_rg: int = 128
    ms_max_seeds: int = 128
    ms_max_clusters: int = 32
    ms_point_cap: int = 16384
    scorer_capacity_mult: float = 1.0
    # thing-row budget of region growing: a fraction in (0, 1) of the padded
    # rows (rounded up to the dense-pull tile, 2048) or an absolute count
    rg_point_cap: float = 0
    min_cluster_size: int = 10
    # eval-time instance extraction (reference structure_3heads.py:28)
    nms_threshold: float = 0.3
    min_cluster_points: int = 100
    min_score: float = 0.5
    compute_dtype: str = "bfloat16"  # conv gather/GEMM precision (f32 accumulation)
    backbone: str = "paper"  # "paper" (7 levels) | "tiny" (3 levels)
    scorer_bits: Tuple[int, int, int] = (7, 7, 9)

    def __post_init__(self):
        layout = BitLayout(*self.scorer_bits)
        if self.total_props >= layout.max_batch:
            raise ValueError(
                f"scorer_bits {self.scorer_bits} leave only {layout.max_batch - 1} "
                f"proposal ids but the cluster budget needs {self.total_props}; widen "
                f"the proposal-id field (fewer coord bits) or shrink max_props_rg/ms budgets"
            )
        unsupported = []
        if self.model_family != "3heads":
            unsupported.append(f"model_family={self.model_family!r}")
        if self.scorer_type != "unet" or not self.use_score_net:
            unsupported.append(f"scorer_type={self.scorer_type!r}")
        if self.mask_supervise:
            unsupported.append("mask_supervise")
        if self.backbone not in ("paper", "tiny"):
            unsupported.append(f"backbone={self.backbone!r}")
        if unsupported:
            raise NotImplementedError(
                "the PyTorch port does not implement " + ", ".join(unsupported) + " yet")

    @property
    def scorer_layout(self) -> BitLayout:
        return BitLayout(*self.scorer_bits)

    def resolved_point_cap(self, n: int) -> int:
        """Thing-row budget for ``n`` padded rows, clamped to ``n``."""
        cap = self.rg_point_cap
        if not cap:
            return 0
        t = math.ceil(cap * n / 2048.0) * 2048 if 0 < cap < 1 else int(cap)
        return min(t, n)

    @property
    def num_down(self) -> int:
        return 6 if self.backbone == "paper" else 2

    @property
    def rg_sources(self) -> Tuple[str, ...]:
        """Which geometric inputs feed region growing, in tag order."""
        return {1: ("vote",), 2: ("pos", "vote"), 3: (), 4: ("pos",), 5: ("vote",),
                6: ("pos", "vote")}[self.cluster_type]

    @property
    def use_meanshift(self) -> bool:
        return self.cluster_type in (3, 4, 5, 6)

    @property
    def total_props(self) -> int:
        p = len(self.rg_sources) * self.max_props_rg
        if self.use_meanshift:
            p += self.num_samples * self.ms_max_clusters
        return p


class Proposals(NamedTuple):
    """Padded proposal membership table (the JAX package's
    ``models/losses.py:Proposals``)."""

    point_idx: torch.Tensor  # [M] int32 row into the voxel arrays (-1 pad)
    prop_id: torch.Tensor  # [M] int32 proposal id (-1 pad)
    member_valid: torch.Tensor  # [M] bool
    prop_valid: torch.Tensor  # [P] bool
    prop_batch: torch.Tensor  # [P] int32 sample id per proposal (-1 pad)
    prop_type: torch.Tensor  # [P] int32 source tag

    @property
    def budget(self) -> int:
        return self.point_idx.shape[0]


class PanopticOutput(NamedTuple):
    """The clustering fields are None for a forward without clustering
    (the prepare train step)."""

    semantic_logits: torch.Tensor  # [N, C] log-probs
    offset_logits: torch.Tensor  # [N, 3]
    embed_logits: torch.Tensor  # [N, E]
    backbone_feats: torch.Tensor  # [N, F]
    proposals: Optional[Proposals] = None
    cluster_scores: Optional[torch.Tensor] = None  # [P]
    # [] int32 members dropped from the ScoreNet grid
    scorer_overflow: Optional[torch.Tensor] = None
    # [] int32 thing rows past the clustering budgets
    cluster_overflow: Optional[torch.Tensor] = None


class PointGroup3HeadsNet(nn.Module):
    """Backbone + 3 heads (each MLP([F, F], bias=False) -> Linear) + the UNet
    ScoreNet with its sigmoid head. Attribute names follow the flax model."""

    def __init__(self, cfg: PanopticConfig):
        super().__init__()
        self.cfg = cfg
        plan_fn = paper_backbone_plan if cfg.backbone == "paper" else tiny_backbone_plan
        f = cfg.in_feat
        self.backbone = SparseUNet(**plan_fn(cfg.feat_dim, f), compute_dtype=cfg.compute_dtype)
        self.semantic_mlp = PointMLP(f, (f,), use_bias=False)
        self.semantic_out = nn.Linear(f, cfg.num_classes)
        self.offset_mlp = PointMLP(f, (f,), use_bias=False)
        self.offset_out = nn.Linear(f, 3)
        self.embed_mlp = PointMLP(f, (f,), use_bias=False)
        self.embed_out = nn.Linear(f, cfg.embed_dim)
        self.scorer = SparseUNet(**scorer_unet_plan(f), compute_dtype=cfg.compute_dtype)
        self.scorer_head = nn.Linear(f, 1)

    def backbone_heads(self, feats: torch.Tensor, hier: Hierarchy, momentum=0.1):
        """``momentum``: BN momentum of the step (training mode only)."""
        mask = hier.grids[0].mask
        x = self.backbone(feats, hier, momentum)
        sem = torch.log_softmax(self.semantic_out(self.semantic_mlp(x, mask, momentum)), dim=-1)
        off = self.offset_out(self.offset_mlp(x, mask, momentum))
        emb = self.embed_out(self.embed_mlp(x, mask, momentum))
        m = mask[:, None]
        return x, sem, torch.where(m, off, 0.0), torch.where(m, emb, 0.0)

    def score(self, scorer_feats, scorer_hier: Hierarchy, prop_of_row, num_props: int,
              momentum=0.1):
        """ScoreNet -> per-proposal max pool -> sigmoid head: scores [P]."""
        out = self.scorer(scorer_feats, scorer_hier, momentum)
        seg = torch.where(prop_of_row >= 0, prop_of_row, torch.full_like(prop_of_row, -1))
        cluster_feats = segment_max(out, seg, num_props, fill=0.0)
        return torch.sigmoid(self.scorer_head(cluster_feats))[:, 0]


def _phase(timer, name):
    return timer(name) if timer is not None else contextlib.nullcontext()


@torch.no_grad()
def build_proposals(cfg: PanopticConfig, pos, offsets, embeds, sem_logp, batch, valid,
                    timer=None):
    """Run the configured cluster sources and assemble the membership table
    (``num_sources`` blocks of N rows). Returns (proposals, cluster_overflow).
    ``timer(name)``, when given, wraps the region growing and the mean shift.
    Clustering emits integer assignments only, so it runs without autograd
    (the JAX package's ``stop_gradient`` around it)."""
    n = pos.shape[0]
    dev = pos.device
    pred = torch.argmax(sem_logp, dim=-1).to(torch.int32)
    is_stuff = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in cfg.stuff_classes:
        is_stuff = is_stuff | (pred == c)
    thing = valid & ~is_stuff

    point_blocks, prop_valid_parts, prop_batch_parts, prop_type_parts = [], [], [], []
    id_offset = 0
    tag = 0
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    for src in cfg.rg_sources:
        grow_pos = pos + offsets if src == "vote" else pos
        with _phase(timer, "region_growing"):
            rg = region_grow_folded(
                grow_pos, pred, batch, thing,
                radius=cfg.cluster_radius,
                max_proposals=cfg.max_props_rg,
                num_classes=cfg.num_classes,
                num_samples=cfg.num_samples,
                point_cap=cfg.resolved_point_cap(n),
                min_cluster_size=cfg.min_cluster_size,
            )
        overflow = overflow + rg.overflow
        point_blocks.append(torch.where(rg.point_prop >= 0, rg.point_prop + id_offset,
                                        torch.full_like(rg.point_prop, -1)))
        prop_valid_parts.append(rg.prop_valid)
        prop_batch_parts.append(rg.prop_batch)
        prop_type_parts.append(torch.full((cfg.max_props_rg,), tag, dtype=torch.int32,
                                          device=dev))
        id_offset += cfg.max_props_rg
        tag += 1

    if cfg.use_meanshift:
        dense, dvalid, src_row, dropped = pack_by_sample(
            embeds, batch, thing, cfg.num_samples, cfg.ms_point_cap)
        overflow = overflow + dropped
        # samples with <= 3 thing points are skipped, as in the reference
        counts = dvalid.to(torch.int32).sum(dim=1)
        dvalid = dvalid & (counts > 3)[:, None]
        with _phase(timer, "mean_shift"):
            ms = mean_shift(dense, dvalid, bandwidth=cfg.bandwidth,
                            max_seeds=cfg.ms_max_seeds)
        lab = torch.where((ms.labels >= 0) & (ms.labels < cfg.ms_max_clusters), ms.labels,
                          torch.full_like(ms.labels, -1))
        sample_ids = torch.arange(cfg.num_samples, dtype=torch.int32, device=dev)[:, None]
        dense_pid = torch.where(lab >= 0, id_offset + sample_ids * cfg.ms_max_clusters + lab,
                                torch.full_like(lab, -1))
        tgt = torch.where(src_row >= 0, src_row, torch.full_like(src_row, n))
        point_blocks.append(scatter_drop(n, -1, tgt.reshape(-1), dense_pid.reshape(-1)))
        ncl = torch.clamp(ms.num_clusters, max=cfg.ms_max_clusters)
        cl_ids = torch.arange(cfg.ms_max_clusters, dtype=torch.int32, device=dev)
        ms_valid = (cl_ids[None, :] < ncl[:, None]).reshape(-1)
        ms_batch = sample_ids.expand(cfg.num_samples, cfg.ms_max_clusters).reshape(-1)
        prop_valid_parts.append(ms_valid)
        prop_batch_parts.append(torch.where(ms_valid, ms_batch, torch.full_like(ms_batch, -1)))
        prop_type_parts.append(torch.full((cfg.num_samples * cfg.ms_max_clusters,), tag,
                                          dtype=torch.int32, device=dev))

    point_idx = torch.arange(n, dtype=torch.int32, device=dev).repeat(len(point_blocks))
    prop_id = torch.cat(point_blocks)
    member_valid = prop_id >= 0
    props = Proposals(
        point_idx=torch.where(member_valid, point_idx, torch.full_like(point_idx, -1)),
        prop_id=prop_id,
        member_valid=member_valid,
        prop_valid=torch.cat(prop_valid_parts),
        prop_batch=torch.cat(prop_batch_parts),
        prop_type=torch.cat(prop_type_parts),
    )
    return props, overflow


def scorer_inputs(cfg: PanopticConfig, props: Proposals, coords, backbone_feats):
    """The ScoreNet minibatch: one sparse grid with the proposal id in the
    batch field and coords centered on each proposal's bbox midpoint.
    Members outside the bit budget or past the grid capacity are dropped and
    counted. Returns (grid, hier, feats, row_of_member, overflow). The
    ScoreNet features keep their gradient to ``backbone_feats``."""
    bits = cfg.scorer_layout
    m = int(props.budget * cfg.scorer_capacity_mult)
    m = -(-m // 256) * 256
    dev = coords.device
    ok = props.member_valid & (props.prop_id >= 0)
    pt = props.point_idx.clamp(min=0).long()
    seg = torch.where(ok, props.prop_id, torch.full_like(props.prop_id, -1))
    c = coords[pt]
    big = torch.iinfo(torch.int32).max
    cmin = segment_min(torch.where(ok[:, None], c, torch.full_like(c, big)), seg,
                       cfg.total_props, fill=0)
    cmax = segment_max(torch.where(ok[:, None], c, torch.full_like(c, -big)), seg,
                       cfg.total_props, fill=0)
    center = (cmin + cmax) >> 1
    rel = c - center[props.prop_id.clamp(min=0).long()]
    half = torch.tensor([1 << (bits.bx - 1), 1 << (bits.by - 1), 1 << (bits.bz - 1)],
                        dtype=torch.int32, device=dev)
    in_budget = ((rel >= -half) & (rel < half)).all(dim=-1)
    overflow = (ok & ~in_budget).sum().to(torch.int32)
    grid, inverse = make_grid(seg, rel, ok, bits=bits, capacity=m)
    overflow = overflow + (ok & in_budget & (inverse < 0)).sum().to(torch.int32)
    feats = backbone_feats.index_select(0, pt)  # backward: an index_add
    sf = scatter_drop(m, 0.0, torch.where(ok & (inverse >= 0), inverse,
                                          torch.full_like(inverse, m)), feats)
    hier = build_hierarchy(grid, num_down=2, bits=bits, device=dev)
    return grid, hier, sf, inverse, overflow


def panoptic_losses(cfg: PanopticConfig, out: PanopticOutput, labels_y, vote_label,
                    instance_labels, instance_mask, batch, valid,
                    class_weights: torch.Tensor | None = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total loss and its terms (the JAX package's ``panoptic_losses``
    without the mask branch): semantic NLL, offset norm and direction,
    discriminative embedding, and with proposals and scores the ScoreNet's
    IoU loss; the overflow counters ride along as f32 metrics."""
    losses = {"semantic_loss": semantic_nll_loss(out.semantic_logits, labels_y, valid,
                                                 class_weights)}
    total = cfg.w_semantic * losses["semantic_loss"]
    off = offset_loss(out.offset_logits, vote_label, instance_mask & valid)
    losses.update(off)
    total = total + cfg.w_offset_norm * off["offset_norm_loss"]
    total = total + cfg.w_offset_dir * off["offset_dir_loss"]
    disc = discriminative_loss(out.embed_logits, instance_labels, batch, instance_mask & valid,
                               cfg.num_samples, cfg.max_instances)
    losses.update(disc)
    total = total + cfg.w_embed * disc["ins_loss"]
    if out.proposals is not None and out.cluster_scores is not None:
        ious = instance_iou(out.proposals, instance_labels, batch, cfg.num_samples,
                            cfg.max_instances)
        losses["score_loss"] = instance_iou_loss(ious, out.cluster_scores,
                                                 out.proposals.prop_valid,
                                                 cfg.min_iou_threshold, cfg.max_iou_threshold)
        total = total + cfg.w_score * losses["score_loss"]
    if out.scorer_overflow is not None:
        losses["scorer_overflow"] = out.scorer_overflow.float()
    if out.cluster_overflow is not None:
        losses["cluster_overflow"] = out.cluster_overflow.float()
    losses["loss"] = total
    return total, losses
