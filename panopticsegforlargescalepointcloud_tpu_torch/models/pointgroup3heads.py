"""PointGroup3Heads and PointGroupEmbed: backbone + semantic/offset/embed
heads + ScoreNet.

Counterpart of the JAX package's ``models/pointgroup3heads.py`` for both
families of the paper's ablation table: ``backbone_heads`` (the embed
family has no offset head), ``score`` (the UNet scorer with its optional
mask head, the sparse-conv encoder or the per-row MLP), ``build_proposals``
(3heads: region growing on the configured sources + mean shift on
embeddings; embed: the ``EMBED_STRATEGIES`` ops, mean shift and HDBSCAN on
random dimension subsets and region growing on positions),
``scorer_inputs`` (the ScoreNet grid, whose batch field is the proposal id
and whose coords are centered per proposal) and ``panoptic_losses``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..cluster.hdbscan import hdbscan_labels
from ..cluster.meanshift import mean_shift, pack_by_sample
from ..cluster.region_grow import region_grow_folded
from ..ops.hashing import BitLayout
from ..ops.hierarchy import Hierarchy, build_hierarchy
from ..ops.scatter import scatter_drop, segment_max, segment_min
from ..ops.sparse import make_grid
from ..utils import prng
from .losses import (
    discriminative_loss,
    instance_iou,
    instance_iou_loss,
    mask_loss,
    offset_loss,
    semantic_nll_loss,
)
from .modules import PointMLP
from .plans import (
    paper_backbone_plan,
    scorer_encoder_plan,
    scorer_unet_plan,
    tiny_backbone_plan,
)
from .point_backbones import KPConvBackbone, PointNet2Backbone
from .unet import SparseEncoder, SparseUNet

# PointGroupEmbed strategy table (Setting I family), the JAX package's
# EMBED_STRATEGIES: every op is (method, space, loops, low, high). loops 0:
# one run on the whole space; loops L: L runs, each on a random subset of
# [low, high] dimensions of the space. Spaces: "xyz" raw positions, "embed"
# the embedding head's output, "both" their concatenation; "rg" ops grow
# regions on raw positions.
EMBED_STRATEGIES = {
    1: (("hdbscan", "xyz", 0, 0, 0), ("hdbscan", "embed", 0, 0, 0)),
    2: (("hdbscan", "both", 9, 3, 5), ("hdbscan", "embed", 0, 0, 0)),
    3: (("hdbscan", "both", 9, 3, 5), ("hdbscan", "xyz", 0, 0, 0)),
    4: (("hdbscan", "both", 8, 3, 5), ("hdbscan", "embed", 0, 0, 0),
        ("hdbscan", "xyz", 0, 0, 0)),
    5: (("hdbscan", "both", 10, 3, 5),),
    6: (("hdbscan", "embed", 6, 2, 5),),
    7: (("meanshift", "embed", 0, 0, 0),),
    8: (("rg", "pos", 0, 0, 0), ("meanshift", "embed", 0, 0, 0)),
    9: (("rg", "pos", 0, 0, 0), ("meanshift", "embed", 10, 3, 5)),
    10: (("meanshift", "embed", 6, 2, 5),),
    11: (("hdbscan", "embed", 6, 2, 5),),
    12: (("rg", "pos", 0, 0, 0), ("meanshift", "embed", 6, 2, 5)),
    13: (("hdbscan", "embed", 6, 2, 5), ("hdbscan", "xyz", 0, 0, 0)),
    14: (("hdbscan", "embed", 0, 0, 0),),
    15: (("meanshift", "embed", 6, 2, 5), ("hdbscan", "embed", 0, 0, 0)),
    16: (("hdbscan", "embed", 6, 2, 5), ("meanshift", "embed", 0, 0, 0)),
}


@dataclasses.dataclass(frozen=True)
class PanopticConfig:
    """Static model + clustering configuration (the model YAML). Field
    meanings and defaults follow the JAX package's PanopticConfig; only the
    fields of the port's paths are kept. There is no switch that selects a
    kernel: on the card the kernels are the path."""

    num_classes: int
    stuff_classes: Tuple[int, ...]
    feat_dim: int = 4
    in_feat: int = 16
    embed_dim: int = 5
    # "3heads" (PointGroup3Heads, Settings II-V) or "embed" (PointGroupEmbed,
    # Setting I: no offset head, cluster strategies from EMBED_STRATEGIES)
    model_family: str = "3heads"
    cluster_type: int = 5
    bandwidth: float = 0.6
    cluster_radius: float = 0.3
    prepare_epoch: int = 30
    # "unet" | "encoder" | "mlp" | "" (semantic certainty: the members' mean
    # class probability)
    scorer_type: str = "unet"
    use_score_net: bool = True
    # the mask head on the UNet scorer's rows (mask_score_a, mask_score_b)
    mask_supervise: bool = False
    # the score feature keeps only rows whose mask probability reaches the
    # threshold, once epoch > start epoch (or with the gates open, epoch None)
    use_mask_filter_score_feature: bool = False
    use_mask_filter_score_feature_start_epoch: int = 200
    mask_filter_score_feature_thre: float = 0.5
    # IoU targets of the score loss count only the members whose mask
    # probability passes 0.5, once epoch > start epoch
    cal_iou_based_on_mask: bool = False
    cal_iou_based_on_mask_start_epoch: int = 200
    min_iou_threshold: float = 0.25
    max_iou_threshold: float = 0.75
    block_merge_th: float = 0.01  # full-scene block merging's IoU threshold
    # loss weights (PointGroup-PAPER yaml loss_weights)
    w_semantic: float = 1.0
    w_offset_norm: float = 0.1
    w_offset_dir: float = 0.1
    w_score: float = 1.0
    w_embed: float = 1.0
    w_mask: float = 1.0
    num_samples: int = 4
    max_instances: int = 64  # K, instance ids per sample
    max_props_rg: int = 128
    ms_max_seeds: int = 128
    ms_max_clusters: int = 32
    ms_point_cap: int = 16384
    scorer_capacity_mult: float = 1.0
    # thing-row budget of region growing: a fraction in (0, 1) of the padded
    # rows (rounded up to the dense-pull tile, 2048) or an absolute count;
    # 0 grows on all rows by the edge path
    rg_point_cap: float = 0
    # the edge path's budgets: forward (and reverse) edges a row, candidate
    # rows scanned a cell
    rg_k_neighbors: int = 16
    rg_cell_cap: int = 8
    # the dense pull (kernel B) over the compacted rows: "on" | "off" (the
    # edge path) | "auto". "auto" means on, on the card and on the CPU: B is
    # the port's counterpart of the TPU's dense pull, which the JAX
    # package's "auto" takes on a TPU only
    rg_dense: str = "auto"
    min_cluster_size: int = 10
    # HDBSCAN (embed family; the reference's hdbscan_cluster.py settings)
    hd_min_samples: int = 5
    hd_min_cluster_size: int = 15
    hd_epsilon: float = 0.006
    hd_max_clusters: int = 32  # per sample, runs on the whole space
    hd_point_cap: int = 2048  # thing points per sample fed to HDBSCAN
    hd_selection: str = "eom"  # excess of mass (exact) | "gap" (one cut)
    loop_max_clusters: int = 8  # per sample per random-subset run
    embed_subset_seed: int = 0  # the subsets' base key
    # eval-time instance extraction (reference structure_3heads.py:28)
    nms_threshold: float = 0.3
    min_cluster_points: int = 100
    min_score: float = 0.5
    compute_dtype: str = "bfloat16"  # conv gather/GEMM precision (f32 accumulation)
    # "paper" (7-level sparse UNet) | "tiny" (3 levels) | "kpconv" (kernel-point
    # conv UNet, reference KPConvPaper) | "pointnet2" (PointNet++ MSG UNet)
    backbone: str = "paper"
    # the point backbones (models/point_backbones.py): grid_size is the data
    # voxel size in meters, level l's neighbourhoods scale with grid_size * 2^l
    grid_size: float = 0.2
    point_levels: int = 4  # strided levels of the point backbones
    kp_base_channels: int = 64
    kp_num_kernel_points: int = 15
    kp_sigma: float = 1.0
    kp_max_neighbors: int = 16
    # deformable kernel points past the stem; their regularizers weigh into
    # the loss by lambda_internal_losses
    kp_deformable: bool = False
    kp_modulated: bool = False
    kp_loss_mode: str = "fitting"  # "fitting" (+ repulsion) | "permissive"
    lambda_internal_losses: float = 0.1
    pn2_base_channels: int = 32
    pn2_radius_scale: float = 2.5
    pn2_nsample: int = 16
    # candidate budget per hash cell of the point backbones' radius queries
    point_cell_cap: int = 16
    scorer_bits: Tuple[int, int, int] = (7, 7, 9)

    def __post_init__(self):
        layout = BitLayout(*self.scorer_bits)
        if self.total_props >= layout.max_batch:
            raise ValueError(
                f"scorer_bits {self.scorer_bits} leave only {layout.max_batch - 1} "
                f"proposal ids but the cluster budget needs {self.total_props}; widen "
                f"the proposal-id field (fewer coord bits) or shrink max_props_rg/ms budgets"
            )

    @property
    def scorer_layout(self) -> BitLayout:
        return BitLayout(*self.scorer_bits)

    @property
    def rg_dense_enabled(self) -> bool:
        """Region growing pulls densely (kernel B): a compaction budget and
        ``rg_dense`` not "off"."""
        if not self.rg_point_cap:
            return False
        return self.rg_dense == "auto" or self.rg_dense in (True, "on", "true", "1")

    @property
    def has_mask_head(self) -> bool:
        """The mask head sits on the UNet scorer only (the flax tree has its
        weights nowhere else)."""
        return self.mask_supervise and self.scorer_type not in ("encoder", "mlp")

    def gates(self, epoch: Optional[int]) -> Tuple[bool, bool]:
        """The epoch gates of the mask head: (score-feature filter, mask IoU
        targets), each on where its flag is set and ``epoch`` is None or
        past its start epoch. The trainer keys its steps by this pair."""
        def past(start):
            return epoch is None or epoch > start
        return (self.mask_supervise and self.use_mask_filter_score_feature
                and past(self.use_mask_filter_score_feature_start_epoch),
                self.mask_supervise and self.cal_iou_based_on_mask
                and past(self.cal_iou_based_on_mask_start_epoch))

    def resolved_point_cap(self, n: int) -> int:
        """Thing-row budget for ``n`` padded rows, clamped to ``n``."""
        cap = self.rg_point_cap
        if not cap:
            return 0
        t = math.ceil(cap * n / 2048.0) * 2048 if 0 < cap < 1 else int(cap)
        return min(t, n)

    @property
    def is_point_backbone(self) -> bool:
        return self.backbone in ("kpconv", "pointnet2")

    @property
    def num_down(self) -> int:
        if self.is_point_backbone:
            return self.point_levels
        return 6 if self.backbone == "paper" else 2

    @property
    def has_offset(self) -> bool:
        return self.model_family != "embed"

    @property
    def embed_ops(self) -> Tuple[Tuple, ...]:
        return EMBED_STRATEGIES[self.cluster_type]

    @property
    def num_sources(self) -> int:
        if self.model_family == "embed":
            return len(self.embed_ops)
        return {1: 1, 2: 2, 3: 1, 4: 2, 5: 2, 6: 3}[self.cluster_type]

    @property
    def rg_sources(self) -> Tuple[str, ...]:
        """Which geometric inputs feed region growing, in tag order."""
        if self.model_family == "embed":
            return tuple(op[1] for op in self.embed_ops if op[0] == "rg")
        return {1: ("vote",), 2: ("pos", "vote"), 3: (), 4: ("pos",), 5: ("vote",),
                6: ("pos", "vote")}[self.cluster_type]

    @property
    def use_meanshift(self) -> bool:
        if self.model_family == "embed":
            return any(op[0] == "meanshift" for op in self.embed_ops)
        return self.cluster_type in (3, 4, 5, 6)

    def _op_budget(self, op) -> int:
        method, _, loops, _, _ = op
        if method == "rg":
            return self.max_props_rg
        return self.num_samples * self._op_max_clusters(op) * max(loops, 1)

    def _op_max_clusters(self, op) -> int:
        """Proposals per sample per run of a clustering op."""
        method, _, loops, _, _ = op
        if loops > 0:
            return self.loop_max_clusters
        return self.hd_max_clusters if method == "hdbscan" else self.ms_max_clusters

    @property
    def total_props(self) -> int:
        if self.model_family == "embed":
            return sum(self._op_budget(op) for op in self.embed_ops)
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
    mask_scores: Optional[torch.Tensor] = None  # [M] mask logit of each member (mask head)
    mask_row_valid: Optional[torch.Tensor] = None  # [M] the member has a scorer row
    # [] int32 members dropped from the ScoreNet grid
    scorer_overflow: Optional[torch.Tensor] = None
    # [] int32 thing rows past the clustering budgets
    cluster_overflow: Optional[torch.Tensor] = None
    # [] int32 rows whose radius-graph edges were truncated (edge path)
    rg_graph_trunc: Optional[torch.Tensor] = None
    # the deformable KPConv's regularizers, summed per name (training mode)
    internal_losses: Optional[Dict[str, torch.Tensor]] = None


def make_backbone(cfg: PanopticConfig) -> nn.Module:
    """The feature extractor ``cfg.backbone`` selects: [N, feat_dim] ->
    [N, in_feat]."""
    if cfg.backbone == "kpconv":
        return KPConvBackbone(
            cfg.feat_dim, num_levels=cfg.point_levels, base_channels=cfg.kp_base_channels,
            out_nc=cfg.in_feat, grid_size=cfg.grid_size, sigma=cfg.kp_sigma,
            num_kernel_points=cfg.kp_num_kernel_points, max_neighbors=cfg.kp_max_neighbors,
            cell_cap=cfg.point_cell_cap, deformable=cfg.kp_deformable,
            modulated=cfg.kp_modulated, loss_mode=cfg.kp_loss_mode,
            compute_dtype=cfg.compute_dtype)
    if cfg.backbone == "pointnet2":
        return PointNet2Backbone(
            cfg.feat_dim, num_levels=cfg.point_levels, base_channels=cfg.pn2_base_channels,
            out_nc=cfg.in_feat, grid_size=cfg.grid_size, radius_scale=cfg.pn2_radius_scale,
            nsample=cfg.pn2_nsample, cell_cap=cfg.point_cell_cap,
            compute_dtype=cfg.compute_dtype)
    plan_fn = paper_backbone_plan if cfg.backbone == "paper" else tiny_backbone_plan
    return SparseUNet(**plan_fn(cfg.feat_dim, cfg.in_feat), compute_dtype=cfg.compute_dtype)


class PointGroup3HeadsNet(nn.Module):
    """Backbone + 3 heads (each MLP([F, F], bias=False) -> Linear) + the
    ScoreNet with its sigmoid head. Attribute names follow the flax model,
    and the modules are those whose weights the flax tree holds (its init
    creates only what it calls): ``scorer_encoder`` for ``scorer_type``
    "encoder", ``scorer_mlp`` for "mlp", the UNet ``scorer`` otherwise, and
    with it ``mask_score_a``/``_b`` under ``mask_supervise``. The embed
    family has no offset head; the ScoreNet weights exist even where no
    forward uses them (``use_score_net`` false, or the semantic-certainty
    score)."""

    def __init__(self, cfg: PanopticConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.in_feat
        self.backbone = make_backbone(cfg)
        self.semantic_mlp = PointMLP(f, (f,), use_bias=False)
        self.semantic_out = nn.Linear(f, cfg.num_classes)
        if cfg.has_offset:
            self.offset_mlp = PointMLP(f, (f,), use_bias=False)
            self.offset_out = nn.Linear(f, 3)
        self.embed_mlp = PointMLP(f, (f,), use_bias=False)
        self.embed_out = nn.Linear(f, cfg.embed_dim)
        if cfg.scorer_type == "encoder":
            self.scorer_encoder = SparseEncoder(**scorer_encoder_plan(f),
                                                num_segments=cfg.total_props,
                                                compute_dtype=cfg.compute_dtype)
        elif cfg.scorer_type == "mlp":
            self.scorer_mlp = PointMLP(f, (f, f))  # the reference's ScorerMLP
        else:
            self.scorer = SparseUNet(**scorer_unet_plan(f), compute_dtype=cfg.compute_dtype)
        self.scorer_head = nn.Linear(f, 1)
        if cfg.has_mask_head:
            self.mask_score_a = nn.Linear(f, f)
            self.mask_score_b = nn.Linear(f, 1)

    def backbone_heads(self, feats: torch.Tensor, hier: Hierarchy, momentum=0.1, *,
                       pos: torch.Tensor):
        """(features, semantic log-probs, offsets, embeddings, internal
        losses). ``momentum``: BN momentum of the step (training mode
        only); ``pos`` [N, 3]: the rows' positions, which the point
        backbones take. The internal losses (the deformable KPConv's
        regularizers) are empty but in training mode."""
        mask = hier.grids[0].mask
        internal: Dict[str, torch.Tensor] = {}
        if self.cfg.is_point_backbone:
            x, internal = self.backbone(feats, pos, hier, momentum)
        else:
            x = self.backbone(feats, hier, momentum)
        sem = torch.log_softmax(self.semantic_out(self.semantic_mlp(x, mask, momentum)), dim=-1)
        if self.cfg.has_offset:
            off = self.offset_out(self.offset_mlp(x, mask, momentum))
        else:
            off = x.new_zeros((x.shape[0], 3))
        emb = self.embed_out(self.embed_mlp(x, mask, momentum))
        m = mask[:, None]
        return x, sem, torch.where(m, off, 0.0), torch.where(m, emb, 0.0), internal

    def score(self, scorer_feats, scorer_hier: Hierarchy, prop_of_row, num_props: int,
              momentum=0.1, epoch: Optional[int] = None):
        """ScoreNet -> per-proposal max pool -> sigmoid head: (scores [P],
        mask logits [rows] or None). The encoder pools per proposal itself
        (the coarsest grid's batch field); the MLP and the UNet scorer pool
        their rows by ``prop_of_row``. Under the mask head, the score
        feature keeps only rows whose mask probability reaches
        ``mask_filter_score_feature_thre`` where the filter's epoch gate is
        open (:meth:`PanopticConfig.gates`; ``epoch`` None opens it)."""
        cfg = self.cfg
        if cfg.scorer_type == "encoder":
            cluster_feats = self.scorer_encoder(scorer_feats, scorer_hier, momentum, num_props)
            return torch.sigmoid(self.scorer_head(cluster_feats))[:, 0], None
        mask_logits = None
        if cfg.scorer_type == "mlp":
            out = self.scorer_mlp(scorer_feats, scorer_hier.grids[0].mask, momentum)
        else:
            out = self.scorer(scorer_feats, scorer_hier, momentum)
            if cfg.mask_supervise:
                mask_logits = self.mask_score_b(F.relu(self.mask_score_a(out)))[:, 0]
                if cfg.gates(epoch)[0]:
                    keep = torch.sigmoid(mask_logits) >= cfg.mask_filter_score_feature_thre
                    out = out * keep[:, None]
        seg = torch.where(prop_of_row >= 0, prop_of_row, torch.full_like(prop_of_row, -1))
        cluster_feats = segment_max(out, seg, num_props, fill=0.0)
        return torch.sigmoid(self.scorer_head(cluster_feats))[:, 0], mask_logits


def _phase(timer, name):
    return timer(name) if timer is not None else contextlib.nullcontext()


class _Blocks:
    """The membership table under construction: one block of N rows per
    clustering run, in tag order, each with its proposals' validity, sample
    and tag; ids are laid out run after run."""

    def __init__(self, n: int, dev):
        self.n, self.dev = n, dev
        self.points, self.valid, self.batch, self.type = [], [], [], []
        self.id_offset = 0
        self.graph_trunc = torch.zeros((), dtype=torch.int32, device=dev)

    def add_region_growing(self, rg) -> None:
        self.graph_trunc = self.graph_trunc + rg.graph_trunc
        self.points.append(torch.where(rg.point_prop >= 0, rg.point_prop + self.id_offset,
                                       torch.full_like(rg.point_prop, -1)))
        self.valid.append(rg.prop_valid)
        self.batch.append(rg.prop_batch)
        self._next(rg.prop_valid.shape[0])

    def add_per_sample(self, lab, ncl, percap: int, src_row) -> None:
        """A run of per-sample clusters: ``lab`` [B, Np] in [0, percap) or -1,
        ``ncl`` [B] clusters per sample, ``src_row`` [B, Np] the flat row of
        each packed point (-1 pad); proposal ids ``sample * percap + lab``."""
        b = lab.shape[0]
        sample_ids = torch.arange(b, dtype=torch.int32, device=self.dev)[:, None]
        pid = torch.where(lab >= 0, self.id_offset + sample_ids * percap + lab,
                          torch.full_like(lab, -1))
        tgt = torch.where(src_row >= 0, src_row, torch.full_like(src_row, self.n))
        self.points.append(scatter_drop(self.n, -1, tgt.reshape(-1), pid.reshape(-1)))
        cl_ids = torch.arange(percap, dtype=torch.int32, device=self.dev)
        pv = (cl_ids[None, :] < ncl[:, None]).reshape(-1)
        pb = sample_ids.expand(b, percap).reshape(-1)
        self.valid.append(pv)
        self.batch.append(torch.where(pv, pb, torch.full_like(pb, -1)))
        self._next(b * percap)

    def _next(self, num_ids: int) -> None:
        self.type.append(torch.full((num_ids,), len(self.type), dtype=torch.int32,
                                    device=self.dev))
        self.id_offset += num_ids

    def proposals(self) -> Proposals:
        point_idx = torch.arange(self.n, dtype=torch.int32, device=self.dev).repeat(
            len(self.points))
        prop_id = torch.cat(self.points)
        member_valid = prop_id >= 0
        return Proposals(
            point_idx=torch.where(member_valid, point_idx, torch.full_like(point_idx, -1)),
            prop_id=prop_id,
            member_valid=member_valid,
            prop_valid=torch.cat(self.valid),
            prop_batch=torch.cat(self.batch),
            prop_type=torch.cat(self.type),
        )


def _region_grow(cfg: PanopticConfig, grow_pos, pred, batch, thing, timer):
    with _phase(timer, "region_growing"):
        return region_grow_folded(
            grow_pos, pred, batch, thing,
            radius=cfg.cluster_radius,
            max_proposals=cfg.max_props_rg,
            num_classes=cfg.num_classes,
            num_samples=cfg.num_samples,
            point_cap=cfg.resolved_point_cap(grow_pos.shape[0]),
            min_cluster_size=cfg.min_cluster_size,
            k_neighbors=cfg.rg_k_neighbors,
            cell_cap=cfg.rg_cell_cap,
            dense_pull=cfg.rg_dense_enabled,
        )


def _ms_labels(ms, percap: int):
    """Mean-shift clusters past ``percap`` per sample become unassigned."""
    lab = torch.where((ms.labels >= 0) & (ms.labels < percap), ms.labels,
                      torch.full_like(ms.labels, -1))
    return lab, torch.clamp(ms.num_clusters, max=percap)


@torch.no_grad()
def build_proposals(cfg: PanopticConfig, pos, offsets, embeds, sem_logp, batch, valid,
                    timer=None, subset_seed=None):
    """Run the configured cluster sources and assemble the membership table
    (``num_sources`` blocks of N rows). Returns (proposals, cluster_overflow,
    graph_trunc): thing rows past the clustering budgets, and rows whose
    radius-graph edges region growing's edge path truncated.
    ``timer(name)``, when given, wraps the region growing, the mean shift
    and HDBSCAN. ``subset_seed`` (embed family): the counter of the random
    dimension subsets, an int or one int per sample (see
    :func:`_subset_masks`). Clustering emits integer assignments only, so it
    runs without autograd (the JAX package's ``stop_gradient`` around it)."""
    n = pos.shape[0]
    dev = pos.device
    pred = torch.argmax(sem_logp, dim=-1).to(torch.int32)
    is_stuff = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in cfg.stuff_classes:
        is_stuff = is_stuff | (pred == c)
    thing = valid & ~is_stuff
    if cfg.model_family == "embed":
        return _embed_proposals(cfg, pos, embeds, pred, batch, thing, subset_seed, timer)

    blocks = _Blocks(n, dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    for src in cfg.rg_sources:
        rg = _region_grow(cfg, pos + offsets if src == "vote" else pos, pred, batch, thing,
                          timer)
        overflow = overflow + rg.overflow
        blocks.add_region_growing(rg)

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
        blocks.add_per_sample(*_ms_labels(ms, cfg.ms_max_clusters), cfg.ms_max_clusters,
                              src_row)
    return blocks.proposals(), overflow, blocks.graph_trunc


def _subset_seeds(cfg: PanopticConfig, subset_seed) -> Optional[np.ndarray]:
    """The per-sample counters: one int broadcasts to every sample (one
    shared draw, as in training), or one int per sample (grouped eval
    dispatch: each tile draws what it would draw alone)."""
    if subset_seed is None:
        return None
    seeds = np.asarray(subset_seed, dtype=np.int64).reshape(-1) % 2**32
    if seeds.shape[0] == 1:
        seeds = np.repeat(seeds, cfg.num_samples)
    if seeds.shape[0] != cfg.num_samples:
        raise ValueError(f"subset_seed: {seeds.shape[0]} counters for "
                         f"{cfg.num_samples} samples")
    return seeds


def _subset_masks(cfg: PanopticConfig, space: str, loops: int, low: int, high: int,
                  seeds: Optional[np.ndarray] = None, tag: int = 0) -> np.ndarray:
    """0/1 dimension masks of one strategy op over the 3 + E features
    (xyz, then the embedding). Zeroing the other dimensions makes every
    distance the subspace's. loops 0: the whole space, [1, d]. With
    ``seeds`` (one counter per sample) each sample's subsets are drawn as
    the JAX package draws them with ``jax.random`` (key
    ``fold_in(PRNGKey(embed_subset_seed), counter)``, see
    :func:`..utils.prng.subset_mask_rows`): [B, loops, d]. Without, fixed
    numpy masks from ``embed_subset_seed``: [loops, d]."""
    d = 3 + cfg.embed_dim
    pool = {"xyz": np.arange(3), "embed": np.arange(3, d), "both": np.arange(d)}[space]
    if loops == 0:
        m = np.zeros((1, d), np.float32)
        m[0, pool] = 1.0
        return m
    if seeds is not None:
        base = prng.prng_key(cfg.embed_subset_seed)
        return np.stack([prng.subset_mask_rows(prng.fold_in(base, int(s)), pool, d, loops,
                                               low, high, tag) for s in seeds])
    rng = np.random.default_rng(cfg.embed_subset_seed)
    masks = np.zeros((loops, d), np.float32)
    for i in range(loops):
        k = min(int(rng.integers(low, high + 1)), len(pool))
        masks[i, rng.choice(pool, size=k, replace=False)] = 1.0
    return masks


def _mask_columns(masks: np.ndarray, width: int) -> np.ndarray:
    """[R, B, d] 0/1 masks -> [R * B, width] the selected columns of each
    run and sample in increasing order, padded with d (a zero column)."""
    r, b, d = masks.shape
    cols = np.full((r * b, width), d, np.int64)
    for i, row in enumerate(masks.reshape(r * b, d)):
        sel = np.flatnonzero(row)
        cols[i, :len(sel)] = sel
    return cols


def _embed_proposals(cfg: PanopticConfig, pos, embeds, pred, batch, thing, subset_seed,
                     timer):
    """The PointGroupEmbed strategy ``cfg.cluster_type``
    (``EMBED_STRATEGIES``): region growing on raw positions, and mean shift
    or HDBSCAN over xyz, the embedding or both, on the whole space or on
    random dimension subsets. Points are packed per sample once per cap
    (``ms_point_cap``, ``hd_point_cap``); each pack's dropped rows count once
    in the overflow. Samples with at most 3 thing points (5 for subset
    runs) are skipped, as the reference's cluster_single / cluster_loop.
    The runs of one op are one batch of R * B samples. Mean shift runs its
    loop (kernel C) on each run's selected columns only."""
    n = pos.shape[0]
    dev = pos.device
    seeds = _subset_seeds(cfg, subset_seed)
    feats_all = torch.cat([pos.float(), embeds.float()], dim=1)
    d = feats_all.shape[1]
    packs = {}
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    blocks = _Blocks(n, dev)
    b = cfg.num_samples
    for op in cfg.embed_ops:
        method, space, loops, low, high = op
        if method == "rg":
            rg = _region_grow(cfg, pos, pred, batch, thing, timer)
            overflow = overflow + rg.overflow
            blocks.add_region_growing(rg)
            continue
        cap = cfg.hd_point_cap if method == "hdbscan" else cfg.ms_point_cap
        if cap not in packs:
            packs[cap] = pack_by_sample(feats_all, batch, thing, b, cap)
            overflow = overflow + packs[cap][3]
        dense, dvalid, src_row, _ = packs[cap]
        counts = dvalid.to(torch.int32).sum(dim=1)
        run_valid = dvalid & (counts > (5 if loops > 0 else 3))[:, None]
        percap = cfg._op_max_clusters(op)
        masks = _subset_masks(cfg, space, loops, low, high, seeds, len(blocks.type))
        masks = masks if masks.ndim == 3 else np.broadcast_to(masks, (b,) + masks.shape)
        masks = np.array(masks.transpose(1, 0, 2), dtype=np.float32)  # [R, B, d]
        runs = masks.shape[0]
        m = torch.from_numpy(masks).to(dev)
        x = (dense[None] * m[:, :, None, :]).reshape(runs * b, cap, d)
        rv = run_valid.repeat(runs, 1)
        if method == "hdbscan":
            with _phase(timer, "hdbscan"):
                res = hdbscan_labels(x, rv, min_samples=cfg.hd_min_samples,
                                     min_cluster_size=cfg.hd_min_cluster_size,
                                     epsilon=cfg.hd_epsilon, max_clusters=percap,
                                     selection=cfg.hd_selection)
            lab, ncl = res.labels, res.num_clusters
        else:
            width = {"xyz": 3, "embed": cfg.embed_dim, "both": d}[space]
            width = min(width, high) if loops > 0 else width
            cols = torch.from_numpy(_mask_columns(masks, width)).to(dev)
            with _phase(timer, "mean_shift"):
                ms = mean_shift(x, rv, bandwidth=cfg.bandwidth, max_seeds=cfg.ms_max_seeds,
                                cols=cols)
            lab, ncl = _ms_labels(ms, percap)
        lab, ncl = lab.reshape(runs, b, cap), ncl.reshape(runs, b)
        for li in range(runs):
            blocks.add_per_sample(lab[li], ncl[li], percap, src_row)
    return blocks.proposals(), overflow, blocks.graph_trunc


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
                    class_weights: torch.Tensor | None = None, epoch: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total loss and its terms (the JAX package's ``panoptic_losses``):
    semantic NLL, offset norm and direction (with an offset head),
    discriminative embedding, with proposals and scores the IoU loss of the
    scores, with mask logits the mask loss, and the backbone's internal
    losses as ``<name>_loss``; the overflow and graph-truncation counters
    ride along as f32 metrics. Where ``cal_iou_based_on_mask``'s epoch gate
    is open (:meth:`PanopticConfig.gates`), the IoU targets count only the
    members whose mask probability passes 0.5, and every member without a
    scorer row."""
    losses = {"semantic_loss": semantic_nll_loss(out.semantic_logits, labels_y, valid,
                                                 class_weights)}
    total = cfg.w_semantic * losses["semantic_loss"]
    if cfg.has_offset:
        off = offset_loss(out.offset_logits, vote_label, instance_mask & valid)
        losses.update(off)
        total = total + cfg.w_offset_norm * off["offset_norm_loss"]
        total = total + cfg.w_offset_dir * off["offset_dir_loss"]
    disc = discriminative_loss(out.embed_logits, instance_labels, batch, instance_mask & valid,
                               cfg.num_samples, cfg.max_instances)
    losses.update(disc)
    total = total + cfg.w_embed * disc["ins_loss"]
    if out.proposals is not None and out.cluster_scores is not None:
        member_pass = None
        if out.mask_scores is not None and cfg.gates(epoch)[1]:
            member_pass = torch.sigmoid(out.mask_scores) > 0.5
            if out.mask_row_valid is not None:
                member_pass = member_pass | ~out.mask_row_valid
        ious = instance_iou(out.proposals, instance_labels, batch, cfg.num_samples,
                            cfg.max_instances, member_pass=member_pass)
        losses["score_loss"] = instance_iou_loss(ious, out.cluster_scores,
                                                 out.proposals.prop_valid,
                                                 cfg.min_iou_threshold, cfg.max_iou_threshold)
        total = total + cfg.w_score * losses["score_loss"]
        if out.mask_scores is not None and cfg.mask_supervise:
            losses["mask_loss"] = mask_loss(ious, out.proposals, torch.sigmoid(out.mask_scores),
                                            instance_labels, cfg.max_instances,
                                            member_scored=out.mask_row_valid)
            total = total + cfg.w_mask * losses["mask_loss"]
    for name, val in (out.internal_losses or {}).items():
        # the deformable KPConv's regularizers (reference
        # collect_internal_losses, lambda-weighted into the loss)
        losses[f"{name}_loss"] = val
        total = total + cfg.lambda_internal_losses * val
    if out.scorer_overflow is not None:
        losses["scorer_overflow"] = out.scorer_overflow.float()
    if out.cluster_overflow is not None:
        losses["cluster_overflow"] = out.cluster_overflow.float()
    if out.rg_graph_trunc is not None:
        losses["rg_graph_trunc"] = out.rg_graph_trunc.float()
    losses["loss"] = total
    return total, losses
