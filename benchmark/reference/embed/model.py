"""PointGroupEmbed (the paper's Setting I): backbone + semantic and
embedding heads, mean shift on the embedding, and its losses.

A frozen copy of the port's embed family (``models/pointgroup3heads.py``:
the ``embed`` branches of ``backbone_heads``, ``build_proposals`` and
``panoptic_losses``, and ``_embed_proposals``) for strategy 7 alone
(``cluster_type`` 7, ``("meanshift", "embed", 0, 0, 0)``), on the plain
copy's modules.

Departures from the reference code base (``pointgroupembed.py`` of
torch-points3d, ``conf/models/panoptic/area4_ablation_19.yaml``), which
the port makes and this copy keeps:

* the reference runs sklearn's ``MeanShift(bandwidth, bin_seeding=True)``
  per sample on the CPU; here all samples are one batch, with the
  sample's thing rows packed at ``ms_point_cap`` (16,384; the rows past it
  are counted as ``cluster_overflow`` and left out), at most
  ``ms_max_seeds`` (128) seeds, the most occupied bins, and at most
  ``ms_max_clusters`` (32) clusters a sample, the rest unassigned;
* every point's row is packed with its position, and mean shift runs on
  the embedding's columns of that row (the seeds are binned over the whole
  row, where the position's columns are 0);
* the loop stops at 100 iterations; converged seeds are deduplicated
  greedily by population (:func:`..plain.cluster.meanshift.mean_shift`);
* samples with at most 3 thing points are skipped, as the reference's
  ``cluster_single``;
* the proposals are the padded membership table of
  :class:`..plain.models.pointgroup3heads.Proposals` (one block of N rows,
  ids ``sample * ms_max_clusters + cluster``);
* ``use_score_net`` is false, so no ScoreNet runs and there is no score
  loss, but its weights exist, as the port's model holds them; the offset
  head does not exist, and the offsets handed on are zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..plain.cluster.meanshift import mean_shift, pack_by_sample
from ..plain.config import panoptic_config_from_yaml
from ..plain.models.losses import discriminative_loss, semantic_nll_loss
from ..plain.models.modules import PointMLP
from ..plain.models.plans import scorer_unet_plan
from ..plain.models.pointgroup3heads import (
    PanopticConfig,
    PanopticOutput,
    _Blocks,
    _ms_labels,
    make_backbone,
)
from ..plain.models.unet import SparseUNet
from ..plain.ops.hierarchy import Hierarchy

STRATEGY = 7  # ("meanshift", "embed", 0, 0, 0): one run on the whole embedding


@dataclasses.dataclass(frozen=True)
class EmbedConfig(PanopticConfig):
    """The plain copy's :class:`PanopticConfig` for the embed family under
    strategy 7: one block of proposals, from mean shift."""

    model_family: str = "embed"
    cluster_type: int = STRATEGY
    use_score_net: bool = False

    def __post_init__(self):
        if self.model_family != "embed" or self.cluster_type != STRATEGY:
            raise ValueError(f"the embed copy holds strategy {STRATEGY} of the embed family, "
                             f"not {self.model_family!r} type {self.cluster_type}")
        if self.use_score_net:
            raise ValueError("the embed copy has no ScoreNet forward")
        super().__post_init__()

    @property
    def has_offset(self) -> bool:
        return False

    @property
    def num_sources(self) -> int:
        return 1

    @property
    def rg_sources(self) -> Tuple[str, ...]:
        return ()

    @property
    def use_meanshift(self) -> bool:
        return True

    @property
    def total_props(self) -> int:
        return self.num_samples * self.ms_max_clusters


def embed_config_from_yaml(run_config: dict, **overrides) -> EmbedConfig:
    """The model configuration of ``run_config`` (its ``backbone`` and
    ``budget_overrides`` keys apply). The plain loader reads every field; it
    checks its budgets against the 3heads table, which has no strategy 7,
    so it reads them under type 5 and the type is set back here."""
    model = run_config["models"][run_config["model_name"]]
    kw = dict(overrides, **run_config.get("budget_overrides", {}))
    backbone = str(run_config.get("backbone", "paper"))
    base = panoptic_config_from_yaml(run_config, backbone=backbone,
                                     **dict(kw, cluster_type=5))[0]
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    fields["cluster_type"] = int(kw.get("cluster_type", model.get("cluster_type", STRATEGY)))
    return EmbedConfig(**fields)


class PointGroupEmbedNet(nn.Module):
    """Backbone + the semantic and embedding heads (each MLP([F, F],
    bias=False) -> Linear) + the UNet ScoreNet's weights, which no forward
    of this configuration uses. Attribute names follow the port's model, so
    that its state dict loads here with ``strict=True``."""

    def __init__(self, cfg: EmbedConfig):
        super().__init__()
        if cfg.scorer_type != "unet" or cfg.mask_supervise:
            raise ValueError(f"scorer {cfg.scorer_type!r} with the mask head "
                             f"{cfg.mask_supervise} is not in the embed copy")
        self.cfg = cfg
        f = cfg.in_feat
        self.backbone = make_backbone(cfg)
        self.semantic_mlp = PointMLP(f, (f,), use_bias=False)
        self.semantic_out = nn.Linear(f, cfg.num_classes)
        self.embed_mlp = PointMLP(f, (f,), use_bias=False)
        self.embed_out = nn.Linear(f, cfg.embed_dim)
        self.scorer = SparseUNet(**scorer_unet_plan(f), compute_dtype=cfg.compute_dtype)
        self.scorer_head = nn.Linear(f, 1)

    def backbone_heads(self, feats: torch.Tensor, hier: Hierarchy, momentum=0.1, *,
                       pos: torch.Tensor):
        """(features, semantic log-probs, offsets (zeros: no offset head),
        embeddings, internal losses (none))."""
        mask = hier.grids[0].mask
        x = self.backbone(feats, hier, momentum)
        sem = torch.log_softmax(self.semantic_out(self.semantic_mlp(x, mask, momentum)), dim=-1)
        off = x.new_zeros((x.shape[0], 3))
        emb = self.embed_out(self.embed_mlp(x, mask, momentum))
        m = mask[:, None]
        return x, sem, torch.where(m, off, 0.0), torch.where(m, emb, 0.0), {}


@torch.no_grad()
def ms_operands(cfg: EmbedConfig, pos, embeds, sem_logp, batch, valid):
    """Mean shift's operands of strategy 7: (x [B, cap, 3 + E], the rows
    that take part [B, cap], the embedding's columns [B, E], each packed
    row's source row [B, cap], the thing rows past the cap []). Each
    sample's predicted thing rows are packed at ``ms_point_cap`` with their
    position and embedding, the position's columns zeroed; a sample with
    at most 3 thing rows takes no part."""
    n = pos.shape[0]
    dev = pos.device
    pred = torch.argmax(sem_logp, dim=-1).to(torch.int32)
    is_stuff = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in cfg.stuff_classes:
        is_stuff = is_stuff | (pred == c)
    thing = valid & ~is_stuff
    b, e = cfg.num_samples, cfg.embed_dim
    feats_all = torch.cat([pos.float(), embeds.float()], dim=1)
    d = feats_all.shape[1]
    dense, dvalid, src_row, overflow = pack_by_sample(feats_all, batch, thing, b,
                                                      cfg.ms_point_cap)
    counts = dvalid.to(torch.int32).sum(dim=1)
    run_valid = dvalid & (counts > 3)[:, None]
    keep = torch.zeros(d, dtype=torch.float32, device=dev)
    keep[3:] = 1.0
    cols = torch.arange(3, d, dtype=torch.int64, device=dev).expand(b, e).contiguous()
    return dense * keep, run_valid, cols, src_row, overflow


@torch.no_grad()
def build_proposals(cfg: EmbedConfig, pos, offsets, embeds, sem_logp, batch, valid):
    """Strategy 7: mean shift on the embedding of each sample's predicted
    thing rows (:func:`ms_operands`). Returns (proposals, cluster_overflow,
    graph_trunc), as the port's ``build_proposals`` does; ``offsets`` is
    not read."""
    x, run_valid, cols, src_row, overflow = ms_operands(cfg, pos, embeds, sem_logp, batch,
                                                        valid)
    ms = mean_shift(x, run_valid, bandwidth=cfg.bandwidth, max_seeds=cfg.ms_max_seeds,
                    cols=cols)
    blocks = _Blocks(pos.shape[0], pos.device)
    blocks.add_per_sample(*_ms_labels(ms, cfg.ms_max_clusters), cfg.ms_max_clusters, src_row)
    return blocks.proposals(), overflow, blocks.graph_trunc


def panoptic_losses(cfg: EmbedConfig, out: PanopticOutput, labels_y, vote_label,
                    instance_labels, instance_mask, batch, valid,
                    class_weights: torch.Tensor | None = None, epoch: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total loss and its terms: semantic NLL and the discriminative
    embedding loss (no offset head, no scores); the overflow and
    graph-truncation counters ride along as f32 metrics. ``vote_label`` and
    ``epoch`` are not read."""
    losses = {"semantic_loss": semantic_nll_loss(out.semantic_logits, labels_y, valid,
                                                 class_weights)}
    total = cfg.w_semantic * losses["semantic_loss"]
    disc = discriminative_loss(out.embed_logits, instance_labels, batch, instance_mask & valid,
                               cfg.num_samples, cfg.max_instances)
    losses.update(disc)
    total = total + cfg.w_embed * disc["ins_loss"]
    if out.cluster_overflow is not None:
        losses["cluster_overflow"] = out.cluster_overflow.float()
    if out.rg_graph_trunc is not None:
        losses["rg_graph_trunc"] = out.rg_graph_trunc.float()
    losses["loss"] = total
    return total, losses
