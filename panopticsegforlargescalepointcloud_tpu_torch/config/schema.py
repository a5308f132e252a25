"""Composed YAML tree -> :class:`PanopticConfig`, :class:`DatasetSpec` and
:class:`TrainingConfig`.

Counterpart of the JAX package's ``config/schema.py``
(``dataset_spec_from_cfg``, ``panoptic_config_from_yaml``,
``training_config_from_yaml``), with the training fields the train step
and the trainer read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..data.datasets import NPM3D_SPEC, TREEINS_SPEC, DatasetSpec
from ..models.pointgroup3heads import PanopticConfig


def dataset_spec_from_cfg(data_cfg: Dict[str, Any]) -> DatasetSpec:
    name = str(data_cfg.get("class", "treeins")).lower()
    return NPM3D_SPEC if "npm3d" in name else TREEINS_SPEC


@dataclasses.dataclass
class TrainingConfig:
    epochs: int = 150
    batch_size: int = 4
    samples_per_epoch: int = 3000
    lr: float = 1e-3
    scheduler: str = "ExponentialLR"
    scheduler_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optimizer: str = "Adam"
    weight_decay: float = 0.0
    grad_accum: int = 1  # mini-batches per optimizer update (optax MultiSteps)
    use_class_weights: bool = False  # sqrt-inverse-frequency weighted semantic NLL
    grad_clip: Optional[float] = None  # <= 0 or None: no clipping
    eval_frequency: int = 1
    bn_momentum: float = 0.1
    bn_decay: float = 0.5  # step-decay policy of the BN momentum
    bn_decay_every: int = 20
    bn_clip: float = 0.01
    checkpoint_dir: str = ""
    seed: int = 2022
    # data-parallel device count: 1 = one device, 0 = all local devices
    # (one here: the port trains on one device)
    num_devices: int = 1
    # validate on the whole val split by deterministic grid tiling; False =
    # quick eval on random val-style tiles
    full_val: bool = True
    # input-pipeline threads (data/prefetch.py); 0 = synchronous sampling
    num_workers: int = 2

    @property
    def steps_per_epoch(self) -> int:
        return max(self.samples_per_epoch // max(self.batch_size, 1), 1)

    @property
    def grad_clip_value(self) -> Optional[float]:
        gc = self.grad_clip
        return None if gc is None or gc <= 0 else float(gc)


def training_config_from_yaml(cfg: Dict[str, Any]) -> TrainingConfig:
    t = cfg.get("training", {})
    lr_s = cfg.get("lr_scheduler", {})
    optim = t.get("optim", {})
    bn = t.get("bn_scheduler", {}).get("params", {})
    gc = t.get("grad_clip", None)
    return TrainingConfig(
        epochs=int(t.get("epochs", 150)),
        batch_size=int(t.get("batch_size", 4)),
        samples_per_epoch=int(t.get("samples_per_epoch", 3000)),
        lr=float(optim.get("base_lr", t.get("lr", 1e-3))),
        scheduler=str(lr_s.get("class", "ExponentialLR")),
        scheduler_params=dict(lr_s.get("params", {}) or {}),
        optimizer=str(optim.get("class", "Adam")),
        weight_decay=float(optim.get("weight_decay", 0.0)),
        grad_accum=int(t.get("grad_accum", 1)),
        use_class_weights=bool(t.get("use_class_weights", False)),
        grad_clip=None if gc is None else float(gc),
        eval_frequency=int(t.get("eval_frequency", 1)),
        bn_momentum=float(bn.get("bn_momentum", 0.1)),
        bn_decay=float(bn.get("bn_decay", 0.5)),
        bn_decay_every=int(bn.get("decay_step", 20)),
        bn_clip=float(bn.get("bn_clip", 0.01)),
        checkpoint_dir=str(t.get("checkpoint_dir", "")),
        seed=int(t.get("seed", 2022)),
        num_devices=int(t.get("num_devices", 1)),
        full_val=bool(t.get("full_val", True)),
        num_workers=int(t.get("num_workers", 2)),
    )


def panoptic_config_from_yaml(
    cfg: Dict[str, Any],
    model_name: str | None = None,
    backbone: str = "paper",
    **overrides,
) -> Tuple[PanopticConfig, DatasetSpec, TrainingConfig]:
    """Build (PanopticConfig, DatasetSpec, TrainingConfig) from a composed
    config tree."""
    models = cfg.get("models", {})
    model_name = model_name or cfg.get("model_name") or next(iter(models))
    if model_name not in models:
        raise KeyError(f"model_name {model_name!r} not in models ({list(models)})")
    m = models[model_name]
    lw = m.get("loss_weights", {})
    spec = dataset_spec_from_cfg(cfg.get("data", {}))
    tr = training_config_from_yaml(cfg)
    grid = float(cfg.get("data", {}).get("grid_size", 0.2))
    klass = str(m.get("class", "PointGroup3Heads"))
    family = str(
        m.get("model_family", "embed" if "embed" in klass.lower() else "3heads")
    )
    kwargs = dict(
        num_classes=spec.num_classes,
        stuff_classes=spec.stuff_classes,
        feat_dim=4,
        in_feat=int(m.get("feat_size", 16)),
        embed_dim=int(m.get("embed_dim", 5)),
        model_family=family,
        cluster_type=int(m.get("cluster_type", 5)),
        bandwidth=float(m.get("bandwidth", 0.6)),
        cluster_radius=float(m.get("cluster_radius_search", 1.5 * grid)),
        prepare_epoch=int(m.get("prepare_epoch", 30)),
        scorer_type=str(m.get("scorer_type", "unet") or ""),
        use_score_net=bool(m.get("use_score_net", True)),
        mask_supervise=bool(m.get("mask_supervise", False)),
        use_mask_filter_score_feature=bool(m.get("use_mask_filter_score_feature", False)),
        use_mask_filter_score_feature_start_epoch=int(
            m.get("use_mask_filter_score_feature_start_epoch", 200)),
        mask_filter_score_feature_thre=float(m.get("mask_filter_score_feature_thre", 0.5)),
        cal_iou_based_on_mask=bool(m.get("cal_iou_based_on_mask", False)),
        cal_iou_based_on_mask_start_epoch=int(m.get("cal_iou_based_on_mask_start_epoch", 200)),
        rg_point_cap=float(m.get("rg_point_cap", 0)),
        rg_dense=str(m.get("rg_dense", "auto")),
        scorer_capacity_mult=float(m.get("scorer_capacity_mult", 1.0)),
        ms_point_cap=int(m.get("ms_point_cap", 16384)),
        hd_point_cap=int(m.get("hd_point_cap", 2048)),
        hd_selection=str(m.get("hd_selection", "eom")),
        min_iou_threshold=float(m.get("min_iou_threshold", 0.25)),
        max_iou_threshold=float(m.get("max_iou_threshold", 0.75)),
        # the model yaml's merge threshold defaults to 0.1, the reference
        # tracker's effective value (the dataclass default is 0.01)
        block_merge_th=float(m.get("block_merge_th", 0.1) or 0.1),
        w_semantic=float(lw.get("semantic", 1.0)),
        w_offset_norm=float(lw.get("offset_norm_loss", 0.1)),
        w_offset_dir=float(lw.get("offset_dir_loss", 0.1)),
        w_score=float(lw.get("score_loss", 1.0)),
        w_embed=float(lw.get("embedding_loss", 1.0)),
        w_mask=float(lw.get("mask_loss", 1.0)),
        num_samples=tr.batch_size,
        # the model yaml may pick the backbone ("kpconv", "pointnet2"); an
        # explicit backbone=... other than the "paper" default overrides it
        backbone=(str(m.get("backbone", backbone)) if backbone == "paper" else backbone),
        grid_size=grid,
        point_levels=int(m.get("point_levels", 4)),
        kp_base_channels=int(m.get("kp_base_channels", 64)),
        kp_num_kernel_points=int(m.get("kp_num_kernel_points", 15)),
        kp_sigma=float(m.get("kp_sigma", 1.0)),
        kp_max_neighbors=int(m.get("kp_max_neighbors", 16)),
        kp_deformable=bool(m.get("kp_deformable", False)),
        kp_modulated=bool(m.get("kp_modulated", False)),
        kp_loss_mode=str(m.get("kp_loss_mode", "fitting")),
        lambda_internal_losses=float(m.get("lambda_internal_losses", 0.1)),
        pn2_base_channels=int(m.get("pn2_base_channels", 32)),
        pn2_radius_scale=float(m.get("pn2_radius_scale", 2.5)),
        pn2_nsample=int(m.get("pn2_nsample", 16)),
        point_cell_cap=int(m.get("point_cell_cap", 16)),
    )
    if m.get("scorer_bits"):
        kwargs["scorer_bits"] = tuple(int(b) for b in m["scorer_bits"])
    kwargs.update(overrides)
    return PanopticConfig(**kwargs), spec, tr
