"""Composed YAML tree -> :class:`PanopticConfig` (model fields only).

Counterpart of the JAX package's ``config/schema.py:panoptic_config_from_yaml``.
Training fields (optimizer, schedules, BN momentum) belong to the training
slice of the port and are not read here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ..models.pointgroup3heads import PanopticConfig

# (num_classes, stuff_classes) per dataset family, as in the JAX package's
# data/datasets.py NPM3D_SPEC / TREEINS_SPEC.
_DATASETS = {
    "npm3d": (9, (0, 1, 5)),
    "treeins": (2, (0,)),
}


def dataset_classes(data_cfg: Dict[str, Any]) -> Tuple[int, Tuple[int, ...]]:
    name = str(data_cfg.get("class", "treeins")).lower()
    return _DATASETS["npm3d" if "npm3d" in name else "treeins"]


def panoptic_config_from_yaml(
    cfg: Dict[str, Any],
    model_name: str | None = None,
    backbone: str = "paper",
    **overrides,
) -> PanopticConfig:
    """Build the model configuration from a composed config tree."""
    models = cfg.get("models", {})
    model_name = model_name or cfg.get("model_name") or next(iter(models))
    if model_name not in models:
        raise KeyError(f"model_name {model_name!r} not in models ({list(models)})")
    m = models[model_name]
    num_classes, stuff = dataset_classes(cfg.get("data", {}))
    grid = float(cfg.get("data", {}).get("grid_size", 0.2))
    klass = str(m.get("class", "PointGroup3Heads"))
    family = str(
        m.get("model_family", "embed" if "embed" in klass.lower() else "3heads")
    )
    kwargs = dict(
        num_classes=num_classes,
        stuff_classes=stuff,
        feat_dim=4,
        in_feat=int(m.get("feat_size", 16)),
        embed_dim=int(m.get("embed_dim", 5)),
        model_family=family,
        cluster_type=int(m.get("cluster_type", 5)),
        bandwidth=float(m.get("bandwidth", 0.6)),
        cluster_radius=float(m.get("cluster_radius_search", 1.5 * grid)),
        scorer_type=str(m.get("scorer_type", "unet") or ""),
        use_score_net=bool(m.get("use_score_net", True)),
        mask_supervise=bool(m.get("mask_supervise", False)),
        rg_point_cap=float(m.get("rg_point_cap", 0)),
        scorer_capacity_mult=float(m.get("scorer_capacity_mult", 1.0)),
        ms_point_cap=int(m.get("ms_point_cap", 16384)),
        num_samples=int(cfg.get("training", {}).get("batch_size", 4)),
        backbone=(str(m.get("backbone", backbone)) if backbone == "paper" else backbone),
    )
    if m.get("scorer_bits"):
        kwargs["scorer_bits"] = tuple(int(b) for b in m["scorer_bits"])
    kwargs.update(overrides)
    return PanopticConfig(**kwargs)
