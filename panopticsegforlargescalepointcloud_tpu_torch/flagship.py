"""The flagship configurations, their synthetic inputs and seeded weights,
shared by ``chip_smoke.py``, :mod:`.trace_eval`, :mod:`.trace_train` and
:mod:`.bench_conv_parts`.

* Training and the eval-tile forward: Setting IV
  (``conf/models/panoptic/area4_ablation_3heads_5.yaml``) on the NPM3D
  0.12 m data yaml, trained as ``conf/training/npm3d.yaml`` with the
  default exponential lr schedule; inputs as the JAX package's
  ``bench.py:build_inputs`` (4 synthetic 16 m cylinders in 131,072 rows).
  The paper's other settings (``SETTINGS``) at the same width and data,
  and the flagship's variants (``VARIANTS``: the ScoreNet's other forms and
  region growing's edge path) through its yaml's dotted overrides.
* Serving: ``conf/eval.yaml``'s defaults, the same model on the FOR-instance
  data yaml ``treeins_rad8`` (2 classes, 0.2 m grid, 8 m cylinders,
  32,768-row eval tiles), on the JAX package's ``bench.py:measure_e2e``
  forest scene (~500k points) from the same seeded draws.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch

from .config import (
    TrainingConfig,
    load_config,
    panoptic_config_from_yaml,
    training_config_from_yaml,
)
from .data import batch_arrays, collate_tiles, synthetic_tile
from .models import PanopticConfig, PointGroup3HeadsNet
from .train.optim import Schedule, make_lr_schedule
from .train.step import TrainState, init_state

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")


# the paper's ablation table: setting -> model yaml (conf/models/panoptic)
SETTINGS = {
    "I": "area4_ablation_19",  # PointGroupEmbed, mean shift on the embedding, no scores
    "II": "area4_ablation_14",  # region growing on votes
    "III": "area4_ablation_15",  # region growing on positions and on votes
    "IV": "area4_ablation_3heads_5",  # votes + mean shift (the flagship)
    "V": "area4_ablation_3heads_6",  # positions + votes + mean shift
}


# the point-backbone yamls (conf/models/panoptic) -> their model names; every
# other model yaml names its model PointGroup-PAPER
POINT_BACKBONES = {
    "kpconv": "KPConvPaper",  # KPConv, rigid kernel points
    "kpconv_deform": "KPConvPaper-Deform",  # deformable past the stem
    "pointnet2": "PointNet2",  # PointNet++ multi-scale grouping
}


# the flagship's variants: name -> the model yaml's dotted overrides
# (``models.PointGroup-PAPER.<key>=<value>``, as on a CLI line)
VARIANTS = {
    # the mask head with both epoch gates open from the start
    "mask": {"mask_supervise": True, "use_mask_filter_score_feature": True,
             "use_mask_filter_score_feature_start_epoch": 0, "cal_iou_based_on_mask": True,
             "cal_iou_based_on_mask_start_epoch": 0},
    "encoder": {"scorer_type": "encoder"},  # the sparse-conv encoder scorer
    "mlp": {"scorer_type": "mlp"},  # the per-row MLP scorer
    "edge_all": {"rg_point_cap": 0},  # region growing's edge path on all rows
    "edge_cap": {"rg_dense": "off"},  # the edge path on the shipped 0.375 cap
}


def variant_overrides(variant: str, model: str = "PointGroup-PAPER") -> list:
    """The dotted overrides of ``VARIANTS[variant]`` for the model ``model``;
    a string value is quoted, so that the loader keeps ``off`` a string."""
    return [f"models.{model}.{k}=" + (f"'{v}'" if isinstance(v, str) else str(v))
            for k, v in VARIANTS[variant].items()]


def model_name(models: str) -> str:
    """The model name of the model yaml ``models``."""
    return POINT_BACKBONES.get(models, "PointGroup-PAPER")


def _flagship_yaml(models: str = SETTINGS["IV"], variant=None):
    return load_config(CONF_DIR, [
        "data=panoptic/npm3d-sparseconv_grid_012_R_16_cylinder_area1",
        f"models=panoptic/{models}",
        f"model_name={model_name(models)}",
        "training=npm3d",
        "lr_scheduler=exponential",
    ] + (variant_overrides(variant, model_name(models)) if variant else []))


def flagship_config(num_samples: int = 4, compute_dtype: str = "bfloat16",
                    models: str = SETTINGS["IV"], variant=None, **overrides) -> PanopticConfig:
    """The flagship's data, training and width with the model yaml
    ``models`` (a name of ``conf/models/panoptic``; ``SETTINGS`` maps the
    paper's settings to theirs, ``POINT_BACKBONES`` the point backbones'
    yamls to their model names) and the overrides of ``VARIANTS[variant]``."""
    return panoptic_config_from_yaml(_flagship_yaml(models, variant), num_samples=num_samples,
                                     compute_dtype=compute_dtype, **overrides)[0]


def flagship_training_config() -> TrainingConfig:
    """Adam at base lr 0.001, exponential decay (gamma 0.9885 per epoch of
    3,000 samples), BN momentum 0.1."""
    return training_config_from_yaml(_flagship_yaml())


def flagship_training(cfg: PanopticConfig, seed: int, device=None
                      ) -> Tuple[TrainState, Schedule, TrainingConfig]:
    """The start of training: the model initialized as the JAX package
    initializes it, from a ``torch.Generator`` seeded with ``seed``, its
    optimizer and lr schedule, and the training configuration (whose
    ``grad_clip_value`` the train step takes)."""
    tc = flagship_training_config()
    state = init_state(cfg, torch.Generator().manual_seed(seed), tc.optimizer, tc.weight_decay,
                       tc.bn_momentum, device=device)
    schedule = make_lr_schedule(tc.scheduler, tc.scheduler_params, tc.lr, tc.steps_per_epoch)
    return state, schedule, tc


def build_inputs(num_tiles: int = 4, capacity: int = 131072, seed: int = 0,
                 radius: float = 16.0, grid_size: float = 0.12, n_instances: int = 24,
                 pts_per_instance: int = 400, n_ground=None):
    """Batch arrays (numpy, in ``batch_arrays`` order) of synthetic
    NPM3D-scale cylinders; ``n_ground`` ground points a tile (default: a
    tile's share of ``capacity``)."""
    rng = np.random.default_rng(seed)
    n_ground = capacity // num_tiles if n_ground is None else n_ground
    tiles = [
        synthetic_tile(rng, num_classes=9, stuff_classes=(0, 7, 8),
                       n_instances=n_instances, pts_per_instance=pts_per_instance,
                       n_ground=n_ground, radius=radius, grid_size=grid_size)
        for _ in range(num_tiles)
    ]
    return batch_arrays(collate_tiles(tiles, capacity=capacity, num_tiles=num_tiles))


def serving_yaml(models=None):
    """``conf/eval.yaml`` composed with its defaults (the run config a
    serving checkpoint stores), with the model yaml ``models`` (a name of
    ``conf/models/panoptic``) in place of its default where given."""
    over = [f"models=panoptic/{models}", f"model_name={model_name(models)}"] if models else []
    return load_config(CONF_DIR, over, root="eval.yaml")


def write_forest_scene(path: str, seed: int = 0, quarter: bool = False) -> int:
    """The JAX package's ``bench.py:measure_e2e`` forest as a .ply: a 35 x
    35 m plot, 100 trees of 2,000 points and 300,000 ground points, from
    the same seeded numpy draws in the same order. ``quarter`` keeps the
    points with x, y < 17.5 m. Returns the point count."""
    from .data.ply import write_ply

    rng = np.random.default_rng(seed)
    pts, sem, tid = [], [], []
    extent, n_trees = 35.0, 100
    for t in range(n_trees):
        c = rng.uniform(2, extent - 2, 2)
        k = 2000
        xy = c + rng.normal(scale=0.8, size=(k, 2))
        z = rng.uniform(0, 18, (k, 1)) * rng.uniform(0.5, 1.0)
        pts.append(np.concatenate([xy, z], 1))
        sem.append(np.full(k, 2))
        tid.append(np.full(k, t))
    k = 300_000
    pts.append(np.stack([rng.uniform(0, extent, k), rng.uniform(0, extent, k),
                         rng.normal(scale=0.05, size=k)], 1))
    sem.append(np.full(k, 1))
    tid.append(np.full(k, -1))
    pos = np.concatenate(pts).astype(np.float32)
    sem, tid = np.concatenate(sem).astype(np.int32), np.concatenate(tid).astype(np.int32)
    if quarter:
        keep = (pos[:, 0] < extent / 2) & (pos[:, 1] < extent / 2)
        pos, sem, tid = pos[keep], sem[keep], tid[keep]
    write_ply(path, [pos, sem, tid], ["x", "y", "z", "semantic_seg", "treeID"])
    return len(pos)


def random_model(cfg: PanopticConfig, seed: int) -> PointGroup3HeadsNet:
    """The model with seeded random weights and non-trivial BN running
    statistics (conv kernels [K, Cin, Cout], sparse or kernel-point, normal
    with std sqrt(2 / (K * Cout)), as the reference's kaiming fan-out init;
    the deformable KPConv's offset kernels a tenth of that, so that the
    kernel points move a fraction of the extent)."""
    gen = torch.Generator().manual_seed(seed)
    model = PointGroup3HeadsNet(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("kernel", "offset_kernel"):
                std = math.sqrt(2.0 / (p.shape[0] * p.shape[2]))
                p.copy_(torch.randn(p.shape, generator=gen) * std
                        * (0.1 if leaf == "offset_kernel" else 1.0))
            elif leaf == "weight":
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
            elif leaf == "scale":
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            else:  # bias
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith(".mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith(".var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))
    return model
