"""What both drivers hand back to :mod:`benchmark.run`."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .. import counts
from ..reference.plain.config import panoptic_config_from_yaml
from ..reference.plain.models.plans import paper_backbone_plan, tiny_backbone_plan
from ..trace import Trace

PEAK_FLOPS = 989e12  # bf16 dense, one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_S = 3.35e12


@dataclasses.dataclass
class Layers:
    """What the per-layer readers read, from the traced window less its
    profiled sub-window and the plain units beside it: the units (steps or
    scenes), the seconds of each span name, the window's seconds, the
    model's operations over those units; the profiled sub-window's trace,
    its units and the bound of its backbone convs; and the seconds a unit
    takes when the same inputs run again with no span and no profiler."""

    units: int = 0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    model_ops: float = 0.0
    trace: Optional[Trace] = None
    trace_units: int = 0
    conv_bound_s: float = 0.0
    plain_unit_s: float = 0.0


@dataclasses.dataclass
class Outcome:
    setup_end: float = 0.0  # perf_counter at the end of set-up
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    lines: List[str] = dataclasses.field(default_factory=list)  # printed before the result
    layers: Optional[Layers] = None
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)  # compared to limits
    memory_peak: int = 0  # bytes, read when the window has closed


def forward_count(config: dict, batch: np.ndarray, coords: np.ndarray) -> counts.ForwardCount:
    """The frozen count of one forward of the configuration's model over
    the voxels (batch, coords), from its widths: the UNet's channel plan
    and the heads' widths."""
    run_config = config["run_config"]
    model = run_config["models"][run_config["model_name"]]
    f = int(model.get("feat_size", 16))
    tiny = run_config.get("backbone", "paper") == "tiny"
    plan = (tiny_backbone_plan if tiny else paper_backbone_plan)(4, f)
    classes = panoptic_config_from_yaml(run_config)[0].num_classes
    heads = (classes, 3, int(model.get("embed_dim", 5)))
    return counts.forward_count(batch, coords, plan, heads, f, PEAK_FLOPS, HBM_BYTES_S)
