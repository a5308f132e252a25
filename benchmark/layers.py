"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. Each
takes the run's :class:`.drivers.common.Layers` and returns None where the
run has nothing to read."""

from __future__ import annotations

from typing import Optional

from .drivers.common import PEAK_FLOPS


def per_unit(layers, *phases: str, scale: float = 1.0) -> Optional[float]:
    """Seconds of the named spans per step or scene, times ``scale``; None
    where no span of those names ran."""
    if layers is None or not layers.units or not any(p in layers.phases for p in phases):
        return None
    return scale * sum(layers.phases.get(p, 0.0) for p in phases) / layers.units


def conv_roofline(layers) -> Optional[float]:
    """Kernel A's share of its roofline, in %: the least time of the
    backbone's forward convs of the profiled sub-window (the frozen count)
    over A's device time inside its ``backbone_heads`` spans."""
    tr = layers.trace if layers is not None else None
    if tr is None or not layers.conv_bound_s:
        return None
    a = sum(tr.family_in_phase(f, "backbone_heads") for f in ("A", "A f32", "A, D second pass"))
    return 100.0 * layers.conv_bound_s / a if a > 0 else None


def idle_share(layers) -> Optional[float]:
    """The device's idle share of a plain step or scene, in %: 1 - the
    device-busy seconds per unit of the profiled sub-window over the
    seconds per unit of the same inputs run again with no span and no
    profiler (the profiler's host overhead lengthens its own sub-window)."""
    tr = layers.trace if layers is not None else None
    if tr is None or not tr.kernels or not layers.trace_units or layers.plain_unit_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / layers.trace_units / layers.plain_unit_s)


def mfu(layers) -> Optional[float]:
    """The model's operations over the traced window (less the profiled
    sub-window) against its length at the bf16 dense peak, in %."""
    if layers is None or not layers.model_ops or layers.window_s <= 0:
        return None
    return 100.0 * layers.model_ops / (layers.window_s * PEAK_FLOPS)
