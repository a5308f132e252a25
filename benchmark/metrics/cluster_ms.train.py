"""ms a step in the region_growing and mean_shift phases (kernels B and C)."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "region_growing", "mean_shift", scale=1e3)
