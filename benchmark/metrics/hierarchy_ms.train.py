"""ms a step in the train step's hierarchy phase: canonicalize and the grid hierarchy's maps."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "hierarchy", scale=1e3)
