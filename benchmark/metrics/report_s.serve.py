"""s a scene in the report phase: the PLYs (where written) and the PQ report."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "report")
