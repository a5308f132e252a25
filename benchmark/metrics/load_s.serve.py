"""s a scene in the benchmark's span around build_evaluator: checkpoint load, PLY read, grid sampling."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "load")
