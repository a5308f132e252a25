"""s a scene in extract (device IoU, the pull, NMS), merge and finalise."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "extract", "merge", "finalise")
