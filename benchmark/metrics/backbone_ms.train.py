"""ms a step in the backbone_heads phase: the sparse UNet (kernel A) and the three heads."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "backbone_heads", scale=1e3)
