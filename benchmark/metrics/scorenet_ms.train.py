"""ms a step in the scorenet phase: the scorer grid and the ScoreNet UNet."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "scorenet", scale=1e3)
