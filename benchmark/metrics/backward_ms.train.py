"""ms a step in the losses, backward and optimizer phases."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "losses", "backward", "optimizer", scale=1e3)
