"""ms a step in the benchmark's span around the port's collate_tiles and batch_arrays."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "collate", scale=1e3)
