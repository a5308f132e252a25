"""The served scene's model FLOP utilization at the bf16 dense peak, in % (backbone and heads' forward over every real tile)."""

from benchmark.layers import mfu


def read(layers):
    return mfu(layers)
