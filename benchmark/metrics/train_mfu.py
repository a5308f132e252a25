"""The train step's model FLOP utilization at the bf16 dense peak, in % (backbone and heads, forward and a backward of twice the forward)."""

from benchmark.layers import mfu


def read(layers):
    return mfu(layers)
