"""Kernel A's share of its roofline in the backbone's forward, in %."""

from benchmark.layers import conv_roofline


def read(layers):
    return conv_roofline(layers)
