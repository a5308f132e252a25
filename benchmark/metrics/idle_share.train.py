"""The device's idle share of a plain step, in % (:func:`benchmark.layers.idle_share`)."""

from benchmark.layers import idle_share


def read(layers):
    return idle_share(layers)
