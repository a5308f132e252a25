"""Host ms a step in the program's conv_backward spans (kernel A on the
transpose map and kernel D), in the plain steps."""
from benchmark import program_spans as ps


def read(layers):
    s = ps.seconds(layers, ps.plain_repeat(layers, ps.records(), ps.TRAIN),
                   lambda name: name == "conv_backward")
    return None if s is None else 1e3 * s
