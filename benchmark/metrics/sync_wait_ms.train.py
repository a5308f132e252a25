"""Host ms a step inside the program's sync::* spans (its host_read waits),
in the plain steps."""
from benchmark import program_spans as ps


def read(layers):
    s = ps.seconds(layers, ps.plain_repeat(layers, ps.records(), ps.TRAIN),
                   lambda name: name.startswith("sync::"))
    return None if s is None else 1e3 * s
