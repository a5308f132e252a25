"""Host ms a step in the program's ms_dedup spans (mean shift's greedy
dedup of converged seeds, one host read a round), in the plain steps; None
where the program has no such span."""
from benchmark import program_spans as ps


def read(layers):
    s = ps.seconds(layers, ps.plain_repeat(layers, ps.records(), ps.TRAIN),
                   lambda name: name == "ms_dedup")
    return None if s is None else 1e3 * s
