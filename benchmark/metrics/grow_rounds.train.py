"""Region growing's propagation rounds a step (the program's counter), in
the profiled steps."""
from benchmark import program_spans as ps


def read(layers):
    return ps.count(layers, ps.sub_window(layers, ps.records(), ps.TRAIN), "grow_rounds")
