"""Blocking host transfers a scene (the program's host_syncs counter), in
the profiled scene."""
from benchmark import program_spans as ps


def read(layers):
    return ps.count(layers, ps.sub_window(layers, ps.records(), ps.SERVE), "host_syncs")
