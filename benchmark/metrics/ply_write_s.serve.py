"""Seconds a scene in the program's ply_write spans (the three ASCII PLYs),
in the plain scene."""
from benchmark import program_spans as ps


def read(layers):
    return ps.seconds(layers, ps.plain_repeat(layers, ps.records(), ps.SERVE),
                      lambda name: name == "ply_write")
