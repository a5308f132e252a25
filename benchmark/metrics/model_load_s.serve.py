"""Seconds a scene in the program's model spans (the checkpoint's open, the
model's rebuild and its move to the card), in the plain scene."""
from benchmark import program_spans as ps


def read(layers):
    return ps.seconds(layers, ps.plain_repeat(layers, ps.records(), ps.SERVE),
                      lambda name: name == "model")
