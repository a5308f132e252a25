"""CUDA graph replays of the grid hierarchy's build a step (the program's
hier_graph_replays counter, one a replay), in the profiled steps: 1 where
the train step's hierarchy replays, 2 with the ScoreNet's, 0 where the
builds stay eager; None where the program's hierarchy has no graph."""
import importlib

from benchmark import program_spans as ps

PROGRAM = "panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy"


def read(layers):
    try:
        hierarchy = importlib.import_module(PROGRAM)
    except ImportError:
        return None
    if not hasattr(hierarchy, "graph_engaged"):
        return None
    return ps.count(layers, ps.sub_window(layers, ps.records(), ps.TRAIN), "hier_graph_replays")
