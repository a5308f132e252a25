"""CUDA graph replays of the backbone and heads a step (the program's
graph_replays counter: one the forward's, one the backward's), in the
profiled steps: 2 where the graphs run, 0 where the step stays eager; None
where the program has no backbone graphs."""
import importlib.util

from benchmark import program_spans as ps

PROGRAM = "panopticsegforlargescalepointcloud_tpu_torch.models.graphed"


def read(layers):
    try:
        if importlib.util.find_spec(PROGRAM) is None:
            return None
    except ImportError:
        return None
    return ps.count(layers, ps.sub_window(layers, ps.records(), ps.TRAIN), "graph_replays")
