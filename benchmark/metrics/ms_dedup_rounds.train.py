"""Rounds of mean shift's dedup loop a step (the program's ms_dedup_rounds
counter), in the profiled steps; None where the program has no ms_dedup
span there."""
from benchmark import program_spans as ps


def read(layers):
    part = ps.sub_window(layers, ps.records(), ps.TRAIN)
    if part is None or not any(r.name == "ms_dedup" for r in part):
        return None
    return ps.count(layers, part, "ms_dedup_rounds")
