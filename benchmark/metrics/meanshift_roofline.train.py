"""Kernel C's share of its roofline, in %: the least time of mean shift's
work in the profiled steps (:mod:`benchmark.ms_counts`, from their recorded
heads, which the embed cell's driver keeps) over C's device time inside
their ``mean_shift`` phases."""


def read(layers):
    tr = layers.trace if layers is not None else None
    bound = getattr(layers, "ms_bound_s", 0.0)
    if tr is None or not bound:
        return None
    c = tr.family_in_phase("C", "mean_shift")
    return 100.0 * bound / c if c > 0 else None
