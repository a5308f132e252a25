from .dense_grow import (
    dense_components,
    min_pull,
    min_pull_blocks_plain,
    min_pull_plain,
    pull_tables,
)
from .meanshift import (
    mean_shift,
    meanshift_converge,
    meanshift_converge_plain,
    meanshift_update,
    pack_by_sample,
    shift_iter_plain,
)
from .neighbors import radius_graph, radius_neighbors
from .region_grow import region_grow_folded

__all__ = [
    "dense_components", "mean_shift", "meanshift_converge", "meanshift_converge_plain",
    "meanshift_update", "min_pull", "min_pull_blocks_plain", "min_pull_plain",
    "pack_by_sample", "pull_tables", "radius_graph", "radius_neighbors", "region_grow_folded",
    "shift_iter_plain",
]
