from .dense_grow import dense_components, min_pull_plain
from .meanshift import mean_shift, meanshift_converge, pack_by_sample
from .neighbors import radius_graph, radius_neighbors
from .region_grow import region_grow, region_grow_folded

__all__ = [
    "dense_components", "mean_shift", "meanshift_converge", "min_pull_plain",
    "pack_by_sample", "radius_graph", "radius_neighbors", "region_grow",
    "region_grow_folded",
]
