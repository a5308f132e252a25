from .conv import sparse_conv, sparse_conv_dw, sparse_conv_dw_plain, sparse_conv_plain
from .hashing import DEFAULT_BITS, INVALID_KEY, BitLayout, lookup, pack_coords
from .hierarchy import Hierarchy, build_hierarchy, default_capacities
from .sparse import SparseGrid, derive_level_maps, downsample, make_grid, same_level_map

__all__ = [
    "BitLayout", "DEFAULT_BITS", "INVALID_KEY", "Hierarchy", "SparseGrid",
    "build_hierarchy", "default_capacities", "derive_level_maps", "downsample",
    "lookup", "make_grid", "pack_coords", "same_level_map", "sparse_conv",
    "sparse_conv_dw", "sparse_conv_dw_plain", "sparse_conv_plain",
]
