from .conv import sparse_conv, sparse_conv_dw, sparse_conv_dw_plain, sparse_conv_plain
from .hashing import DEFAULT_BITS, INVALID_KEY, BitLayout, lookup, pack_coords, unpack_coords
from .hierarchy import Hierarchy, build_hierarchy, default_capacities
from .sparse import (
    KERNEL_OFFSETS_K3,
    SparseGrid,
    derive_down_map,
    derive_level_maps,
    derive_same_map,
    down_map,
    down_map_fine_side,
    downsample,
    make_grid,
    same_level_map,
    up_map,
    up_map_from_down,
)

__all__ = [
    "BitLayout", "DEFAULT_BITS", "INVALID_KEY", "Hierarchy", "KERNEL_OFFSETS_K3", "SparseGrid",
    "build_hierarchy", "default_capacities", "derive_down_map", "derive_level_maps",
    "derive_same_map", "down_map", "down_map_fine_side", "downsample", "lookup", "make_grid",
    "pack_coords", "same_level_map", "sparse_conv", "sparse_conv_dw", "sparse_conv_dw_plain",
    "sparse_conv_plain", "unpack_coords", "up_map", "up_map_from_down",
]
