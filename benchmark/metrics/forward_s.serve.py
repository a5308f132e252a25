"""s a scene from tiling through the eval forward's phases (tiling, collate, hierarchy, backbone_heads, region_growing, mean_shift, scorenet)."""

from benchmark.layers import per_unit


def read(layers):
    return per_unit(layers, "tiling", "collate", "hierarchy", "backbone_heads", "region_growing",
                    "mean_shift", "scorenet")
