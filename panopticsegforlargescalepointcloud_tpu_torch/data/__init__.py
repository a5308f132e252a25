from .batch import VoxelBatch, batch_arrays, collate_tiles
from .datasets import NPM3D_SPEC, TREEINS_SPEC, DatasetSpec, PanopticFileDataset
from .synthetic import synthetic_tile

__all__ = ["DatasetSpec", "NPM3D_SPEC", "PanopticFileDataset", "TREEINS_SPEC", "VoxelBatch",
           "batch_arrays", "collate_tiles", "synthetic_tile"]
