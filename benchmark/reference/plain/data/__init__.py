from .batch import VoxelBatch, batch_arrays, collate_tiles, stack_device_batches
from .datasets import NPM3D_SPEC, TREEINS_SPEC, DatasetSpec, PanopticFileDataset

__all__ = ["DatasetSpec", "NPM3D_SPEC", "PanopticFileDataset", "TREEINS_SPEC", "VoxelBatch",
           "batch_arrays", "collate_tiles", "stack_device_batches"]
