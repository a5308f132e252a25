from .batch import VoxelBatch, collate_tiles
from .synthetic import synthetic_tile

__all__ = ["VoxelBatch", "collate_tiles", "synthetic_tile"]
