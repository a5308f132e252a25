"""Sparse 3D UNet and encoder over a prebuilt hierarchy (counterparts of
the JAX package's ``models/unet.py:SparseUNet`` and ``SparseEncoder``).

Skip wiring: every down output except the last is pushed; ups pop in
reverse, the first up gets no skip, and ResNetUp concatenates the skip at
the coarse level before the transpose conv.

Transpose maps, which carry each conv's backward: a down conv at level l
pairs with ``hier.up_maps[l]``, an up conv from level l with
``hier.down_maps[l - 1]``, and a submanifold map is its own transpose. The
JAX package's ``remat`` is not carried over: it worked around the TPU's
tile-padded activations, and a GPU step keeps its activations.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.hierarchy import Hierarchy
from ..ops.scatter import segment_max
from .modules import PointMLP, ResNetDown, ResNetUp


class SparseUNet(nn.Module):
    def __init__(
        self,
        down_channels: Tuple[Tuple[int, int], ...],
        up_channels: Tuple[Tuple[int, int], ...],
        down_strides: Tuple[int, ...],
        up_strides: Tuple[int, ...],
        num_blocks: int = 2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.down_strides = tuple(down_strides)
        self.up_strides = tuple(up_strides)
        for i, (ch, s) in enumerate(zip(down_channels, down_strides)):
            setattr(self, f"down_{i}", ResNetDown(ch, s, num_blocks, compute_dtype))
        for i, (ch, s) in enumerate(zip(up_channels, up_strides)):
            setattr(self, f"up_{i}", ResNetUp(ch, s, num_blocks, compute_dtype))
        self.output_nc = up_channels[-1][1]

    def forward(self, x: torch.Tensor, hier: Hierarchy, momentum=0.1) -> torch.Tensor:
        level = 0
        skips = []
        n_down = len(self.down_strides)
        for i, s in enumerate(self.down_strides):
            if s == 1:
                conv_map = conv_map_t = hier.same_maps[level]
                out_level = level
            else:
                conv_map, conv_map_t = hier.down_maps[level], hier.up_maps[level]
                out_level = level + 1
            x = getattr(self, f"down_{i}")(
                x, conv_map, hier.same_maps[out_level], hier.grids[out_level].mask,
                momentum, conv_map_t,
            )
            level = out_level
            if i < n_down - 1:
                skips.append((x, level))
        skips.append((None, level))

        for i, s in enumerate(self.up_strides):
            skip, skip_level = skips.pop()
            if skip_level != level:
                raise ValueError(f"up module {i}: skip level {skip_level} != {level}")
            if s == 1:
                conv_map = conv_map_t = hier.same_maps[level]
                out_level = level
            else:
                conv_map, conv_map_t = hier.up_maps[level - 1], hier.down_maps[level - 1]
                out_level = level - 1
            x = getattr(self, f"up_{i}")(
                x, skip, conv_map, hier.same_maps[out_level], hier.grids[out_level].mask,
                momentum, conv_map_t,
            )
            level = out_level
        if level != 0:
            raise ValueError(f"UNet did not return to level 0 (at {level})")
        return x


class SparseEncoder(nn.Module):
    """ResNetDowns, then ``PointMLP_0`` (the ``global_nn`` channels) on the
    coarsest grid and a max pool per sample of that grid: [num_segments,
    global_nn[-1]], 0 where a segment has no row (the reference's
    ScorerEncoder, a global max aggregation). In the ScoreNet the grid's
    batch field is the proposal id, carried down the levels by the
    hierarchy, so the pool yields one row per proposal."""

    def __init__(
        self,
        down_channels: Tuple[Tuple[int, int], ...],
        down_strides: Tuple[int, ...],
        global_nn: Tuple[int, ...],
        num_segments: int,
        num_blocks: int = 2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.down_strides = tuple(down_strides)
        self.num_segments = num_segments
        for i, (ch, s) in enumerate(zip(down_channels, down_strides)):
            setattr(self, f"down_{i}", ResNetDown(ch, s, num_blocks, compute_dtype))
        self.PointMLP_0 = PointMLP(down_channels[-1][1], global_nn)
        self.output_nc = global_nn[-1]

    def forward(self, x: torch.Tensor, hier: Hierarchy, momentum=0.1,
                num_segments: int | None = None) -> torch.Tensor:
        """``num_segments``: the pool's rows where the forward's proposal
        budget differs from the model's (grouped serving dispatch)."""
        level = 0
        for i, s in enumerate(self.down_strides):
            if s == 1:
                conv_map = conv_map_t = hier.same_maps[level]
                out_level = level
            else:
                conv_map, conv_map_t = hier.down_maps[level], hier.up_maps[level]
                out_level = level + 1
            x = getattr(self, f"down_{i}")(
                x, conv_map, hier.same_maps[out_level], hier.grids[out_level].mask,
                momentum, conv_map_t,
            )
            level = out_level
        grid = hier.grids[level]
        x = self.PointMLP_0(x, grid.mask, momentum)
        seg = torch.where(grid.mask, grid.batch, torch.full_like(grid.batch, -1))
        return segment_max(x, seg, num_segments or self.num_segments, fill=0.0)
