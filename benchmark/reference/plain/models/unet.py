"""Sparse 3D UNet over a prebuilt hierarchy (counterpart of the JAX
package's ``models/unet.py:SparseUNet``).

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
from .modules import ResNetDown, ResNetUp


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
        self.up_channels = tuple(up_channels)

    @property
    def output_nc(self) -> int:
        return self.up_channels[-1][1]

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
