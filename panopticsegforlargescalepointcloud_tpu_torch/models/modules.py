"""Building blocks of the sparse 3D UNet.

Counterparts of the JAX package's ``models/modules.py``. Every module takes
padded [N, C] features plus a valid mask and prebuilt kernel maps, and the
BN momentum of the step (used in training mode only). Every conv also gets
its transpose map, which carries its backward (:func:`..ops.conv.sparse_conv`):
a submanifold map is its own transpose, and a strided conv's is the partner
map of its down/up pair. Attribute
names mirror the flax module names (``SparseConv_0``, ``ConvBNReLU_1``,
``ResBlock_0``, ``Dense_0``, ``MaskedBatchNorm_0``, ...) so that
:func:`..weights.params_from_flax` is a rename.

Lane packing and the split-weight skip concat of the TPU path are not
carried over: the skip concat is a plain ``torch.cat`` and the 1x1 shortcut
a plain ``x @ W``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import sparse_conv
from .norm import MaskedBatchNorm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SparseConv(nn.Module):
    """One sparse convolution through a [N_out, 27] kernel map; weights
    ``kernel`` [27, Cin, Cout]. Inputs and weights are cast to
    ``compute_dtype``; accumulation and output are f32."""

    def __init__(self, cin: int, cout: int, compute_dtype: str = "float32"):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, cin, cout))
        self.compute_dtype = _DTYPES[compute_dtype]

    def forward(self, x: torch.Tensor, nbr: torch.Tensor, nbr_t=None) -> torch.Tensor:
        cdt = self.compute_dtype
        return sparse_conv(x.to(cdt).contiguous(), nbr, self.kernel.to(cdt).contiguous(), nbr_t)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, compute_dtype: str = "float32"):
        super().__init__()
        self.SparseConv_0 = SparseConv(cin, cout, compute_dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, x, nbr, mask, momentum=0.1, nbr_t=None):
        return F.relu(self.MaskedBatchNorm_0(self.SparseConv_0(x, nbr, nbr_t), mask, momentum))


class ResBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN-ReLU + (identity | 1x1 dense-BN) shortcut; the
    ReLU comes before the residual add, as in the reference."""

    def __init__(self, cin: int, cout: int, compute_dtype: str = "float32"):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, cout, compute_dtype)
        self.ConvBNReLU_1 = ConvBNReLU(cout, cout, compute_dtype)
        if cin != cout:
            self.Dense_0 = nn.Linear(cin, cout, bias=False)
            self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, x, same_map, mask, momentum=0.1):
        h = self.ConvBNReLU_0(x, same_map, mask, momentum, same_map)
        h = self.ConvBNReLU_1(h, same_map, mask, momentum, same_map)
        if hasattr(self, "Dense_0"):
            sc = self.MaskedBatchNorm_0(self.Dense_0(x), mask, momentum)
        else:
            sc = x
        return h + sc


class ResNetDown(nn.Module):
    """Strided (or submanifold) conv-BN-ReLU then ``num_blocks`` ResBlocks.
    A strided first conv keeps ``cin`` channels (the reference's quirk) and
    the first ResBlock widens to ``cout``."""

    def __init__(self, conv_nn: Sequence[int], stride: int = 2, num_blocks: int = 2,
                 compute_dtype: str = "float32"):
        super().__init__()
        cin, cout = conv_nn
        first_out = cin if stride > 1 else cout
        self.ConvBNReLU_0 = ConvBNReLU(cin, first_out, compute_dtype)
        for b in range(num_blocks):
            setattr(self, f"ResBlock_{b}",
                    ResBlock(first_out if b == 0 else cout, cout, compute_dtype))
        self.num_blocks = num_blocks

    def forward(self, x, conv_map, same_map_out, mask_out, momentum=0.1, conv_map_t=None):
        """``conv_map_t``: the transpose of ``conv_map``."""
        h = self.ConvBNReLU_0(x, conv_map, mask_out, momentum, conv_map_t)
        for b in range(self.num_blocks):
            h = getattr(self, f"ResBlock_{b}")(h, same_map_out, mask_out, momentum)
        return h


class ResNetUp(nn.Module):
    """Concatenate the skip at the coarse level, then a ResNetDown (named
    ``up``, as in flax) through the transpose map."""

    def __init__(self, conv_nn: Sequence[int], stride: int = 2, num_blocks: int = 2,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.up = ResNetDown(conv_nn, stride, num_blocks, compute_dtype)

    def forward(self, x, skip, conv_map, same_map_out, mask_out, momentum=0.1,
                conv_map_t=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        return self.up(x, conv_map, same_map_out, mask_out, momentum, conv_map_t)


class PointMLP(nn.Module):
    """Per-point [Dense -> MaskedBN -> LeakyReLU(0.2)] layers, then the mask."""

    def __init__(self, cin: int, channels: Sequence[int], use_bias: bool = True):
        super().__init__()
        self.channels = tuple(channels)
        for i, c in enumerate(self.channels):
            setattr(self, f"Dense_{i}", nn.Linear(cin, c, bias=use_bias))
            setattr(self, f"MaskedBatchNorm_{i}", MaskedBatchNorm(c))
            cin = c

    def forward(self, x, mask, momentum=0.1):
        for i in range(len(self.channels)):
            x = getattr(self, f"Dense_{i}")(x)
            x = getattr(self, f"MaskedBatchNorm_{i}")(x, mask, momentum)
            x = F.leaky_relu(x, 0.2)
        return x * mask.to(x.dtype)[:, None]
