"""Masked batch normalization for padded [N, C] voxel features (eval).

Counterpart of the JAX package's ``models/norm.py:MaskedBatchNorm``: padding
rows are zeroed on output, statistics are f32. This slice runs inference
only, so the running statistics normalize (the training branch comes with
the training slice).
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """Parameters ``scale``/``bias`` and buffers ``mean``/``var`` carry the
    flax names (``MaskedBatchNorm_*/{scale,bias}``, batch_stats
    ``{mean,var}``)."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.to(torch.float32)[:, None]
        y = (x.float() - self.mean) * torch.rsqrt(self.var + self.epsilon)
        y = y * self.scale + self.bias
        return (y * m).to(x.dtype)
