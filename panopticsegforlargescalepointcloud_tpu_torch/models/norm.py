"""Masked batch normalization for padded [N, C] voxel features.

Counterpart of the JAX package's ``models/norm.py:MaskedBatchNorm``: padding
rows are zeroed on output and statistics are f32. In training mode
(``module.train()``) it normalizes with the batch mean and biased variance
over the valid rows and updates the running statistics; in eval mode the
running statistics normalize. Momentum follows torch (new = (1 - m) *
running + m * batch) and is a call argument, as in the JAX package, so a
scheduler changes it per step without touching the modules.
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor, momentum=0.1) -> torch.Tensor:
        m = mask.to(torch.float32)[:, None]
        if self.training:
            xf = x.float() * m
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = xf.sum(dim=0) / cnt
            # torch.maximum (not clamp) splits the gradient at a tie, as
            # jnp.maximum does
            var = torch.maximum((xf * xf).sum(dim=0) / cnt - mean * mean, xf.new_zeros(()))
            # The running statistics are state, not part of the graph: they
            # are updated in place, outside autograd. Like torch's BatchNorm
            # they keep the unbiased variance, while the batch is normalized
            # with the biased one.
            with torch.no_grad():
                mom = torch.as_tensor(momentum, dtype=torch.float32, device=x.device)
                unbiased = var * (cnt / torch.clamp(cnt - 1.0, min=1.0))
                self.mean.copy_((1.0 - mom) * self.mean + mom * mean)
                self.var.copy_((1.0 - mom) * self.var + mom * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x.float() - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        return (y * m).to(x.dtype)
