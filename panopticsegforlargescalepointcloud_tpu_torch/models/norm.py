"""Masked batch normalization for padded [N, C] voxel features.

Counterpart of the JAX package's ``models/norm.py:MaskedBatchNorm``: padding
rows are zeroed on output and statistics are f32. In training mode
(``module.train()``) it normalizes with the batch mean and biased variance
over the valid rows and updates the running statistics; in eval mode the
running statistics normalize. Momentum follows torch (new = (1 - m) *
running + m * batch) and is a call argument, as in the JAX package, so a
scheduler changes it per step without touching the modules: a float, or a
0-dim f32 tensor on the device (:func:`momentum_tensor`), which the train
step uploads once and hands to every BN, so that no BN call reads the host.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import trace


def momentum_tensor(momentum, device) -> torch.Tensor:
    """The BN momentum as a 0-dim f32 tensor on ``device``: a tensor as it
    is (cast and moved where it differs), a float uploaded, one blocking
    host read (``sync::bn_momentum``)."""
    if isinstance(momentum, torch.Tensor):
        return momentum.to(device=device, dtype=torch.float32)
    with trace.host_read("bn_momentum"):
        return torch.as_tensor(momentum, dtype=torch.float32, device=device)


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
                mom = momentum_tensor(momentum, x.device)
                unbiased = var * (cnt / torch.clamp(cnt - 1.0, min=1.0))
                self.mean.copy_((1.0 - mom) * self.mean + mom * mean)
                self.var.copy_((1.0 - mom) * self.var + mom * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x.float() - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        return (y * m).to(x.dtype)
