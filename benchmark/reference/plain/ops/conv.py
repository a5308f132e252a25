"""Sparse convolution ``out[i] = sum_k feats[idx[i, k]] @ W[k]``, plain.

The reference's copy of the port's plain sparse convolution: a zero pad
row, one gather and GEMM per offset, f32 accumulation, and PyTorch's own
autograd for the backward (the port's custom backward through the
transpose map gives the same sums). No kernel of the port is used, on any
device.

``operand_round``, when given, is applied to the gathered operands and the
weights before each GEMM, and to the output's gradient: the precision
control rounds them to fp8 there (:mod:`..precision`)."""

from __future__ import annotations

import torch


def sparse_conv_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Zero-pad-row gathers + one GEMM per offset, accumulated in f32."""
    n_in, cin = feats.shape
    fz = torch.cat([feats, feats.new_zeros((1, cin))], dim=0).float()
    idx_z = torch.where(idx >= 0, idx, torch.full_like(idx, n_in)).long()
    w = weights.float()
    out = torch.zeros((idx.shape[0], weights.shape[2]), dtype=torch.float32,
                      device=feats.device)
    for k in range(idx.shape[1]):
        # index_select: its backward adds rows with index_add_, where advanced
        # indexing's sorts them first (seconds a step on the card)
        out = out + torch.index_select(fz, 0, idx_z[:, k]) @ w[k]
    return out


def sparse_conv(feats: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                idx_t: torch.Tensor | None = None) -> torch.Tensor:
    """feats [N_in, Cin], idx [N_out, K] int32 (-1 = absent), weights [K,
    Cin, Cout] -> [N_out, Cout] f32, differentiable by autograd.
    ``idx_t`` (the transpose map the port's backward takes) is not needed."""
    return sparse_conv_plain(feats, idx, weights)


__all__ = ["sparse_conv", "sparse_conv_plain"]
