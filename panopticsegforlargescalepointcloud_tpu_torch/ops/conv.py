"""Sparse convolution forward: ``out[i] = sum_k feats[idx[i, k]] @ W[k]``.

Counterpart of the JAX package's ``ops/conv.py:sparse_conv`` (forward only).
On a CUDA tensor :func:`sparse_conv` launches the gather-GEMM kernel
``csrc/sparse_conv.cu``; on a CPU tensor it runs :func:`sparse_conv_plain`,
the JAX package's ``_apply`` (zero pad row, per-offset gather and GEMM, f32
accumulation).
"""

from __future__ import annotations

import torch

from .. import _cuda

KERNEL = _cuda.Kernel(
    "sparse_conv_fwd",
    "pst_sparse_conv_fwd",
    [_cuda.PTR] * 4 + [_cuda.INT] * 6 + [_cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/sparse_conv.cu",
    replaces="panopticsegforlargescalepointcloud_tpu/ops/winconv.py:307",
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
        out += fz[idx_z[:, k]] @ w[k]
    return out


def sparse_conv(feats: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """feats [N_in, Cin] f32|bf16, idx [N_out, K] int32 (-1 = absent),
    weights [K, Cin, Cout] in the feats dtype -> [N_out, Cout] f32."""
    n_out, kvol = idx.shape
    if weights.dim() != 3 or weights.shape[0] != kvol or weights.shape[1] != feats.shape[1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match feats "
                         f"{tuple(feats.shape)} and map {tuple(idx.shape)}")
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, idx, weights)
    if feats.dtype not in _DTYPES or weights.dtype != feats.dtype:
        raise TypeError(f"sparse_conv takes f32 or bf16 feats and weights of the same "
                        f"dtype, got {feats.dtype} and {weights.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"kernel map must be int32, got {idx.dtype}")
    if not (idx.device == feats.device == weights.device):
        raise ValueError("feats, map and weights must be on one device")
    if not (feats.is_contiguous() and idx.is_contiguous() and weights.is_contiguous()):
        raise ValueError("sparse_conv needs contiguous feats, map and weights")
    n_in, cin = feats.shape
    cout = weights.shape[2]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=feats.device)
    KERNEL(feats.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(),
           n_in, n_out, cin, cout, kvol, _DTYPES[feats.dtype],
           _cuda.stream_ptr(feats.device))
    return out
