"""Kernel E: the per-part probe of kernel A (the sparse-conv forward).

Counterpart of the JAX package's TPU probe ``scripts/bench_winkernel_parts.py``,
which ablates the windowed-conv Pallas body to say where a conv's time goes.
On the GPU the same question is put to kernel A's own body
(``csrc/sparse_conv_tile.cuh``), compiled once per part
(``csrc/sparse_conv_parts.cu``):

* ``full``: A itself, ``out[i] = sum_k feats[idx[i, k]] @ W[k]`` [N, Cout];
* ``index``: index loads and the offset skip only,
  ``out[i, 0] = #{k : idx[i, k] >= 0}`` [N, 1];
* ``gather``: the rows gathered into shared memory, no W, no FMA,
  ``out[i, c] = sum_k feats[idx[i, k], c]`` [N, Cin];
* ``contig``: A's W staging and FMA loop on contiguous rows,
  ``out[i] = sum_k [idx[i, k] >= 0] feats[i] @ W[k]`` [N, Cout], on a
  same-level map (N_in == N_out).

On a CUDA tensor :func:`sparse_conv_part` launches the kernel; on a CPU
tensor it runs :func:`sparse_conv_part_plain`.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .conv import _DTYPES, _check_cuda, _check_map, sparse_conv_plain

KERNEL = _cuda.Kernel(
    "sparse_conv_parts",
    "pst_sparse_conv_parts",
    [_cuda.INT] + [_cuda.PTR] * 4 + [_cuda.INT] * 6 + [_cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/sparse_conv_parts.cu",
    replaces="scripts/bench_winkernel_parts.py:36",
)

PARTS = ("full", "index", "gather", "contig")
# the gather part keeps its sums in registers, six 32-channel chunks at most
GATHER_MAX_CIN = 192


def _valid(idx: torch.Tensor, n_in: int) -> torch.Tensor:
    return (idx >= 0) & (idx < n_in)


def sparse_conv_part_plain(part: str, feats: torch.Tensor, idx: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The function each part computes, in plain PyTorch, f32."""
    n_in, cin = feats.shape
    if part == "full":
        return sparse_conv_plain(feats, idx, weights)
    valid = _valid(idx, n_in)
    if part == "index":
        return valid.sum(dim=1, keepdim=True).float()
    f = feats.float()
    out = torch.zeros((idx.shape[0], cin if part == "gather" else weights.shape[2]),
                      dtype=torch.float32, device=feats.device)
    if part == "gather":
        fz = torch.cat([f, f.new_zeros((1, cin))])
        idx_z = torch.where(valid, idx, torch.full_like(idx, n_in)).long()
        for k in range(idx.shape[1]):
            out += fz[idx_z[:, k]]
        return out
    if part == "contig":
        w = weights.float()
        for k in range(idx.shape[1]):
            out += torch.where(valid[:, k, None], f @ w[k], 0.0)
        return out
    raise ValueError(f"unknown part {part!r}; parts are {PARTS}")


def sparse_conv_part(part: str, feats: torch.Tensor, idx: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Kernel E, one part: feats [N_in, Cin] f32|bf16, idx [N_out, K] int32,
    weights [K, Cin, Cout] in the feats dtype -> the part's f32 output."""
    if part not in PARTS:
        raise ValueError(f"unknown part {part!r}; parts are {PARTS}")
    n_out, kvol = idx.shape
    n_in, cin = feats.shape
    if weights.dim() != 3 or weights.shape[0] != kvol or weights.shape[1] != cin:
        raise ValueError(f"weights {tuple(weights.shape)} do not match feats "
                         f"{tuple(feats.shape)} and map {tuple(idx.shape)}")
    if part == "contig" and n_in != n_out:
        raise ValueError("the contig part reads row i for output row i: it needs a "
                         f"same-level map, got N_in {n_in} != N_out {n_out}")
    if part == "gather" and cin > GATHER_MAX_CIN:
        raise ValueError(f"the gather part takes Cin <= {GATHER_MAX_CIN}, got {cin}")
    if feats.device.type == "cpu":
        return sparse_conv_part_plain(part, feats, idx, weights)
    _check_cuda("sparse_conv_part", feats, weights)
    _check_map("sparse_conv_part", idx, feats.device)
    if weights.device != feats.device:
        raise ValueError("feats and weights must be on one device")
    cout = weights.shape[2]
    width = {"full": cout, "contig": cout, "index": 1, "gather": cin}[part]
    out = torch.empty((n_out, width), dtype=torch.float32, device=feats.device)
    KERNEL(PARTS.index(part), feats.data_ptr(), idx.data_ptr(), weights.data_ptr(),
           out.data_ptr(), n_in, n_out, cin, cout, kvol, _DTYPES[feats.dtype],
           _cuda.stream_ptr(feats.device))
    return out
