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

In bf16 the parts are compile-time parts of A's tensor-core body: ``gather``
is the cp.async ring with a dependent output, ``contig`` the MMAs on
contiguous rows; in f32, of A's CUDA-core body. Each launch takes A's plan
(:func:`.conv.conv_plan`), so ``full`` equals A bit for bit. On a CUDA tensor
:func:`sparse_conv_part` launches the kernel; on a CPU tensor it runs
:func:`sparse_conv_part_plain`.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .conv import _DTYPES, check_operands, conv_plan, sparse_conv_plain

KERNEL = _cuda.Kernel(
    "sparse_conv_parts",
    "pst_sparse_conv_parts",
    [_cuda.INT] + [_cuda.PTR] * 5 + [_cuda.INT] * 11 + [_cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/sparse_conv_parts.cu",
    replaces="scripts/bench_winkernel_parts.py:36",
)

PARTS = ("full", "index", "gather", "contig")
# the gather part keeps its sums in registers (f32) or shared memory (bf16)
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
    check_operands("sparse_conv_part", feats, weights, idx)
    if part == "gather" and feats.dtype == torch.bfloat16 and cin % 16:
        raise ValueError(f"the bf16 gather part takes Cin a multiple of 16, got {cin}")
    cout = weights.shape[2]
    width = {"full": cout, "contig": cout, "index": 1, "gather": cin}[part]
    out = torch.empty((n_out, width), dtype=torch.float32, device=feats.device)
    # A's plan for the parts with its products; the index and gather parts
    # cover every offset in one pass, with one Cout tile
    plan = conv_plan(n_out, cin, cout, kvol, feats.dtype)
    if part not in ("full", "contig"):
        plan = plan._replace(n_tiles=1, splits=1, kpg=kvol)
    ws = (torch.empty((plan.splits, n_out, cout), dtype=torch.float32, device=feats.device)
          if plan.splits > 1 else None)
    KERNEL(PARTS.index(part), feats.data_ptr(), idx.data_ptr(), weights.data_ptr(),
           out.data_ptr(), ws.data_ptr() if ws is not None else None, n_in, n_out, cin, cout,
           kvol, plan.bm, plan.bn, plan.n_tiles, plan.splits, plan.kpg, _DTYPES[feats.dtype],
           _cuda.stream_ptr(feats.device))
    return out
