"""Sparse convolution ``out[i] = sum_k feats[idx[i, k]] @ W[k]`` and its
gradient.

Counterpart of the JAX package's ``ops/conv.py``: :func:`sparse_conv` with a
transpose map is the custom VJP ``_conv_tm``. Its backward runs through the
transpose map ``idx_t`` (``idx_t[j, K-1-k] = i  <=>  idx[i, k] = j``):

* dX is the same convolution on ``idx_t`` with the flipped, transposed
  weights, so it is kernel A again (``csrc/sparse_conv.cu``), counted apart
  in :data:`KERNEL_DX`;
* dW is ``dW[k] = sum_i feats[idx[i, k]]^T g[i]``, kernel D
  (``csrc/sparse_conv_dw.cu``).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version: :func:`sparse_conv_plain` (the JAX package's ``_apply``:
zero pad row, per-offset gather and GEMM, f32 accumulation) and
:func:`sparse_conv_dw_plain` (``_conv_tm_bwd``'s per-offset ``fk^T @ g``).
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
# kernel A in its backward role (dX on the transpose map): the same entry
# point, launches counted apart from the forward's
KERNEL_DX = _cuda.Kernel(
    "sparse_conv_dx",
    "pst_sparse_conv_fwd",
    KERNEL.argtypes,
    source=KERNEL.source,
    replaces=KERNEL.replaces,
)
KERNEL_DW = _cuda.Kernel(
    "sparse_conv_dw",
    "pst_sparse_conv_dw",
    [_cuda.PTR] * 5 + [_cuda.INT] * 7 + [_cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/sparse_conv_dw.cu",
    replaces="panopticsegforlargescalepointcloud_tpu/ops/winconv.py:343",
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel D's row groups (csrc/sparse_conv_dw.cu): rows per chunk, the blocks
# wanted (8 per SM of an H100), and the workspace cap.
_DW_ROWS = 64
_DW_BLOCKS = 8 * 132
_DW_WORKSPACE_BYTES = 32 << 20


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


def sparse_conv_dw_plain(feats: torch.Tensor, idx: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Per-offset gather and ``fk^T @ g``, in f32: [K, Cin, Cout]."""
    n_in, cin = feats.shape
    fz = torch.cat([feats, feats.new_zeros((1, cin))], dim=0).float()
    idx_z = torch.where(idx >= 0, idx, torch.full_like(idx, n_in)).long()
    gf = g.float()
    return torch.stack([fz[idx_z[:, k]].T @ gf for k in range(idx.shape[1])])


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors[1:]):
        raise TypeError(f"{name} takes f32 or bf16 operands of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def _check_map(name: str, idx: torch.Tensor, device) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: kernel map must be int32, got {idx.dtype}")
    if idx.device != device or not idx.is_contiguous():
        raise ValueError(f"{name}: the kernel map must be contiguous and on the operands' device")


def sparse_conv_fwd(feats: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                    kernel: _cuda.Kernel = KERNEL) -> torch.Tensor:
    """Kernel A: feats [N_in, Cin], idx [N_out, K] int32 (-1 = absent),
    weights [K, Cin, Cout] in the feats dtype -> [N_out, Cout] f32.
    ``kernel`` names the role whose counter the launch adds to."""
    n_out, kvol = idx.shape
    if weights.dim() != 3 or weights.shape[0] != kvol or weights.shape[1] != feats.shape[1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match feats "
                         f"{tuple(feats.shape)} and map {tuple(idx.shape)}")
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, idx, weights)
    _check_cuda("sparse_conv", feats, weights)
    _check_map("sparse_conv", idx, feats.device)
    if weights.device != feats.device:
        raise ValueError("feats and weights must be on one device")
    n_in, cin = feats.shape
    cout = weights.shape[2]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=feats.device)
    kernel(feats.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(),
           n_in, n_out, cin, cout, kvol, _DTYPES[feats.dtype], _cuda.stream_ptr(feats.device))
    return out


def _dw_row_groups(n_out: int, kvol: int, cin: int, cout: int) -> int:
    """Row groups of kernel D: enough blocks to fill the card, at most one
    group per 64-row chunk, and a workspace of at most 32 MiB."""
    tiles = -(-cin // 64) * -(-cout // 64)  # the kernel's tiles: one up to 64 wide
    want = -(-_DW_BLOCKS // (kvol * tiles))
    cap = _DW_WORKSPACE_BYTES // (kvol * cin * cout * 4)
    chunks = -(-n_out // _DW_ROWS)
    return max(1, min(want, cap, chunks))


def sparse_conv_dw(feats: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel D: feats [N_in, Cin], idx [N_out, K] int32, g [N_out, Cout] in
    the feats dtype -> dW [K, Cin, Cout] f32."""
    n_out, kvol = idx.shape
    if g.dim() != 2 or g.shape[0] != n_out:
        raise ValueError(f"g {tuple(g.shape)} does not match map {tuple(idx.shape)}")
    if feats.device.type == "cpu":
        return sparse_conv_dw_plain(feats, idx, g)
    _check_cuda("sparse_conv_dw", feats, g)
    _check_map("sparse_conv_dw", idx, feats.device)
    if g.device != feats.device:
        raise ValueError("feats and g must be on one device")
    n_in, cin = feats.shape
    cout = g.shape[1]
    out = torch.empty((kvol, cin, cout), dtype=torch.float32, device=feats.device)
    groups = _dw_row_groups(n_out, kvol, cin, cout)
    partial = (torch.empty((groups, kvol, cin, cout), dtype=torch.float32, device=feats.device)
               if groups > 1 else out)
    KERNEL_DW(feats.data_ptr(), idx.data_ptr(), g.data_ptr(), partial.data_ptr(),
              out.data_ptr(), n_in, n_out, cin, cout, kvol, groups, _DTYPES[feats.dtype],
              _cuda.stream_ptr(feats.device))
    return out


class _SparseConvTM(torch.autograd.Function):
    """``_conv_tm`` of the JAX package: forward through ``idx``, backward
    through the transpose map ``idx_t``."""

    @staticmethod
    def forward(ctx, feats, weights, idx, idx_t):
        ctx.save_for_backward(feats, weights, idx, idx_t)
        return sparse_conv_fwd(feats, idx, weights)

    @staticmethod
    def backward(ctx, g):
        feats, weights, idx, idx_t = ctx.saved_tensors
        gq = g.to(feats.dtype).contiguous()
        gf = gw = None
        if ctx.needs_input_grad[0]:
            w_t = weights.flip(0).transpose(1, 2).contiguous()
            gf = sparse_conv_fwd(gq, idx_t, w_t, kernel=KERNEL_DX).to(feats.dtype)
        if ctx.needs_input_grad[1]:
            gw = sparse_conv_dw(feats, idx, gq).to(weights.dtype)
        return gf, gw, None, None


def sparse_conv(feats: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                idx_t: torch.Tensor | None = None) -> torch.Tensor:
    """feats [N_in, Cin] f32|bf16, idx [N_out, K] int32 (-1 = absent),
    weights [K, Cin, Cout] in the feats dtype -> [N_out, Cout] f32.

    ``idx_t`` ([N_in, K]) is the transpose map: the submanifold map itself,
    or the partner of a down/up pair. With it the result is differentiable
    through the kernels (dX by kernel A on ``idx_t``, dW by kernel D).
    Without it only a CPU call is differentiable (through the plain
    version's own autograd); a CUDA call that needs a gradient raises."""
    if idx_t is None:
        if (feats.device.type != "cpu" and torch.is_grad_enabled()
                and (feats.requires_grad or weights.requires_grad)):
            raise ValueError("sparse_conv needs the transpose map idx_t to differentiate "
                             "on the GPU")
        return sparse_conv_fwd(feats, idx, weights)
    if idx_t.shape != (feats.shape[0], idx.shape[1]):
        raise ValueError(f"transpose map {tuple(idx_t.shape)} does not match feats "
                         f"{tuple(feats.shape)} and map {tuple(idx.shape)}")
    return _SparseConvTM.apply(feats, weights, idx, idx_t)
