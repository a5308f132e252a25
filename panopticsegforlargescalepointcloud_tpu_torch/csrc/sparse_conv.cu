// Gather-GEMM sparse convolution forward (kernel A of the port).
//
// Replaces: panopticsegforlargescalepointcloud_tpu/ops/winconv.py:_fwd_kernel
// (launched by _run_fwd through windowed_conv / _winconv_tm), whose spec is
// ops/conv.py:sparse_conv:
//     out[i] = sum_k feats[idx[i, k]] @ W[k],  idx = -1 contributes 0,
// feats [N_in, Cin] (f32 or bf16), idx [N_out, K] int32, W [K, Cin, Cout] in
// the feats dtype, out [N_out, Cout] f32 with f32 accumulation.
//
// What bounds it on the H100: at the paper plan's widths (Cin, Cout 4..192)
// the work per gathered row is small (2*Cout FLOPs per input value), so the
// kernel sits near the memory side of the roofline: the random row gathers
// (27 rows of Cin values per output row, served mostly from L2 since a
// level's features fit in 50 MB) and the f32 output write.
//
// Design of this first version: the TPU kernel's lane packing, union windows,
// one-hot row selection and correction lists are not carried over; a GPU
// block reads rows by index directly. The block body (a 64 x 64 output tile,
// offsets with no neighbor in the tile skipped, rows gathered into shared
// memory in chunks of 32 channels, f32 FMAs on the CUDA cores) lives in
// sparse_conv_tile.cuh, shared with the per-part probe (kernel E). Tensor
// cores (mma.sync / wgmma), TMA and multistage copies are later work.

#include "sparse_conv_tile.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int pst_sparse_conv_fwd(const void* feats, const int* idx, const void* w, float* out,
                        int n_in, int n_out, int cin, int cout, int kvol, int dtype,
                        void* stream) {
  using namespace pst_conv;
  if (n_out == 0 || cout == 0) return 0;
  dim3 grid((n_out + TM - 1) / TM, (cout + TN - 1) / TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    sparse_conv_tile<__nv_bfloat16, Part::kFull><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), idx,
        static_cast<const __nv_bfloat16*>(w), out, n_in, n_out, cin, cout, kvol);
  } else {
    sparse_conv_tile<float, Part::kFull><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(feats), idx, static_cast<const float*>(w), out,
        n_in, n_out, cin, cout, kvol);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
