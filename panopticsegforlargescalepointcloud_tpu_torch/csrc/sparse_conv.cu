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
// block reads rows by index directly. One block computes a 64 x 64 output
// tile with 256 threads (4 x 4 f32 accumulators each, in registers). It walks
// the 27 offsets; for each it loads the tile's index column, skips the offset
// when no row of the tile has a neighbor there (strided maps are sparse),
// gathers the rows into shared memory in chunks of 32 input channels (zeros
// for -1 and for the ragged channel tail, so any Cin works), stages the
// matching W_k chunk, and accumulates with FMAs on the CUDA cores. bf16
// inputs are widened to f32 on the way into shared memory; their products
// are exact in f32. Tensor cores (mma.sync / wgmma), TMA and multistage
// copies are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TN = 64;   // output channels per block
constexpr int TK = 32;   // input channels per shared-memory chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
sparse_conv_fwd_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                       const T* __restrict__ w, float* __restrict__ out,
                       int n_in, int n_out, int cin, int cout, int kvol) {
  __shared__ float As[TK][TM + 1];  // gathered rows, channel-major
  __shared__ float Bs[TK][TN];
  __shared__ int rows[TM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kvol; ++k) {
    int has = 0;
    if (tid < TM) {
      const int r = m0 + tid;
      int j = r < n_out ? idx[(int64_t)r * kvol + k] : -1;
      if (j >= n_in) j = -1;  // never produced by the maps; read as absent
      rows[tid] = j;
      has = j >= 0;
    }
    if (!__syncthreads_or(has)) continue;

    for (int c0 = 0; c0 < cin; c0 += TK) {
      for (int e = tid; e < TM * TK; e += THREADS) {
        const int r = e / TK, c = e % TK;
        const int j = rows[r];
        float v = 0.f;
        if (j >= 0 && c0 + c < cin) v = to_f32(feats[(int64_t)j * cin + c0 + c]);
        As[c][r] = v;
      }
      for (int e = tid; e < TK * TN; e += THREADS) {
        const int c = e / TN, n = e % TN;
        float v = 0.f;
        if (c0 + c < cin && n0 + n < cout)
          v = to_f32(w[((int64_t)k * cin + c0 + c) * cout + n0 + n]);
        Bs[c][n] = v;
      }
      __syncthreads();
      const int kc = min(TK, cin - c0);
      for (int kk = 0; kk < kc; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < cout) out[(int64_t)r * cout + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int pst_sparse_conv_fwd(const void* feats, const int* idx, const void* w, float* out,
                        int n_in, int n_out, int cin, int cout, int kvol, int dtype,
                        void* stream) {
  if (n_out == 0 || cout == 0) return 0;
  dim3 grid((n_out + TM - 1) / TM, (cout + TN - 1) / TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    sparse_conv_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), idx,
        static_cast<const __nv_bfloat16*>(w), out, n_in, n_out, cin, cout, kvol);
  } else {
    sparse_conv_fwd_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(feats), idx, static_cast<const float*>(w), out,
        n_in, n_out, cin, cout, kvol);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
