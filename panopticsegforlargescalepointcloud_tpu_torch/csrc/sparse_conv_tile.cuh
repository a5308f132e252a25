// The block body of kernel A (csrc/sparse_conv.cu), shared with its per-part
// probe, kernel E (csrc/sparse_conv_parts.cu).
//
// One block computes a 64 x 64 output tile with 256 threads (4 x 4 f32
// accumulators each, in registers). It walks the K offsets; for each it
// loads the tile's index column and skips the offset when no row of the tile
// has a neighbor there (__syncthreads_or), gathers the rows into shared
// memory in chunks of 32 input channels (zeros for -1 and for the ragged
// channel tail), stages the matching W_k chunk, and accumulates with FMAs on
// the CUDA cores. bf16 inputs are widened to f32 on the way into shared
// memory; their products are exact in f32.
//
// The compile-time Part selects what the body does, each part with an
// output that depends on every load it keeps:
//   kFull   - the whole body: out[i] = sum_k feats[idx[i, k]] @ W[k] ([N, Cout]);
//   kIndex  - index loads and the skip only: out[i] = #{k : idx[i, k] >= 0} ([N, 1]);
//   kGather - the gathered rows into shared memory, no W staging, no FMA:
//             out[i, c] = sum_k feats[idx[i, k], c] ([N, Cin]);
//   kContig - W staging and the FMA loop on contiguous rows (row i itself
//             where idx[i, k] >= 0, on a same-level map, N_in == N_out):
//             out[i] = sum_k [idx[i, k] >= 0] feats[i] @ W[k] ([N, Cout]).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: each source that includes this file compiles its own
// instances, so the two kernels' libraries never share a kernel symbol.
namespace pst_conv {
namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TN = 64;   // output channels per block
constexpr int TK = 32;   // input channels per shared-memory chunk
constexpr int THREADS = 256;
// kGather keeps one accumulator per (chunk, element) in registers
constexpr int GATHER_MAX_CIN = 192;
constexpr int GATHER_PER_THREAD = TM * TK / THREADS;

enum class Part { kFull = 0, kIndex = 1, kGather = 2, kContig = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Gather channels [c0, c0 + TK) of the tile's rows into As (zeros for absent
// rows and for the ragged channel tail).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ feats, const int* rows,
                                           float (*As)[TM + 1], int cin, int c0, int tid) {
  for (int e = tid; e < TM * TK; e += THREADS) {
    const int r = e / TK, c = e % TK;
    const int j = rows[r];
    float v = 0.f;
    if (j >= 0 && c0 + c < cin) v = to_f32(feats[(int64_t)j * cin + c0 + c]);
    As[c][r] = v;
  }
}

template <typename T, Part P>
__global__ void __launch_bounds__(THREADS)
sparse_conv_tile(const T* __restrict__ feats, const int* __restrict__ idx,
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
  float gacc[GATHER_MAX_CIN / TK][GATHER_PER_THREAD];
  if constexpr (P == Part::kGather) {
#pragma unroll
    for (int q = 0; q < GATHER_MAX_CIN / TK; ++q)
#pragma unroll
      for (int e = 0; e < GATHER_PER_THREAD; ++e) gacc[q][e] = 0.f;
  }
  int count = 0;

  for (int k = 0; k < kvol; ++k) {
    int has = 0;
    if (tid < TM) {
      const int r = m0 + tid;
      int j = r < n_out ? idx[(int64_t)r * kvol + k] : -1;
      if (j >= n_in) j = -1;  // never produced by the maps; read as absent
      if constexpr (P == Part::kContig) j = j >= 0 ? r : -1;
      rows[tid] = j;
      has = j >= 0;
      count += has;
    }
    if (!__syncthreads_or(has)) continue;

    if constexpr (P == Part::kGather) {
#pragma unroll
      for (int q = 0; q < GATHER_MAX_CIN / TK; ++q) {
        if (q * TK >= cin) break;
        stage_rows(feats, rows, As, cin, q * TK, tid);
        __syncthreads();
#pragma unroll
        for (int e = 0; e < GATHER_PER_THREAD; ++e) {
          const int el = tid + e * THREADS;
          gacc[q][e] += As[el % TK][el / TK];
        }
        __syncthreads();
      }
    } else if constexpr (P != Part::kIndex) {
      for (int c0 = 0; c0 < cin; c0 += TK) {
        stage_rows(feats, rows, As, cin, c0, tid);
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
  }

  if constexpr (P == Part::kIndex) {
    if (tid < TM && m0 + tid < n_out) out[m0 + tid] = static_cast<float>(count);
  } else if constexpr (P == Part::kGather) {
#pragma unroll
    for (int q = 0; q < GATHER_MAX_CIN / TK; ++q)
#pragma unroll
      for (int e = 0; e < GATHER_PER_THREAD; ++e) {
        const int el = tid + e * THREADS;
        const int r = m0 + el / TK, c = q * TK + el % TK;
        if (r < n_out && c < cin) out[(int64_t)r * cin + c] = gacc[q][e];
      }
  } else {
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
}

}  // namespace
}  // namespace pst_conv
