// Building blocks of the bf16 tensor-core gather-GEMMs (kernels A, D and E):
// cp.async row gathers with zero fill, ldmatrix fragment loads, the
// m16n8k16 bf16 MMA with f32 accumulation, and the ordered second-pass sum
// of split partials. Inline PTX for sm_90a; no library.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 operands), with
// g = lane / 4 and c = lane % 4:
//   A (16 x 16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 8+2c..), a3 = (g+8, 8+2c..)
//   B (16 x 8, k x n):      b0 = (k 2c..2c+1, n g), b1 = (k 8+2c.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..2c+1)
// ldmatrix.x4 takes one 16-byte row address per lane: lanes 0-7, 8-15,
// 16-23 and 24-31 address the rows of matrices 0, 1, 2 and 3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pst_mma {
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy into shared memory; when !valid nothing is read
// and the 16 bytes are zero-filled (src-size 0), so a slot never keeps a
// stale row.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 8-byte form, for rows whose segments are only 8-byte aligned (4 bf16).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16) * b (16 x 8), bf16 products (exact in f32), f32 sums
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[e] = sum over parts p = 0, 1, ... of parts[p * total + e], in part
// order: the second pass of a split, with no atomics, so a run repeats bit
// for bit.
__global__ void ordered_sum_kernel(const float* __restrict__ parts, float* __restrict__ out,
                                   int64_t total, int n_parts) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += parts[(int64_t)p * total + e];
  out[e] = s;
}

inline int launch_ordered_sum(const float* parts, float* out, int64_t total, int n_parts,
                              cudaStream_t s) {
  if (total == 0) return 0;
  const int threads = 256;
  ordered_sum_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      parts, out, total, n_parts);
  return static_cast<int>(cudaGetLastError());
}

// Raise a kernel's dynamic shared-memory limit once it needs more than the
// default 48 KB (per instantiation; `set` remembers the largest granted).
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int& set) {
  if (bytes <= 48 * 1024 || bytes <= set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
}

}  // namespace
}  // namespace pst_mma
