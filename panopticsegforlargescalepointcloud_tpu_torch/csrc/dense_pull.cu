// Dense min-label pull for region growing (kernel B of the port), over the
// block pairs that can hold a neighbour.
//
// Replaces: panopticsegforlargescalepointcloud_tpu/cluster/dense_grow.py:
// _pull_kernel (launched by min_pull_pallas, looped by dense_components),
// whose spec is dense_grow.min_pull_xla:
//     out[i] = min { labels[j] : ids[j] == ids[i], d2(i, j) <= r2 },
//     d2(i, j) = sum_r qmat[r, i] * smat[r, j]   (r = 0..7, in that order)
// with +inf where no row qualifies. The [8, T] operands hold
// (-2x, -2y, -2z, 1, |q|^2, 0, 0, 0) and (x, y, z, |p|^2, 1, 0, 0, 0), so the
// contraction is |q|^2 + |p|^2 - 2 q.p; invalid rows carry +inf norms, which
// only ever multiply the constant 1, so every pair with one is +inf.
//
// The constant rows make three of the eight products x * 1 (exact) and
// three 0 * 0 (adding +0 is exact), so the sum is computed as
//     d2 = (((q0 * s0 + q1 * s1) + q2 * s2) + pn) + qn
// with pn = smat[3, j] and qn = qmat[4, i]: 3 multiplies and 4 adds per pair,
// each rounding exactly as the same step of the 8-term sum. This file is
// compiled with -fmad=false, so each product and each sum rounds as the
// plain PyTorch version's separate elementwise multiplies and adds do: pairs
// at the radius boundary decide the same way in both.
//
// What bounds it on the H100: the pairs. The TPU kernel evaluates all T^2
// (2.4e9 at T = 49,152), free on its matrix unit; here each pair costs ~10
// f32 CUDA-core instructions. Yet a row has at most ~20 same-id rows within
// the radius. So the caller (dense_grow.pull_tables, pull_tables.cu) orders
// the rows by (id, Hilbert index of a radius-sized cell), cuts that order
// into blocks of BR rows, and lists for each query block the support blocks
// with a run of one id whose id range meets one of its own and whose box lies
// within the radius, with a margin that covers the rounding of d2 (derived
// in dense_grow.pull_tables). Only those
// block pairs are evaluated; the rest provably hold no qualifying pair, and
// a min does not depend on the order of its terms, so the result equals the
// all-pairs pull row for row.
//
// Design: one thread-block cluster of SPLIT blocks per query block of BR
// rows, one query row per thread, its operand values and id in registers.
// Block k of the cluster takes candidates k, k + SPLIT, ... of the list, so
// that a query block with many candidates (a sparse id whose rows spread
// over the tile) is shared out; its support blocks stream through a two-slot
// cp.async ring in shared memory: (x, y, z, pn) as one float4, the id, and
// the label read through the row order (labels stay in the caller's order,
// so a pull is one launch). The blocks' running minima meet in distributed
// shared memory, where block 0 takes their min (no atomics, no
// initialised output) and writes the result in the caller's row order.
// Labels are f32 row ids, exact up to 2^24.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BR = 128;    // rows per block, query and support (one per thread)
constexpr int SPLIT = 8;   // blocks per cluster sharing one query block's candidates

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q, p: [T] (q0, q1, q2, qn) and (x, y, z, pn) in block order; sid: ids in
// block order; perm: block position -> caller row; cand: [nb, nb] support
// blocks of each query block, the first ncand[qb] of its row valid.
__global__ void __launch_bounds__(BR)
dense_pull_blocks_kernel(const float4* __restrict__ q, const float4* __restrict__ p,
                         const int* __restrict__ sid, const int* __restrict__ perm,
                         const float* __restrict__ labels, const int* __restrict__ cand,
                         const int* __restrict__ ncand, float* __restrict__ out, int nb,
                         float r2) {
  __shared__ __align__(16) float4 s_p[2][BR];
  __shared__ int s_id[2][BR];
  __shared__ float s_lab[2][BR];
  __shared__ float s_run[BR];

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();
  const int qb = blockIdx.x / SPLIT;
  const int tid = threadIdx.x;
  const int i = qb * BR + tid;
  const float4 qv = q[i];
  const int idq = sid[i];
  const int nc = ncand[qb];
  const int* list = cand + (int64_t)qb * nb;

  auto stage = [&](int slot, int sb) {
    const int j = sb * BR + tid;
    cp_async16(&s_p[slot][tid], p + j);
    cp_async4(&s_id[slot][tid], sid + j);
    cp_async4(&s_lab[slot][tid], labels + perm[j]);
    cp_async_commit();
  };

  float run = INFINITY;
  if (k < nc) stage(0, list[k]);
  for (int c = k, slot = 0; c < nc; c += SPLIT, slot ^= 1) {
    if (c + SPLIT < nc) {
      stage(slot ^ 1, list[c + SPLIT]);  // that slot was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < BR; ++e) {
      const float4 pv = s_p[slot][e];
      const float d2 = (((qv.x * pv.x + qv.y * pv.y) + qv.z * pv.z) + pv.w) + qv.w;
      if (d2 <= r2 && s_id[slot][e] == idq) run = fminf(run, s_lab[slot][e]);
    }
    __syncthreads();
  }
  s_run[tid] = run;
  cluster.sync();  // every block's minima are written and visible
  if (k == 0) {
    for (int r = 1; r < SPLIT; ++r) run = fminf(run, cluster.map_shared_rank(s_run, r)[tid]);
    out[perm[i]] = run;
  }
  cluster.sync();  // no block leaves while block 0 may read its minima
}

}  // namespace

// t must be a multiple of BR; every pointer is on the device.
extern "C" int pst_dense_pull_blocks(const float* q, const float* p, const int* sid,
                                     const int* perm, const float* labels, const int* cand,
                                     const int* ncand, float* out, int t, float r2,
                                     void* stream) {
  if (t % BR != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return 0;
  const int nb = t / BR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * SPLIT, 1, 1);
  cfg.blockDim = dim3(BR, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, dense_pull_blocks_kernel,
                                       reinterpret_cast<const float4*>(q),
                                       reinterpret_cast<const float4*>(p), sid, perm, labels,
                                       cand, ncand, out, nb, r2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
