// Dense min-label pull for region growing (kernel B of the port).
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
// each rounding exactly as the same step of the 8-term sum.
//
// What bounds it on the H100: the T x T pair loop. At T = 49,152 that is
// 2.4e9 pairs of 7 flops each, plus an id compare, a d2 compare and a min,
// on the f32 CUDA cores; the operands (T x 6 words) stay in L2.
//
// Design: one thread per query row, 256 rows per block, the query's four
// operand values and id in registers. Support rows stream through shared
// memory in chunks of 1024, (x, y, z, pn) as one float4 so each pair costs
// one 16-byte shared load besides the id. This file is compiled with
// -fmad=false, so each product and each sum rounds as the plain PyTorch
// version's separate elementwise multiplies and adds do: pairs at the radius
// boundary decide the same way in both. Labels are f32 row ids, exact up to
// 2^24.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 256;   // query rows per block (one per thread)
constexpr int CH = 1024;  // support rows per shared-memory chunk

__global__ void __launch_bounds__(BQ)
dense_pull_kernel(const float* __restrict__ qmat, const float* __restrict__ smat,
                  const int* __restrict__ ids, const float* __restrict__ labels,
                  float* __restrict__ out, int t, float r2) {
  __shared__ float4 s_p[CH];  // (x, y, z, pn) of each support row
  __shared__ int s_id[CH];
  __shared__ float s_lab[CH];

  const int i = blockIdx.x * BQ + threadIdx.x;
  const bool active = i < t;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, qn = 0.f;
  int idq = 0;
  if (active) {
    q0 = qmat[i];
    q1 = qmat[(int64_t)t + i];
    q2 = qmat[2 * (int64_t)t + i];
    qn = qmat[4 * (int64_t)t + i];
    idq = ids[i];
  }
  float run = INFINITY;

  for (int s0 = 0; s0 < t; s0 += CH) {
    const int cnt = min(CH, t - s0);
    for (int e = threadIdx.x; e < cnt; e += BQ) {
      const int64_t j = s0 + e;
      s_p[e] = make_float4(smat[j], smat[(int64_t)t + j], smat[2 * (int64_t)t + j],
                           smat[3 * (int64_t)t + j]);
      s_id[e] = ids[j];
      s_lab[e] = labels[j];
    }
    __syncthreads();
    if (active) {
      for (int e = 0; e < cnt; ++e) {
        const float4 p = s_p[e];
        const float d2 = (((q0 * p.x + q1 * p.y) + q2 * p.z) + p.w) + qn;
        if (d2 <= r2 && s_id[e] == idq) run = fminf(run, s_lab[e]);
      }
    }
    __syncthreads();
  }
  if (active) out[i] = run;
}

}  // namespace

extern "C" int pst_dense_pull(const float* qmat, const float* smat, const int* ids,
                              const float* labels, float* out, int t, float r2,
                              void* stream) {
  if (t == 0) return 0;
  dense_pull_kernel<<<(t + BQ - 1) / BQ, BQ, 0, static_cast<cudaStream_t>(stream)>>>(
      qmat, smat, ids, labels, out, t, r2);
  return static_cast<int>(cudaGetLastError());
}
