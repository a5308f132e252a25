// The pair tables of kernel B (dense_pull.cu), built on the device in three
// launches around one sort, once per dense_components call.
//
// Part of the port of panopticsegforlargescalepointcloud_tpu/cluster/
// dense_grow.py:_pull_kernel. The TPU kernel needs no tables: it evaluates
// all T^2 pairs on its matrix unit. Kernel B evaluates only the block pairs
// these tables list; dense_grow.pull_tables (whose plain PyTorch versions,
// _keys_plain, _blocks_plain and _cands_plain, these kernels equal bit for
// bit) states the rule and derives the skip's margin.
//
//  1. pull_keys_kernel: a 64-bit sort key per row: (id, Hilbert index of the
//     row's radius-sized cell), the index reversed for odd ids so that one
//     id's last rows and the next id's first rows share a corner; invalid
//     rows (non-finite norm) get the largest key. A Hilbert order, unlike a
//     Morton order, never jumps between far cells, so BR consecutive rows of
//     one id stay small in all three axes.
//  2. (torch.argsort, stable, in the caller.)
//  3. pull_blocks_kernel: one block per BR rows of the order: gathers the
//     rows' operands, ids and row numbers into block order, cuts the block
//     into at most SEGS runs of one id (the last takes the rest), and writes
//     each run's box, id range and largest norm over its valid rows (an
//     empty range, idlo > idhi, where it has none).
//  4. pull_cands_kernel: one block per query block: tests it against every
//     support block (any run pair with meeting id ranges and a box distance
//     within r2 + margin) and writes the candidates in ascending order.
//
// What bounds it on the H100: a few passes over T rows and (T / BR)^2 run
// tests, microseconds; the tables replace some 130 small PyTorch operations
// whose host work (~3 ms a build) outlasted the pulls they serve. This file
// is compiled with -fmad=false: the candidate test rounds as the plain
// version's separate operations do, so the two give the same lists.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;   // rows per block (dense_pull.cu: BR)
constexpr int SEGS = 4;   // id runs per block with a box of their own
constexpr int BITS = 16;  // Hilbert bits per axis
constexpr int ID_SHIFT = 3 * BITS;
constexpr long long LAST_KEY = 0x7fffffffffffffffLL;

__device__ __forceinline__ unsigned long long spread3(unsigned long long v) {
  v = (v | (v << 32)) & 0x1F00000000FFFFull;
  v = (v | (v << 16)) & 0x1F0000FF0000FFull;
  v = (v | (v << 8)) & 0x100F00F00F00F00Full;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
  return (v | (v << 2)) & 0x1249249249249249ull;
}

// Skilling's transform (AIP Conf. Proc. 707, 2004): cell coordinates to the
// transposed Hilbert index, then interleaved, X[0] the high bit of a level.
__device__ __forceinline__ unsigned long long hilbert3(unsigned x0, unsigned x1, unsigned x2) {
  unsigned X[3] = {x0, x1, x2};
  for (unsigned q = 1u << (BITS - 1); q > 1; q >>= 1) {
    const unsigned p = q - 1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (X[i] & q) {
        X[0] ^= p;
      } else {
        const unsigned t = (X[0] ^ X[i]) & p;
        X[0] ^= t;
        X[i] ^= t;
      }
    }
  }
  X[1] ^= X[0];
  X[2] ^= X[1];
  unsigned t = 0;
  for (unsigned q = 1u << (BITS - 1); q > 1; q >>= 1)
    if (X[2] & q) t ^= q - 1;
#pragma unroll
  for (int i = 0; i < 3; ++i) X[i] ^= t;
  return (spread3(X[0]) << 2) | (spread3(X[1]) << 1) | spread3(X[2]);
}

__device__ __forceinline__ bool row_valid(const float* qmat, const float* smat, int t, int i) {
  return isfinite(smat[3 * (int64_t)t + i]) && isfinite(qmat[4 * (int64_t)t + i]);
}

__global__ void pull_keys_kernel(const float* __restrict__ qmat, const float* __restrict__ smat,
                                 const int* __restrict__ ids, const float* __restrict__ lo,
                                 long long* __restrict__ key, int t, float inv_cell) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t) return;
  if (!row_valid(qmat, smat, t, i)) {
    key[i] = LAST_KEY;
    return;
  }
  unsigned c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f = floorf((smat[k * (int64_t)t + i] - lo[k]) * inv_cell);
    c[k] = (unsigned)fminf(fmaxf(f, 0.f), (float)((1 << BITS) - 1));
  }
  unsigned long long h = hilbert3(c[0], c[1], c[2]);
  const long long id = min(max(ids[i], 0), (1 << (63 - ID_SHIFT)) - 1);
  if (id & 1) h = ((1ull << ID_SHIFT) - 1) - h;
  key[i] = (long long)(((unsigned long long)id << ID_SHIFT) | h);
}

// float <-> int with the same order, for shared-memory atomic min and max
__device__ __forceinline__ int ord(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float unord(int b) {
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}

// q, p: [T, 4] in block order; sid, perm32: [T]; per run r = block * SEGS +
// k: lo, hi [R, 3], idlo, idhi, nmax [R]
__global__ void __launch_bounds__(BR)
pull_blocks_kernel(const float* __restrict__ qmat, const float* __restrict__ smat,
                   const int* __restrict__ ids, const long long* __restrict__ perm, int t,
                   float4* __restrict__ q, float4* __restrict__ p, int* __restrict__ sid,
                   int* __restrict__ perm32, float* __restrict__ lo, float* __restrict__ hi,
                   int* __restrict__ idlo, int* __restrict__ idhi, float* __restrict__ nmax) {
  __shared__ int s_id[BR];
  __shared__ int s_warp[BR / 32];
  __shared__ int s_lo[SEGS][3], s_hi[SEGS][3], s_idlo[SEGS], s_idhi[SEGS], s_nmax[SEGS];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * BR + tid;
  const int row = (int)perm[j];
  const int64_t T = t;
  const float4 pv = make_float4(smat[row], smat[T + row], smat[2 * T + row], smat[3 * T + row]);
  q[j] = make_float4(qmat[row], qmat[T + row], qmat[2 * T + row], qmat[4 * T + row]);
  p[j] = pv;
  const int id = ids[row];
  sid[j] = id;
  perm32[j] = row;
  const bool valid = row_valid(qmat, smat, t, row);

  if (tid < SEGS) {
    for (int k = 0; k < 3; ++k) {
      s_lo[tid][k] = ord(INFINITY);
      s_hi[tid][k] = ord(-INFINITY);
    }
    s_idlo[tid] = INT_MAX;  // an empty id range: a run with no valid row
    s_idhi[tid] = INT_MIN;
    s_nmax[tid] = ord(0.f);
  }
  s_id[tid] = id;
  __syncthreads();
  // run index: the count of id changes up to this row, capped
  const int lane = tid & 31, warp = tid >> 5;
  const bool first = tid == 0 || s_id[tid - 1] != id;
  const unsigned ball = __ballot_sync(0xffffffffu, first);
  int pre = __popc(ball & (0xffffffffu >> (31 - lane)));  // inclusive, in the warp
  if (lane == 31) s_warp[warp] = pre;
  __syncthreads();
  for (int w = 0; w < warp; ++w) pre += s_warp[w];
  const int seg = min(pre - 1, SEGS - 1);
  if (valid) {
    atomicMin(&s_lo[seg][0], ord(pv.x));
    atomicMin(&s_lo[seg][1], ord(pv.y));
    atomicMin(&s_lo[seg][2], ord(pv.z));
    atomicMax(&s_hi[seg][0], ord(pv.x));
    atomicMax(&s_hi[seg][1], ord(pv.y));
    atomicMax(&s_hi[seg][2], ord(pv.z));
    atomicMin(&s_idlo[seg], id);
    atomicMax(&s_idhi[seg], id);
    atomicMax(&s_nmax[seg], ord(pv.w));
  }
  __syncthreads();
  if (tid < SEGS) {
    const int r = blockIdx.x * SEGS + tid;
    for (int k = 0; k < 3; ++k) {
      lo[3 * r + k] = unord(s_lo[tid][k]);
      hi[3 * r + k] = unord(s_hi[tid][k]);
    }
    idlo[r] = s_idlo[tid];
    idhi[r] = s_idhi[tid];
    nmax[r] = unord(s_nmax[tid]);
  }
}

__device__ __forceinline__ bool runs_meet(const float* alo, const float* ahi, int ailo, int aihi,
                                          float an, const float* blo, const float* bhi,
                                          int bilo, int bihi, float bn, float r2,
                                          float margin_scale) {
  // a run with no valid row has idlo > idhi
  if (ailo > aihi || bilo > bihi || ailo > bihi || bilo > aihi) return false;
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = fmaxf(fmaxf(alo[k] - bhi[k], blo[k] - ahi[k]), 0.f);
  const float bd2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2];
  const float margin = margin_scale * ((an + bn) + r2);
  return bd2 <= r2 + margin;
}

__global__ void __launch_bounds__(BR)
pull_cands_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                  const int* __restrict__ idlo, const int* __restrict__ idhi,
                  const float* __restrict__ nmax, int nb, float r2, float margin_scale,
                  int* __restrict__ cand, int* __restrict__ ncand) {
  __shared__ float s_lo[SEGS][3], s_hi[SEGS][3], s_n[SEGS];
  __shared__ int s_ilo[SEGS], s_ihi[SEGS];
  __shared__ int s_warp[BR / 32];
  __shared__ int s_base;

  const int qb = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < SEGS) {
    const int r = qb * SEGS + tid;
    for (int k = 0; k < 3; ++k) {
      s_lo[tid][k] = lo[3 * r + k];
      s_hi[tid][k] = hi[3 * r + k];
    }
    s_ilo[tid] = idlo[r];
    s_ihi[tid] = idhi[r];
    s_n[tid] = nmax[r];
  }
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (int c0 = 0; c0 < nb; c0 += BR) {
    const int sb = c0 + tid;
    bool ok = false;
    if (sb < nb) {
      for (int b = 0; b < SEGS && !ok; ++b) {
        const int r = sb * SEGS + b;
        const float* blo = lo + 3 * r;
        const float* bhi = hi + 3 * r;
        const int bilo = idlo[r], bihi = idhi[r];
        const float bn = nmax[r];
        for (int a = 0; a < SEGS && !ok; ++a)
          ok = runs_meet(s_lo[a], s_hi[a], s_ilo[a], s_ihi[a], s_n[a], blo, bhi, bilo, bihi,
                         bn, r2, margin_scale);
      }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int off = s_base;
    for (int w = 0; w < warp; ++w) off += s_warp[w];
    if (ok) cand[(int64_t)qb * nb + off + __popc(ball & ((1u << lane) - 1))] = sb;
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int w = 0; w < BR / 32; ++w) n += s_warp[w];
      s_base += n;
    }
    __syncthreads();
  }
  if (tid == 0) ncand[qb] = s_base;
}

}  // namespace

// key: [T] int64; lo: [3] f32, the valid rows' smallest coordinates;
// inv_cell: 1 / the cell's side.
extern "C" int pst_pull_keys(const float* qmat, const float* smat, const int* ids,
                             const float* lo, long long* key, int t, float inv_cell,
                             void* stream) {
  if (t == 0) return 0;
  pull_keys_kernel<<<(t + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      qmat, smat, ids, lo, key, t, inv_cell);
  return static_cast<int>(cudaGetLastError());
}

// perm: [T] int64 from the stable sort of the keys; t a multiple of BR.
extern "C" int pst_pull_blocks(const float* qmat, const float* smat, const int* ids,
                               const long long* perm, int t, float* q, float* p, int* sid,
                               int* perm32, float* lo, float* hi, int* idlo, int* idhi,
                               float* nmax, void* stream) {
  if (t % BR != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return 0;
  pull_blocks_kernel<<<t / BR, BR, 0, static_cast<cudaStream_t>(stream)>>>(
      qmat, smat, ids, perm, t, reinterpret_cast<float4*>(q), reinterpret_cast<float4*>(p),
      sid, perm32, lo, hi, idlo, idhi, nmax);
  return static_cast<int>(cudaGetLastError());
}

// cand: [nb, nb] (only the first ncand[qb] of row qb are written), ncand: [nb]
extern "C" int pst_pull_cands(const float* lo, const float* hi, const int* idlo,
                              const int* idhi, const float* nmax, int nb, float r2,
                              float margin_scale, int* cand, int* ncand, void* stream) {
  if (nb == 0) return 0;
  pull_cands_kernel<<<nb, BR, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, idlo, idhi, nmax, nb, r2, margin_scale, cand, ncand);
  return static_cast<int>(cudaGetLastError());
}
