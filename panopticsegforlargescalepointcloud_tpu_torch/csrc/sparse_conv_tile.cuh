// The block bodies of kernel A (csrc/sparse_conv.cu), shared with its
// per-part probe, kernel E (csrc/sparse_conv_parts.cu), and their host-side
// launchers, so that E's `full` part is A's code and A's launch plan.
//
// bf16: sparse_conv_mma, an implicit GEMM on the tensor cores. A block
// computes out[BM rows, BN channels] = Ahat[BM, K * Cin] . What[K * Cin, BN],
// where row i of Ahat is the K gathered rows feats[idx[i, k]] laid end to end
// (zeros for idx = -1 and idx >= n_in) and What is W [K, Cin, Cout] viewed as
// [K * Cin, Cout]. The block loads its [BM, K] index tile once, ORs a mask of
// the offsets with a neighbor in the tile, and walks the flattened (k, c)
// axis in k16 steps:
//   - Cin % 16 == 0 ("by offset"): a step lies inside one offset; offsets
//     with no neighbor in the tile are skipped whole; a launch may split the
//     K offsets into contiguous groups (blockIdx.z), each writing f32
//     partials that a second pass sums in group order;
//   - otherwise (Cin = 4, the input conv): a step covers 16 / Cin offsets
//     (no zero padding of the channel axis), no skipping, no split.
// KS steps form a stage. Each stage's gathered rows (16- or 8-byte cp.async
// segments, zero-filled where absent) and W rows (16-byte segments) go
// through a 3-stage cp.async ring, so the gathers of stage s + 2 are in
// flight while the MMAs of stage s run. 4 warps own 16 rows x BN each;
// fragments come through ldmatrix (W's n-contiguous rows with .trans) into
// mma.sync m16n8k16 bf16 with f32 accumulators in registers (BN / 2 a
// thread). BN is the launch's own Cout tile (16 to 128 in steps of 16, 160, 192;
// ops/conv.py:conv_plan); shared-memory rows are padded by 16 bytes so the
// eight row addresses of every ldmatrix fall in distinct banks.
//
// f32: sparse_conv_tile, the first design's CUDA-core body (64 x 64 tile, offsets
// with no neighbor skipped, rows gathered in 32-channel chunks, FMAs): the
// tensor cores would round f32 operands to TF32.
//
// The compile-time Part selects what a body does, each part with an output
// that depends on every load it keeps:
//   kFull   - the whole body: out[i] = sum_k feats[idx[i, k]] @ W[k] ([N, Cout]);
//   kIndex  - the index tile and the offset skip only: out[i] = #{k : idx[i, k] >= 0} ([N, 1]);
//   kGather - the gathered rows through the ring (bf16) or into shared
//             memory (f32), no W, no products: out[i, c] = sum_k feats[idx[i, k], c] ([N, Cin]);
//   kContig - the W stream and the products on contiguous rows (row i
//             itself where idx[i, k] >= 0, on a same-level map, N_in == N_out):
//             out[i] = sum_k [idx[i, k] >= 0] feats[i] @ W[k] ([N, Cout]).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

// Internal linkage: each source that includes this file compiles its own
// instances, so the two kernels' libraries never share a kernel symbol.
namespace pst_conv {
namespace {

enum class Part { kFull = 0, kIndex = 1, kGather = 2, kContig = 3 };

// A launch's plan, as ops/conv.py:conv_plan makes it: rows per block, the
// Cout tile and the number of them, the offset groups and offsets per group.
// The launchers take it as given and refuse one their instances cannot run.
struct Plan {
  int bm, bn, n_tiles, splits, kpg;
};

// ------------------------------------------------------------ f32, CUDA cores

constexpr int TM = 64;   // output rows per block
constexpr int TN = 64;   // output channels per block
constexpr int TK = 32;   // input channels per shared-memory chunk
constexpr int THREADS = 256;
// kGather keeps one accumulator per (chunk, element) in registers
constexpr int GATHER_MAX_CIN = 192;
constexpr int GATHER_PER_THREAD = TM * TK / THREADS;

// Gather channels [c0, c0 + TK) of the tile's rows into As (zeros for absent
// rows and for the ragged channel tail).
__device__ __forceinline__ void stage_rows(const float* __restrict__ feats, const int* rows,
                                           float (*As)[TM + 1], int cin, int c0, int tid) {
  for (int e = tid; e < TM * TK; e += THREADS) {
    const int r = e / TK, c = e % TK;
    const int j = rows[r];
    float v = 0.f;
    if (j >= 0 && c0 + c < cin) v = feats[(int64_t)j * cin + c0 + c];
    As[c][r] = v;
  }
}

template <Part P>
__global__ void __launch_bounds__(THREADS)
sparse_conv_tile(const float* __restrict__ feats, const int* __restrict__ idx,
                 const float* __restrict__ w, float* __restrict__ out,
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
          if (c0 + c < cin && n0 + n < cout) v = w[((int64_t)k * cin + c0 + c) * cout + n0 + n];
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

template <Part P>
int launch_fma(const float* feats, const int* idx, const float* w, float* out, int n_in,
               int n_out, int cin, int cout, int kvol, Plan p, cudaStream_t s) {
  const int ny = (P == Part::kFull || P == Part::kContig) ? (cout + TN - 1) / TN : 1;
  if (p.bm != TM || p.bn != TN || p.n_tiles != ny || p.splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n_out + TM - 1) / TM, ny);
  sparse_conv_tile<P><<<grid, THREADS, 0, s>>>(feats, idx, w, out, n_in, n_out, cin, cout, kvol);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16, tensor cores

constexpr int MM_BM = 64;  // output rows per block: 4 warps x 16
constexpr int MM_THREADS = 128;
constexpr int MM_STAGES = 3;
constexpr int MM_KMAX = 32;  // offsets per map (one bit each in the tile's mask)
constexpr int MM_GATHER_MAX_CIN = 192;

template <int BN>
struct MmaShape {
  static_assert(BN % 16 == 0 && BN <= 192, "BN: a multiple of 16, at most 192");
  static constexpr int KS = BN <= 64 ? 4 : 2;  // k16 steps per stage
  static constexpr int BK = 16 * KS;
  static constexpr int A_PITCH = BK + 8;       // bf16; +16 bytes: conflict-free ldmatrix
  static constexpr int B_PITCH = BN + 8;
  static constexpr int A_ELEMS = MM_BM * A_PITCH;
  static constexpr int B_ELEMS = BK * B_PITCH;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
};

// Dynamic shared memory before the ring: the [BM, K] index tile, the active
// offsets, 8 words of block state and, where Cin % 16 == 0, the step table
// (one entry per k16 step: K * Cin / 16); rounded up to 128 bytes.
__host__ __device__ constexpr int mma_head_bytes(int kvol, int cin) {
  return ((MM_BM * kvol + MM_KMAX + 8 + ((cin & 15) == 0 ? kvol * (cin >> 4) : 0)) * 4 + 127) /
         128 * 128;
}

template <Part P, int BN>
constexpr int mma_smem_bytes(int kvol, int cin) {
  return P == Part::kIndex ? mma_head_bytes(kvol, cin)
                           : mma_head_bytes(kvol, cin) + MM_STAGES * MmaShape<BN>::STAGE_ELEMS * 2 +
                                 (P == Part::kGather ? (MM_BM + 1) * cin * 4 : 0);
}

// Launched as grid (row tiles, Cout tiles, offset groups of kpg offsets).
// `out` is the output itself for one group, else the workspace
// [groups, N_out, Cout]. Preconditions (launch_mma): Cin % 4 == 0, Cout % 8
// == 0, 16-byte aligned feats (8-byte where Cin % 8 == 4) and W rows, K <=
// MM_KMAX, several groups only when Cin % 16 == 0.
template <Part P, int BN>
__global__ void __launch_bounds__(MM_THREADS)
sparse_conv_mma(const __nv_bfloat16* __restrict__ feats, const int* __restrict__ idx,
                const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int n_in,
                int n_out, int cin, int cout, int kvol, int kpg) {
  using S = MmaShape<BN>;
  using namespace pst_mma;
  extern __shared__ __align__(128) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem);  // [BM][kvol]
  int* act = idx_s + MM_BM * kvol;            // active offsets, in order
  int* state = act + MM_KMAX;                 // [0..3] warp masks, [4] active count
  int* stab = state + 8;                      // step t: (first channel << 5) | offset
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + mma_head_bytes(kvol, cin));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MM_BM;
  const int n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kpg;
  const int ke = min(kvol, kb + kpg);

  // the tile's index block, once, all of a thread's loads in flight
  // together; absent rows and idx >= n_in read as -1
  constexpr int IDX_PER_THREAD = (MM_BM * MM_KMAX + MM_THREADS - 1) / MM_THREADS;
  const int tile_elems = min(MM_BM, n_out - m0) * kvol;
  const int* idx_tile = idx + (int64_t)m0 * kvol;
  int vals[IDX_PER_THREAD];
#pragma unroll
  for (int u = 0; u < IDX_PER_THREAD; ++u) {
    const int e = tid + u * MM_THREADS;
    vals[u] = e < tile_elems ? idx_tile[e] : -1;
  }
  unsigned my_mask = 0;
#pragma unroll
  for (int u = 0; u < IDX_PER_THREAD; ++u) {
    const int e = tid + u * MM_THREADS;
    if (e >= MM_BM * kvol) break;
    const int r = e / kvol, k = e - r * kvol;
    int j = vals[u];
    if (j >= n_in) j = -1;  // never produced by the maps
    if constexpr (P == Part::kContig) j = j >= 0 ? m0 + r : -1;
    idx_s[e] = j;
    if (j >= 0 && k >= kb && k < ke) my_mask |= 1u << k;
  }
  my_mask = __reduce_or_sync(0xffffffffu, my_mask);
  if (lane == 0) state[warp] = static_cast<int>(my_mask);
  __syncthreads();
  const unsigned mask = static_cast<unsigned>(state[0] | state[1] | state[2] | state[3]);
  if (tid == 0) {
    int n = 0;
    for (int k = kb; k < ke; ++k)
      if ((mask >> k) & 1u) act[n++] = k;
    state[4] = n;
  }
  __syncthreads();
  const int n_act = state[4];

  if constexpr (P == Part::kIndex) {
    // the count reads the skip's list: an offset with a neighbor in a row
    // is active in its tile
    if (tid < MM_BM && m0 + tid < n_out) {
      int count = 0;
      for (int a = 0; a < n_act; ++a) count += idx_s[tid * kvol + act[a]] >= 0;
      out[m0 + tid] = static_cast<float>(count);
    }
    return;
  }

  const bool by_offset = (cin & 15) == 0;
  const int spk = cin >> 4;  // k16 steps per offset
  const int qmax = kvol * cin;
  const int nsteps = by_offset ? n_act * spk : (mask ? (qmax + 15) / 16 : 0);
  const int nst = (nsteps + S::KS - 1) / S::KS;
  if (by_offset) {  // the steps' (offset, first channel), so the loads divide nothing
    for (int t = tid; t < nsteps; t += MM_THREADS) {
      const int a = t / spk;
      stab[t] = (((t - a * spk) * 16) << 5) | act[a];
    }
    __syncthreads();
  }

  // the offset k and channel c of flattened entry (step t, + off); false
  // past the end of the flattened axis
  auto locate = [&](int t, int off, int& k, int& c) -> bool {
    if (by_offset) {
      const int v = stab[t];
      k = v & 31;
      c = (v >> 5) + off;
      return true;
    }
    const int q = t * 16 + off;
    k = q / cin;
    c = q - k * cin;
    return q < qmax;
  };

  auto load_stage = [&](int slot, int st) {
    __nv_bfloat16* As = ring + slot * S::STAGE_ELEMS;
    __nv_bfloat16* Bs = As + S::A_ELEMS;
    if ((cin & 7) == 0) {  // 16-byte segments: 8 channels of one offset
      constexpr int SEGS = S::BK / 8;
      for (int e = tid; e < MM_BM * SEGS; e += MM_THREADS) {
        const int r = e / SEGS, s = e - r * SEGS;
        const int t = st * S::KS + (s >> 1);
        int j = -1, k, c = 0;
        if (t < nsteps && locate(t, (s & 1) * 8, k, c)) j = idx_s[r * kvol + k];
        cp_async16(As + r * S::A_PITCH + s * 8, j >= 0 ? feats + (int64_t)j * cin + c : feats,
                   j >= 0);
      }
    } else {  // Cin % 8 == 4: 8-byte segments of 4 channels
      constexpr int SEGS = S::BK / 4;
      for (int e = tid; e < MM_BM * SEGS; e += MM_THREADS) {
        const int r = e / SEGS, s = e - r * SEGS;
        const int t = st * S::KS + (s >> 2);
        int j = -1, k, c = 0;
        if (t < nsteps && locate(t, (s & 3) * 4, k, c)) j = idx_s[r * kvol + k];
        cp_async8(As + r * S::A_PITCH + s * 4, j >= 0 ? feats + (int64_t)j * cin + c : feats,
                  j >= 0);
      }
    }
    if constexpr (P != Part::kGather) {  // W rows of the stage's steps
      constexpr int NSEG = BN / 8;
      for (int e = tid; e < S::BK * NSEG; e += MM_THREADS) {
        const int kr = e / NSEG, s = e - kr * NSEG;
        const int t = st * S::KS + (kr >> 4);
        int k, c;
        const bool in = t < nsteps && locate(t, kr & 15, k, c);
        const int n = n0 + s * 8;
        const bool ok = in && n < cout;
        cp_async16(Bs + kr * S::B_PITCH + s * 8,
                   ok ? w + ((int64_t)k * cin + c) * cout + n : w, ok);
      }
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // kGather: the sums of the gathered rows, channel-major [Cin][BM + 1] f32
  // after the ring (conflict-free: a warp's lanes are 32 consecutive rows);
  // thread (row tid % BM, half tid / BM) owns the channels c with c % 16 in
  // [8 * half, 8 * half + 8)
  float* gacc = reinterpret_cast<float*>(ring + MM_STAGES * S::STAGE_ELEMS);
  if constexpr (P == Part::kGather) {
    for (int e = tid; e < (MM_BM + 1) * cin; e += MM_THREADS) gacc[e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1
    {
      const int nx = st + MM_STAGES - 1;
      if (nx < nst) load_stage(nx % MM_STAGES, nx);
      cp_async_commit();
    }
    const __nv_bfloat16* As = ring + (st % MM_STAGES) * S::STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + S::A_ELEMS;
    if constexpr (P == Part::kGather) {
      const int r = tid % MM_BM, h = tid / MM_BM;
      for (int j = 0; j < S::KS; ++j) {
        const int t = st * S::KS + j;
        if (t >= nsteps) break;
        const int c0 = (stab[t] >> 5) + h * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(As + r * S::A_PITCH + j * 16 + h * 8);
        const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) gacc[(c0 + e) * (MM_BM + 1) + r] += __bfloat162float(src[e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < S::KS; ++j) {
        uint32_t a[4];
        ldsm_x4(a, As + (warp * 16 + (lane & 15)) * S::A_PITCH + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < BN / 16; ++nn) {
          uint32_t b[4];
          ldsm_x4_trans(b, Bs + (j * 16 + (lane & 15)) * S::B_PITCH + nn * 16 + (lane >> 4) * 8);
          mma_bf16_16816(acc[2 * nn], a, b[0], b[1]);
          mma_bf16_16816(acc[2 * nn + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (P == Part::kGather) {
    __syncthreads();
    for (int e = tid; e < MM_BM * cin; e += MM_THREADS) {
      const int r = e / cin, c = e - r * cin;
      if (m0 + r < n_out) out[(int64_t)m0 * cin + e] = gacc[c * (MM_BM + 1) + r];
    }
  } else {
    float* dst = out + (int64_t)blockIdx.z * n_out * cout;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int r0 = m0 + warp * 16 + g;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int n = n0 + nt * 8 + c2;
      if (n >= cout) continue;
      if (r0 < n_out)
        *reinterpret_cast<float2*>(dst + (int64_t)r0 * cout + n) = make_float2(acc[nt][0], acc[nt][1]);
      if (r0 + 8 < n_out)
        *reinterpret_cast<float2*>(dst + (int64_t)(r0 + 8) * cout + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

template <Part P, int BN>
int launch_mma_bn(const __nv_bfloat16* feats, const int* idx, const __nv_bfloat16* w,
                  float* dst, int n_in, int n_out, int cin, int cout, int kvol, Plan p,
                  cudaStream_t s) {
  static int smem_set = 0;
  const int bytes = mma_smem_bytes<P, BN>(kvol, cin);
  const cudaError_t e = pst_mma::allow_smem(sparse_conv_mma<P, BN>, bytes, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n_out + MM_BM - 1) / MM_BM, p.n_tiles, p.splits);
  sparse_conv_mma<P, BN><<<grid, MM_THREADS, bytes, s>>>(feats, idx, w, dst, n_in, n_out, cin,
                                                         cout, kvol, p.kpg);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 launch of part P with plan `p` (ops/conv.py:conv_plan; the index
// and gather parts take one Cout tile and one group): `p.splits` offset
// groups write the workspace `ws` [splits, N_out, Cout] f32, summed into
// `out` in group order. Returns cudaErrorInvalidValue for a plan or operand
// the instances do not take.
template <Part P>
int launch_mma(const void* feats, const int* idx, const void* w, float* out, float* ws, int n_in,
               int n_out, int cin, int cout, int kvol, Plan p, cudaStream_t s) {
  constexpr bool kProducts = P == Part::kFull || P == Part::kContig;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (cin <= 0 || cin % 4 != 0 || kvol < 1 || kvol > MM_KMAX) return bad;
  if (p.bm != MM_BM || p.kpg < 1 || p.splits != (kvol + p.kpg - 1) / p.kpg) return bad;
  if (kProducts && (cout % 8 != 0 || p.bn < 1 || p.n_tiles != (cout + p.bn - 1) / p.bn)) return bad;
  if (!kProducts && (p.splits != 1 || p.n_tiles != 1)) return bad;
  if (p.splits > 1 && (cin % 16 != 0 || ws == nullptr)) return bad;
  if (P == Part::kGather && (cin % 16 != 0 || cin > MM_GATHER_MAX_CIN)) return bad;
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  float* dst = p.splits > 1 ? ws : out;
  int rc;
  if constexpr (!kProducts) {
    rc = launch_mma_bn<P, 16>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s);
  } else {
    switch (p.bn) {
      case 16: rc = launch_mma_bn<P, 16>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 32: rc = launch_mma_bn<P, 32>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 48: rc = launch_mma_bn<P, 48>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 64: rc = launch_mma_bn<P, 64>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 80: rc = launch_mma_bn<P, 80>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 96: rc = launch_mma_bn<P, 96>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 112: rc = launch_mma_bn<P, 112>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 128: rc = launch_mma_bn<P, 128>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 160: rc = launch_mma_bn<P, 160>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      case 192: rc = launch_mma_bn<P, 192>(f, idx, wb, dst, n_in, n_out, cin, cout, kvol, p, s); break;
      default: return bad;
    }
  }
  if (rc != 0 || p.splits == 1) return rc;
  return pst_mma::launch_ordered_sum(ws, out, (int64_t)n_out * cout, p.splits, s);
}

// Part P of kernel A in either dtype (0 = float32, 1 = bfloat16).
template <Part P>
int launch_part(const void* feats, const int* idx, const void* w, float* out, float* ws,
                int n_in, int n_out, int cin, int cout, int kvol, Plan p, int dtype,
                cudaStream_t s) {
  if (n_out == 0) return 0;
  if (dtype == 1)
    return launch_mma<P>(feats, idx, w, out, ws, n_in, n_out, cin, cout, kvol, p, s);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fma<P>(static_cast<const float*>(feats), idx, static_cast<const float*>(w), out,
                       n_in, n_out, cin, cout, kvol, p, s);
}

}  // namespace
}  // namespace pst_conv
