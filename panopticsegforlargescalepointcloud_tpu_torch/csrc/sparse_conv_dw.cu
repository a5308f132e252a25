// Sparse-convolution weight gradient (kernel D of the port).
//
// Replaces: panopticsegforlargescalepointcloud_tpu/ops/winconv.py:_dw_kernel
// (launched by _run_dw from the windowed conv's custom VJP), whose spec is
// the dW half of ops/conv.py:_conv_tm_bwd:
//     dW[k] = sum_i feats[idx[i, k]]^T (x) g[i]   over rows i with idx[i, k] >= 0,
// feats [N_in, Cin] and g [N_out, Cout] in one dtype (f32 or bf16; bf16 x
// bf16 products are exact in f32), idx [N_out, K] int32, dW [K, Cin, Cout]
// f32 with f32 accumulation.
//
// What bounds it on the H100: each (row, offset) pair with a neighbor costs
// 2 * Cin * Cout FLOPs against Cin + Cout gathered values, so at the paper
// plan's widths (4..192) the bytes (feats, g and the map once) bound it, like
// kernel A. The first design put one offset in each block, so every g
// row was staged again for each of the 27 offsets; its tiles were at least 16
// channels wide (3/4 zeros at Cin 4); its products were FMAs on the CUDA
// cores.
//
// What this design does about it (bf16). dW is viewed as [K * Cin, Cout] =
// sum over rows of Ahat^T g, Ahat the rows' K gathered feats rows laid end to
// end (as in kernel A). A block owns 64 entries of the flattened (k, c) axis
// (16 offsets at Cin 4, 4 at Cin 16, part of one offset's channels at Cin
// >= 64) and a Cout tile shaped to the width (ops/conv.py:dw_plan), and walks
// a fixed contiguous group of output rows in chunks of 32: each chunk's g
// rows are staged once for every offset of the tile. A first pass marks the
// chunks with a neighbor at some offset of the tile (one warp per chunk) and
// compacts them in order; the rest are skipped. The gathered feats rows
// (cp.async, 16 or 8 bytes, zero fill for absent rows) and the g rows go
// through a 3-stage cp.async ring; both operands reach the mma.sync m16n8k16
// fragments through ldmatrix.trans; f32 accumulators stay in registers. Each
// row group writes its own partial [K * Cin, Cout]; a second pass sums them
// in group order. No atomics: a run repeats bit for bit. f32 keeps the first design's
// CUDA-core kernel (width-shaped 16/32/64 tiles, one offset per block): the
// tensor cores would round f32 to TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// ------------------------------------------------------------ f32, CUDA cores

constexpr int TR = 64;   // output rows per chunk
constexpr int THREADS = 256;
constexpr int MAX_TILE = 64;

template <int TCI, int TCO>
__global__ void __launch_bounds__(THREADS)
sparse_conv_dw_partial_kernel(const float* __restrict__ feats, const int* __restrict__ idx,
                              const float* __restrict__ g, float* __restrict__ partial,
                              int n_in, int n_out, int cin, int cout, int kvol,
                              int chunks_per_group) {
  constexpr int TX = TCO / 4;          // threads along Cout
  constexpr int TPT = (TCI / 4) * TX;  // threads per tile
  constexpr int RS = THREADS / TPT;    // interleaved row sets
  static_assert(RS * TCI * TCO <= 2 * TR * MAX_TILE, "partial tiles must fit the staging");
  // staging (gathered feats rows, then g rows) during the walk; the row
  // sets' partial tiles at the end
  __shared__ float smem[2 * TR * MAX_TILE];
  __shared__ int rows[TR];
  float (*Fs)[TCI] = reinterpret_cast<float (*)[TCI]>(smem);
  float (*Gs)[TCO] = reinterpret_cast<float (*)[TCO]>(smem + TR * TCI);

  const int grp = blockIdx.x;
  const int co_tiles = (cout + TCO - 1) / TCO;
  const int ci0 = (blockIdx.y / co_tiles) * TCI;
  const int co0 = (blockIdx.y % co_tiles) * TCO;
  const int k = blockIdx.z;
  const int tid = threadIdx.x;
  const int rs = tid / TPT;
  const int tx = (tid % TPT) % TX;
  const int ty = (tid % TPT) / TX;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_chunks = (n_out + TR - 1) / TR;
  const int c_begin = grp * chunks_per_group;
  const int c_end = min(c_begin + chunks_per_group, n_chunks);
  for (int c = c_begin; c < c_end; ++c) {
    const int r0 = c * TR;
    int has = 0;
    if (tid < TR) {
      const int r = r0 + tid;
      int j = r < n_out ? idx[(int64_t)r * kvol + k] : -1;
      if (j >= n_in) j = -1;  // never produced by the maps; read as absent
      rows[tid] = j;
      has = j >= 0;
    }
    if (!__syncthreads_or(has)) continue;

    for (int e = tid; e < TR * TCI; e += THREADS) {
      const int r = e / TCI, ci = e % TCI;
      const int j = rows[r];
      float v = 0.f;
      if (j >= 0 && ci0 + ci < cin) v = feats[(int64_t)j * cin + ci0 + ci];
      Fs[r][ci] = v;
    }
    for (int e = tid; e < TR * TCO; e += THREADS) {
      const int r = e / TCO, co = e % TCO;
      float v = 0.f;
      if (rows[r] >= 0 && co0 + co < cout) v = g[(int64_t)(r0 + r) * cout + co0 + co];
      Gs[r][co] = v;
    }
    __syncthreads();
    for (int r = rs; r < TR; r += RS) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Fs[r][ty + (TCI / 4) * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Gs[r][tx + TX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // sum the row sets' tiles in set order; every (k, ci, co) of the tile is
  // written, zeros included, since the reduce reads all groups
  float* red = smem;  // [RS][TCI][TCO]; nothing reads the staging any more
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(rs * TCI + ty + (TCI / 4) * i) * TCO + tx + TX * j] = acc[i][j];
  __syncthreads();
  float* dst = partial + ((int64_t)grp * kvol + k) * cin * cout;
  for (int e = tid; e < TCI * TCO; e += THREADS) {
    float s = 0.f;
    for (int q = 0; q < RS; ++q) s += red[q * TCI * TCO + e];
    const int ci = ci0 + e / TCO, co = co0 + e % TCO;
    if (ci < cin && co < cout) dst[(int64_t)ci * cout + co] = s;
  }
}

int tile_for(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : MAX_TILE); }

template <int TCI, int TCO>
void launch_partial(dim3 grid, cudaStream_t s, const float* feats, const int* idx, const float* g,
                    float* dst, int n_in, int n_out, int cin, int cout, int kvol, int cpg) {
  sparse_conv_dw_partial_kernel<TCI, TCO><<<grid, THREADS, 0, s>>>(feats, idx, g, dst, n_in,
                                                                   n_out, cin, cout, kvol, cpg);
}

template <int TCI>
void launch_tco(int tco, dim3 grid, cudaStream_t s, const float* feats, const int* idx,
                const float* g, float* dst, int n_in, int n_out, int cin, int cout, int kvol,
                int cpg) {
  if (tco == 16)
    launch_partial<TCI, 16>(grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else if (tco == 32)
    launch_partial<TCI, 32>(grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else
    launch_partial<TCI, 64>(grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
}

int launch_fma(const float* feats, const int* idx, const float* g, float* dst, int n_in,
               int n_out, int cin, int cout, int kvol, int groups, int cpg, cudaStream_t s) {
  const int tci = tile_for(cin), tco = tile_for(cout);
  dim3 grid(groups, ((cin + tci - 1) / tci) * ((cout + tco - 1) / tco), kvol);
  if (tci == 16)
    launch_tco<16>(tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else if (tci == 32)
    launch_tco<32>(tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else
    launch_tco<64>(tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16, tensor cores

constexpr int DW_BM = 64;  // flattened (offset, channel) entries per block: 4 warps x 16
constexpr int DW_BR = 32;  // output rows per chunk: two k16 steps
constexpr int DW_THREADS = 128;
constexpr int DW_STAGES = 3;

// dynamic shared memory before the ring: the group's active chunk list, 8
// words of block state, one flag byte per chunk; rounded up to 128 bytes
__host__ __device__ constexpr int dw_head_bytes(int chunks_per_group) {
  return ((chunks_per_group * 4 + 8 * 4 + chunks_per_group) + 127) / 128 * 128;
}

template <int BN>
struct DwShape {
  static_assert(BN % 16 == 0 && BN <= 192, "BN: a multiple of 16, at most 192");
  static constexpr int F_PITCH = DW_BM + 8;  // bf16; +16 bytes: conflict-free ldmatrix
  static constexpr int G_PITCH = BN + 8;
  static constexpr int F_ELEMS = DW_BR * F_PITCH;
  static constexpr int G_ELEMS = DW_BR * G_PITCH;
  static constexpr int STAGE_ELEMS = F_ELEMS + G_ELEMS;
};

// Launched as grid (flattened tiles, Cout tiles, row groups of
// chunks_per_group chunks); writes partial[group] ([K * Cin, Cout] each;
// the output itself for one group). Preconditions (pst_sparse_conv_dw): Cin
// % 4 == 0, Cout % 8 == 0, 16-byte aligned g rows and feats rows (8-byte
// where Cin % 8 == 4).
template <int BN>
__global__ void __launch_bounds__(DW_THREADS)
sparse_conv_dw_mma(const __nv_bfloat16* __restrict__ feats, const int* __restrict__ idx,
                   const __nv_bfloat16* __restrict__ g, float* __restrict__ partial, int n_in,
                   int n_out, int cin, int cout, int kvol, int chunks_per_group) {
  using S = DwShape<BN>;
  using namespace pst_mma;
  extern __shared__ __align__(128) unsigned char smem[];
  int* list = reinterpret_cast<int*>(smem);  // active chunks of the group, in order
  int* state = list + chunks_per_group;      // [0..3] per-warp counts
  unsigned char* flags = reinterpret_cast<unsigned char*>(state + 8);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + dw_head_bytes(chunks_per_group));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qmax = kvol * cin;
  const int qm0 = blockIdx.x * DW_BM;
  const int n0 = blockIdx.y * BN;
  const int grp = blockIdx.z;
  const int kb = qm0 / cin;
  const int ke = min(kvol, (min(qm0 + DW_BM, qmax) - 1) / cin + 1);
  const int n_chunks = (n_out + DW_BR - 1) / DW_BR;
  const int c_begin = grp * chunks_per_group;
  const int nc = max(0, min(c_begin + chunks_per_group, n_chunks) - c_begin);

  // 1. the group's chunks with a neighbor at some offset of the tile
  for (int c = warp; c < nc; c += DW_THREADS / 32) {
    const int i = (c_begin + c) * DW_BR + lane;
    bool has = false;
    if (i < n_out)
      for (int k = kb; k < ke; ++k) {
        const int j = idx[(int64_t)i * kvol + k];
        has |= j >= 0 && j < n_in;
      }
    const bool any = __any_sync(0xffffffffu, has);
    if (lane == 0) flags[c] = any ? 1 : 0;
  }
  __syncthreads();
  // 2. compacted in chunk order, 128 flags a round
  int n_act = 0;
  for (int base = 0; base < nc; base += DW_THREADS) {
    const bool f = base + tid < nc && flags[base + tid];
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (lane == 0) state[warp] = __popc(b);
    __syncthreads();
    int off = n_act;
    for (int w = 0; w < warp; ++w) off += state[w];
    if (f) list[off + __popc(b & ((1u << lane) - 1u))] = base + tid;
    n_act += state[0] + state[1] + state[2] + state[3];
    __syncthreads();
  }

  auto load_stage = [&](int slot, int a) {
    __nv_bfloat16* Fs = ring + slot * S::STAGE_ELEMS;
    __nv_bfloat16* Gs = Fs + S::F_ELEMS;
    const int r0 = (c_begin + list[a]) * DW_BR;
    if ((cin & 7) == 0) {  // 16-byte segments: 8 channels of one offset
      constexpr int SEGS = DW_BM / 8;
      for (int e = tid; e < DW_BR * SEGS; e += DW_THREADS) {
        const int rr = e / SEGS, s = e - rr * SEGS;
        const int q = qm0 + s * 8, i = r0 + rr;
        int j = -1, c = 0;
        if (q < qmax && i < n_out) {
          const int k = q / cin;
          c = q - k * cin;
          j = idx[(int64_t)i * kvol + k];
          if (j >= n_in) j = -1;
        }
        cp_async16(Fs + rr * S::F_PITCH + s * 8, j >= 0 ? feats + (int64_t)j * cin + c : feats,
                   j >= 0);
      }
    } else {  // Cin % 8 == 4: 8-byte segments of 4 channels
      constexpr int SEGS = DW_BM / 4;
      for (int e = tid; e < DW_BR * SEGS; e += DW_THREADS) {
        const int rr = e / SEGS, s = e - rr * SEGS;
        const int q = qm0 + s * 4, i = r0 + rr;
        int j = -1, c = 0;
        if (q < qmax && i < n_out) {
          const int k = q / cin;
          c = q - k * cin;
          j = idx[(int64_t)i * kvol + k];
          if (j >= n_in) j = -1;
        }
        cp_async8(Fs + rr * S::F_PITCH + s * 4, j >= 0 ? feats + (int64_t)j * cin + c : feats,
                  j >= 0);
      }
    }
    constexpr int NSEG = BN / 8;
    for (int e = tid; e < DW_BR * NSEG; e += DW_THREADS) {
      const int rr = e / NSEG, s = e - rr * NSEG;
      const int i = r0 + rr, n = n0 + s * 8;
      const bool ok = i < n_out && n < cout;
      cp_async16(Gs + rr * S::G_PITCH + s * 8, ok ? g + (int64_t)i * cout + n : g, ok);
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < n_act) load_stage(s, s);
    cp_async_commit();
  }
  for (int a = 0; a < n_act; ++a) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // chunk a has landed; every warp is done with chunk a - 1
    {
      const int nx = a + DW_STAGES - 1;
      if (nx < n_act) load_stage(nx % DW_STAGES, nx);
      cp_async_commit();
    }
    const __nv_bfloat16* Fs = ring + (a % DW_STAGES) * S::STAGE_ELEMS;
    const __nv_bfloat16* Gs = Fs + S::F_ELEMS;
#pragma unroll
    for (int ks = 0; ks < DW_BR / 16; ++ks) {
      // A = Fs^T: rows m (the warp's 16 flattened entries), columns the
      // chunk's rows; stored row-major as [row][m], hence .trans
      uint32_t af[4];
      ldsm_x4_trans(af, Fs + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * S::F_PITCH +
                            warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4_trans(b, Gs + (ks * 16 + (lane & 15)) * S::G_PITCH + nn * 16 + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * nn], af, b[0], b[1]);
        mma_bf16_16816(acc[2 * nn + 1], af, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // every (q, n) of the tile is written, zeros included: the second pass
  // reads every group
  float* dst = partial + (int64_t)grp * qmax * cout;
  const int q0 = qm0 + warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int n = n0 + nt * 8 + c2;
    if (n >= cout) continue;
    if (q0 < qmax)
      *reinterpret_cast<float2*>(dst + (int64_t)q0 * cout + n) = make_float2(acc[nt][0], acc[nt][1]);
    if (q0 + 8 < qmax)
      *reinterpret_cast<float2*>(dst + (int64_t)(q0 + 8) * cout + n) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int BN>
int launch_dw_bn(const void* feats, const int* idx, const void* g, float* dst, int n_in,
                 int n_out, int cin, int cout, int kvol, dim3 grid, int cpg, cudaStream_t s) {
  static int smem_set = 0;
  const int bytes = dw_head_bytes(cpg) + DW_STAGES * DwShape<BN>::STAGE_ELEMS * 2;
  const cudaError_t e = pst_mma::allow_smem(sparse_conv_dw_mma<BN>, bytes, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  sparse_conv_dw_mma<BN><<<grid, DW_THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(feats), idx, static_cast<const __nv_bfloat16*>(g), dst,
      n_in, n_out, cin, cout, kvol, cpg);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 launch with the plan of ops/conv.py:dw_plan: Cout tile `bn`,
// m_tiles x n_tiles output tiles, `groups` row groups of `cpg` chunks.
int launch_mma(const void* feats, const int* idx, const void* g, float* dst, int n_in, int n_out,
               int cin, int cout, int kvol, int bn, int m_tiles, int n_tiles, int groups, int cpg,
               cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (cin % 4 != 0 || cout % 8 != 0 || bn < 1) return bad;
  if (m_tiles != (kvol * cin + DW_BM - 1) / DW_BM || n_tiles != (cout + bn - 1) / bn) return bad;
  const dim3 grid(m_tiles, n_tiles, groups);
  switch (bn) {
    case 16: return launch_dw_bn<16>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 32: return launch_dw_bn<32>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 48: return launch_dw_bn<48>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 64: return launch_dw_bn<64>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 80: return launch_dw_bn<80>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 96: return launch_dw_bn<96>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 112: return launch_dw_bn<112>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 128: return launch_dw_bn<128>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 160: return launch_dw_bn<160>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    case 192: return launch_dw_bn<192>(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, grid, cpg, s);
    default: return bad;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bn, m_tiles, n_tiles, groups,
// rows_per_group: the plan of ops/conv.py:dw_plan (the f32 kernel picks its
// own 16/32/64 tiles and takes only the row groups). partial: workspace
// [groups, K, Cin, Cout] f32 (unused, may be null, when groups == 1: the one
// group writes ``out``). Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int pst_sparse_conv_dw(const void* feats, const int* idx, const void* g,
                                  float* partial, float* out, int n_in, int n_out, int cin,
                                  int cout, int kvol, int bn, int m_tiles, int n_tiles,
                                  int groups, int rows_per_group, int dtype, void* stream) {
  if (cin == 0 || cout == 0 || kvol == 0) return 0;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int chunk = dtype == 1 ? DW_BR : TR;  // rows per chunk of the dtype's kernel
  if (groups < 1 || (groups > 1 && partial == nullptr) || rows_per_group < 0 ||
      rows_per_group % chunk != 0 || (int64_t)groups * rows_per_group < n_out)
    return bad;
  const int cpg = rows_per_group / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = groups == 1 ? out : partial;
  int rc;
  if (dtype == 1)
    rc = launch_mma(feats, idx, g, dst, n_in, n_out, cin, cout, kvol, bn, m_tiles, n_tiles, groups,
                    cpg, s);
  else if (dtype == 0)
    rc = launch_fma(static_cast<const float*>(feats), idx, static_cast<const float*>(g), dst, n_in,
                    n_out, cin, cout, kvol, groups, cpg, s);
  else
    rc = bad;
  if (rc != 0 || groups == 1) return rc;
  return pst_mma::launch_ordered_sum(partial, out, (int64_t)kvol * cin * cout, groups, s);
}
