// Sparse-convolution weight gradient (kernel D of the port).
//
// Replaces: panopticsegforlargescalepointcloud_tpu/ops/winconv.py:_dw_kernel
// (launched by _run_dw from the windowed conv's custom VJP), whose spec is
// the dW half of ops/conv.py:_conv_tm_bwd:
//     dW[k] = sum_i feats[idx[i, k]]^T (x) g[i]   over rows i with idx[i, k] >= 0,
// feats [N_in, Cin] and g [N_out, Cout] in one dtype (f32 or bf16, widened to
// f32; bf16 x bf16 products are exact in f32), idx [N_out, K] int32,
// dW [K, Cin, Cout] f32 with f32 accumulation.
//
// What bounds it on the H100: each (row, offset) pair with a neighbor costs
// 2 * Cin * Cout FLOPs against Cin + Cout gathered values, so at the paper
// plan's widths (4..192) it sits near the memory side, like kernel A: the
// random row gathers of feats (served mostly from L2) and the reads of g.
// The output is small (K * Cin * Cout floats).
//
// Design of this first version. The TPU kernel carried one f32 accumulator
// across its sequential grid of row tiles, in a slot-expanded, lane-packed
// layout folded at the end; none of that carries over. GPU blocks run in no
// order, so the grid is (row group, Cin x Cout tile, offset k): each block
// walks a fixed contiguous range of output rows in chunks of 64, skips a
// chunk when no row of it has a neighbor at k (strided maps are mostly -1),
// stages the gathered feats rows and the g rows in shared memory (zeros for
// -1 and for ragged channel tails, so Cin = 4 and 192 take the same code),
// and accumulates a TCI x TCO tile of dW with FMAs in registers, 4 x 4 per
// thread. The tile is 16, 32 or 64 wide on each side, the narrowest that
// holds the width (64 and more channels take 64-wide tiles), so a 16 -> 16
// conv does not pay for a 64 x 64 tile: the 256 threads split the chunk's
// rows into 256 / (TCI * TCO / 16) interleaved sets, and the block sums the
// sets' tiles in shared memory in a fixed order at the end. It writes one
// partial per row group to a workspace; a second kernel sums the partials
// in group order. No atomics: a run repeats bit for bit. The wrapper chooses
// the number of groups so the workspace stays at tens of MB
// (ops/conv.py:_dw_row_groups). Tensor cores, TMA and tuned split-K are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;   // output rows per chunk
constexpr int THREADS = 256;
constexpr int MAX_TILE = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int TCI, int TCO>
__global__ void __launch_bounds__(THREADS)
sparse_conv_dw_partial_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                              const T* __restrict__ g, float* __restrict__ partial,
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
      if (j >= 0 && ci0 + ci < cin) v = to_f32(feats[(int64_t)j * cin + ci0 + ci]);
      Fs[r][ci] = v;
    }
    for (int e = tid; e < TR * TCO; e += THREADS) {
      const int r = e / TCO, co = e % TCO;
      float v = 0.f;
      if (rows[r] >= 0 && co0 + co < cout) v = to_f32(g[(int64_t)(r0 + r) * cout + co0 + co]);
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

__global__ void sparse_conv_dw_reduce_kernel(const float* __restrict__ partial,
                                             float* __restrict__ out, int64_t total,
                                             int groups) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int grp = 0; grp < groups; ++grp) s += partial[(int64_t)grp * total + e];
  out[e] = s;
}

int tile_for(int c) { return c <= 16 ? 16 : (c <= 32 ? 32 : MAX_TILE); }

template <typename T, int TCI, int TCO>
void launch_partial(dim3 grid, cudaStream_t s, const void* feats, const int* idx, const void* g,
                    float* dst, int n_in, int n_out, int cin, int cout, int kvol, int cpg) {
  sparse_conv_dw_partial_kernel<T, TCI, TCO><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(feats), idx, static_cast<const T*>(g), dst, n_in, n_out, cin, cout,
      kvol, cpg);
}

template <typename T, int TCI>
void launch_tco(int tco, dim3 grid, cudaStream_t s, const void* feats, const int* idx,
                const void* g, float* dst, int n_in, int n_out, int cin, int cout, int kvol,
                int cpg) {
  if (tco == 16)
    launch_partial<T, TCI, 16>(grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else if (tco == 32)
    launch_partial<T, TCI, 32>(grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else
    launch_partial<T, TCI, 64>(grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
}

template <typename T>
void launch_tiles(int tci, int tco, dim3 grid, cudaStream_t s, const void* feats,
                  const int* idx, const void* g, float* dst, int n_in, int n_out, int cin,
                  int cout, int kvol, int cpg) {
  if (tci == 16)
    launch_tco<T, 16>(tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else if (tci == 32)
    launch_tco<T, 32>(tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
  else
    launch_tco<T, 64>(tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol, cpg);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. partial: workspace [groups, K, Cin, Cout]
// f32 (unused, may be null, when groups == 1: the one group writes ``out``).
// Returns cudaGetLastError() after the launches.
extern "C" int pst_sparse_conv_dw(const void* feats, const int* idx, const void* g,
                                  float* partial, float* out, int n_in, int n_out, int cin,
                                  int cout, int kvol, int groups, int dtype, void* stream) {
  if (cin == 0 || cout == 0 || kvol == 0) return 0;
  if (groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n_out + TR - 1) / TR;
  const int chunks_per_group = (n_chunks + groups - 1) / groups;
  float* dst = groups == 1 ? out : partial;
  const int tci = tile_for(cin), tco = tile_for(cout);
  dim3 grid(groups, ((cin + tci - 1) / tci) * ((cout + tco - 1) / tco), kvol);
  if (dtype == 1) {
    launch_tiles<__nv_bfloat16>(tci, tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout,
                                kvol, chunks_per_group);
  } else {
    launch_tiles<float>(tci, tco, grid, s, feats, idx, g, dst, n_in, n_out, cin, cout, kvol,
                        chunks_per_group);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  const int64_t total = (int64_t)kvol * cin * cout;
  const int threads = 256;
  sparse_conv_dw_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      partial, out, total, groups);
  return static_cast<int>(cudaGetLastError());
}
