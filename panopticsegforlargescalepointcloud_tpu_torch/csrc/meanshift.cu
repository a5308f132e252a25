// Batched flat-kernel mean shift, the whole loop in one launch (kernel C of
// the port).
//
// Replaces: panopticsegforlargescalepointcloud_tpu/cluster/pallas_meanshift.py:
// _ms_kernel (launched by meanshift_update, looped by
// meanshift._mean_shift_single in a lax.while_loop and vmapped over the
// batch). One update, for every sample b and seed s, is meanshift._shift_iter:
//     W = { valid points x of sample b : |s|^2 + |x|^2 - 2 s.x <= bw^2 }
//     cnt = |W|,  new = sum(W) / cnt,  or the old seed where cnt = 0.
// The loop (meanshift.py:110-131) updates each valid, unfrozen seed; a seed
// whose shift^2 falls below tol2 = (1e-3 bw)^2 keeps that step's update and
// freezes; an invalid seed never moves; it stops at max_iter. A seed's
// trajectory depends on that seed alone, so each seed runs to its own
// freeze, and the returned counts are the populations at the returned
// seeds (the JAX package's final _shift_iter).
//
// What bounds it on the H100: the pair loop, sum over seeds of (iterations
// + 1) x Np pairs of 3E + 4 f32 operations, a few microseconds; the TPU
// port before this launched one update per iteration from a host loop with
// a host sync each, which cost far more than the arithmetic.
//
// Design: one thread-block cluster of NC <= 8 blocks per (sample, tile of
// 32 seeds). Block r of the cluster owns points [r * share, (r + 1) * share)
// of its sample and keeps them in shared memory for every iteration: the
// coordinates and |x|^2, +inf for an invalid point, so that its d2 is +inf
// and it never counts (its coordinates stay finite). Lane l of every warp
// holds seed l of the tile; the WARPS warps split the block's points. Per
// iteration each thread sums its points' coordinates in f64 and counts
// them; the warps' partials are added in warp order, the blocks' over
// distributed shared memory in rank order, by every block alike: no
// atomics, so every block applies the same update, takes the same exit
// decision, and a run repeats itself bit for bit. Sums are f64 and rounded
// once to f32 before the divide, as the plain version's f64 product is, so
// that kernel and plain version move seeds identically (f32 sums in two
// orders would drift apart by ulps over the iterations and flip counts at
// the bandwidth). Norms and dot products are summed term by term in
// dimension order and this file is compiled with -fmad=false, so d2 rounds
// as the plain PyTorch version's does and the within-bandwidth counts agree
// exactly. A share larger than the shared memory is refused (the launcher
// returns cudaErrorInvalidValue): at E = 5 a block holds 2,195 points, so
// 8 blocks hold a sample of 17,560, above every config's ms_point_cap.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TSEED = 32;           // seeds per tile: one per lane
constexpr int WARPS = 16;           // warps per block, each over its own points
constexpr int NT = TSEED * WARPS;   // threads per block
constexpr int MAXE = 8;             // largest embedding dimension supported
constexpr int MAXC = 8;             // blocks per cluster (the portable limit)
constexpr int SMEM_CAP = 200 * 1024;  // dynamic shared memory a block may take

struct Args {
  const float* seeds;            // [B, S, E]
  const unsigned char* svalid;   // [B, S]
  const float* points;           // [B, Np, E]
  const unsigned char* pvalid;   // [B, Np]
  float* seeds_out;              // [B, S, E]
  float* counts;                 // [B, S]
  int* iters;                    // [B, S]
  int S, Np, share, max_iter;
  float bw2, tol2;
};

// Shared memory: red[2][TSEED][E + 1] f64 (this block's partials, read by
// the whole cluster, double-buffered by iteration), tot[TSEED][E + 1] f64
// (the cluster's sums), wsum[WARPS][TSEED][E + 1] f64 (the warps'
// partials), then share point records: pstride<E>() floats (the E coordinates
// and |x|^2, padded to whole float4s, so that a warp reads them with one or
// two 16-byte broadcast loads), then dstride<E>() doubles (the coordinates
// again, converted once when staged: a conversion to f64 issues at an
// eighth of the f32 rate, and a point within the bandwidth of any of a
// warp's 32 seeds would otherwise convert E values every iteration).
template <int E>
__host__ __device__ constexpr size_t f64_words() {
  return (size_t)(2 + 1 + WARPS) * TSEED * (E + 1);
}

template <int E>
__host__ __device__ constexpr int pstride() {
  return (E + 1 + 3) / 4 * 4;
}

template <int E>
__host__ __device__ constexpr int dstride() {
  return (E + 1) / 2 * 2;
}

template <int E>
__host__ __device__ constexpr size_t record_bytes() {
  return pstride<E>() * sizeof(float) + dstride<E>() * sizeof(double);
}

template <int E>
__device__ __forceinline__ void stage_points(const Args& a, char* pts, int b, int p0, int len) {
  for (int k = threadIdx.x; k < len; k += NT) {
    const int64_t gp = (int64_t)b * a.Np + p0 + k;
    const float* x = a.points + gp * E;
    char* rec = pts + (size_t)k * record_bytes<E>();
    float* dst = reinterpret_cast<float*>(rec);
    double* dst_d = reinterpret_cast<double*>(rec + pstride<E>() * sizeof(float));
    float xx = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float xe = x[e];
      dst[e] = xe;
      dst_d[e] = (double)xe;
      xx = e == 0 ? xe * xe : xx + xe * xe;
    }
    dst[E] = a.pvalid[gp] ? xx : INFINITY;
#pragma unroll
    for (int e = E; e < dstride<E>(); ++e) dst_d[e] = 0.0;
  }
}

template <int E>
__global__ void __launch_bounds__(NT, 1) meanshift_converge_kernel(Args a) {
  extern __shared__ __align__(16) double smem[];
  double* red = smem;                                   // [2][TSEED][E + 1]
  double* tot = red + 2 * TSEED * (E + 1);              // [TSEED][E + 1]
  double* wsum = tot + TSEED * (E + 1);                 // [WARPS][TSEED][E + 1]
  char* pts = reinterpret_cast<char*>(wsum + WARPS * TSEED * (E + 1));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nc = (int)cluster.num_blocks();
  const int b = blockIdx.z;
  const int lane = threadIdx.x % TSEED;
  const int warp = threadIdx.x / TSEED;
  const int s = blockIdx.y * TSEED + lane;
  const bool in_range = s < a.S;
  const int64_t gs = (int64_t)b * a.S + s;

  float sd[E];
#pragma unroll
  for (int e = 0; e < E; ++e) sd[e] = in_range ? a.seeds[gs * E + e] : 0.f;
  bool active = in_range && a.svalid[gs];
  int iters = 0;

  const int p_lo = min(a.Np, rank * a.share);
  const int my_len = min(a.Np, p_lo + a.share) - p_lo;
  stage_points<E>(a, pts, b, p_lo, my_len);
  __syncthreads();

  int buf = 0;
  for (int it = 0;; ++it) {
    // the same on every warp of every block of the cluster
    const bool last = it == a.max_iter || !__any_sync(0xffffffffu, active);
    float ss = sd[0] * sd[0];
#pragma unroll
    for (int e = 1; e < E; ++e) ss = ss + sd[e] * sd[e];
    double acc[dstride<E>()];  // E sums, and one more slot where E is odd
#pragma unroll
    for (int e = 0; e < dstride<E>(); ++e) acc[e] = 0.0;
    int n = 0;
#pragma unroll 4
    for (int k = warp; k < my_len; k += WARPS) {
      const char* base = pts + (size_t)k * record_bytes<E>();
      float4 rec[pstride<E>() / 4];
#pragma unroll
      for (int v = 0; v < pstride<E>() / 4; ++v)
        rec[v] = reinterpret_cast<const float4*>(base)[v];
      const float* pt = reinterpret_cast<const float*>(rec);
      float dot = sd[0] * pt[0];
#pragma unroll
      for (int e = 1; e < E; ++e) dot = dot + sd[e] * pt[e];
      const float d2 = (ss + pt[E]) - 2.f * dot;
      if (d2 <= a.bw2) {
        if (!last) {
          const double2* pd =
              reinterpret_cast<const double2*>(base + pstride<E>() * sizeof(float));
#pragma unroll
          for (int v = 0; v < dstride<E>() / 2; ++v) {
            const double2 d = pd[v];
            acc[2 * v] += d.x;
            acc[2 * v + 1] += d.y;
          }
        }
        ++n;
      }
    }
    double* w = wsum + ((size_t)warp * TSEED + lane) * (E + 1);
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = acc[e];
    w[E] = (double)n;
    __syncthreads();
    if (warp == 0) {
      double* r = red + ((size_t)buf * TSEED + lane) * (E + 1);
      for (int e = 0; e <= E; ++e) {
        double v = 0.0;
        for (int ww = 0; ww < WARPS; ++ww) v += wsum[((size_t)ww * TSEED + lane) * (E + 1) + e];
        r[e] = v;
      }
    }
    cluster.sync();  // every block's partials are written and visible
    if (warp == 0) {
      double v[E + 1];
#pragma unroll
      for (int e = 0; e <= E; ++e) v[e] = 0.0;
      for (int rr = 0; rr < nc; ++rr) {
        const double* r =
            cluster.map_shared_rank(red, rr) + ((size_t)buf * TSEED + lane) * (E + 1);
#pragma unroll
        for (int e = 0; e <= E; ++e) v[e] += r[e];
      }
#pragma unroll
      for (int e = 0; e <= E; ++e) tot[lane * (E + 1) + e] = v[e];
    }
    __syncthreads();
    const float cnt = (float)tot[lane * (E + 1) + E];
    if (last) {
      if (rank == 0 && warp == 0 && in_range) {
#pragma unroll
        for (int e = 0; e < E; ++e) a.seeds_out[gs * E + e] = sd[e];
        a.counts[gs] = cnt;
        a.iters[gs] = iters;
      }
      cluster.sync();  // no block leaves while another may read its partials
      return;
    }
    if (active) {
      float nw[E];
      const float denom = fmaxf(cnt, 1.f);
#pragma unroll
      for (int e = 0; e < E; ++e)
        nw[e] = cnt > 0.f ? (float)tot[lane * (E + 1) + e] / denom : sd[e];
      float d = nw[0] - sd[0];
      float shift2 = d * d;
#pragma unroll
      for (int e = 1; e < E; ++e) {
        d = nw[e] - sd[e];
        shift2 = shift2 + d * d;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sd[e] = nw[e];
      ++iters;
      if (shift2 < a.tol2) active = false;
    }
    buf ^= 1;
  }
}

template <int E>
int launch(const Args& a0, int B, cudaStream_t st) {
  Args a = a0;
  const int nc = a.Np <= 0 ? 1 : min(MAXC, max(1, (a.Np + 2047) / 2048));
  a.share = a.Np <= 0 ? 0 : (a.Np + nc - 1) / nc;
  const size_t fixed = f64_words<E>() * sizeof(double);
  if (a.share > (int)((SMEM_CAP - fixed) / record_bytes<E>()))
    return static_cast<int>(cudaErrorInvalidValue);  // the share does not fit
  const size_t smem = fixed + (size_t)a.share * record_bytes<E>();
  static size_t smem_set = 0;  // per instance: the attribute is raised once
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(meanshift_converge_kernel<E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, (a.S + TSEED - 1) / TSEED, B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, meanshift_converge_kernel<E>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seeds [B, S, E], svalid [B, S] (bool bytes), points [B, Np, E], pvalid
// [B, Np] (bool bytes), all contiguous on the device -> seeds_out [B, S, E],
// counts [B, S] f32, iters [B, S] int32 (updates each seed took).
extern "C" int pst_meanshift_converge(const float* seeds, const unsigned char* svalid,
                                      const float* points, const unsigned char* pvalid,
                                      float* seeds_out, float* counts, int* iters, int B,
                                      int S, int Np, int E, int max_iter, float bw2, float tol2,
                                      void* stream) {
  if (E < 1 || E > MAXE || max_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  Args a{seeds, svalid, points, pvalid, seeds_out, counts, iters, S, Np, 0, max_iter,
         bw2, tol2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 1: return launch<1>(a, B, st);
    case 2: return launch<2>(a, B, st);
    case 3: return launch<3>(a, B, st);
    case 4: return launch<4>(a, B, st);
    case 5: return launch<5>(a, B, st);
    case 6: return launch<6>(a, B, st);
    case 7: return launch<7>(a, B, st);
    default: return launch<8>(a, B, st);
  }
}
