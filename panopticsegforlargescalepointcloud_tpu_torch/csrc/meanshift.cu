// Batched flat-kernel mean-shift update (kernel C of the port).
//
// Replaces: panopticsegforlargescalepointcloud_tpu/cluster/pallas_meanshift.py:
// _ms_kernel (launched by meanshift_update, looped by
// meanshift._mean_shift_single and vmapped over the batch), whose spec is
// meanshift._shift_iter: for every sample b and seed s,
//     W = { valid points x of sample b : |s|^2 + |x|^2 - 2 s.x <= bw^2 }
//     cnt = |W|,  new = sum(W) / cnt,  or the old seed where cnt = 0.
// Seeds [B, S, E], points [B, Np, E], pvalid [B, Np] (1/0), all f32.
//
// What bounds it on the H100: the B x S x Np pair loop (about 8.4e6 pairs at
// B = 4, S = 128, Np = 16,384, each 3E + 3 f32 operations plus E + 1
// accumulating adds): a few microseconds of arithmetic, so at these sizes
// launch latency and the loop around it dominate.
//
// Design: the TPU kernel carried its running sums across sequential grid
// steps; GPU blocks run in no order, so the grid runs over (point chunk,
// seed tile, sample) and each block writes its partial sums and count to
// [B, chunks, S, E + 1]. A second small kernel reduces the chunks in a fixed
// order, divides and applies the cnt = 0 rule: no float atomics, so a run
// repeats itself bit for bit. Each thread holds one seed; a block stages 256
// points of its sample (coordinates, squared norm, validity) in shared
// memory. Norms and dot products are summed term by term in dimension order
// and this file is compiled with -fmad=false, so d2 rounds exactly as the
// plain PyTorch version's and the within-bandwidth counts agree exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 128;   // seeds per block (one per thread)
constexpr int PC = 256;   // points per chunk
constexpr int MAXE = 8;   // largest embedding dimension supported

__global__ void __launch_bounds__(TS)
ms_partial_kernel(const float* __restrict__ seeds, const float* __restrict__ points,
                  const float* __restrict__ pvalid, float* __restrict__ partial,
                  int S, int Np, int E, int chunks, float bw2) {
  __shared__ float sp[PC][MAXE];
  __shared__ float sxx[PC];
  __shared__ float sv[PC];

  const int c = blockIdx.x;
  const int s = blockIdx.y * TS + threadIdx.x;
  const int b = blockIdx.z;

  for (int p = threadIdx.x; p < PC; p += TS) {
    const int gp = c * PC + p;
    float xx = 0.f, v = 0.f;
    if (gp < Np) {
      const float* x = points + ((int64_t)b * Np + gp) * E;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        if (e < E) {
          const float xe = x[e];
          sp[p][e] = xe;
          xx = e == 0 ? xe * xe : xx + xe * xe;
        }
      }
      v = pvalid[(int64_t)b * Np + gp];
    }
    sxx[p] = xx;
    sv[p] = v;
  }
  __syncthreads();
  if (s >= S) return;

  float sd[MAXE];
  float ss = 0.f;
  const float* seed = seeds + ((int64_t)b * S + s) * E;
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    sd[e] = e < E ? seed[e] : 0.f;
    if (e < E) ss = e == 0 ? sd[e] * sd[e] : ss + sd[e] * sd[e];
  }

  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;
  float n = 0.f;
  const int np_chunk = min(PC, Np - c * PC);
  for (int p = 0; p < np_chunk; ++p) {
    float dot = sd[0] * sp[p][0];
#pragma unroll
    for (int e = 1; e < MAXE; ++e)
      if (e < E) dot = dot + sd[e] * sp[p][e];
    const float d2 = (ss + sxx[p]) - 2.f * dot;
    if (d2 <= bw2 && sv[p] > 0.f) {
#pragma unroll
      for (int e = 0; e < MAXE; ++e)
        if (e < E) acc[e] += sp[p][e];
      n += 1.f;
    }
  }
  float* dst = partial + (((int64_t)b * chunks + c) * S + s) * (E + 1);
#pragma unroll
  for (int e = 0; e < MAXE; ++e)
    if (e < E) dst[e] = acc[e];
  dst[E] = n;
}

__global__ void ms_finish_kernel(const float* __restrict__ seeds,
                                 const float* __restrict__ partial,
                                 float* __restrict__ new_seeds, float* __restrict__ cnt,
                                 int B, int S, int E, int chunks) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= B * S) return;
  const int b = g / S, s = g % S;
  float sum[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) sum[e] = 0.f;
  float n = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float* src = partial + (((int64_t)b * chunks + c) * S + s) * (E + 1);
#pragma unroll
    for (int e = 0; e < MAXE; ++e)
      if (e < E) sum[e] += src[e];
    n += src[E];
  }
  const float* seed = seeds + (int64_t)g * E;
  float* dst = new_seeds + (int64_t)g * E;
  const float denom = fmaxf(n, 1.f);
#pragma unroll
  for (int e = 0; e < MAXE; ++e)
    if (e < E) dst[e] = n > 0.f ? sum[e] / denom : seed[e];
  cnt[g] = n;
}

}  // namespace

// partial: scratch [B, ceil(Np / 256), S, E + 1] f32 allocated by the caller.
extern "C" int pst_meanshift_update(const float* seeds, const float* points,
                                    const float* pvalid, float* partial,
                                    float* new_seeds, float* cnt, int B, int S,
                                    int Np, int E, float bw2, void* stream) {
  if (E < 1 || E > MAXE) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (Np + PC - 1) / PC;
  if (chunks > 0) {
    dim3 grid(chunks, (S + TS - 1) / TS, B);
    ms_partial_kernel<<<grid, TS, 0, st>>>(seeds, points, pvalid, partial, S, Np, E,
                                           chunks, bw2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ms_finish_kernel<<<(B * S + 127) / 128, 128, 0, st>>>(seeds, partial, new_seeds, cnt,
                                                        B, S, E, chunks);
  return static_cast<int>(cudaGetLastError());
}
