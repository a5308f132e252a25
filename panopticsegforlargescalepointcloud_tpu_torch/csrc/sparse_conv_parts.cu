// Per-part probe of kernel A (kernel E of the port).
//
// Replaces: scripts/bench_winkernel_parts.py:kernel, the TPU probe that
// ablates the windowed-conv Pallas body (full, dot1/cmp row selection only,
// nodma compute with one DMA, noloop DMA only, lane-mask variants) to say
// where a conv's time goes. Its lane packing, one-hot selection and masks
// are TPU formulation; the Hopper counterpart decomposes kernel A's own body
// (csrc/sparse_conv_tile.cuh) the same way, each part a compile-time
// instance of that body with an output that keeps its loads alive:
//   part 0 full   - A itself (noloop + dot1 + the W GEMM); equals A bit for bit;
//   part 1 index  - index loads and the offset skip only (E's noloop):
//                   out[i, 0] = #{k : idx[i, k] >= 0};
//   part 2 gather - rows gathered into shared memory, no W, no FMA (E's
//                   dot1 / cmp): out[i, c] = sum_k feats[idx[i, k], c];
//   part 3 contig - A's W staging and FMA loop on contiguous rows (E's
//                   nodma): out[i] = sum_k [idx[i, k] >= 0] feats[i] @ W[k],
//                   on a same-level map; against full it prices the random
//                   gathers at identical arithmetic.
//
// What bounds it on the H100: each part reads the index map once (N x 27
// int32); gather and full add the rows (from L2 at these sizes), contig and
// full the W chunks and the FMAs on the CUDA cores. The parts are timed, not
// tuned: the probe's job is to split A's time.

#include "sparse_conv_tile.cuh"

namespace {

using pst_conv::Part;

template <Part P>
int launch(const void* feats, const int* idx, const void* w, float* out, int n_in,
           int n_out, int cin, int cout, int kvol, int dtype, cudaStream_t s) {
  using namespace pst_conv;
  const int ny = (P == Part::kFull || P == Part::kContig) ? (cout + TN - 1) / TN : 1;
  dim3 grid((n_out + TM - 1) / TM, ny);
  if (dtype == 1) {
    sparse_conv_tile<__nv_bfloat16, P><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), idx,
        static_cast<const __nv_bfloat16*>(w), out, n_in, n_out, cin, cout, kvol);
  } else {
    sparse_conv_tile<float, P><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(feats), idx, static_cast<const float*>(w), out,
        n_in, n_out, cin, cout, kvol);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// part: 0 full, 1 index, 2 gather, 3 contig; dtype: 0 = float32, 1 =
// bfloat16. Returns cudaGetLastError() after launch (cudaErrorInvalidValue
// for an unknown part).
int pst_sparse_conv_parts(int part, const void* feats, const int* idx, const void* w,
                          float* out, int n_in, int n_out, int cin, int cout, int kvol,
                          int dtype, void* stream) {
  if (n_out == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (part) {
    case 0: return launch<Part::kFull>(feats, idx, w, out, n_in, n_out, cin, cout, kvol, dtype, s);
    case 1: return launch<Part::kIndex>(feats, idx, w, out, n_in, n_out, cin, cout, kvol, dtype, s);
    case 2: return launch<Part::kGather>(feats, idx, w, out, n_in, n_out, cin, cout, kvol, dtype, s);
    case 3: return launch<Part::kContig>(feats, idx, w, out, n_in, n_out, cin, cout, kvol, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
