// Per-part probe of kernel A (kernel E of the port).
//
// Replaces: scripts/bench_winkernel_parts.py:kernel, the TPU probe that
// ablates the windowed-conv Pallas body (full, dot1/cmp row selection only,
// nodma compute with one DMA, noloop DMA only, lane-mask variants) to say
// where a conv's time goes. Its lane packing, one-hot selection and masks
// are TPU formulation; the Hopper counterpart decomposes kernel A's own body
// (csrc/sparse_conv_tile.cuh) the same way, each part a compile-time
// instance of that body, launched with A's plan, with an output that keeps
// its loads alive:
//   part 0 full   - A itself (its plan, split and second pass included);
//                   equals A bit for bit;
//   part 1 index  - the tile's index block and the offset skip only (E's
//                   noloop): out[i, 0] = #{k : idx[i, k] >= 0};
//   part 2 gather - bf16: the gathered rows through A's cp.async ring, no W,
//                   no MMA, summed in shared memory; f32: rows into shared
//                   memory (E's dot1 / cmp): out[i, c] = sum_k feats[idx[i, k], c];
//   part 3 contig - A's W stream and products (bf16: the MMAs) on contiguous
//                   rows (E's nodma): out[i] = sum_k [idx[i, k] >= 0] feats[i] @ W[k],
//                   on a same-level map; against full it prices the random
//                   gathers at identical arithmetic.
//
// What bounds it on the H100: each part reads the index map once (N x 27
// int32); gather and full add the rows (from L2 at these sizes), contig and
// full W and the products. The parts are timed, not tuned: the probe's job
// is to split A's time.

#include "sparse_conv_tile.cuh"

extern "C" {

// part: 0 full, 1 index, 2 gather, 3 contig; dtype: 0 = float32, 1 =
// bfloat16; bm, bn, n_tiles, splits, kpg, ws: A's plan
// (ops/conv.py:conv_plan; the index and gather parts take one Cout tile and
// one group). Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for an unknown part or a plan the part does not take).
int pst_sparse_conv_parts(int part, const void* feats, const int* idx, const void* w,
                          float* out, float* ws, int n_in, int n_out, int cin, int cout, int kvol,
                          int bm, int bn, int n_tiles, int splits, int kpg, int dtype,
                          void* stream) {
  using namespace pst_conv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p{bm, bn, n_tiles, splits, kpg};
  switch (part) {
    case 0: return launch_part<Part::kFull>(feats, idx, w, out, ws, n_in, n_out, cin, cout, kvol, p, dtype, s);
    case 1: return launch_part<Part::kIndex>(feats, idx, w, out, ws, n_in, n_out, cin, cout, kvol, p, dtype, s);
    case 2: return launch_part<Part::kGather>(feats, idx, w, out, ws, n_in, n_out, cin, cout, kvol, p, dtype, s);
    case 3: return launch_part<Part::kContig>(feats, idx, w, out, ws, n_in, n_out, cin, cout, kvol, p, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
