// Gather-GEMM sparse convolution forward (kernel A of the port); also the
// conv's dX, run on the transpose map with the flipped, transposed weights.
//
// Replaces: panopticsegforlargescalepointcloud_tpu/ops/winconv.py:_fwd_kernel
// (launched by _run_fwd through windowed_conv / _winconv_tm), whose spec is
// ops/conv.py:sparse_conv:
//     out[i] = sum_k feats[idx[i, k]] @ W[k],  idx = -1 contributes 0,
// feats [N_in, Cin] (f32 or bf16), idx [N_out, K] int32, W [K, Cin, Cout] in
// the feats dtype, out [N_out, Cout] f32 with f32 accumulation.
//
// What bounds it on the H100: at the paper plan's widths (Cin, Cout 4..192)
// the bytes (the features, the map, W and the f32 output, each once) take
// longer than the bf16 products at the tensor cores' rate, so the bound is
// the memory's. What held the first version far above it was its inner
// loop, not its gathers (kernel E, PERF.md): a fixed 64 x 64 tile (3/4 of it
// zeros at Cout 16), two shared loads per four FMAs, one offset and 32
// channels per barrier pair (7/8 zeros at Cin 4), and 72-264 blocks on 132
// SMs at the deep levels.
//
// What this design does about it (bf16; body in sparse_conv_tile.cuh): an
// implicit GEMM over the flattened (offset, channel) axis on the tensor
// cores (mma.sync m16n8k16, ldmatrix fragments), in k16 steps that cover
// four offsets at Cin 4; a Cout tile shaped to the launch's width; the
// tile's index block loaded once and empty offsets skipped; gathered rows
// and W rows through a 3-stage cp.async ring with zero fill; and, where the
// row tiles would not fill the card, the 27 offsets split into groups whose
// f32 partials a second pass sums in group order (no atomics: a run repeats
// bit for bit). The plan (Cout tile, groups, workspace) is
// ops/conv.py:conv_plan. f32 keeps the CUDA-core body: the tensor cores
// would round f32 operands to TF32.

#include "sparse_conv_tile.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bm, bn, n_tiles, splits, kpg: the plan
// of ops/conv.py:conv_plan (rows per block, Cout tile and tiles, offset
// groups of kpg offsets); ws: workspace [splits, N_out, Cout] f32, unused
// (may be null) when splits == 1. Returns cudaGetLastError() after the
// launches, cudaErrorInvalidValue for a plan the kernel does not take.
int pst_sparse_conv_fwd(const void* feats, const int* idx, const void* w, float* out, float* ws,
                        int n_in, int n_out, int cin, int cout, int kvol, int bm, int bn,
                        int n_tiles, int splits, int kpg, int dtype, void* stream) {
  using namespace pst_conv;
  if (n_out == 0 || cout == 0) return 0;
  return launch_part<Part::kFull>(feats, idx, w, out, ws, n_in, n_out, cin, cout, kvol,
                                  Plan{bm, bn, n_tiles, splits, kpg}, dtype,
                                  static_cast<cudaStream_t>(stream));
}

const char* pst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
