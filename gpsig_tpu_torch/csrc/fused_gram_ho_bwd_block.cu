// Backward of the general fused signature Gram, a block of W warps a pair
// (more than 128 rows, four a lane): the float32 instantiations and the
// entry point for BlockGroup (float64 in fused_gram_ho_bwd_block_f64.cu).
// The design note, kernel and launch are in fused_gram_ho_bwd.cuh.

#include "fused_gram_ho_bwd.cuh"

extern "C" {

// As gpsig_fused_gram_ho_bwd, the rows over W = 2..8 warps of one block.
int gpsig_fused_gram_ho_bwd_block(const void* X, const void* Y,
                                  const void* g, void* Xbar, void* Ybar,
                                  int N1, int N2, int L, int d, int nl,
                                  int order, int kind, int degree, int diff,
                                  int W, int f64, void* stream) {
  if (L < 2 || d < 1 || nl < 1 || nl > kRlLevels || order < 1 ||
      kind < kLinear || kind > kPoly || (kind == kPoly && degree < 1) ||
      W < 2 || !plan_ok(diff ? L - 1 : L, W, 4))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? gram_ho_bwd_block_f64(P, X, Y, g, Xbar, Ybar, N1, N2, L, d,
                                     nl, kind, degree, diff, W, s)
             : by_order<float, 4, BlockGroup<float>>(
                   P, X, Y, g, Xbar, Ybar, N1, N2, L, d, nl, kind, degree,
                   diff, W, s);
}

}  // extern "C"
