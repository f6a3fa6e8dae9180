// Backward of the general fused signature Gram, a block of W warps a pair:
// the float64 instantiations, called by gpsig_fused_gram_ho_bwd_block
// (fused_gram_ho_bwd_block.cu). The design note, kernel and launch are in
// fused_gram_ho_bwd.cuh.

#include "fused_gram_ho_bwd.cuh"

namespace gpsig {

cudaError_t gram_ho_bwd_block_f64(int P, const void* X, const void* Y,
                                  const void* g, void* Xbar, void* Ybar,
                                  int N1, int N2, int L, int d, int nl,
                                  int kind, int degree, int diff, int W,
                                  cudaStream_t s) {
  return by_order<double, 4, BlockGroup<double>>(P, X, Y, g, Xbar, Ybar, N1,
                                                 N2, L, d, nl, kind, degree,
                                                 diff, W, s);
}

}  // namespace gpsig
