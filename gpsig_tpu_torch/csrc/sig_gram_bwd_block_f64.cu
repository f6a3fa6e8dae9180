// Backward of the per-pair signature DP over prebuilt increment matrices:
// the float64 instantiations for a block of W warps a matrix, called by
// gpsig_sig_gram_bwd (sig_gram_bwd.cu). The design note and kernel are in
// sig_gram_bwd.cuh.

#include "sig_gram_bwd.cuh"

namespace gpsig {

cudaError_t sig_gram_bwd_block_f64(int P, const void* M, const void* g,
                                   void* Mbar, int B, int L1, int L2, int nl,
                                   int W, cudaStream_t s) {
  return by_order<double, 4, BlockGroup<double>>(P, M, g, Mbar, B, L1, L2,
                                                 nl, W, s);
}

}  // namespace gpsig
