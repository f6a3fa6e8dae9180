// Backward of the general fused signature Gram, one warp a pair: the
// float64 instantiations, called by gpsig_fused_gram_ho_bwd
// (fused_gram_ho_bwd.cu). The design note, kernel and launch are in
// fused_gram_ho_bwd.cuh.

#include "fused_gram_ho_bwd.cuh"

namespace gpsig {

cudaError_t gram_ho_bwd_warp_f64(int P, const void* X, const void* Y,
                                 const void* g, void* Xbar, void* Ybar,
                                 int N1, int N2, int L, int d, int nl,
                                 int kind, int degree, int diff, int R,
                                 cudaStream_t s) {
  return by_rows<double>(P, X, Y, g, Xbar, Ybar, N1, N2, L, d, nl, kind,
                         degree, diff, R, s);
}

}  // namespace gpsig
