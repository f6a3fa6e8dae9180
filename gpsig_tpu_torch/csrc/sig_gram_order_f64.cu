// Per-pair signature DP over prebuilt increment matrices at orders past 7
// (p = min(order, num_levels) = 8 .. 127), float64: the forward and the
// backward, called by gpsig_sig_gram (sig_gram.cu) and gpsig_sig_gram_bwd
// (sig_gram_bwd.cu). The design note and kernels are in sig_gram_order.cuh.

#include "sig_gram_order.cuh"

namespace gpsig {
template cudaError_t sg_fwd_order<double>(const SgArgs&, cudaStream_t);
template cudaError_t sg_bwd_order<double>(const SgArgs&, cudaStream_t);
}  // namespace gpsig
