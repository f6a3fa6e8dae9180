// Backward of the per-pair signature DP over prebuilt increment matrices:
// the float64 bands, called by gpsig_sig_gram_bwd (sig_gram_bwd.cu). The
// design note and kernels are in sig_gram_bwd.cuh.

#include "sig_gram_bwd.cuh"

namespace gpsig {
template cudaError_t sg_bwd<double, true>(const SgArgs&, cudaStream_t);
}  // namespace gpsig
