// Backward of the per-pair signature DP over prebuilt increment matrices:
// past 7 levels (num_levels 8 .. 127, p <= 7) in float32, called by
// gpsig_sig_gram_bwd (sig_gram_bwd.cu). The design note and kernels are in
// sig_gram_bwd.cuh.

#include "sig_gram_bwd.cuh"

namespace gpsig {
template cudaError_t sg_bwd_deep<float>(const SgArgs&, cudaStream_t);
}  // namespace gpsig
