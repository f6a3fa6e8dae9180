// Per-pair signature DP over prebuilt increment matrices: the float64
// register path, called by gpsig_sig_gram (sig_gram.cu). The design note
// and kernels are in sig_gram.cuh.

#include "sig_gram.cuh"

namespace gpsig {
template cudaError_t sg_fwd<double>(const SgArgs&, cudaStream_t);
}  // namespace gpsig
