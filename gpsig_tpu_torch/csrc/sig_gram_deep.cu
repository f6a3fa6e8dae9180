// Per-pair signature DP over prebuilt increment matrices past 7 levels
// (num_levels 8 .. 127, p = min(order, num_levels) <= 7), both dtypes,
// called by gpsig_sig_gram (sig_gram.cu): sig_gram.cuh's segments and
// bands with deep_levels.cuh's loop over levels, each row's per-level
// slots in shared memory or the workspace.

#include "sig_gram.cuh"

namespace gpsig {
template cudaError_t sg_fwd_deep<float>(const SgArgs&, cudaStream_t);
template cudaError_t sg_fwd_deep<double>(const SgArgs&, cudaStream_t);
}  // namespace gpsig
