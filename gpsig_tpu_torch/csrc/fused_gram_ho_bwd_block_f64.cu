// Backward of the general fused signature Gram: a block of W warps a pair,
// float64, up to 7 levels (called by the entry points in
// fused_gram_ho_bwd.cu). The design note, kernel and launch are in
// fused_gram_ho_bwd.cuh.

#include "fused_gram_ho_bwd.cuh"

namespace gpsig {
template cudaError_t ho_bwd_block<double, 7>(int, const HoBwdArgs&, int,
                                  cudaStream_t);
}  // namespace gpsig
