// Backward of the general fused signature Gram: one warp a pair, float32, up
// to 4 levels (called by the entry points in fused_gram_ho_bwd.cu). The design
// note, kernel and launch are in fused_gram_ho_bwd.cuh.

#include "fused_gram_ho_bwd.cuh"

namespace gpsig {
template cudaError_t ho_bwd_warp<float, 4>(int, const HoBwdArgs&, int,
                                  cudaStream_t);
}  // namespace gpsig
