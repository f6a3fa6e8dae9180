// Backward of the fused Kuf at order 1: the float64 instantiation (called
// by the entry point in tens_seq_bwd.cu). The design note, kernels and
// launches are in tens_seq_bwd.cuh.

#include "tens_seq_bwd.cuh"

namespace gpsig {
namespace kuf1_bwd {
template cudaError_t by_levels<double>(int, int, const void*, const void*,
                                       const void*, void*, void*, int, int, int,
                                       int, int, int, int, cudaStream_t);
}  // namespace kuf1_bwd
}  // namespace gpsig
