// Fused Kuf at order 1: the float64 instantiation (called by the entry
// point in tens_seq.cu). The design note, kernels and launches are in
// tens_seq.cuh.

#include "tens_seq.cuh"

namespace gpsig {
namespace kuf1_fwd {
template cudaError_t by_levels<double>(int, int, const void*, const void*,
                                       void*, int, int, int, int, int, int,
                                       cudaStream_t);
}  // namespace kuf1_fwd
}  // namespace gpsig
