// Fused Kuf of the general engine: the float64 instantiation (called by the
// entry point in tens_seq_general.cu). The design note, kernels and
// launches are in tens_seq_general.cuh.

#include "tens_seq_general.cuh"

namespace gpsig {
namespace kuf_fwd {
template cudaError_t by_levels<double>(int, int, const void*, const void*,
                                    void*, int, int, int, int, int, int, int,
                                    int, int, int, cudaStream_t);
}  // namespace kuf_fwd
}  // namespace gpsig
