// Backward of the general Kuf: the float64 instantiation (called by the
// entry point in tens_seq_general_bwd.cu). The design note, kernels and
// launches are in tens_seq_general_bwd.cuh.

#include "tens_seq_general_bwd.cuh"

namespace gpsig {
namespace kuf_bwd {
template cudaError_t by_levels<double>(
    int, int, const void*, const void*, const void*, void*, void*, void*, int,
    int, int, int, int, int, int, int, int, int, int, int, int, cudaStream_t);
}  // namespace kuf_bwd
}  // namespace gpsig
