// Fused signature Gram of the general engine: the float64 instantiation
// (called by the entry point in fused_gram_ho.cu). The design note, kernels
// and launches are in fused_gram_ho.cuh.

#include "fused_gram_ho.cuh"

namespace gpsig {
namespace ho_fwd {
template cudaError_t by_order<double>(
    int, int, int, int, const void*, const void*, void*, int, int, int, int,
    int, int, int, int, int, cudaStream_t);
}  // namespace ho_fwd
}  // namespace gpsig
