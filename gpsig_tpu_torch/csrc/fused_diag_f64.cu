// Order-1 signature self-kernels: the float64 instantiations (called by
// the entry point in fused_diag.cu). The design note, kernel and launch
// are in fused_diag.cuh.

#include "fused_diag.cuh"

namespace gpsig {
template cudaError_t diag_dispatch<double>(const DiagArgs&, cudaStream_t);
}  // namespace gpsig
