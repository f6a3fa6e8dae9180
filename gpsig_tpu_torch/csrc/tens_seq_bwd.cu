// Backward of the fused Kuf at order 1: the entry point and the float32
// instantiation. The design note, kernels and launches are in
// tens_seq_bwd.cuh; tens_seq_bwd_f64.cu compiles the float64 ones.

#include "tens_seq_bwd.cuh"

namespace gpsig {
namespace kuf1_bwd {
template cudaError_t by_levels<float>(int, int, const void*, const void*,
                                      const void*, void*, void*, int, int, int,
                                      int, int, int, int, cudaStream_t);
}  // namespace kuf1_bwd
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// Z [T, F(, 2), d], X [N, L, d], g [nl + 1, T, N] contiguous, d <= 3; Zbar
// [T, F(, 2), d] and Xbar [N, L, d] zero-filled; the launch (ppw pairs a
// warp, blocks of 64 threads) as ops/cuda/plan.py's kuf_bwd_plan gives it.
// Returns cudaGetLastError() after the launch (0 on success).
int gpsig_tens_seq_bwd(const void* Z, const void* X, const void* g,
                       void* Zbar, void* Xbar, int Tn, int N, int L, int d,
                       int nl, int rbf, int inc, int f64, int ppw, int blocks,
                       void* stream) {
  if (L < 1 || d < 1 || d > kuf1_bwd::kMaxD) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? kuf1_bwd::by_levels<double>(nl, inc, Z, X, g, Zbar, Xbar,
                                           Tn, N, L, d, rbf, ppw, blocks, s)
             : kuf1_bwd::by_levels<float>(nl, inc, Z, X, g, Zbar, Xbar, Tn,
                                          N, L, d, rbf, ppw, blocks, s);
}

}  // extern "C"
