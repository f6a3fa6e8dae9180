// Fused Kuf at order 1: the entry point and the float32 instantiation. The
// design note, kernels and launches are in tens_seq.cuh; tens_seq_f64.cu
// compiles the float64 ones.

#include "tens_seq.cuh"

namespace gpsig {
namespace kuf1_fwd {
template cudaError_t by_levels<float>(int, int, const void*, const void*,
                                      void*, int, int, int, int, int, int,
                                      cudaStream_t);
}  // namespace kuf1_fwd
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// Z [T, F(, 2), d] contiguous, Xt [L, d, N] contiguous -> out
// [nl + 1, T, N]; threads a block (32, 64 or 128) as ops/cuda/plan.py's
// kuf_fwd_plan gives them, for a d whose records fit the shared memory.
// Returns cudaGetLastError() after the launch (0 on success).
int gpsig_tens_seq(const void* Z, const void* Xt, void* out, int Tn, int N,
                   int L, int d, int nl, int rbf, int inc, int f64,
                   int threads, void* stream) {
  if (L < 1 || d < 1 || Tn > 65535 ||
      (threads != 32 && threads != 64 && threads != 128))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? kuf1_fwd::by_levels<double>(nl, inc, Z, Xt, out, Tn, N, L,
                                           d, rbf, threads, s)
             : kuf1_fwd::by_levels<float>(nl, inc, Z, Xt, out, Tn, N, L, d,
                                          rbf, threads, s);
}

}  // extern "C"
