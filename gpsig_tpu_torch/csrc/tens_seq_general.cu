// Fused Kuf of the general engine: the entry point and the float32
// instantiation. The design note, kernels and launches are in
// tens_seq_general.cuh; tens_seq_general_f64.cu compiles the float64 ones.

#include "tens_seq_general.cuh"

namespace gpsig {
namespace kuf_fwd {
template cudaError_t by_levels<float>(int, int, const void*, const void*,
                                    void*, int, int, int, int, int, int, int,
                                    int, int, int, cudaStream_t);
}  // namespace kuf_fwd
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// Z [T, F(, 2), d] contiguous, Xt [L, d, N] contiguous -> out
// [nl + 1, T, N] at order p = min(order, nl); kind as gpsig::BaseKind
// (degree for kPoly); threads a block and staged (the factors in shared
// memory) as ops/cuda/plan.py's kuf_fwd_plan gives them. Returns
// cudaGetLastError() after the launch.
int gpsig_tens_seq_general(const void* Z, const void* Xt, void* out, int Tn,
                           int N, int L, int d, int nl, int order, int kind,
                           int degree, int inc, int diff, int f64,
                           int threads, int staged, void* stream) {
  if (L < (diff ? 2 : 1) || d < 1 || Tn > 65535 || order < 1 ||
      kind < kLinear || kind > kPoly || (kind == kPoly && degree < 1))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? kuf_fwd::by_levels<double>(nl, P, Z, Xt, out, Tn, N, L, d,
                                          kind, degree, inc, diff, threads,
                                          staged, s)
             : kuf_fwd::by_levels<float>(nl, P, Z, Xt, out, Tn, N, L, d,
                                         kind, degree, inc, diff, threads,
                                         staged, s);
}

}  // extern "C"
