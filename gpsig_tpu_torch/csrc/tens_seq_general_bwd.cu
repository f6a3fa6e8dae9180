// Backward of the general Kuf: the entry point and the float32
// instantiation. The design note, kernels and launches are in
// tens_seq_general_bwd.cuh; tens_seq_general_bwd_f64.cu compiles the
// float64 ones.

// float32: every kernel inlines its levels (tens_seq_general_bwd.cuh)
#define GPSIG_KUF_LEVEL __forceinline__
#include "tens_seq_general_bwd.cuh"

namespace gpsig {
namespace kuf_bwd {
template cudaError_t by_levels<float>(
    int, int, const void*, const void*, const void*, void*, void*, void*, int,
    int, int, int, int, int, int, int, int, int, int, int, int, cudaStream_t);
}  // namespace kuf_bwd
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// Z [T, F(, 2), d], X [N, L, d], g [nl + 1, T, N] contiguous; Zbar
// [T, F(, 2), d] and Xbar [N, L, d] zero-filled; work: the columns'
// workspace (blocks x threads x (F2 (d + 1) + 3d) values) unless staged;
// the launch (threads, ppw pairs a warp, items, blocks, staged) as
// ops/cuda/plan.py's kuf_bwd_plan gives it; order, kind, degree, inc and
// diff as gpsig_tens_seq_general. Returns cudaGetLastError() after the
// launch (0 on success).
int gpsig_tens_seq_general_bwd(const void* Z, const void* X, const void* g,
                               void* Zbar, void* Xbar, void* work, int Tn,
                               int N, int L, int d, int nl, int order,
                               int kind, int degree, int inc, int diff,
                               int f64, int threads, int ppw, int items,
                               int blocks, int staged, void* stream) {
  if (L < (diff ? 2 : 1) || d < 1 || order < 1 || kind < kLinear ||
      kind > kPoly || (kind == kPoly && degree < 1))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? kuf_bwd::by_levels<double>(nl, P, Z, X, g, Zbar, Xbar, work,
                                          Tn, N, L, d, kind, degree, inc,
                                          diff, threads, ppw, items, blocks,
                                          staged, s)
             : kuf_bwd::by_levels<float>(nl, P, Z, X, g, Zbar, Xbar, work,
                                         Tn, N, L, d, kind, degree, inc, diff,
                                         threads, ppw, items, blocks, staged,
                                         s);
}

}  // extern "C"
