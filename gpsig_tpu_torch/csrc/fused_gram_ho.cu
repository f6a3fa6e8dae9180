// Fused signature Gram of the general engine: the entry point and the
// float32 instantiation. The design note, kernels and launches are in
// fused_gram_ho.cuh; fused_gram_ho_f64.cu compiles the float64 ones.

#include "fused_gram_ho.cuh"

namespace gpsig {
namespace ho_fwd {
template cudaError_t by_order<float>(
    int, int, int, int, const void*, const void*, void*, int, int, int, int,
    int, int, int, int, int, cudaStream_t);
}  // namespace ho_fwd
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// X [N1, L, d], Y [N2, L, d] contiguous -> out [nl + 1, N1, N2], at order
// p = min(order, nl); kind as gpsig::BaseKind (degree for kPoly); the rows
// spread as the plan says: segments of S lanes at R rows a lane (W = 1), or
// W > 1 warps a pair at R = 4; with sym (Y = X) only the pairs on and
// above the diagonal are solved, each written twice. Returns
// cudaGetLastError() after the launch (0 on success).
int gpsig_fused_gram_ho(const void* X, const void* Y, void* out, int N1,
                        int N2, int L, int d, int nl, int order, int kind,
                        int degree, int diff, int S, int R, int W, int sym,
                        int f64, void* stream) {
  const int rows = diff ? L - 1 : L;
  const bool seg_ok = W == 1 && (S == 8 || S == 16 || S == 32) &&
                      rows <= S * R;
  if (L < 2 || d < 1 || nl < 1 || nl > kRlLevels || order < 1 ||
      kind < kLinear || kind > kPoly || (kind == kPoly && degree < 1) ||
      (W > 1 ? (S != 32 || !plan_ok(rows, W, R)) : !seg_ok) ||
      (sym && N1 != N2))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? ho_fwd::by_order<double>(P, S, R, W, X, Y, out, N1, N2, L,
                                        d, nl, kind, degree, diff, sym, s)
             : ho_fwd::by_order<float>(P, S, R, W, X, Y, out, N1, N2, L, d,
                                       nl, kind, degree, diff, sym, s);
}

}  // extern "C"
