// Backward of the general fused signature Gram, one warp a pair (up to
// 128 rows): the float32 instantiations and the entry point for WarpGroup
// (float64 in fused_gram_ho_bwd_f64.cu). The design note, kernel and launch
// are in fused_gram_ho_bwd.cuh.

#include "fused_gram_ho_bwd.cuh"

extern "C" {

// X [N1, L, d], Y [N2, L, d], g [nl + 1, N1, N2] contiguous; Xbar, Ybar
// zero-filled [N1, L, d], [N2, L, d], distinct buffers; order, kind,
// degree and diff as gpsig_fused_gram_ho; R rows a lane of one warp (at
// most 128 rows). Returns cudaGetLastError() after the launch (0 on
// success).
int gpsig_fused_gram_ho_bwd(const void* X, const void* Y, const void* g,
                            void* Xbar, void* Ybar, int N1, int N2, int L,
                            int d, int nl, int order, int kind, int degree,
                            int diff, int R, int f64, void* stream) {
  if (L < 2 || d < 1 || nl < 1 || nl > kRlLevels || order < 1 ||
      kind < kLinear || kind > kPoly || (kind == kPoly && degree < 1) ||
      !plan_ok(diff ? L - 1 : L, 1, R))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? gram_ho_bwd_warp_f64(P, X, Y, g, Xbar, Ybar, N1, N2, L, d, nl,
                                    kind, degree, diff, R, s)
             : by_rows<float>(P, X, Y, g, Xbar, Ybar, N1, N2, L, d, nl, kind,
                              degree, diff, R, s);
}

}  // extern "C"
