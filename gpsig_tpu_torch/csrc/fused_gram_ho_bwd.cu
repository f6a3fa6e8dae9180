// Backward of the general fused signature Gram: the two entry points (one
// warp a pair up to 128 rows, a block of W warps above) and the one-warp
// float32 instantiation up to 7 levels. The design note, kernel and launch
// are in fused_gram_ho_bwd.cuh; the other instantiations are compiled by
// their own sources.

#include "fused_gram_ho_bwd.cuh"

namespace gpsig {
template cudaError_t ho_bwd_warp<float, 7>(int, const HoBwdArgs&, int,
                                           cudaStream_t);
}  // namespace gpsig

using namespace gpsig;

namespace {

// The argument checks shared by both entry points.
bool ho_bwd_ok(int L, int d, int nl, int order, int kind, int degree,
               int ch, int staged, int blocks, const void* work) {
  return L >= 2 && d >= 1 && nl >= 1 && nl <= kRlLevels && order >= 1 &&
         kind >= kLinear && kind <= kPoly && (kind != kPoly || degree >= 1) &&
         (ch == 2 || ch == 4 || ch == 8) && blocks >= 1 &&
         (staged || work != nullptr);
}

}  // namespace

extern "C" {

// X [N1, L, d], Y [N2, L, d], g [nl + 1, N1, N2] contiguous; Xbar, Ybar
// zero-filled [N1, L, d], [N2, L, d], distinct buffers; order, kind,
// degree and diff as gpsig_fused_gram_ho; R rows a lane of one warp (at
// most 128 rows); tiles of ch columns; `staged` (x, y and the X̄ sums in
// shared memory) or not (work: [blocks][pairs][L][d + 1]); `blocks`
// blocks, striding over the items. Returns cudaGetLastError() after the
// launch (0 on success).
int gpsig_fused_gram_ho_bwd(const void* X, const void* Y, const void* g,
                            void* Xbar, void* Ybar, void* work, int N1,
                            int N2, int L, int d, int nl, int order,
                            int kind, int degree, int diff, int R, int ch,
                            int staged, int blocks, int f64, void* stream) {
  if (!ho_bwd_ok(L, d, nl, order, kind, degree, ch, staged, blocks, work) ||
      !plan_ok(diff ? L - 1 : L, 1, R))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  const HoBwdArgs a{X, Y, g, Xbar, Ybar, work, N1, N2, L, d, nl, kind,
                    degree, diff, ch, staged, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) return ho_bwd_warp<double, 7>(P, a, R, s);
  return nl <= 4 ? ho_bwd_warp<float, 4>(P, a, R, s)
                 : ho_bwd_warp<float, 7>(P, a, R, s);
}

// As gpsig_fused_gram_ho_bwd, the rows over W = 2..8 warps of one block.
int gpsig_fused_gram_ho_bwd_block(const void* X, const void* Y,
                                  const void* g, void* Xbar, void* Ybar,
                                  void* work, int N1, int N2, int L, int d,
                                  int nl, int order, int kind, int degree,
                                  int diff, int W, int ch, int staged,
                                  int blocks, int f64, void* stream) {
  if (!ho_bwd_ok(L, d, nl, order, kind, degree, ch, staged, blocks, work) ||
      W < 2 || !plan_ok(diff ? L - 1 : L, W, 4))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  const HoBwdArgs a{X, Y, g, Xbar, Ybar, work, N1, N2, L, d, nl, kind,
                    degree, diff, ch, staged, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) return ho_bwd_block<double, 7>(P, a, W, s);
  return nl <= 4 ? ho_bwd_block<float, 4>(P, a, W, s)
                 : ho_bwd_block<float, 7>(P, a, W, s);
}

}  // extern "C"
