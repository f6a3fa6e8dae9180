// Backward of the per-pair signature DP over prebuilt increment matrices:
// the entry point and the float32 segments (the others in
// sig_gram_bwd_f64.cu, sig_gram_bwd_band.cu, sig_gram_bwd_band_f64.cu,
// sig_gram_bwd_deep.cu and sig_gram_bwd_deep_f64.cu; past order 7
// sig_gram_order.cu and sig_gram_order_f64.cu). The design notes and
// kernels are in sig_gram_bwd.cuh and sig_gram_order.cuh.

#include "sig_gram_bwd.cuh"
#include "sig_gram_order.cuh"

namespace gpsig {
template cudaError_t sg_bwd<float, false>(const SgArgs&, cudaStream_t);
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// M [B, L1, L2], g [nl + 1, B] contiguous -> Mbar [B, L1, L2] (every entry
// written) at order p = min(order, nl), num_levels 1 .. 127, the plan and
// work as gpsig_sig_gram's (p > 7: sig_gram_order.cuh); returns
// cudaGetLastError() after the launch.
int gpsig_sig_gram_bwd(const void* M, const void* g, void* Mbar, void* work,
                       int B, int L1, int L2, int nl, int order, int S, int R,
                       int bands, int W, int area_smem, int blocks, int area,
                       int f64, void* stream) {
  const int P = order < nl ? order : nl;
  if (nl < 1 || nl > kDeepLevels || order < 1) return cudaErrorInvalidValue;
  const SgArgs a{M, g, Mbar, work, B,         L1,     L2,  nl,
                 P, S, R,    bands, W,        area_smem, blocks, area};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > kDeepOrder)
    return f64 ? sg_bwd_order<double>(a, s) : sg_bwd_order<float>(a, s);
  if (nl > kRlLevels)
    return f64 ? sg_bwd_deep<double>(a, s) : sg_bwd_deep<float>(a, s);
  if (bands > 1)
    return f64 ? sg_bwd<double, true>(a, s) : sg_bwd<float, true>(a, s);
  return f64 ? sg_bwd<double, false>(a, s) : sg_bwd<float, false>(a, s);
}

}  // extern "C"
