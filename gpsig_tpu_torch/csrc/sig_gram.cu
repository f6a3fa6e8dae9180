// Per-pair signature DP over prebuilt increment matrices: the entry point
// and the float32 register path (float64 in sig_gram_f64.cu, past 7 levels
// sig_gram_deep.cu, past order 7 sig_gram_order.cu and
// sig_gram_order_f64.cu). The design notes and kernels are in
// sig_gram.cuh and sig_gram_order.cuh.

#include "sig_gram_order.cuh"

namespace gpsig {
template cudaError_t sg_fwd<float>(const SgArgs&, cudaStream_t);
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// M [B, L1, L2] contiguous -> out [nl + 1, B] at order p = min(order, nl),
// num_levels 1 .. 127, as the plan (S, R, bands, W, area_smem, blocks,
// area; ops/cuda/plan.py's sig_gram_plan) says, work the workspace or null;
// p > 7 takes the run-time-order instance (sig_gram_order.cuh); returns
// cudaGetLastError() after the launch.
int gpsig_sig_gram(const void* M, void* out, void* work, int B, int L1,
                   int L2, int nl, int order, int S, int R, int bands, int W,
                   int area_smem, int blocks, int area, int f64,
                   void* stream) {
  const int P = order < nl ? order : nl;
  if (nl < 1 || nl > kDeepLevels || order < 1) return cudaErrorInvalidValue;
  const SgArgs a{M,     nullptr, out, work, B,         L1,     L2,  nl,
                 P,     S,       R,   bands, W,        area_smem, blocks,
                 area};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > kDeepOrder)
    return f64 ? sg_fwd_order<double>(a, s) : sg_fwd_order<float>(a, s);
  if (nl <= kRlLevels) return f64 ? sg_fwd<double>(a, s) : sg_fwd<float>(a, s);
  return f64 ? sg_fwd_deep<double>(a, s) : sg_fwd_deep<float>(a, s);
}

}  // extern "C"
