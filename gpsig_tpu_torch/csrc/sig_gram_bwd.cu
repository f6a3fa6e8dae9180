// Backward of the per-pair signature DP over prebuilt increment matrices:
// the float32 instantiations and the entry point (float64 in
// sig_gram_bwd_f64.cu and sig_gram_bwd_block_f64.cu). The design note and
// kernel are in sig_gram_bwd.cuh.

#include "sig_gram_bwd.cuh"

extern "C" {

// M [B, L1, L2], g [nl + 1, B] contiguous -> Mbar [B, L1, L2] (every entry
// written) at order p = min(order, nl), L2 spread as the plan (W, R) says;
// returns cudaGetLastError() after the launch.
int gpsig_sig_gram_bwd(const void* M, const void* g, void* Mbar, int B,
                       int L1, int L2, int nl, int order, int W, int R,
                       int f64, void* stream) {
  if (B < 1 || L1 < 1 || L2 < 1 || nl < 1 || nl > kRlLevels || order < 1 ||
      !plan_ok(L2, W, R))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return W > 1 ? sig_gram_bwd_block_f64(P, M, g, Mbar, B, L1, L2, nl, W, s)
                 : sig_gram_bwd_warp_f64(P, M, g, Mbar, B, L1, L2, nl, R, s);
  return W > 1 ? by_order<float, 4, BlockGroup<float>>(P, M, g, Mbar, B, L1,
                                                       L2, nl, W, s)
               : by_rows<float>(P, M, g, Mbar, B, L1, L2, nl, R, s);
}

}  // extern "C"
