// Order-1 signature self-kernels: the entry point and the float32
// instantiations. The design note, kernel and launch are in
// fused_diag.cuh; fused_diag_f64.cu compiles the float64 ones.

#include "fused_diag.cuh"

namespace gpsig {
template cudaError_t diag_dispatch<float>(const DiagArgs&, cudaStream_t);
}  // namespace gpsig

using namespace gpsig;

extern "C" {

// X [N, L, d] contiguous -> out [nl + 1, N]. W = 0: the segment design,
// segments of S lanes at R rows a lane (one band, `stage` kStageAll),
// 32 / S sequences a one-warp block; W > 0: the band design, S = 32, R = 8,
// `bands` bands of 256 rows on a block of W warps a sequence, `stage` a
// DiagStage, the bands' carries in shared memory (carry_smem) or in work
// [blocks][W][nl - 1][L - 1], `blocks` blocks striding over the sequences.
// Returns cudaGetLastError() after the launch (0 on success).
int gpsig_fused_diag(const void* X, void* out, void* work, int N, int L,
                     int d, int nl, int rbf, int S, int R, int W, int bands,
                     int stage, int carry_smem, int blocks, int f64,
                     void* stream) {
  const int rows = L - 1;
  const bool band_ok = W >= 1 && W <= kDiagBandWarps && S == 32 && R == 8 &&
                       bands == (rows + 255) / 256 && blocks >= 1 &&
                       stage >= kStageNone && stage <= kStageAll &&
                       (bands == 1 || nl == 1 || carry_smem ||
                        work != nullptr);
  const bool seg_ok = W == 0 && (S == 8 || S == 16 || S == 32) &&
                      (R == 2 || R == 4 || R == 8) && S * R >= rows &&
                      bands == 1 && stage == kStageAll;
  if (L < 2 || d < 1 || nl < 1 || nl > 7 || N < 1 || !(band_ok || seg_ok))
    return cudaErrorInvalidValue;
  const DiagArgs a{X, out, work, N, L, d, nl, rbf, S, R, W, bands, stage,
                   carry_smem, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? diag_dispatch<double>(a, s) : diag_dispatch<float>(a, s);
}

}  // extern "C"
