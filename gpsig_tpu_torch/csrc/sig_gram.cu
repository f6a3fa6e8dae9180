// Per-pair signature DP over prebuilt increment matrices, for Hopper
// (sm_90a): out[m, b] = k_m(M_b) for M [B, L1, L2].
//
// Replaces the TPU kernels gpsig_tpu/ops/pallas/sig_gram.py:_fwd_kernel
// (order 1, entry point sig_gram_levels) and sig_gram.py:_fwd_kernel_ho
// (order >= 2, entry point sig_gram_levels_ho): the same function for any
// order p = min(order, num_levels) <= num_levels <= 7, order 1 being the
// P = 1 instantiation of the same source. The plain version is
// ops/signature.py's signature_kern. In the port it computes the
// normalisation diagonal of every configuration that the tuned
// _diag_kernel does not take (order >= 2, difference=False, Poly/Cosine),
// from the self-increment matrices the kernel layer builds in PyTorch.
//
// Design. The run-length column DP of fused_gram_ho.cu (common.cuh's
// run_length_levels), with its columns read from M instead of built: one
// warp per matrix, 4 per block. The truncated signature kernel is
// symmetric under transposing M (swapping the roles of i and j swaps the
// run lengths r and s, and the recursion treats them alike), so the warp
// streams M's rows M[b, i, :] as its "columns" and spreads j over the
// lanes: each read is a contiguous row, coalesced, with no shared-memory
// staging and no transpose; L2 > 128 is refused by the wrapper.
// Templated on (P, R): 7 x 2 instantiations per dtype.
//
// What bounds it on the H100. It reads B L1 L2 values once and writes
// (nl + 1) B: at the flagship diagonal (B = 2048, L1 = L2 = 49, float32)
// that is 19.7 MB, 5.9 us at 3.35 TB/s, against about L1 L2 (R_m^2 +
// 3 R_m) multiply-adds per level and pair plus R_m warp scans per row and
// level, so instruction throughput bounds it; L1 serial row steps per
// warp also make it latency-bound when B is small.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kWarpsPerBlock = 4;

// Warp w of block b handles matrix b * 4 + w. out: [nl + 1, B].
template <typename T, int R, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sig_gram_kernel(const T* __restrict__ M, T* __restrict__ out, int B, int L1,
                int L2, int nl) {
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only
  MatrixRows<T, R> rows{M + static_cast<long long>(b) * L1 * L2, L2,
                        static_cast<int>(threadIdx.x & 31)};
  run_length_levels<T, R, P>(rows, L1, nl, out + b,
                             static_cast<long long>(B));
}

template <typename T, int R, int P>
cudaError_t launch(const void* M, void* out, int B, int L1, int L2, int nl,
                   cudaStream_t stream) {
  const unsigned blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sig_gram_kernel<T, R, P><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(M), static_cast<T*>(out), B, L1, L2, nl);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t by_order(int P, const void* M, void* out, int B, int L1, int L2,
                     int nl, cudaStream_t s) {
  switch (P) {
    case 1: return launch<T, R, 1>(M, out, B, L1, L2, nl, s);
    case 2: return launch<T, R, 2>(M, out, B, L1, L2, nl, s);
    case 3: return launch<T, R, 3>(M, out, B, L1, L2, nl, s);
    case 4: return launch<T, R, 4>(M, out, B, L1, L2, nl, s);
    case 5: return launch<T, R, 5>(M, out, B, L1, L2, nl, s);
    case 6: return launch<T, R, 6>(M, out, B, L1, L2, nl, s);
    case 7: return launch<T, R, 7>(M, out, B, L1, L2, nl, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_rows(int P, const void* M, void* out, int B, int L1, int L2,
                    int nl, cudaStream_t s) {
  switch (rl_rows_per_lane(L2)) {
    case 2: return by_order<T, 2>(P, M, out, B, L1, L2, nl, s);
    case 4: return by_order<T, 4>(P, M, out, B, L1, L2, nl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// M [B, L1, L2] contiguous (L2 <= 128) -> out [nl + 1, B] at order
// p = min(order, nl); returns cudaGetLastError() after the launch.
int gpsig_sig_gram(const void* M, void* out, int B, int L1, int L2, int nl,
                   int order, int f64, void* stream) {
  if (B < 1 || L1 < 1 || L2 < 1 || nl < 1 || nl > kRlLevels || order < 1)
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_rows<double>(P, M, out, B, L1, L2, nl, s)
             : by_rows<float>(P, M, out, B, L1, L2, nl, s);
}

}  // extern "C"
