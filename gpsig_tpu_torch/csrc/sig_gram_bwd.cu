// Backward of the per-pair signature DP over prebuilt increment matrices,
// for Hopper (sm_90a): M̄ [B, L1, L2] from the level cotangents w
// [nl + 1, B] of out[m, b] = k_m(M_b) (sig_gram.cu).
//
// Replaces the TPU kernels gpsig_tpu/ops/pallas/sig_gram.py:_bwd_kernel
// (order 1, the custom VJP of sig_gram_levels) and sig_gram.py:
// _bwd_kernel_ho (order >= 2, of sig_gram_levels_ho): the VJP of the
// plain version signature_kern, order 1 being the P = 1 instantiation of
// the same source, as in the forward.
//
// Design. The forward's layout: one warp per matrix, 4 per block, the
// warp sweeping M's rows as the DP's columns with j over the lanes (the
// forward's choice, which the kernel value's symmetry under Mᵀ allows).
// The backward keeps that orientation: the DP it differentiates is the one
// the forward ran, on M's rows, so the M̄ it produces for "column" i, lane
// entry j is ∂/∂M[b, i, j] itself and is stored there, a coalesced row,
// each entry written once (no transpose, no atomics; lanes past L2 write
// nothing). The adjoint is common.cuh's run_length_levels_bwd: a forward
// sweep to the end carries, then a reverse sweep that rebuilds each row's
// states by subtraction, all in registers.
//
// What bounds it on the H100. It reads M (B L1 L2 values) and writes M̄ of
// the same size, 2 × 19.2 MB at B = 2048, L = 49 in float32: 11.5 us at
// 3.35 TB/s. Per entry it does the forward's DP work twice (forward
// sweep, rebuild) and the adjoint's, about 3-4x the forward's operations,
// plus about twice its warp scans, so at the training shapes (B = 50 or
// 150) it is bound by its L1 serial row steps per warp: latency, with far
// fewer warps than the card holds.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kWarpsPerBlock = 4;

// Warp w of block b handles matrix b * 4 + w.
template <typename T, int R, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sig_gram_bwd_kernel(const T* __restrict__ M, const T* __restrict__ g,
                    T* __restrict__ Mbar, int B, int L1, int L2, int nl) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only
  const long long off = static_cast<long long>(b) * L1 * L2;
  MatrixRows<T, R> rows{M + off, L2, lane};
  T w[kRlLevels];
#pragma unroll
  for (int m = 0; m < kRlLevels; ++m)
    w[m] = m < nl ? g[static_cast<long long>(m + 1) * B + b] : T(0);
  T* gb = Mbar + off;
  auto sink = [&](int i, const T (&mbar)[R]) {
    T* row = gb + static_cast<long long>(i) * L2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jj = lane * R + r;
      if (jj < L2) row[jj] = mbar[r];
    }
  };
  run_length_levels_bwd<T, R, P>(rows, rows, sink, L1, nl, w);
}

template <typename T, int R, int P>
cudaError_t launch(const void* M, const void* g, void* Mbar, int B, int L1,
                   int L2, int nl, cudaStream_t stream) {
  const unsigned blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sig_gram_bwd_kernel<T, R, P><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(M), static_cast<const T*>(g),
      static_cast<T*>(Mbar), B, L1, L2, nl);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t by_order(int P, const void* M, const void* g, void* Mbar, int B,
                     int L1, int L2, int nl, cudaStream_t s) {
  switch (P) {
    case 1: return launch<T, R, 1>(M, g, Mbar, B, L1, L2, nl, s);
    case 2: return launch<T, R, 2>(M, g, Mbar, B, L1, L2, nl, s);
    case 3: return launch<T, R, 3>(M, g, Mbar, B, L1, L2, nl, s);
    case 4: return launch<T, R, 4>(M, g, Mbar, B, L1, L2, nl, s);
    case 5: return launch<T, R, 5>(M, g, Mbar, B, L1, L2, nl, s);
    case 6: return launch<T, R, 6>(M, g, Mbar, B, L1, L2, nl, s);
    case 7: return launch<T, R, 7>(M, g, Mbar, B, L1, L2, nl, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_rows(int P, const void* M, const void* g, void* Mbar, int B,
                    int L1, int L2, int nl, cudaStream_t s) {
  switch (rl_rows_per_lane(L2)) {
    case 2: return by_order<T, 2>(P, M, g, Mbar, B, L1, L2, nl, s);
    case 4: return by_order<T, 4>(P, M, g, Mbar, B, L1, L2, nl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// M [B, L1, L2] (L2 <= 128), g [nl + 1, B] contiguous -> Mbar [B, L1, L2]
// (every entry written) at order p = min(order, nl); returns
// cudaGetLastError() after the launch.
int gpsig_sig_gram_bwd(const void* M, const void* g, void* Mbar, int B,
                       int L1, int L2, int nl, int order, int f64,
                       void* stream) {
  if (B < 1 || L1 < 1 || L2 < 1 || nl < 1 || nl > kRlLevels || order < 1)
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_rows<double>(P, M, g, Mbar, B, L1, L2, nl, s)
             : by_rows<float>(P, M, g, Mbar, B, L1, L2, nl, s);
}

}  // extern "C"
