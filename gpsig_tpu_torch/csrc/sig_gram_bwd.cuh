// Shared by three sources, compiled apart so that their instantiations
// build in parallel: sig_gram_bwd.cu (float32 and the entry point),
// sig_gram_bwd_f64.cu (one warp a matrix, float64) and
// sig_gram_bwd_block_f64.cu (a block of warps a matrix, float64).
//
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
// Design. The forward's layout: one warp per matrix, 4 per block, or
// above L2 = 128 a block of W warps per matrix, the group sweeping M's rows
// as the DP's columns with j over its threads (the forward's choice,
// which the kernel value's symmetry under Mᵀ allows). The backward keeps
// that orientation: the DP it differentiates is the one the forward ran,
// on M's rows, so the M̄ it produces for "column" i, thread entry j is
// ∂/∂M[b, i, j] itself and is stored there, a coalesced row, each entry
// written once (no transpose, no atomics; threads past L2 write nothing).
// The adjoint is common.cuh's run_length_levels_bwd: a forward sweep to
// the end carries, then a reverse sweep that rebuilds each row's states
// by subtraction, all in registers.
//
// What bounds it on the H100. It reads M (B L1 L2 values) and writes M̄ of
// the same size, 2 × 19.2 MB at B = 2048, L = 49 in float32: 11.5 us at
// 3.35 TB/s. Per entry it does the forward's DP work twice (forward
// sweep, rebuild) and the adjoint's, about 3-4x the forward's operations,
// plus about twice its warp scans, so at the training shapes (B = 50 or
// 150) it is bound by its L1 serial row steps per warp: latency, with far
// fewer warps than the card holds.

#pragma once

#include "common.cuh"

namespace {

using namespace gpsig;

// Matrix b = blockIdx.x * pairs + p (one warp each, or the whole block
// for a BlockGroup).
template <typename T, int R, int P, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
sig_gram_bwd_kernel(const T* __restrict__ M, const T* __restrict__ g,
                    T* __restrict__ Mbar, int B, int L1, int L2, int nl,
                    int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const int p = G::kBlock ? 0 : static_cast<int>(threadIdx.x) >> 5;
  const int b = blockIdx.x * pairs + p;
  if (b >= B) return;  // whole warps only; a block group is always live
  G grp(W, reinterpret_cast<T*>(smem_raw));
  const int t = grp.thread();
  const long long off = static_cast<long long>(b) * L1 * L2;
  MatrixRows<T, R> rows{M + off, L2, t};
  T w[kRlLevels];
#pragma unroll
  for (int m = 0; m < kRlLevels; ++m)
    w[m] = m < nl ? g[static_cast<long long>(m + 1) * B + b] : T(0);
  T* gb = Mbar + off;
  auto sink = [&](int i, const T (&mbar)[R], G&) {
    T* row = gb + static_cast<long long>(i) * L2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jj = t * R + r;
      if (jj < L2) row[jj] = mbar[r];
    }
  };
  run_length_levels_bwd<T, R, P>(rows, rows, sink, L1, nl, w, grp);
}

template <typename T, int R, int P, typename G>
cudaError_t launch(const void* M, const void* g, void* Mbar, int B, int L1,
                   int L2, int nl, int W, cudaStream_t stream) {
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const unsigned blocks = (B + pairs - 1) / pairs;
  sig_gram_bwd_kernel<T, R, P, G><<<blocks,
                                    G::kBlock ? 32 * W : 32 * kPairsPerBlock,
                                    exchange_bytes<T>(W), stream>>>(
      static_cast<const T*>(M), static_cast<const T*>(g),
      static_cast<T*>(Mbar), B, L1, L2, nl, W);
  return cudaGetLastError();
}

template <typename T, int R, typename G>
cudaError_t by_order(int P, const void* M, const void* g, void* Mbar, int B,
                     int L1, int L2, int nl, int W, cudaStream_t s) {
  switch (P) {
    case 1: return launch<T, R, 1, G>(M, g, Mbar, B, L1, L2, nl, W, s);
    case 2: return launch<T, R, 2, G>(M, g, Mbar, B, L1, L2, nl, W, s);
    case 3: return launch<T, R, 3, G>(M, g, Mbar, B, L1, L2, nl, W, s);
    case 4: return launch<T, R, 4, G>(M, g, Mbar, B, L1, L2, nl, W, s);
    case 5: return launch<T, R, 5, G>(M, g, Mbar, B, L1, L2, nl, W, s);
    case 6: return launch<T, R, 6, G>(M, g, Mbar, B, L1, L2, nl, W, s);
    case 7: return launch<T, R, 7, G>(M, g, Mbar, B, L1, L2, nl, W, s);
    default: return cudaErrorInvalidValue;
  }
}

// One warp a matrix at R = 2 or 4 (a block of W warps is
// by_order<T, 4, BlockGroup<T>>).
template <typename T>
cudaError_t by_rows(int P, const void* M, const void* g, void* Mbar, int B,
                    int L1, int L2, int nl, int R, cudaStream_t s) {
  switch (R) {
    case 2: return by_order<T, 2, WarpGroup<T>>(P, M, g, Mbar, B, L1, L2, nl,
                                                1, s);
    case 4: return by_order<T, 4, WarpGroup<T>>(P, M, g, Mbar, B, L1, L2, nl,
                                                1, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace gpsig {

// The float64 launches, defined in sig_gram_bwd_f64.cu (one warp a
// matrix, R rows a lane) and sig_gram_bwd_block_f64.cu (W warps a matrix).
cudaError_t sig_gram_bwd_warp_f64(int P, const void* M, const void* g,
                                  void* Mbar, int B, int L1, int L2, int nl,
                                  int R, cudaStream_t s);
cudaError_t sig_gram_bwd_block_f64(int P, const void* M, const void* g,
                                   void* Mbar, int B, int L1, int L2, int nl,
                                   int W, cudaStream_t s);

}  // namespace gpsig
