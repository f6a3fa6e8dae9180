// Backward of the per-pair signature DP over prebuilt increment matrices
// for num_levels 8 .. 127 (p = min(order, num_levels) <= 3), for Hopper
// (sm_90a): M̄ [B, L1, L2] from the level cotangents g [nl + 1, B].
//
// Replaces, past 7 levels, the TPU kernels gpsig_tpu/ops/pallas/
// sig_gram.py:_bwd_kernel (order 1) and _bwd_kernel_ho (order >= 2), as
// sig_gram_bwd.cuh does up to 7; the plain version is autograd through
// ops/signature.py's signature_kern.
//
// Design. sig_gram_bwd.cuh's layout and orientation (one warp per matrix,
// 4 per block, up to L2 = 128; a block of W warps above; M's rows swept as
// the DP's columns, each M̄ row written once, coalesced) with
// deep_levels.cuh's adjoint: the per-level state that the register path
// unrolls over 7 levels (the forward carries, the rebuilt states, the
// scans and the reverse carries, nl + (nl-1)(p² + 3p - 1) values a row)
// lives in shared memory where the block's pairs fit, else in a device
// workspace the wrapper allocates, the grid striding over the pairs.
//
// What bounds it on the H100. As sig_gram_bwd.cuh: L1 serial row steps per
// pair, now with every level's carries read and written through memory
// each step (shared memory or L1/L2), so latency at the training shapes.

#include "deep_levels.cuh"

namespace {

using namespace gpsig;

template <typename T, int R, int P, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
sig_gram_bwd_deep_kernel(const T* __restrict__ M, const T* __restrict__ gw,
                         T* __restrict__ Mbar, T* work, int per_pair, int B,
                         int L1, int L2, int nl, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  deep_pairs<T, R, G>(
      reinterpret_cast<T*>(smem_raw), work, per_pair, B, W,
      [&](int b, const DeepStore<T, R>& mem, G& g) {
        const int t = g.thread();
        const long long off = static_cast<long long>(b) * L1 * L2;
        MatrixRows<T, R> rows{M + off, L2, t};
        auto w = [&](int m) { return gw[static_cast<long long>(m + 1) * B +
                                        b]; };
        T* gb = Mbar + off;
        auto sink = [&](int i, const T (&mbar)[R], G&) {
          T* row = gb + static_cast<long long>(i) * L2;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int jj = t * R + r;
            if (jj < L2) row[jj] = mbar[r];
          }
        };
        deep_levels_bwd<T, R, P>(rows, rows, sink, L1, nl, w, mem, g);
      });
}

template <typename T, int R, int P, typename G>
cudaError_t launch(const void* M, const void* g, void* Mbar, void* work,
                   int B, int L1, int L2, int nl, int W, int blocks,
                   int per_pair, cudaStream_t stream) {
  const int threads = G::kBlock ? 32 * W : 32 * kPairsPerBlock;
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  size_t smem = exchange_bytes<T>(W);
  if (!work) smem += sizeof(T) * static_cast<size_t>(pairs) * per_pair;
  cudaError_t e = allow_smem(sig_gram_bwd_deep_kernel<T, R, P, G>, smem);
  if (e != cudaSuccess) return e;
  sig_gram_bwd_deep_kernel<T, R, P, G><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(M), static_cast<const T*>(g),
      static_cast<T*>(Mbar), static_cast<T*>(work), per_pair, B, L1, L2, nl,
      W);
  return cudaGetLastError();
}

template <typename T, int R, typename G>
cudaError_t by_order(int P, const void* M, const void* g, void* Mbar,
                     void* work, int B, int L1, int L2, int nl, int W,
                     int blocks, int per_pair, cudaStream_t s) {
  switch (P) {
    case 1: return launch<T, R, 1, G>(M, g, Mbar, work, B, L1, L2, nl, W,
                                      blocks, per_pair, s);
    case 2: return launch<T, R, 2, G>(M, g, Mbar, work, B, L1, L2, nl, W,
                                      blocks, per_pair, s);
    case 3: return launch<T, R, 3, G>(M, g, Mbar, work, B, L1, L2, nl, W,
                                      blocks, per_pair, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_rows(int P, const void* M, const void* g, void* Mbar,
                    void* work, int B, int L1, int L2, int nl, int W, int R,
                    int blocks, int per_pair, cudaStream_t s) {
  if (W > 1)
    return by_order<T, 4, BlockGroup<T>>(P, M, g, Mbar, work, B, L1, L2, nl,
                                         W, blocks, per_pair, s);
  switch (R) {
    case 2: return by_order<T, 2, WarpGroup<T>>(P, M, g, Mbar, work, B, L1,
                                                L2, nl, 1, blocks, per_pair,
                                                s);
    case 4: return by_order<T, 4, WarpGroup<T>>(P, M, g, Mbar, work, B, L1,
                                                L2, nl, 1, blocks, per_pair,
                                                s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// As gpsig_sig_gram_bwd for num_levels 1 .. 127 at p = min(order, nl) <= 3,
// with work, blocks and per_pair as gpsig_sig_gram_deep.
int gpsig_sig_gram_bwd_deep(const void* M, const void* g, void* Mbar,
                            void* work, int B, int L1, int L2, int nl,
                            int order, int W, int R, int blocks, int per_pair,
                            int f64, void* stream) {
  const int P = order < nl ? order : nl;
  if (B < 1 || L1 < 1 || L2 < 1 || nl < 1 || nl > kDeepLevels ||
      order < 1 || P > kDeepOrder || blocks < 1 || per_pair < 1 ||
      !plan_ok(L2, W, R))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_rows<double>(P, M, g, Mbar, work, B, L1, L2, nl, W, R,
                               blocks, per_pair, s)
             : by_rows<float>(P, M, g, Mbar, work, B, L1, L2, nl, W, R,
                              blocks, per_pair, s);
}

}  // extern "C"
