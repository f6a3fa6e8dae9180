// Per-pair signature DP over prebuilt increment matrices, for Hopper
// (sm_90a): out[m, b] = k_m(M_b) for M [B, L1, L2].
//
// Replaces the TPU kernels gpsig_tpu/ops/pallas/sig_gram.py:_fwd_kernel
// (order 1, entry point sig_gram_levels) and sig_gram.py:_fwd_kernel_ho
// (order >= 2, entry point sig_gram_levels_ho): the same function for any
// order p = min(order, num_levels) <= num_levels <= 127, order 1 being the
// P = 1 instantiation of the same source. The plain version is
// ops/signature.py's signature_kern. In the port it computes the
// normalisation diagonal of every configuration that the tuned
// _diag_kernel does not take (order >= 2, difference=False, Poly/Cosine),
// from the self-increment matrices the kernel layer builds in PyTorch.
//
// Design. The run-length column DP of fused_gram_ho.cu (common.cuh's
// run_length_levels), with its columns read from M instead of built: one
// warp per matrix, 4 per block, up to L2 = 128; above, one block of W <= 8
// warps per matrix (the wrapper's plan), the row scans crossing the warps
// through shared memory. The truncated signature kernel is symmetric under
// transposing M (swapping the roles of i and j swaps the run lengths r and
// s, and the recursion treats them alike), so the group streams M's rows
// M[b, i, :] as its "columns" and spreads j over its threads: each read is
// a contiguous row, coalesced, with no shared-memory staging and no
// transpose. Templated on (P, R) and the group: 7 x 3 instantiations per
// dtype (R = 2, 4 on a warp, 4 on a block).
//
// Past 7 levels (up to 127, p <= 3) the same layout runs deep_levels.cuh's
// loop over levels, the per-level carries (nl + (nl-1)(p-1) values a row)
// in shared memory where the block's pairs fit, else in a device
// workspace the wrapper allocates, the grid striding over the pairs: 3 x 3
// instantiations per dtype, the level count a run-time value.
//
// What bounds it on the H100. It reads B L1 L2 values once and writes
// (nl + 1) B: at the flagship diagonal (B = 2048, L1 = L2 = 49, float32)
// that is 19.7 MB, 5.9 us at 3.35 TB/s, against about L1 L2 (R_m^2 +
// 3 R_m) multiply-adds per level and pair plus R_m warp scans per row and
// level, so instruction throughput bounds it; L1 serial row steps per
// warp also make it latency-bound when B is small.

#include "common.cuh"
#include "deep_levels.cuh"

namespace {

using namespace gpsig;

// Matrix b = blockIdx.x * pairs + p (one warp each, or the whole block
// for a BlockGroup). out: [nl + 1, B].
template <typename T, int R, int P, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
sig_gram_kernel(const T* __restrict__ M, T* __restrict__ out, int B, int L1,
                int L2, int nl, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const int p = G::kBlock ? 0 : static_cast<int>(threadIdx.x) >> 5;
  const int b = blockIdx.x * pairs + p;
  if (b >= B) return;  // whole warps only; a block group is always live
  G g(W, reinterpret_cast<T*>(smem_raw));
  MatrixRows<T, R> rows{M + static_cast<long long>(b) * L1 * L2, L2,
                        g.thread()};
  run_length_levels<T, R, P>(rows, L1, nl, out + b,
                             static_cast<long long>(B), g);
}

template <typename T, int R, int P, typename G>
cudaError_t launch(const void* M, void* out, int B, int L1, int L2, int nl,
                   int W, cudaStream_t stream) {
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const unsigned blocks = (B + pairs - 1) / pairs;
  sig_gram_kernel<T, R, P, G><<<blocks,
                                G::kBlock ? 32 * W : 32 * kPairsPerBlock,
                                exchange_bytes<T>(W), stream>>>(
      static_cast<const T*>(M), static_cast<T*>(out), B, L1, L2, nl, W);
  return cudaGetLastError();
}

template <typename T, int R, typename G>
cudaError_t by_order(int P, const void* M, void* out, int B, int L1, int L2,
                     int nl, int W, cudaStream_t s) {
  switch (P) {
    case 1: return launch<T, R, 1, G>(M, out, B, L1, L2, nl, W, s);
    case 2: return launch<T, R, 2, G>(M, out, B, L1, L2, nl, W, s);
    case 3: return launch<T, R, 3, G>(M, out, B, L1, L2, nl, W, s);
    case 4: return launch<T, R, 4, G>(M, out, B, L1, L2, nl, W, s);
    case 5: return launch<T, R, 5, G>(M, out, B, L1, L2, nl, W, s);
    case 6: return launch<T, R, 6, G>(M, out, B, L1, L2, nl, W, s);
    case 7: return launch<T, R, 7, G>(M, out, B, L1, L2, nl, W, s);
    default: return cudaErrorInvalidValue;
  }
}

// One warp a matrix at R = 2 or 4, or a block of W warps at R = 4.
template <typename T>
cudaError_t by_rows(int P, const void* M, void* out, int B, int L1, int L2,
                    int nl, int W, int R, cudaStream_t s) {
  if (W > 1)
    return by_order<T, 4, BlockGroup<T>>(P, M, out, B, L1, L2, nl, W, s);
  switch (R) {
    case 2: return by_order<T, 2, WarpGroup<T>>(P, M, out, B, L1, L2, nl, 1,
                                                s);
    case 4: return by_order<T, 4, WarpGroup<T>>(P, M, out, B, L1, L2, nl, 1,
                                                s);
    default: return cudaErrorInvalidValue;
  }
}

// The deep path (num_levels 8 .. 127): state from shared memory at
// per_pair elements a pair (work null) or from the workspace.
template <typename T, int R, int P, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
sig_gram_deep_kernel(const T* __restrict__ M, T* __restrict__ out, T* work,
                     int per_pair, int B, int L1, int L2, int nl, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  deep_pairs<T, R, G>(
      reinterpret_cast<T*>(smem_raw), work, per_pair, B, W,
      [&](int b, const DeepStore<T, R>& mem, G& g) {
        MatrixRows<T, R> rows{M + static_cast<long long>(b) * L1 * L2, L2,
                              g.thread()};
        deep_levels<T, R, P>(rows, L1, nl, out + b,
                             static_cast<long long>(B), mem, g);
      });
}

template <typename T, int R, int P, typename G>
cudaError_t launch_deep(const void* M, void* out, void* work, int B, int L1,
                        int L2, int nl, int W, int blocks, int per_pair,
                        cudaStream_t stream) {
  const int threads = G::kBlock ? 32 * W : 32 * kPairsPerBlock;
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  size_t smem = exchange_bytes<T>(W);
  if (!work) smem += sizeof(T) * static_cast<size_t>(pairs) * per_pair;
  cudaError_t e = allow_smem(sig_gram_deep_kernel<T, R, P, G>, smem);
  if (e != cudaSuccess) return e;
  sig_gram_deep_kernel<T, R, P, G><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(M), static_cast<T*>(out), static_cast<T*>(work),
      per_pair, B, L1, L2, nl, W);
  return cudaGetLastError();
}

template <typename T, int R, typename G>
cudaError_t deep_by_order(int P, const void* M, void* out, void* work, int B,
                          int L1, int L2, int nl, int W, int blocks,
                          int per_pair, cudaStream_t s) {
  switch (P) {
    case 1: return launch_deep<T, R, 1, G>(M, out, work, B, L1, L2, nl, W,
                                           blocks, per_pair, s);
    case 2: return launch_deep<T, R, 2, G>(M, out, work, B, L1, L2, nl, W,
                                           blocks, per_pair, s);
    case 3: return launch_deep<T, R, 3, G>(M, out, work, B, L1, L2, nl, W,
                                           blocks, per_pair, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t deep_by_rows(int P, const void* M, void* out, void* work, int B,
                         int L1, int L2, int nl, int W, int R, int blocks,
                         int per_pair, cudaStream_t s) {
  if (W > 1)
    return deep_by_order<T, 4, BlockGroup<T>>(P, M, out, work, B, L1, L2, nl,
                                              W, blocks, per_pair, s);
  switch (R) {
    case 2: return deep_by_order<T, 2, WarpGroup<T>>(P, M, out, work, B, L1,
                                                     L2, nl, 1, blocks,
                                                     per_pair, s);
    case 4: return deep_by_order<T, 4, WarpGroup<T>>(P, M, out, work, B, L1,
                                                     L2, nl, 1, blocks,
                                                     per_pair, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// M [B, L1, L2] contiguous -> out [nl + 1, B] at order p = min(order, nl),
// L2 spread as the plan (W warps, R entries a lane) says; returns
// cudaGetLastError() after the launch.
int gpsig_sig_gram(const void* M, void* out, int B, int L1, int L2, int nl,
                   int order, int W, int R, int f64, void* stream) {
  if (B < 1 || L1 < 1 || L2 < 1 || nl < 1 || nl > kRlLevels || order < 1 ||
      !plan_ok(L2, W, R))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_rows<double>(P, M, out, B, L1, L2, nl, W, R, s)
             : by_rows<float>(P, M, out, B, L1, L2, nl, W, R, s);
}

// As gpsig_sig_gram for num_levels 1 .. 127 at p = min(order, nl) <= 3 by
// deep_levels.cuh: work null (state in shared memory, per_pair elements a
// pair) or a workspace of blocks x pairs-a-block x per_pair elements;
// blocks is the grid (at least ceil(B / pairs-a-block) without work).
int gpsig_sig_gram_deep(const void* M, void* out, void* work, int B, int L1,
                        int L2, int nl, int order, int W, int R, int blocks,
                        int per_pair, int f64, void* stream) {
  const int P = order < nl ? order : nl;
  if (B < 1 || L1 < 1 || L2 < 1 || nl < 1 || nl > kDeepLevels ||
      order < 1 || P > kDeepOrder || blocks < 1 || per_pair < 1 ||
      !plan_ok(L2, W, R))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? deep_by_rows<double>(P, M, out, work, B, L1, L2, nl, W, R,
                                    blocks, per_pair, s)
             : deep_by_rows<float>(P, M, out, work, B, L1, L2, nl, W, R,
                                   blocks, per_pair, s);
}

}  // extern "C"
