// Fused order-1 signature Gram, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/fused_gram.py:_fused_kernel
// (per-level Gram k_m(x, y), entry point fused_gram_levels). Semantics:
// order 1, difference=True, RBF or Linear base on pre-scaled sequences,
// num_levels <= 7; the RBF column build is exp(-1/2 (|x|^2 + |y|^2) +
// <x, y>) without a clamp, as the Pallas kernel and its reference
// _xla_reference compute it. gpsig_error_string, the library's error
// text, lives here too.
//
// Design of the Gram (redesigned for Hopper). Up to 256 rows a segment of
// S = 8, 16 or 32 lanes of one warp (a WarpGroup<T, S>) takes a pair; the
// plan (S, R) comes from the wrapper (ops/cuda/plan.py's gram_fwd_plan):
// R = 8 rows a lane, 32 / S pairs a warp, four warps to a block, all the
// block's pairs of one x sequence (common.cuh's SegBlock, SegColumns).
// Lane t holds the rows i of the (virtual) increment matrix M[i, j] from
// t*R and sweeps the columns j: it builds the base-kernel values
// k(x_i, y_{j+1}) at its R + 1 points from x staged lane major (no bank
// conflicts) and y broadcast from shared memory, and double-differences
// them against the previous column held in registers, so M never exists
// in memory. The DP state per level is the running column sum
// C_m[i] = sum_{j' < j} A_m[i, j'], and the order-1 update for column j is
//     A_1 = M[:, j],   A_m = M[:, j] * (exclusive row prefix of C_{m-1}),
//     C_m += A_m,
// with the prefix taken over C as it was before column j, levels taken in
// descending order so that no prefix outlives its update. Every level up
// to a bound NLM (4 or 7, templated) is updated unconditionally, so the
// NLM - 1 scans of a column are free of branches and interleave; a scan is
// log2(S) + 1 shuffles, shared by the warp's pairs. The level sums
// k_m = sum_i C_m[i] are segment reductions at the end; level 0 is 1. A
// symmetric Gram (Y = X) solves only the pairs on and above the diagonal
// and writes each twice. At wide d, where the block's y would outgrow the
// shared memory, the segments read y from global memory (SegBlock). Past
// 256 rows one block of W <= 8 warps takes a pair (a BlockGroup at R = 4),
// the scans crossing the warps through shared memory; it stages x and y
// where they fit, else reads them from global memory (every d).
//
// The chain axis. X [C, N1, L, d] and Y [C, N2, L, d] give C independent
// Grams out [C, nl + 1, N1, N2] in one launch: the chain is blockIdx.y,
// and each kernel offsets X, Y and out to its chain before anything else,
// so every chain runs exactly the code of a launch with C = 1 (the
// counterpart of the grid axis that pallas_call's batching rule adds
// under vmap; the design is unchanged).
//
// The diagonal (fused_gram.py:_diag_kernel, entry point
// fused_diag_levels) is fused_diag.cuh's.
//
// What bounds it on the H100. Per pair it reads 2 L d values and writes
// nl + 1, so memory is not the limit: instruction throughput is. The work
// per pair is L^2 base-kernel evaluations (2d + 2 flops and one exp each,
// 1/R of them repeated at lane boundaries), (L-1)^2 increment entries at
// 2 subtractions + (nl - 1) multiply-adds + nl adds each, and per column
// nl - 1 segment scans: O(nl N1 N2 L^2) in all, where the TPU kernel's
// dense triangular matmuls counted 2 nl N1 N2 L^2 Lp. The exp pipe (16 a
// clock an SM against 128 FMAs) bounds the base values; the segment plan
// cuts the shuffles a pair (log2(S) + 1 a scan, shared by 32 / S pairs),
// the idle lanes (49 rows on 7 of 8 lanes at L = 50, not 25 of 32) and
// the barriers past 128 rows (none up to 256).

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kMaxLevels = 7;

// Per-level kernels of one pair, computed by the calling group.
// xs, ys: [L][d] staged sequences; nxs, nys: their -|.|^2/2 (RBF only).
// Group thread 0 writes level m to out[m * stride].
template <typename T, int R, typename G>
__device__ void pair_levels(const T* xs, const T* nxs, const T* ys,
                            const T* nys, int L, int d, int nl, bool rbf,
                            T* out, long long stride, G& g) {
  const int t = g.thread();
  const int rows = L - 1;
  int xi[R + 1];
  T nx[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    xi[r] = min(t * R + r, L - 1);
    nx[r] = rbf ? nxs[xi[r]] : T(0);
  }
  T kprev[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r)
    kprev[r] = base_k(xs + xi[r] * d, nx[r], ys, rbf ? nys[0] : T(0), d, rbf);

  T C[kMaxLevels][R];
#pragma unroll
  for (int m = 0; m < kMaxLevels; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) C[m][r] = T(0);

  for (int j = 0; j < rows; ++j) {
    const T* yj = ys + (j + 1) * d;
    const T nyj = rbf ? nys[j + 1] : T(0);
    T knew[R + 1];
#pragma unroll
    for (int r = 0; r <= R; ++r)
      knew[r] = base_k(xs + xi[r] * d, nx[r], yj, nyj, d, rbf);
    T mcol[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T v = (knew[r + 1] - kprev[r + 1]) - (knew[r] - kprev[r]);
      mcol[r] = (t * R + r < rows) ? v : T(0);
    }
#pragma unroll
    for (int r = 0; r <= R; ++r) kprev[r] = knew[r];

    // exclusive row prefixes of C_1..C_{nl-1}, before this column's update
    T pre[kMaxLevels][R];
#pragma unroll
    for (int m = 0; m + 1 < kMaxLevels; ++m)
      if (m + 1 < nl) g.template prefix<R>(C[m], pre[m]);
#pragma unroll
    for (int r = 0; r < R; ++r) C[0][r] += mcol[r];
#pragma unroll
    for (int m = 1; m < kMaxLevels; ++m) {
      if (m < nl) {
#pragma unroll
        for (int r = 0; r < R; ++r) C[m][r] += mcol[r] * pre[m - 1][r];
      }
    }
  }

  if (t == 0) out[0] = T(1);
#pragma unroll
  for (int m = 0; m < kMaxLevels; ++m) {
    if (m < nl) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += C[m][r];
      s = g.sum(s);
      if (t == 0) out[(m + 1) * stride] = s;
    }
  }
}

// The order-1 DP of one pair by a segment: C[m] = k_{m+1}'s carries,
// every level below NLM updated (levels >= nl are never read).
template <typename T, int R, int NLM, typename Col, typename G>
__device__ __forceinline__ void seg_order1(Col& col, int ncols,
                                           T (&C)[NLM][R], G& g) {
#pragma unroll
  for (int m = 0; m < NLM; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) C[m][r] = T(0);
  for (int j = 0; j < ncols; ++j) {
    T mcol[R];
    col(j, mcol);
#pragma unroll
    for (int m = NLM - 1; m >= 1; --m) {
      T pre[R];
      g.template prefix<R>(C[m - 1], pre);
#pragma unroll
      for (int r = 0; r < R; ++r) C[m][r] += mcol[r] * pre[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) C[0][r] += mcol[r];
  }
}

// Gram on the segment plan: block b handles x = X[b / nyb] against the y
// sequences (b % nyb) * kPairs + p, p the thread's segment, of chain
// blockIdx.y. out: [C][nl + 1, N1, N2].
template <typename T, int R, int S, int NLM>
__global__ void __launch_bounds__(32 * kPairsPerBlock)
gram_seg_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                T* __restrict__ out, int N1, int N2, int L, int d, int nl,
                int rbf, int sym, int stage_y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  {  // chain blockIdx.y's sequences and Gram
    const long long c = blockIdx.y;
    X += c * N1 * L * d;
    Y += c * N2 * L * d;
    out += c * (nl + 1) * N1 * N2;
  }
  SegBlock<T, R, S> b;
  if (!b.stage(X, Y, N1, N2, L, d, rbf != 0, sym != 0, stage_y != 0,
               reinterpret_cast<T*>(smem_raw)))
    return;
  // no barrier follows: a warp none of whose pairs is written stops here
  if (!__any_sync(kFull, b.live)) return;
  WarpGroup<T, S> g;
  SegColumns<T, R, S> col(b, L, d, rbf ? kRbf : kLinear, 0, true,
                          g.thread());
  T C[NLM][R];
  seg_order1<T, R, NLM>(col, L - 1, C, g);
  T lv[NLM];
#pragma unroll
  for (int m = 0; m < NLM; ++m) {
    if (m < nl) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += C[m][r];
      lv[m] = g.sum(s);
    }
  }
  if (b.live && g.thread() == 0) {
    b.write(out, 0, T(1), N1, N2, sym != 0);
#pragma unroll
    for (int m = 0; m < NLM; ++m)
      if (m < nl) b.write(out, m + 1, lv[m], N1, N2, sym != 0);
  }
}

// Gram on the block design: block b handles x = X[b / N2] against
// y = Y[b % N2] of chain blockIdx.y with a BlockGroup of W warps; with sym
// only the pairs on and above the diagonal, thread 0 mirroring its values.
// x and y are staged where they fit (stage), else read from global memory.
// out: [C][nl + 1, N1, N2].
template <typename T>
__global__ void __launch_bounds__(BlockGroup<T>::kMaxThreads)
gram_block_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                  T* __restrict__ out, int N1, int N2, int L, int d, int nl,
                  int rbf, int W, int sym, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  {  // chain blockIdx.y's sequences and Gram
    const long long c = blockIdx.y;
    X += c * N1 * L * d;
    Y += c * N2 * L * d;
    out += c * (nl + 1) * N1 * N2;
  }
  const int n1 = blockIdx.x / N2;
  const int n2 = blockIdx.x % N2;
  if (sym && n2 < n1) return;  // the whole block: one pair
  const int Ld = L * d;
  const T* xs = X + static_cast<long long>(n1) * Ld;
  const T* ys = Y + static_cast<long long>(n2) * Ld;
  T* nxs = reinterpret_cast<T*>(smem_raw);
  if (stage) {  // x, -|x|^2/2, y, -|y|^2/2; else only the half norms
    T* x_s = nxs;
    T* y_s = x_s + Ld + L;
    for (int k = threadIdx.x; k < Ld; k += blockDim.x) {
      x_s[k] = xs[k];
      y_s[k] = ys[k];
    }
    nxs = x_s + Ld;
    xs = x_s;
    ys = y_s;
  }
  T* nys = stage ? nxs + L + Ld : nxs + L;
  T* buf = nys + L;
  __syncthreads();
  if (rbf) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    half_sqnorms(ys, nys, L, d, threadIdx.x, blockDim.x);
  }
  __syncthreads();
  BlockGroup<T> g(W, buf);
  const long long stride = static_cast<long long>(N1) * N2;
  pair_levels<T, 4>(xs, nxs, ys, nys, L, d, nl, rbf != 0,
                    out + static_cast<long long>(n1) * N2 + n2, stride, g);
  if (sym && n2 != n1 && g.thread() == 0) {
    // thread 0 wrote the pair's levels: mirror them
    for (int m = 0; m <= nl; ++m)
      out[m * stride + static_cast<long long>(n2) * N2 + n1] =
          out[m * stride + static_cast<long long>(n1) * N2 + n2];
  }
}

template <typename T>
cudaError_t launch_gram_block(const void* X, const void* Y, void* out,
                              int C, int N1, int N2, int L, int d, int nl,
                              int rbf, int W, int sym, cudaStream_t stream) {
  // staged where it fits (plan.py's gram_fwd_smem decides alike)
  size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * 2 + exchange_bytes<T>(W);
  const int stage = smem <= kSegSmemBytes;
  if (!stage) smem = sizeof(T) * 2 * static_cast<size_t>(L) +
                     exchange_bytes<T>(W);
  cudaError_t e = allow_smem(gram_block_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(N1) * N2;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), C);
  gram_block_kernel<T><<<grid, 32 * W, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(out), N1, N2, L, d, nl, rbf, W, sym, stage);
  return cudaGetLastError();
}

template <typename T, int R, int S, int NLM>
cudaError_t launch_gram_seg(const void* X, const void* Y, void* out, int C,
                            int N1, int N2, int L, int d, int nl, int rbf,
                            int sym, cudaStream_t stream) {
  using B = SegBlock<T, R, S>;
  const bool stage_y = B::stages_y(L, d);
  const size_t smem = sizeof(T) * B::smem_elems(L, d, stage_y);
  cudaError_t e = allow_smem(gram_seg_kernel<T, R, S, NLM>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = B::blocks(N1, N2);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), C);
  gram_seg_kernel<T, R, S, NLM><<<grid, 32 * kPairsPerBlock, smem,
                                  stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(out), N1, N2, L, d, nl, rbf, sym, stage_y);
  return cudaGetLastError();
}

// The segment plan's level bound and rows a lane (plan.py's gram_fwd_plan
// with tuned=True: NLM carries a row).
template <typename T, int NLM>
cudaError_t gram_seg_dispatch(const void* X, const void* Y, void* out,
                              int C, int N1, int N2, int L, int d, int nl,
                              int rbf, int S, int R, int sym, cudaStream_t s) {
  constexpr int Rt = seg_rows<T>(NLM);
  if (R != Rt) return cudaErrorInvalidValue;
  switch (S) {
    case 8: return launch_gram_seg<T, Rt, 8, NLM>(
        X, Y, out, C, N1, N2, L, d, nl, rbf, sym, s);
    case 16: return launch_gram_seg<T, Rt, 16, NLM>(
        X, Y, out, C, N1, N2, L, d, nl, rbf, sym, s);
    case 32: return launch_gram_seg<T, Rt, 32, NLM>(
        X, Y, out, C, N1, N2, L, d, nl, rbf, sym, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t gram_dispatch(const void* X, const void* Y, void* out, int C,
                          int N1, int N2, int L, int d, int nl, int rbf,
                          int S, int R, int W, int sym, cudaStream_t s) {
  if (W > 1)
    return launch_gram_block<T>(X, Y, out, C, N1, N2, L, d, nl, rbf, W, sym,
                                s);
  return nl <= 4 ? gram_seg_dispatch<T, 4>(X, Y, out, C, N1, N2, L, d, nl,
                                           rbf, S, R, sym, s)
                 : gram_seg_dispatch<T, 7>(X, Y, out, C, N1, N2, L, d, nl,
                                           rbf, S, R, sym, s);
}

}  // namespace

extern "C" {

// X [C, N1, L, d], Y [C, N2, L, d] contiguous -> out [C, nl + 1, N1, N2]
// (C = 1: the unbatched [N1, L, d] -> [nl + 1, N1, N2]), the L - 1 rows
// spread as the plan says: segments of S lanes at R rows a lane (W = 1), or
// W > 1 warps a pair at R = 4; with sym (Y = X) only the pairs on and above
// the diagonal are solved, each written twice. Returns cudaGetLastError()
// after the launch (0 on success).
int gpsig_fused_gram(const void* X, const void* Y, void* out, int C, int N1,
                     int N2, int L, int d, int nl, int rbf, int S, int R,
                     int W, int sym, int f64, void* stream) {
  const bool seg_ok = W == 1 && (S == 8 || S == 16 || S == 32) &&
                      L - 1 <= S * R;
  if (L < 2 || d < 1 || nl < 1 || nl > kMaxLevels ||
      (W > 1 ? (S != 32 || !plan_ok(L - 1, W, R)) : !seg_ok) ||
      (sym && N1 != N2) || C < 1 || C > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? gram_dispatch<double>(X, Y, out, C, N1, N2, L, d, nl, rbf, S,
                                     R, W, sym, s)
             : gram_dispatch<float>(X, Y, out, C, N1, N2, L, d, nl, rbf, S,
                                    R, W, sym, s);
}

const char* gpsig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
