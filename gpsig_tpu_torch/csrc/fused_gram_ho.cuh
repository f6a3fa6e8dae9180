// Fused signature Gram of the general engine, for Hopper (sm_90a): any
// order, difference True or False, linear / RBF / poly<K> / cosine base.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/fused_gram_ho.py:_ho_kernel
// (entry point fused_gram_ho_levels): out[m, a, b] = k_m(x_a, y_b), the
// level-m truncated signature kernel at order p = min(order, num_levels),
// num_levels <= 7, on pre-scaled sequences (a Poly offset already folded
// in as a constant channel by the kernel layer). The plain version is
// _xla_reference_ho (fused_gram_ho.py), the recursion ops/signature.py's
// _higher_order; the RBF exponent is not clamped, as there.
//
// Design (redesigned for Hopper). The segment plan of fused_gram.cu: up to
// 256 rows a segment of S = 8, 16 or 32 lanes of one warp takes a pair,
// 32 / S pairs a warp, four warps to a block sharing one x sequence
// (a WarpGroup<T, S>; common.cuh's SegBlock, SegColumns; the plan (S, R)
// from the wrapper, ops/cuda/plan.py's gram_fwd_plan). Lane t holds the
// rows of the (virtual) increment matrix M[i, j] from t*R and the segment
// sweeps the columns j, building each column of M in registers: with
// difference=True the double difference of the base values at the lane's
// R + 1 points against the previous column's (L - 1 rows and columns),
// with difference=False the raw values (L rows and columns); rows past the
// matrix are exactly 0 (RBF and cosine are not 0 at zero input). The
// run-length DP over the columns is common.cuh's rl_forward, its state
// bounded by a level bound NLM (4 for order 2 at num_levels <= 4, else 7)
// and R the most of 8, 4, 2 rows a lane whose state fits 128 registers
// (seg_rows): R = 8 at order 1 and at order 2 up to 4 levels (float32),
// so 149 rows take one warp with no barrier. Where the state takes only
// R = 2, a warp of 32 lanes at R = 4 takes a pair up to 128 rows (the
// one-warp design the kernel had before segments). A scan is log2(S) + 1
// shuffles. A symmetric Gram (Y = X) solves only the pairs on and above
// the diagonal and writes each twice. At wide d, where the block's y would
// outgrow the shared memory, the segments read y from global memory
// (SegBlock). Past what one warp takes, one block of W <= 8 warps takes a
// pair at R = 4 (the BlockGroup design, GramColumns and
// run_length_levels, as sig_gram.cu), the scans crossing the warps
// through shared memory; it stages x and y where they fit, else reads them
// from global memory (every d). Instantiations per dtype: each
// (P, NLM) at its R and S in {8, 16, 32} (P <= 3; S = 32 above), at R = 4
// and S = 32 where its R is 2, and the block design for each P. Each
// dtype's are compiled by one source: float32 by fused_gram_ho.cu (which
// holds the entry point), float64 by fused_gram_ho_f64.cu.
//
// What bounds it on the H100. Per pair it reads 2 L d values and writes
// nl + 1, so memory is not the limit: instruction throughput is. Per pair
// it evaluates about L^2 (1 + 1/R) base kernels (2d + 2 flops and one exp,
// or a cos and a sqrt, each; the exp pipe runs 16 a clock an SM) and, per
// increment entry and level m, about R_m^2 + 3 R_m multiply-adds for the
// states and their sums, plus R_m segment scans per column and level
// (R_m = min(p, m)), a chain across the levels of a column. At order 2
// that is about 3x the order-1 kernel's DP work; the design keeps every
// state in registers and spends log2(S) + 1 shuffles, not shared memory
// or barriers, on each prefix.

#pragma once

#include "common.cuh"

namespace gpsig {
namespace ho_fwd {

// Columns of M for one pair, built from staged sequences.
template <typename T, int R>
struct GramColumns {
  const T* xs;
  const T* ys;
  const T* nys;
  int L, d, kind, degree, rows, t;
  bool diff;
  int xi[R + 1];
  T nx[R + 1];
  T kprev[R + 1];

  __device__ GramColumns(const T* xs_, const T* nxs, const T* ys_,
                         const T* nys_, int L_, int d_, int kind_,
                         int degree_, bool diff_, int t_)
      : xs(xs_), ys(ys_), nys(nys_), L(L_), d(d_), kind(kind_),
        degree(degree_), rows(diff_ ? L_ - 1 : L_), t(t_), diff(diff_) {
    const bool norms = kind_norms(kind);
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      xi[r] = min(t * R + r, L - 1);
      nx[r] = norms ? nxs[xi[r]] : T(0);
    }
    if (diff) {
#pragma unroll
      for (int r = 0; r <= R; ++r) kprev[r] = k(r, 0);
    }
  }

  __device__ T k(int r, int j) const {
    return kind_k(xs + xi[r] * d, nx[r], ys + j * d,
                  kind_norms(kind) ? nys[j] : T(0), d, kind, degree);
  }

  __device__ void operator()(int j, T (&mcol)[R]) {
    if (diff) {
      T knew[R + 1];
#pragma unroll
      for (int r = 0; r <= R; ++r) knew[r] = k(r, j + 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T v = (knew[r + 1] - kprev[r + 1]) - (knew[r] - kprev[r]);
        mcol[r] = (t * R + r < rows) ? v : T(0);
      }
#pragma unroll
      for (int r = 0; r <= R; ++r) kprev[r] = knew[r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        mcol[r] = (t * R + r < rows) ? k(r, j) : T(0);
    }
  }
};

// The segment plan: block b handles x = X[b / nyb] against the y
// sequences (b % nyb) * kPairs + p, p the thread's segment.
// out: [nl + 1, N1, N2].
template <typename T, int R, int P, int S, int NLM>
__global__ void __launch_bounds__(32 * kPairsPerBlock)
gram_ho_seg_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                   T* __restrict__ out, int N1, int N2, int L, int d, int nl,
                   int kind, int degree, int diff, int sym, int stage_y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SegBlock<T, R, S> b;
  if (!b.stage(X, Y, N1, N2, L, d, kind_norms(kind), sym != 0, stage_y != 0,
               reinterpret_cast<T*>(smem_raw)))
    return;
  // no barrier follows: a warp none of whose pairs is written stops here
  if (!__any_sync(kFull, b.live)) return;
  WarpGroup<T, S> g;
  SegColumns<T, R, S> col(b, L, d, kind, degree, diff != 0, g.thread());
  T lv[NLM];
  run_length_sums<T, R, P>(col, diff ? L - 1 : L, nl, lv, g);
  if (b.live && g.thread() == 0) {
    b.write(out, 0, T(1), N1, N2, sym != 0);
#pragma unroll
    for (int m = 0; m < NLM; ++m)
      if (m < nl) b.write(out, m + 1, lv[m], N1, N2, sym != 0);
  }
}

// The block design: block b handles x = X[b / N2] against y = Y[b % N2]
// with a BlockGroup of W warps; with sym only the pairs on and above the
// diagonal, thread 0 mirroring its values. x and y are staged where they
// fit (stage), else read from global memory. out: [nl + 1, N1, N2].
template <typename T, int P>
__global__ void __launch_bounds__(BlockGroup<T>::kMaxThreads)
gram_ho_block_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                     T* __restrict__ out, int N1, int N2, int L, int d,
                     int nl, int kind, int degree, int diff, int W,
                     int sym, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
  if (kind_norms(kind)) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    half_sqnorms(ys, nys, L, d, threadIdx.x, blockDim.x);
  }
  __syncthreads();
  BlockGroup<T> g(W, buf);
  GramColumns<T, 4> col(xs, nxs, ys, nys, L, d, kind, degree, diff != 0,
                        g.thread());
  const long long stride = static_cast<long long>(N1) * N2;
  run_length_levels<T, 4, P>(col, diff ? L - 1 : L, nl,
                             out + static_cast<long long>(n1) * N2 + n2,
                             stride, g);
  if (sym && n2 != n1 && g.thread() == 0) {
    // thread 0 wrote the pair's levels: mirror them
    for (int m = 0; m <= nl; ++m)
      out[m * stride + static_cast<long long>(n2) * N2 + n1] =
          out[m * stride + static_cast<long long>(n1) * N2 + n2];
  }
}

template <typename T, int P>
cudaError_t launch_block(const void* X, const void* Y, void* out, int N1,
                         int N2, int L, int d, int nl, int kind, int degree,
                         int diff, int W, int sym, cudaStream_t stream) {
  // staged where it fits (plan.py's gram_fwd_smem decides alike)
  size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * 2 + exchange_bytes<T>(W);
  const int stage = smem <= kSegSmemBytes;
  if (!stage) smem = sizeof(T) * 2 * static_cast<size_t>(L) +
                     exchange_bytes<T>(W);
  cudaError_t e = allow_smem(gram_ho_block_kernel<T, P>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(N1) * N2;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gram_ho_block_kernel<T, P><<<static_cast<unsigned>(blocks), 32 * W, smem,
                               stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(out), N1, N2, L, d, nl, kind, degree, diff, W, sym,
      stage);
  return cudaGetLastError();
}

template <typename T, int R, int P, int S, int NLM>
cudaError_t launch_seg(const void* X, const void* Y, void* out, int N1,
                       int N2, int L, int d, int nl, int kind, int degree,
                       int diff, int sym, cudaStream_t stream) {
  using B = SegBlock<T, R, S>;
  const bool stage_y = B::stages_y(L, d);
  const size_t smem = sizeof(T) * B::smem_elems(L, d, stage_y);
  cudaError_t e = allow_smem(gram_ho_seg_kernel<T, R, P, S, NLM>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = B::blocks(N1, N2);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gram_ho_seg_kernel<T, R, P, S, NLM><<<static_cast<unsigned>(blocks),
                                        32 * kPairsPerBlock, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(out), N1, N2, L, d, nl, kind, degree, diff, sym,
      stage_y);
  return cudaGetLastError();
}

// The segment plan at order P and level bound NLM: R from the state's
// size (plan.py's gram_fwd_plan), S in {8, 16, 32} up to order 3, S = 32
// above; where the state takes only R = 2, also S = 32 at R = 4.
template <typename T, int P, int NLM>
cudaError_t by_segment(int S, int R, const void* X, const void* Y,
                       void* out, int N1, int N2, int L, int d, int nl,
                       int kind, int degree, int diff, int sym,
                       cudaStream_t s) {
  constexpr int Rt = seg_rows<T>(P * P + NLM + (NLM - 1) * (P - 1));
  if constexpr (Rt == 2) {
    if (S == 32 && R == 4)
      return launch_seg<T, 4, P, 32, NLM>(X, Y, out, N1, N2, L, d, nl, kind,
                                          degree, diff, sym, s);
  }
  if (R != Rt) return cudaErrorInvalidValue;
  if constexpr (P <= 3) {
    if (S == 8)
      return launch_seg<T, Rt, P, 8, NLM>(X, Y, out, N1, N2, L, d, nl, kind,
                                          degree, diff, sym, s);
    if (S == 16)
      return launch_seg<T, Rt, P, 16, NLM>(X, Y, out, N1, N2, L, d, nl,
                                           kind, degree, diff, sym, s);
  }
  if (S == 32)
    return launch_seg<T, Rt, P, 32, NLM>(X, Y, out, N1, N2, L, d, nl, kind,
                                         degree, diff, sym, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_order(int P, int S, int R, int W, const void* X,
                     const void* Y, void* out, int N1, int N2, int L, int d,
                     int nl, int kind, int degree, int diff, int sym,
                     cudaStream_t s) {
  if (W == 1 && P == 2 && nl <= 4)
    return by_segment<T, 2, 4>(S, R, X, Y, out, N1, N2, L, d, nl, kind,
                               degree, diff, sym, s);
#define GPSIG_P(p)                                                          \
  case p:                                                                   \
    return W > 1 ? launch_block<T, p>(X, Y, out, N1, N2, L, d, nl, kind,    \
                                      degree, diff, W, sym, s)              \
                 : by_segment<T, p, kRlLevels>(S, R, X, Y, out, N1, N2, L,  \
                                               d, nl, kind, degree, diff,   \
                                               sym, s);
  switch (P) {
    GPSIG_P(1) GPSIG_P(2) GPSIG_P(3) GPSIG_P(4) GPSIG_P(5) GPSIG_P(6)
    GPSIG_P(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_P
}

// Each dtype's instantiation is compiled by one source (the note above).
extern template cudaError_t by_order<float>(
    int, int, int, int, const void*, const void*, void*, int, int, int, int,
    int, int, int, int, int, cudaStream_t);
extern template cudaError_t by_order<double>(
    int, int, int, int, const void*, const void*, void*, int, int, int, int,
    int, int, int, int, int, cudaStream_t);

}  // namespace ho_fwd
}  // namespace gpsig
