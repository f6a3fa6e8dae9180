// Shared by four sources, compiled apart so that their instantiations
// build in parallel: fused_gram_ho_bwd.cu (one warp a pair, float32, and
// the entry point), fused_gram_ho_bwd_f64.cu (one warp, float64),
// fused_gram_ho_bwd_block.cu (a block of warps a pair, float32, and its
// entry point) and fused_gram_ho_bwd_block_f64.cu (a block, float64).
//
// Backward of the general fused signature Gram, for Hopper (sm_90a): any
// order, difference True or False, linear / RBF / poly<K> / cosine base.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/fused_gram_ho_bwd.py:
// _ho_bwd_kernel (entry point fused_gram_ho_bwd_pallas): given X
// [N1, L, d], Y [N2, L, d] and the cotangents g [nl + 1, N1, N2] of the
// per-level Gram of fused_gram_ho.cu, it returns X̄ and Ȳ, the VJP of the
// plain version fused_gram_ho_levels_ref (_xla_reference_ho in the JAX
// package), num_levels <= 7, RBF exponent unclamped. A Poly offset is a
// constant channel of X and Y, so its gradient is Ȳ's last channel.
//
// Math. M̄ column by column from common.cuh's run_length_levels_bwd (the
// adjoint of the run-length DP; its derivation there), then the chain to
// the base-kernel values K[p, q] = k(x_p, y_q): with difference=True
// K̄[:, q] = D̄(q-1) - D̄(q), D̄(j)[p] = M̄[p-1, j] - M̄[p, j] (as
// fused_gram_bwd.cu); with difference=False K̄ = M̄ on the real rows. Then
// through the activation, u = K̄ · dk/dacc (exp for RBF, sin t / t for
// cosine, K acc^(K-1) for poly<K>, 1 for linear), and the accumulator:
// acc = <x, y> (- |x|²/2 - |y|²/2 for RBF and cosine), so
//     X̄_p = sum_q u y_q (- x_p sum_q u),   Ȳ_q = sum_p u x_p (- y_q sum_p u).
//
// Design. The order-1 Gram backward's first layout with fused_gram_ho.cu's
// state grid: one group of threads per (x, y) pair (one warp, four pairs to a
// block sharing x, up to 128 rows; above, a block of W <= 8 warps, the
// wrapper's plan), group threads holding R = 2 or 4 consecutive rows; the
// group runs the forward sweep to the end carries, then the reverse sweep,
// rebuilding the states by subtraction (the JAX kernel's own scheme).
// Columns of M are rebuilt from the staged sequences in both sweeps; in
// the reverse sweep the thread keeps k and dk/dacc at its points for the
// column the chain needs. Rows past the matrix are exactly zero in M (RBF
// and cosine are not zero at zero input) and their M̄ is dropped. With
// difference a thread holds R + 1 points and the one it shares with the
// next thread is owned by its own last slot (the next thread's first row
// of M̄ crosses a warp boundary through shared memory). Ȳ of a column is a
// warp sum added atomically by each warp (N1 blocks share a y); X̄ sums
// live in shared memory per pair and are added across the block's pairs,
// then atomically across y blocks. X and Y may be one tensor: X̄ and Ȳ are
// separate buffers and autograd adds them.
//
// What bounds it on the H100. Instruction throughput and latency, not
// memory (it reads 2 L d values and g's nl + 1 per pair): about 2 L² base
// kernels and their derivatives per pair, the forward DP twice (sweep and
// rebuild) and its adjoint, about 3x the forward's DP work, with about
// twice its warp scans, and d + 1 warp sums per column for Ȳ.

#pragma once

#include "common.cuh"

namespace {

using namespace gpsig;

// One warp's pair: columns of M in both sweeps, and the chain of M̄ to X̄
// (xacc, this warp's [L][d + 1] shared sums) and Ȳ (ybar, global).
template <typename T, int R>
struct GramBwdColumns {
  const T* xs;
  const T* ys;
  const T* nys;
  T* xacc;
  T* ybar;
  int L, d, kind, degree, rows, t;
  bool diff, norms;
  int xi[R + 1];
  bool own[R + 1];
  T nx[R + 1];
  T kprev[R + 1];            // forward sweep: k at column j
  T khi[R + 1], dkhi[R + 1];  // reverse sweep: k, dk at column j + 1
  T klo[R + 1], dklo[R + 1];  // reverse sweep: k, dk at column j
  T dprev[R + 1];            // D̄(j + 1)

  __device__ GramBwdColumns(const T* xs_, const T* nxs, const T* ys_,
                            const T* nys_, T* xacc_, T* ybar_, int t_,
                            int L_, int d_, int kind_, int degree_,
                            bool diff_)
      : xs(xs_), ys(ys_), nys(nys_), xacc(xacc_), ybar(ybar_), L(L_), d(d_),
        kind(kind_), degree(degree_), rows(diff_ ? L_ - 1 : L_), t(t_),
        diff(diff_), norms(kind_norms(kind_)) {
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      const int p = t * R + r;
      xi[r] = min(p, L - 1);
      own[r] = diff ? (p <= L - 1 && (r > 0 || t == 0)) : (r < R && p < L);
      nx[r] = norms ? nxs[xi[r]] : T(0);
    }
    if (diff) {
#pragma unroll
      for (int r = 0; r <= R; ++r) kprev[r] = kv(r, 0).k;
    }
  }

  // k(x_p, y_j) and dk/dacc at the lane's point r
  __device__ KindValue<T> kv(int r, int j) const {
    T a = norms ? nx[r] + nys[j] : T(0);
    for (int c = 0; c < d; ++c) a += xs[xi[r] * d + c] * ys[j * d + c];
    return kind_value(a, kind, degree);
  }

  // k and dk/dacc at the lane's points against y_j (points 0..R-1 without
  // difference, 0..R with)
  __device__ void eval(int j, T (&k)[R + 1], T (&dk)[R + 1]) const {
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      k[r] = dk[r] = T(0);
      if (r < R || diff) {
        const KindValue<T> v = kv(r, j);
        k[r] = v.k;
        dk[r] = v.dk;
      }
    }
  }

  __device__ void mask(T (&mcol)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (t * R + r >= rows) mcol[r] = T(0);
  }

  // forward sweep, ascending j (as fused_gram_ho.cu's GramColumns)
  __device__ void fwd(int j, T (&mcol)[R]) {
    if (diff) {
      T knew[R + 1];
#pragma unroll
      for (int r = 0; r <= R; ++r) knew[r] = kv(r, j + 1).k;
#pragma unroll
      for (int r = 0; r < R; ++r)
        mcol[r] = (knew[r + 1] - kprev[r + 1]) - (knew[r] - kprev[r]);
#pragma unroll
      for (int r = 0; r <= R; ++r) kprev[r] = knew[r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) mcol[r] = kv(r, j).k;
    }
    mask(mcol);
  }

  __device__ void start_reverse() {
    if (diff) {
      eval(L - 1, khi, dkhi);
#pragma unroll
      for (int r = 0; r <= R; ++r) dprev[r] = T(0);
    }
  }

  // reverse sweep, descending j
  __device__ void rev(int j, T (&mcol)[R]) {
    eval(j, klo, dklo);
    if (diff) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        mcol[r] = (khi[r + 1] - klo[r + 1]) - (khi[r] - klo[r]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) mcol[r] = klo[r];
    }
    mask(mcol);
  }

  // X̄ and Ȳ contributions of base-kernel column j, K̄ = kbar at the
  // lane's points (owned ones count), dk/dacc = dk
  __device__ void chain(int j, const T (&kbar)[R + 1],
                        const T (&dk)[R + 1]) const {
    T u[R + 1];
    T su = T(0);
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      u[r] = own[r] ? kbar[r] * dk[r] : T(0);
      su += u[r];
      if (own[r]) xacc[xi[r] * (d + 1) + d] += u[r];
    }
    const T* yj = ys + j * d;
    const T su_all = norms ? warp_sum(su) : T(0);
    for (int c = 0; c < d; ++c) {
      const T yc = yj[c];
      T s = T(0);
#pragma unroll
      for (int r = 0; r <= R; ++r) {
        if (own[r]) xacc[xi[r] * (d + 1) + c] += u[r] * yc;
        s += u[r] * xs[xi[r] * d + c];
      }
      s = warp_sum(s);
      if ((threadIdx.x & 31) == 0)
        atomicAdd(ybar + j * d + c, norms ? s - yc * su_all : s);
    }
  }

  template <typename G>
  __device__ void sink(int j, T (&mbar)[R], G& g) {
    mask(mbar);
    T kbar[R + 1];
    if (diff) {
      // D̄(j)[p] = M̄[p-1] - M̄[p] at the thread's points (point t*R + R
      // reads the next thread's first row; point 0 has no row above it)
      const T mnext = g.next(mbar[0]);
#pragma unroll
      for (int r = 0; r <= R; ++r) {
        const T dcol =
            (r > 0 ? mbar[r - 1] : T(0)) - (r < R ? mbar[r] : mnext);
        kbar[r] = dcol - dprev[r];  // K̄ at column j + 1
        dprev[r] = dcol;
      }
      chain(j + 1, kbar, dkhi);
#pragma unroll
      for (int r = 0; r <= R; ++r) {
        khi[r] = klo[r];
        dkhi[r] = dklo[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r <= R; ++r) kbar[r] = r < R ? mbar[r] : T(0);
      chain(j, kbar, dklo);
    }
  }

  __device__ void finish() const {
    if (!diff) return;
    T kbar[R + 1];
#pragma unroll
    for (int r = 0; r <= R; ++r) kbar[r] = -dprev[r];  // K̄ at column 0
    chain(0, kbar, dkhi);
  }
};

// Block b: x = X[b / nyb] against the y sequences (b % nyb) * pairs + p
// (one warp each, or the whole block when W > 1).
// Xbar, Ybar: [N1, L, d], [N2, L, d], zeroed by the caller.
template <typename T, int R, int P, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
gram_ho_bwd_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                   const T* __restrict__ g, T* __restrict__ Xbar,
                   T* __restrict__ Ybar, int N1, int N2, int L, int d,
                   int nl, int kind, int degree, int diff, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const int p = G::kBlock ? 0 : static_cast<int>(threadIdx.x) >> 5;
  const int nyb = (N2 + pairs - 1) / pairs;
  const int n1 = blockIdx.x / nyb;
  const int n2 = (blockIdx.x % nyb) * pairs + p;
  const int Ld = L * d;
  const int La = L * (d + 1);
  const int gthreads = 32 * W;
  const int gt = static_cast<int>(threadIdx.x) - p * 32;
  const bool norms = kind_norms(kind);
  const int per_pair = Ld + L + La;
  T* xs = smem;                          // [L][d]
  T* nxs = xs + Ld;                      // [L]
  T* ys = nxs + L + p * per_pair;        // [L][d], this pair's y
  T* nys = ys + Ld;                      // [L]
  T* xacc = nys + L;                     // [L][d + 1]
  T* buf = nxs + L + pairs * per_pair;
  const bool active = n2 < N2;

  const T* xg = X + static_cast<long long>(n1) * Ld;
  for (int k = threadIdx.x; k < Ld; k += blockDim.x) xs[k] = xg[k];
  for (int k = gt; k < La; k += gthreads) xacc[k] = T(0);
  if (active) {
    const T* yg = Y + static_cast<long long>(n2) * Ld;
    for (int k = gt; k < Ld; k += gthreads) ys[k] = yg[k];
  }
  __syncthreads();
  if (norms) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    if (active) half_sqnorms(ys, nys, L, d, gt, gthreads);
  }
  __syncthreads();
  if (active) {  // whole groups; a W-warp block is always active
    const long long plane = static_cast<long long>(N1) * N2;
    const long long pair = static_cast<long long>(n1) * N2 + n2;
    T w[kRlLevels];
#pragma unroll
    for (int m = 0; m < kRlLevels; ++m)
      w[m] = m < nl ? g[(m + 1) * plane + pair] : T(0);
    G grp(W, buf);
    GramBwdColumns<T, R> col(xs, nxs, ys, nys, xacc,
                             Ybar + static_cast<long long>(n2) * Ld,
                             grp.thread(), L, d, kind, degree, diff != 0);
    const int ncols = diff ? L - 1 : L;
    auto fwd = [&](int j, T (&mcol)[R]) { col.fwd(j, mcol); };
    auto rev = [&](int j, T (&mcol)[R]) {
      if (j == ncols - 1) col.start_reverse();
      col.rev(j, mcol);
    };
    auto sink = [&](int j, T (&mbar)[R], G& g) { col.sink(j, mbar, g); };
    run_length_levels_bwd<T, R, P>(fwd, rev, sink, ncols, nl, w, grp);
    col.finish();
  }
  __syncthreads();
  // X̄ of this block's x: add the pairs' sums, then across y blocks
  const T* acc0 = nxs + L + Ld + L;  // pair 0's xacc
  T* xb = Xbar + static_cast<long long>(n1) * Ld;
  for (int q = threadIdx.x; q < Ld; q += blockDim.x) {
    const int pt = q / d, c = q - pt * d;
    T s = T(0), su = T(0);
    for (int k = 0; k < pairs; ++k) {
      s += acc0[k * per_pair + pt * (d + 1) + c];
      su += acc0[k * per_pair + pt * (d + 1) + d];
    }
    atomicAdd(xb + q, norms ? s - xs[q] * su : s);
  }
}

template <typename T, int R, int P, typename G>
cudaError_t launch(const void* X, const void* Y, const void* g, void* Xbar,
                   void* Ybar, int N1, int N2, int L, int d, int nl, int kind,
                   int degree, int diff, int W, cudaStream_t stream) {
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * (1 + 2 * pairs) +
      exchange_bytes<T>(W);
  cudaError_t e = allow_smem(gram_ho_bwd_kernel<T, R, P, G>, smem);
  if (e != cudaSuccess) return e;
  const long long nyb = (N2 + pairs - 1) / pairs;
  const long long blocks = static_cast<long long>(N1) * nyb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gram_ho_bwd_kernel<T, R, P, G><<<static_cast<unsigned>(blocks),
                                   G::kBlock ? 32 * W : 32 * kPairsPerBlock,
                                   smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<const T*>(g), static_cast<T*>(Xbar), static_cast<T*>(Ybar),
      N1, N2, L, d, nl, kind, degree, diff, W);
  return cudaGetLastError();
}

template <typename T, int R, typename G>
cudaError_t by_order(int P, const void* X, const void* Y, const void* g,
                     void* Xbar, void* Ybar, int N1, int N2, int L, int d,
                     int nl, int kind, int degree, int diff, int W,
                     cudaStream_t s) {
#define GPSIG_P(p)                                                         \
  case p:                                                                  \
    return launch<T, R, p, G>(X, Y, g, Xbar, Ybar, N1, N2, L, d, nl, kind, \
                              degree, diff, W, s);
  switch (P) {
    GPSIG_P(1) GPSIG_P(2) GPSIG_P(3) GPSIG_P(4) GPSIG_P(5) GPSIG_P(6)
    GPSIG_P(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_P
}

// One warp a pair at R = 2 or 4 rows a lane.
template <typename T>
cudaError_t by_rows(int P, const void* X, const void* Y, const void* g,
                    void* Xbar, void* Ybar, int N1, int N2, int L, int d,
                    int nl, int kind, int degree, int diff, int R,
                    cudaStream_t s) {
  switch (R) {
    case 2: return by_order<T, 2, WarpGroup<T>>(P, X, Y, g, Xbar, Ybar, N1,
                                                N2, L, d, nl, kind, degree,
                                                diff, 1, s);
    case 4: return by_order<T, 4, WarpGroup<T>>(P, X, Y, g, Xbar, Ybar, N1,
                                                N2, L, d, nl, kind, degree,
                                                diff, 1, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace gpsig {

// The float64 launches, defined in fused_gram_ho_bwd_f64.cu (one warp a
// pair, R rows a lane) and fused_gram_ho_bwd_block_f64.cu (W warps a pair).
cudaError_t gram_ho_bwd_warp_f64(int P, const void* X, const void* Y,
                                 const void* g, void* Xbar, void* Ybar,
                                 int N1, int N2, int L, int d, int nl,
                                 int kind, int degree, int diff, int R,
                                 cudaStream_t s);
cudaError_t gram_ho_bwd_block_f64(int P, const void* X, const void* Y,
                                  const void* g, void* Xbar, void* Ybar,
                                  int N1, int N2, int L, int d, int nl,
                                  int kind, int degree, int diff, int W,
                                  cudaStream_t s);

}  // namespace gpsig
