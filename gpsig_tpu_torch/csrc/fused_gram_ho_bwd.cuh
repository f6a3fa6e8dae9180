// Shared by the sources of the general Gram backward, compiled apart so
// that their instantiations build in parallel: fused_gram_ho_bwd.cu (the
// two entry points, one warp a pair up to 7 levels, float32) and
// fused_gram_ho_bwd_{nl4,f64,block,block_nl4,block_f64}.cu (one warp or a
// block of warps a pair; float32 up to 4 or up to 7 levels, float64 up to
// 7 at every level count).
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
// What bounds it on the H100. Instruction throughput and latency, not
// memory (it reads 2 L d values and g's nl + 1 per pair): about 2 L² base
// kernels and their derivatives per pair, the forward DP twice (sweep and
// rebuild) and its adjoint, about 3x the forward's DP work, with about
// twice its warp scans.
//
// Design (Hopper redesign, fused_gram_bwd.cu's recipe for the general
// engines). One group of threads per (x, y) pair: one warp, four pairs to
// a block sharing x, up to 128 rows (R = 2 or 4 rows a lane); above, a
// block of W <= 8 warps (the wrapper's plan). The group runs the forward
// sweep to the end carries, then the reverse sweep, rebuilding the states
// by subtraction (the JAX kernel's own scheme). The first design spent its
// issue slots off the DP: per column an out-of-line call per base value
// (2R + 3 of them, each saving and restoring registers), d + 1 warp sums
// and d global atomics for Ȳ, and shared-memory adds for X̄. Now:
// - Base values once per tile. The group fills a shared tile of k (and in
//   the reverse sweep dk/dacc) for its points against CH + 1 columns, in
//   one inlined loop over the tile's (point, column) pairs with the kind's
//   switch outside it; the DP reads its columns of M from the tile.
// - The chain leaves the column loop. The reverse sweep writes u = K̄ ·
//   dk/dacc at the thread's own points into a shared tile of CH columns;
//   when the tile is full, threads over points add sum_j u y_j and sum_j u
//   into X̄ sums in shared memory, and threads over the tile's columns add
//   Ȳ of those columns to global memory, one atomic per (pair, column,
//   channel) and point range.
// - Every d (plan.py's gram_ho_bwd_launch): where x, the pairs' y and their
//   X̄ sums do not fit shared memory, x and y are read from global memory
//   and the X̄ sums go to a device workspace, a slot a block, the grid
//   striding over the items, as in fused_gram_bwd.cu.
// - Registers bound the occupancy, so the DP state is templated on a level
//   bound NLM (4 or 7; the state arrays hold NLM levels, not 7) as well as
//   the order, and the float32 one-warp instances at NLM = 4, p <= 2 are
//   capped at 128 registers (four 128-thread blocks an SM). Two pairs a
//   warp at four rows a lane (16-lane scans serving both, as
//   fused_gram_bwd.cu does) measured slower at the order-2 bench shape
//   (PERF.md).
// Rows past the matrix are exactly zero in M (RBF and cosine are not zero
// at zero input) and their M̄ is dropped. With difference a thread holds
// R + 1 points and the one it shares with the next thread is owned by its
// own last slot. X and Y may be one tensor: X̄ and Ȳ are separate buffers
// and autograd adds them.

#pragma once

#include "common.cuh"

namespace gpsig {

// k(x_p, y_j) and dk/dacc for the points p < npts against columns j0 ..
// j0 + ncol - 1, into kt and dkt [c * ld + p] (dkt null: k only), by the
// group's threads t of GT: one loop for the kind, inlined (the kind a
// compile-time constant, common.cuh's activate and activate_grad fold to
// its branch).
template <typename T, int Kind>
__device__ __forceinline__ void tile_kind(const T* xs, const T* nxs,
                                          const T* ys, const T* nys,
                                          int npts, int d, int degree,
                                          int j0, int ncol, T* kt, T* dkt,
                                          int ld, int t, int GT) {
  for (int e = t; e < npts * ncol; e += GT) {
    const int c = e / npts, p = e - c * npts, j = j0 + c;
    T acc = (Kind == kRbf || Kind == kCosine) ? nxs[p] + nys[j] : T(0);
    for (int q = 0; q < d; ++q) acc += xs[p * d + q] * ys[j * d + q];
    kt[c * ld + p] = activate(acc, Kind, degree);
    if (dkt) dkt[c * ld + p] = activate_grad(acc, Kind, degree);
  }
}

template <typename T>
__device__ void tile_values(int kind, const T* xs, const T* nxs, const T* ys,
                            const T* nys, int npts, int d, int degree, int j0,
                            int ncol, T* kt, T* dkt, int ld, int t, int GT) {
  switch (kind) {
    case kRbf:
      tile_kind<T, kRbf>(xs, nxs, ys, nys, npts, d, degree, j0, ncol, kt,
                         dkt, ld, t, GT);
      break;
    case kCosine:
      tile_kind<T, kCosine>(xs, nxs, ys, nys, npts, d, degree, j0, ncol, kt,
                            dkt, ld, t, GT);
      break;
    case kPoly:
      tile_kind<T, kPoly>(xs, nxs, ys, nys, npts, d, degree, j0, ncol, kt,
                          dkt, ld, t, GT);
      break;
    default:
      tile_kind<T, kLinear>(xs, nxs, ys, nys, npts, d, degree, j0, ncol, kt,
                            dkt, ld, t, GT);
  }
}

// Contract the u tile's n columns (slot s holds column c0 - s) into X̄ sums
// (xacc [L][d + 1], the pair's, in shared memory) and Ȳ (ybar [L][d],
// global) by the group.
template <typename T, typename G>
__device__ __forceinline__ void contract_u(const T* xs, const T* ys,
                                           const T* u, int lu, int n, int c0,
                                           int ch, int L, int d, bool norms,
                                           T* xacc, T* ybar, const G& g) {
  g.sync();
  const int t = g.thread(), GT = g.size();
  for (int p = t; p < L; p += GT) {
    T su = T(0);
    for (int s = 0; s < n; ++s) su += u[s * lu + p];
    xacc[p * (d + 1) + d] += su;
    for (int c = 0; c < d; ++c) {
      T a = T(0);
      for (int s = 0; s < n; ++s) a += u[s * lu + p] * ys[(c0 - s) * d + c];
      xacc[p * (d + 1) + c] += a;
    }
  }
  const int s = t % ch, part = t / ch, parts = GT / ch;
  if (s < n) {
    const int col = c0 - s;
    const T* us = u + s * lu;
    T su = T(0);
    for (int p = part; p < L; p += parts) su += us[p];
    for (int c = 0; c < d; ++c) {
      T a = T(0);
      for (int p = part; p < L; p += parts) a += us[p] * xs[p * d + c];
      atomicAdd(ybar + col * d + c, norms ? a - ys[col * d + c] * su : a);
    }
  }
  g.sync();
}

// One group's pair: columns of M from the k tile in both sweeps, and the
// chain of M̄ through the u tile to X̄ (xacc) and Ȳ (ybar).
template <typename T, int R>
struct HoBwdColumns {
  const T* xs;
  const T* nxs;
  const T* ys;
  const T* nys;
  T* kt;    // [CH + 1][L]: k of the tile's columns
  T* dkt;   // [CH + 1][L]: dk/dacc (reverse sweep)
  T* u;     // [CH][lu]
  T* xacc;  // [L][d + 1]
  T* ybar;  // [L][d] of this pair's y
  int L, d, kind, degree, rows, t, ch, lu;
  bool diff, norms;
  int lo, hi;       // the k tile's columns
  int filled, c0;   // the u tile: slots 0 .. filled-1 hold c0, c0-1, ...
  int pt[R + 1];    // the thread's points (clamped to L - 1)
  bool own[R + 1];
  T dprev[R + 1];   // D̄(j + 1)

  __device__ void init() {
    lo = 0;
    hi = -1;  // an empty tile
    filled = 0;
    c0 = L - 1;
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      const int p = t * R + r;
      pt[r] = min(p, L - 1);
      own[r] = diff ? (p <= L - 1 && (r > 0 || t == 0)) : (r < R && p < L);
      dprev[r] = T(0);
    }
  }

  template <typename G>
  __device__ void load(int j0, int n, bool grad, G& g) {
    g.sync();
    tile_values<T>(kind, xs, nxs, ys, nys, L, d, degree, j0, n, kt,
                   grad ? dkt : nullptr, L, g.thread(), g.size());
    g.sync();
    lo = j0;
    hi = j0 + n - 1;
  }

  // column j of M from the tile (which holds j, and j + 1 with difference)
  __device__ void column(int j, T (&mcol)[R]) const {
    const T* k0 = kt + (j - lo) * L;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T v;
      if (diff) {
        const T* k1 = k0 + L;
        v = (k1[pt[r + 1]] - k0[pt[r + 1]]) - (k1[pt[r]] - k0[pt[r]]);
      } else {
        v = k0[pt[r]];
      }
      mcol[r] = t * R + r < rows ? v : T(0);
    }
  }

  // forward sweep, ascending j
  template <typename G>
  __device__ void fwd(int j, T (&mcol)[R], G& g) {
    const int top = diff ? j + 1 : j;
    if (top > hi) load(j, min(ch + 1, L - j), false, g);
    column(j, mcol);
  }

  // reverse sweep, descending j; the first call reloads with dk/dacc
  template <typename G>
  __device__ void rev(int j, T (&mcol)[R], G& g) {
    const int top = diff ? j + 1 : j;
    if (j < lo || top > hi) {
      const int j0 = max(0, top - ch);
      load(j0, top - j0 + 1, true, g);
    }
    column(j, mcol);
  }

  // u of base-kernel column col at the thread's own points, K̄ = kbar
  template <typename G>
  __device__ void store(int col, const T (&kbar)[R + 1], const G& g) {
    const T* dk = dkt + (col - lo) * L;
    T* us = u + filled * lu;
#pragma unroll
    for (int r = 0; r <= R; ++r)
      if (own[r]) us[pt[r]] = kbar[r] * dk[pt[r]];
    if (++filled == ch) flush(g);
  }

  template <typename G>
  __device__ void flush(const G& g) {
    if (filled == 0) return;
    contract_u(xs, ys, u, lu, filled, c0, ch, L, d, norms, xacc, ybar, g);
    c0 -= filled;
    filled = 0;
  }

  template <typename G>
  __device__ void sink(int j, T (&mbar)[R], G& g) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (t * R + r >= rows) mbar[r] = T(0);
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
      store(j + 1, kbar, g);
    } else {
#pragma unroll
      for (int r = 0; r <= R; ++r) kbar[r] = r < R ? mbar[r] : T(0);
      store(j, kbar, g);
    }
  }

  template <typename G>
  __device__ void finish(const G& g) {
    if (diff) {
      T kbar[R + 1];
#pragma unroll
      for (int r = 0; r <= R; ++r) kbar[r] = -dprev[r];  // K̄ at column 0
      store(0, kbar, g);
    }
    flush(g);
  }
};

// Per-pair shared memory (values): y and its half norms, X̄ sums, the k
// and dk tiles of CH + 1 columns and the u tile of CH columns at an odd
// row stride (plan.py's gram_ho_bwd_smem).
__host__ __device__ inline int ho_bwd_per_pair(int L, int d, int ch) {
  return L * (d + 1) + L * (d + 1) + 2 * (ch + 1) * L + ch * (L | 1);
}

// Occupancy: the one-warp instances at up to 4 levels and order 2 are
// capped at 128 registers (four 128-thread blocks an SM).
template <typename G, int NLM, int P>
constexpr int ho_bwd_min_blocks() {
  return !G::kBlock && NLM <= 4 && P <= 2 ? 4 : 1;
}

// Item i: x = X[i / nyb] against the y sequences (i % nyb) * pairs + p
// (one warp each, or the whole block when W > 1); block b takes items b,
// b + gridDim.x, ... Xbar, Ybar: [N1, L, d], [N2, L, d], zeroed by the
// caller. Staged: x, the pairs' y and X̄ sums in shared memory; else x and
// y read from global memory (their half norms staged) and the X̄ sums in
// the block's slot of work [gridDim.x][pairs][L][d + 1] (plan.py's
// gram_ho_bwd_launch).
template <typename T, int R, int P, int NLM, typename G>
__global__ void __launch_bounds__(G::kMaxThreads,
                                  (ho_bwd_min_blocks<G, NLM, P>()))
gram_ho_bwd_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                   const T* __restrict__ g, T* __restrict__ Xbar,
                   T* __restrict__ Ybar, T* __restrict__ work, int N1,
                   int N2, int L, int d, int nl, int kind, int degree,
                   int diff, int W, int ch, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const int p = G::kBlock ? 0 : static_cast<int>(threadIdx.x) >> 5;
  const int nyb = (N2 + pairs - 1) / pairs;
  const int Ld = L * d;
  const int La = L * (d + 1);
  const int gthreads = 32 * W;
  const int gt = static_cast<int>(threadIdx.x) - p * 32;
  const bool norms = kind_norms(kind);
  // staged: xs [L][d], nxs [L], then per pair ys [L][d], nys [L], xacc
  // [L][d + 1], the tiles; else nxs [L], then per pair nys [L], the tiles
  const int seq = staged ? Ld : 0;
  const int per_pair = ho_bwd_per_pair(L, d, ch) -
                       (staged ? 0 : Ld + La);
  T* nxs = smem + seq;                   // [L]
  T* nys = nxs + L + p * per_pair + seq; // [L]
  T* kt = nys + L + (staged ? La : 0);   // [CH + 1][L]
  T* dkt = kt + (ch + 1) * L;            // [CH + 1][L]
  T* u = dkt + (ch + 1) * L;             // [CH][L | 1]
  T* buf = nxs + L + pairs * per_pair;
  // the pairs' X̄ sums: pair k's at acc0 + k * acc_stride
  T* acc0 = staged ? nxs + L + Ld + L
                   : work + static_cast<long long>(blockIdx.x) * pairs * La;
  const int acc_stride = staged ? per_pair : La;
  T* xacc = acc0 + p * acc_stride;       // [L][d + 1]
  const long long items = static_cast<long long>(N1) * nyb;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int n1 = static_cast<int>(item / nyb);
    const int n2 = static_cast<int>(item % nyb) * pairs + p;
    const bool active = n2 < N2;
    const T* xg = X + static_cast<long long>(n1) * Ld;
    const T* yg = Y + static_cast<long long>(active ? n2 : N2 - 1) * Ld;
    const T* xs = xg;
    const T* ys = yg;
    if (staged) {
      T* x_s = smem;
      T* y_s = nys - Ld;
      for (int k = threadIdx.x; k < Ld; k += blockDim.x) x_s[k] = xg[k];
      if (active)
        for (int k = gt; k < Ld; k += gthreads) y_s[k] = yg[k];
      xs = x_s;
      ys = y_s;
    }
    for (int k = gt; k < La; k += gthreads) xacc[k] = T(0);
    __syncthreads();
    if (norms) {
      half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
      if (active) half_sqnorms(ys, nys, L, d, gt, gthreads);
    }
    __syncthreads();
    if (active) {  // whole groups; a W-warp block is always active
      const long long plane = static_cast<long long>(N1) * N2;
      const long long pair = static_cast<long long>(n1) * N2 + n2;
      T w[NLM];
#pragma unroll
      for (int m = 0; m < NLM; ++m)
        w[m] = m < nl ? g[(m + 1) * plane + pair] : T(0);
      G grp(W, buf);
      HoBwdColumns<T, R> col{xs, nxs, ys, nys, kt, dkt, u, xacc,
                             Ybar + static_cast<long long>(n2) * Ld};
      col.L = L;
      col.d = d;
      col.kind = kind;
      col.degree = degree;
      col.diff = diff != 0;
      col.norms = norms;
      col.rows = diff ? L - 1 : L;
      col.t = grp.thread();
      col.ch = ch;
      col.lu = L | 1;
      col.init();
      const int ncols = diff ? L - 1 : L;
      auto fwd = [&](int j, T (&mcol)[R]) { col.fwd(j, mcol, grp); };
      bool first = true;
      auto rev = [&](int j, T (&mcol)[R]) {
        if (first) {  // the forward's tile holds k only
          col.hi = -1;
          first = false;
        }
        col.rev(j, mcol, grp);
      };
      auto sink = [&](int j, T (&mbar)[R], G& gg) { col.sink(j, mbar, gg); };
      run_length_levels_bwd<T, R, P>(fwd, rev, sink, ncols, nl, w, grp);
      col.finish(grp);
    }
    __syncthreads();
    // X̄ of this item's x: add the pairs' sums (zero for a pair past N2),
    // then across y blocks
    T* xb = Xbar + static_cast<long long>(n1) * Ld;
    for (int q = threadIdx.x; q < Ld; q += blockDim.x) {
      const int pt = q / d, c = q - pt * d;
      T s = T(0), su = T(0);
      for (int k = 0; k < pairs; ++k) {
        s += acc0[k * acc_stride + pt * (d + 1) + c];
        su += acc0[k * acc_stride + pt * (d + 1) + d];
      }
      atomicAdd(xb + q, norms ? s - xs[q] * su : s);
    }
    __syncthreads();  // the next item overwrites the staged values
  }
}

// The launch arguments of one call.
struct HoBwdArgs {
  const void* X;
  const void* Y;
  const void* g;
  void* Xbar;
  void* Ybar;
  void* work;
  int N1, N2, L, d, nl, kind, degree, diff, ch, staged, blocks;
};

template <typename T, int R, int P, int NLM, typename G>
cudaError_t launch_ho_bwd(const HoBwdArgs& a, int W, cudaStream_t stream) {
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const size_t Ld = static_cast<size_t>(a.L) * a.d;
  const size_t seq = a.staged ? Ld : 0;
  const size_t smem =
      sizeof(T) * (seq + a.L +
                   static_cast<size_t>(pairs) *
                       (ho_bwd_per_pair(a.L, a.d, a.ch) -
                        (a.staged ? 0 : Ld + Ld + a.L))) +
      exchange_bytes<T>(W);
  if (smem > kSegSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(gram_ho_bwd_kernel<T, R, P, NLM, G>, smem);
  if (e != cudaSuccess) return e;
  gram_ho_bwd_kernel<T, R, P, NLM, G><<<a.blocks,
                                        G::kBlock ? 32 * W
                                                  : 32 * kPairsPerBlock,
                                        smem, stream>>>(
      static_cast<const T*>(a.X), static_cast<const T*>(a.Y),
      static_cast<const T*>(a.g), static_cast<T*>(a.Xbar),
      static_cast<T*>(a.Ybar), static_cast<T*>(a.work), a.N1, a.N2, a.L,
      a.d, a.nl, a.kind, a.degree, a.diff, W, a.ch, a.staged);
  return cudaGetLastError();
}

template <typename T, int R, int NLM, typename G>
cudaError_t ho_bwd_by_order(int P, const HoBwdArgs& a, int W,
                            cudaStream_t s) {
#define GPSIG_P(p)                                              \
  case p:                                                       \
    if constexpr (p <= NLM)                                     \
      return launch_ho_bwd<T, R, p, NLM, G>(a, W, s);           \
    return cudaErrorInvalidValue;
  switch (P) {
    GPSIG_P(1) GPSIG_P(2) GPSIG_P(3) GPSIG_P(4) GPSIG_P(5) GPSIG_P(6)
    GPSIG_P(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_P
}

// One warp a pair at R = 2 or 4 rows a lane, up to NLM levels. Float64
// takes four rows a lane at every length up to 128 rows, and the 7-level
// instances at every level count: its other instances would add a fifth
// of the build's compile work, for a dtype whose kernels are checked, not
// timed.
template <typename T, int NLM>
cudaError_t ho_bwd_warp(int P, const HoBwdArgs& a, int R, cudaStream_t s) {
  if constexpr (sizeof(T) == 8)
    return ho_bwd_by_order<T, 4, NLM, WarpGroup<T>>(P, a, 1, s);
  switch (R) {
    case 2: return ho_bwd_by_order<T, 2, NLM, WarpGroup<T>>(P, a, 1, s);
    case 4: return ho_bwd_by_order<T, 4, NLM, WarpGroup<T>>(P, a, 1, s);
    default: return cudaErrorInvalidValue;
  }
}

// A block of W warps a pair at 4 rows a lane, up to NLM levels.
template <typename T, int NLM>
cudaError_t ho_bwd_block(int P, const HoBwdArgs& a, int W, cudaStream_t s) {
  return ho_bwd_by_order<T, 4, NLM, BlockGroup<T>>(P, a, W, s);
}

// Each instantiation is compiled by one source (the file comment above).
extern template cudaError_t ho_bwd_warp<float, 4>(int, const HoBwdArgs&,
                                                  int, cudaStream_t);
extern template cudaError_t ho_bwd_warp<float, 7>(int, const HoBwdArgs&,
                                                  int, cudaStream_t);
extern template cudaError_t ho_bwd_warp<double, 7>(int, const HoBwdArgs&,
                                                   int, cudaStream_t);
extern template cudaError_t ho_bwd_block<float, 4>(int, const HoBwdArgs&,
                                                   int, cudaStream_t);
extern template cudaError_t ho_bwd_block<float, 7>(int, const HoBwdArgs&,
                                                   int, cudaStream_t);
extern template cudaError_t ho_bwd_block<double, 7>(int, const HoBwdArgs&,
                                                    int, cudaStream_t);

}  // namespace gpsig
