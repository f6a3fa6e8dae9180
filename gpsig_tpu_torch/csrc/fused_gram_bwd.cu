// Backward of the fused order-1 signature Gram, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/fused_gram.py:
// _bwd_fused_kernel (entry point fused_gram_levels_bwd_pallas): given X
// [N1, L, d], Y [N2, L, d] and the cotangents g [nl + 1, N1, N2] of the
// per-level Gram k_m(x, y) (fused_gram.cu), it returns X̄ [N1, L, d] and
// Ȳ [N2, L, d], the VJP of the plain version fused_gram_levels_ref
// (_xla_reference in the JAX package): order 1, difference=True, RBF or
// Linear base on pre-scaled sequences, num_levels <= 7, RBF distance
// unclamped.
//
// Math (fused_gram.py:611-628). The forward sweeps columns j of the
// increment matrix M with A_1 = M[:, j], A_m = M[:, j] * P_{m-1},
// P_m = exclusive row prefix of C_m, C_m = sum_{j' < j} A_m[:, j'], and
// k_m = sum A_m. With w_m = g[m] the adjoint is
//     Ā_m = w_m + R_m,   R_m(j) = sum_{j' > j} SLᵀ (M ⊙ Ā_{m+1})[:, j'],
//     M̄   = Ā_1 + sum_{m >= 2} Ā_m * P_{m-1},
// where SLᵀ is the exclusive suffix over rows. The kernel first runs the
// forward sweep to get the end states C_m, then sweeps the columns
// backwards, rebuilding the states by subtraction in ascending m
// (C_m(before j) = C_m(after j) - A_m[:, j], and A_m needs P_{m-1} of the
// level below, already rebuilt), so nothing of size O(L) per level is kept.
// M̄ chains through the double difference (K̄[:, j] = D̄(j-1) - D̄(j),
// D̄(j)[p] = M̄[p-1, j] - M̄[p, j]) and the base kernel:
//     RBF:    ∂k/∂x_i = k (y_j - x_i),   ∂k/∂y_j = k (x_i - y_j);
//     Linear: ∂k/∂x_i = y_j,             ∂k/∂y_j = x_i.
// With u = K̄ k (RBF) or K̄ (Linear), X̄_i = sum_j u_ij y_j - x_i sum_j u_ij
// (second term RBF only), and Ȳ likewise.
//
// What bounds it on the H100. Instruction issue and latency, not memory:
// per pair it reads 2 L d values and g's nl + 1 and does about three
// forwards' work (the forward recompute, the reverse sweep, the chain), no
// tensor-core work at all: the contractions have width d <= 8 and the
// recursions are elementwise, so wgmma has nothing to take; the resources
// are the FP32 pipe, shuffles and shared memory. The first design spent
// most of its issue slots off the DP: one warp per pair with R = 2 rows a
// lane at L = 50 (64 slots for 49 rows, a 5-shuffle scan per level and
// column), and per column d + 1 butterfly warp sums and d global atomics
// for the Ȳ row, plus (R + 1)(d + 1) shared-memory updates of X̄.
//
// Design (Hopper redesign).
// - Rows over a group (common.cuh), R = 4 rows a lane. Up to 64 rows a
//   segment of 16 lanes takes a pair, two pairs to a warp: the 4-step
//   scans of one warp serve two pairs, and at L = 50 a lane's R + 1 base
//   kernels cover 4 rows, not 2. Up to 128 rows one warp takes a pair;
//   above, one block of W <= 8 warps (a BlockGroup), its scans crossing
//   the warps through shared memory. The plan (S, W) and the tile width
//   come from the wrapper (ops/cuda/plan.py).
// - The chain leaves the column loop. The reverse sweep writes
//   u[p, j] = K̄[p, j] k(x_p, y_j) (RBF) or K̄[p, j] (Linear) at the
//   thread's own points into a shared tile of CH columns (8, or for a
//   W-warp pair 32/16/8, the most that fits). When the tile is full the
//   group contracts it: threads over points add sum_j u y_j and sum_j u
//   into X̄ sums in shared memory, threads over the tile's columns (and
//   over point ranges when the group is wider than the tile) reduce
//   sum_p u x_p and sum_p u and add Ȳ of those columns to global memory,
//   one atomic per (pair, point, channel) and range: no warp sums and no
//   atomics per column. The tile's row stride is odd, so threads reading a
//   point of different columns hit different banks.
// - Registers bound the occupancy, so the kernel is templated on the
//   level count (its state arrays C, R, P hold nl - 1 levels, not 6) and
//   capped at 128 registers (two 256-thread blocks an SM; four-warp blocks
//   then keep at least four to an SM).
// - A block shares x: it holds 8 pairs (16-lane segments), 4 (one warp
//   each) or 1 (W warps), the same x against consecutive y. At the end the
//   pairs' X̄ sums are added and accumulated across blocks atomically. A
//   pair past N2 in the last block runs on the last y, so that the two
//   halves of a warp shuffle alike, and writes nothing.
// - Every d (plan.py's gram_bwd_launch). Where x, the pairs' y and their
//   X̄ sums do not fit the block's shared memory, x and y are read from
//   global memory (only their half norms and the u tiles stay in shared
//   memory) and the X̄ sums go to a device workspace, a slot a block, the
//   grid striding over the items (an x against a block's y) so that the
//   workspace stays within plan.WORKSPACE_BYTES
//   (fused_gram_bwd_wide_kernel).
// X and Y may be the same tensor: X̄ and Ȳ are separate buffers and
// autograd adds them.
// - The chain axis: X [C, N1, L, d], Y [C, N2, L, d] and g [C, nl + 1,
//   N1, N2] give C independent backwards in one launch, the chain on
//   blockIdx.y; each kernel offsets X, Y, g, X̄, Ȳ (and the wide kernel its
//   workspace, a slot a block of each chain) to its chain first, so every
//   chain runs the code of a C = 1 launch (the counterpart of the grid axis
//   pallas_call's batching rule adds under vmap; the design is unchanged).

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kMaxLevels = 7;

// Contract the tile's n columns (slot s holds column c0 - s) into X̄ sums
// (xacc [L][d + 1], the pair's, in shared memory) and Ȳ (ybar [L][d],
// global; null for a pair that writes nothing).
template <typename T, typename G>
__device__ __forceinline__ void contract_tile(const T* xs, const T* ys,
                                              const T* u, int Lu, int n,
                                              int c0, int chunk, int L, int d,
                                              bool rbf, T* xacc, T* ybar,
                                              const G& g) {
  g.sync();
  const int t = g.thread(), GT = g.size();
  for (int p = t; p < L; p += GT) {
    T su = T(0);
    for (int s = 0; s < n; ++s) su += u[s * Lu + p];
    xacc[p * (d + 1) + d] += su;
    for (int c = 0; c < d; ++c) {
      T a = T(0);
      for (int s = 0; s < n; ++s) a += u[s * Lu + p] * ys[(c0 - s) * d + c];
      xacc[p * (d + 1) + c] += a;
    }
  }
  const int s = t % chunk, part = t / chunk, parts = GT / chunk;
  if (ybar != nullptr && s < n) {
    const int col = c0 - s;
    const T* us = u + s * Lu;
    T su = T(0);
    for (int p = part; p < L; p += parts) su += us[p];
    for (int c = 0; c < d; ++c) {
      T a = T(0);
      for (int p = part; p < L; p += parts) a += us[p] * xs[p * d + c];
      atomicAdd(ybar + col * d + c, rbf ? a - ys[col * d + c] * su : a);
    }
  }
  g.sync();
}

// Adjoint of one pair's NL per-level kernels, by the calling group.
// xs, ys: [L][d] staged sequences; nxs, nys: their -|.|^2/2 (RBF only);
// w[m]: cotangent of level m + 1. Adds Σ_j u y_j and Σ_j u for each point
// into xacc [L][d + 1] (shared) and Ȳ into ybar [L][d] (global), through
// the tile u [chunk][Lu] (shared).
template <typename T, int R, int NL, typename G>
__device__ __forceinline__ void pair_levels_bwd(
    const T* xs, const T* nxs, const T* ys, const T* nys, int L, int d,
    bool rbf, const T (&w)[NL], T* xacc, T* u, int Lu, int chunk, T* ybar,
    G& g) {
  constexpr int NC = NL > 1 ? NL - 1 : 1;  // states C_1 .. C_{NL-1}
  const int t = g.thread();
  const int rows = L - 1;
  int xi[R + 1];
  bool own[R + 1];
  T nx[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    const int p = t * R + r;
    xi[r] = min(p, L - 1);
    // a point shared with the next thread is owned by this one's last
    // slot; point 0 by thread 0
    own[r] = p <= L - 1 && (r > 0 || t == 0);
    nx[r] = rbf ? nxs[xi[r]] : T(0);
  }
  auto column = [&](int j, T (&k)[R + 1]) {
    const T nyj = rbf ? nys[j] : T(0);
#pragma unroll
    for (int r = 0; r <= R; ++r)
      k[r] = base_k(xs + xi[r] * d, nx[r], ys + j * d, nyj, d, rbf);
  };
  auto increments = [&](const T (&hi)[R + 1], const T (&lo)[R + 1],
                        T (&mcol)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T v = (hi[r + 1] - lo[r + 1]) - (hi[r] - lo[r]);
      mcol[r] = (t * R + r < rows) ? v : T(0);
    }
  };

  // ---- phase 1: forward sweep to the end states C_1 .. C_{NL-1} ----------
  T C[NC][R];
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) C[m][r] = T(0);
  T khi[R + 1];
  column(0, khi);
  for (int j = 0; j < rows; ++j) {
    T knew[R + 1], mcol[R];
    column(j + 1, knew);
    increments(knew, khi, mcol);
#pragma unroll
    for (int r = 0; r <= R; ++r) khi[r] = knew[r];
    T pre[NC][R];
#pragma unroll
    for (int m = 0; m + 2 < NL; ++m) g.template prefix<R>(C[m], pre[m]);
    if constexpr (NL > 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) C[0][r] += mcol[r];
    }
#pragma unroll
    for (int m = 1; m + 1 < NL; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r) C[m][r] += mcol[r] * pre[m - 1][r];
  }

  // ---- phase 2: reverse column sweep --------------------------------------
  // khi holds k at column j + 1 (y_{L-1} to start); Rs[m] is R_{m+1}.
  T Rs[NC][R];
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) Rs[m][r] = T(0);
  T dprev[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) dprev[r] = T(0);
  int filled = 0, c0 = L - 1;  // tile: columns c0, c0 - 1, ...
  auto store = [&](const T (&kbar)[R + 1], const T (&kv)[R + 1]) {
    T* us = u + filled * Lu;
#pragma unroll
    for (int r = 0; r <= R; ++r)
      if (own[r]) us[xi[r]] = rbf ? kbar[r] * kv[r] : kbar[r];
    if (++filled == chunk) {
      contract_tile(xs, ys, u, Lu, filled, c0, chunk, L, d, rbf, xacc, ybar,
                    g);
      c0 -= filled;
      filled = 0;
    }
  };

  for (int j = rows - 1; j >= 0; --j) {
    T klo[R + 1], mcol[R];
    column(j, klo);
    increments(khi, klo, mcol);

    // rebuild C_m and P_m = prefix(C_m) before column j, ascending m
    T P[NC][R];
    T a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = mcol[r];  // A_1
#pragma unroll
    for (int m = 0; m + 1 < NL; ++m) {
#pragma unroll
      for (int r = 0; r < R; ++r) C[m][r] -= a[r];
      g.template prefix<R>(C[m], P[m]);
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = mcol[r] * P[m][r];  // A_{m+2}
    }

    // M̄ = Ā_1 + Σ_{m>=2} Ā_m P_{m-1}, with Ā_m = w_m + R_m (R_NL = 0)
    T Mbar[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Mbar[r] = w[0];
      if constexpr (NL > 1) Mbar[r] += Rs[0][r];
    }
#pragma unroll
    for (int m = 1; m < NL; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r)
        Mbar[r] += (w[m] + (m + 1 < NL ? Rs[m < NC ? m : 0][r] : T(0))) *
                   P[m - 1][r];
    // R_m += SLᵀ (M ⊙ Ā_{m+1}), ascending m so Ā_{m+1} reads the old R
#pragma unroll
    for (int m = 0; m + 1 < NL; ++m) {
      T v[R], sfx[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = mcol[r] *
               (w[m + 1] + (m + 2 < NL ? Rs[m + 1 < NC ? m + 1 : 0][r] : T(0)));
      g.template suffix<R>(v, sfx);
#pragma unroll
      for (int r = 0; r < R; ++r) Rs[m][r] += sfx[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (t * R + r >= rows) Mbar[r] = T(0);

    // D̄(j)[p] = M̄[p-1] - M̄[p] at the thread's points (point t*R + R
    // reads the next thread's first row; point 0 has no row above it)
    const T mnext = g.next(Mbar[0]);
    T kbar[R + 1];
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      const T lo = r > 0 ? Mbar[r - 1] : T(0);
      const T hi = r < R ? Mbar[r] : mnext;
      const T dcol = lo - hi;
      kbar[r] = dcol - dprev[r];  // K̄ at column j + 1
      dprev[r] = dcol;
    }
    store(kbar, khi);
#pragma unroll
    for (int r = 0; r <= R; ++r) khi[r] = klo[r];
  }
  T kbar[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) kbar[r] = -dprev[r];  // K̄ at column 0
  store(kbar, khi);
  if (filled > 0)
    contract_tile(xs, ys, u, Lu, filled, c0, chunk, L, d, rbf, xacc, ybar, g);
}

// Block b: x = X[b / nyb] against the y sequences (b % nyb) * pairs + p,
// of chain blockIdx.y. Xbar, Ybar: [C][N1, L, d], [C][N2, L, d], zeroed by
// the caller. At most 128
// registers a thread (the launch bound: two 256-thread blocks an SM), so
// that 4-warp blocks keep at least four to an SM.
template <typename T, int R, int NL, typename G>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
fused_gram_bwd_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                      const T* __restrict__ g, T* __restrict__ Xbar,
                      T* __restrict__ Ybar, int N1, int N2, int L, int d,
                      int rbf, int W, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  {  // chain blockIdx.y's sequences, cotangents and gradients
    const long long c = blockIdx.y;
    X += c * N1 * L * d;
    Xbar += c * N1 * L * d;
    Y += c * N2 * L * d;
    Ybar += c * N2 * L * d;
    g += c * (NL + 1) * N1 * N2;
  }
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int GT = G::kBlock ? 32 * W : G::kLanes;  // threads per pair
  const int pairs = G::kBlock ? 1 : 32 * kPairsPerBlock / G::kLanes;
  const int p = threadIdx.x / GT;
  const int t = threadIdx.x % GT;
  const int nyb = (N2 + pairs - 1) / pairs;
  const int n1 = blockIdx.x / nyb;
  const int n2base = (blockIdx.x % nyb) * pairs;
  const int n2 = n2base + p;
  const bool active = n2 < N2;
  const int n2c = active ? n2 : N2 - 1;
  const int Ld = L * d;
  const int La = L * (d + 1);
  const int Lu = L | 1;
  const int per_pair = Ld + L + La + chunk * Lu;
  T* xs = smem;                        // [L][d]
  T* nxs = xs + Ld;                    // [L]
  T* ys = nxs + L + p * per_pair;      // [L][d], this pair's y
  T* nys = ys + Ld;                    // [L]
  T* xacc = nys + L;                   // [L][d + 1]
  T* u = xacc + La;                    // [chunk][Lu]
  T* buf = nxs + L + pairs * per_pair;

  const T* xg = X + static_cast<long long>(n1) * Ld;
  for (int k = threadIdx.x; k < Ld; k += blockDim.x) xs[k] = xg[k];
  const T* yg = Y + static_cast<long long>(n2c) * Ld;
  for (int k = t; k < Ld; k += GT) ys[k] = yg[k];
  for (int k = t; k < La; k += GT) xacc[k] = T(0);
  __syncthreads();
  if (rbf) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    half_sqnorms(ys, nys, L, d, t, GT);
  }
  __syncthreads();
  {
    const long long plane = static_cast<long long>(N1) * N2;
    const long long pair = static_cast<long long>(n1) * N2 + n2c;
    T w[NL];
#pragma unroll
    for (int m = 0; m < NL; ++m) w[m] = g[(m + 1) * plane + pair];
    G grp(W, buf);
    pair_levels_bwd<T, R, NL>(
        xs, nxs, ys, nys, L, d, rbf != 0, w, xacc, u, Lu, chunk,
        active ? Ybar + static_cast<long long>(n2) * Ld : nullptr, grp);
  }
  __syncthreads();
  // X̄ of this block's x: add the live pairs' sums, then across y blocks
  const int live = min(pairs, N2 - n2base);
  const T* acc0 = nxs + L + Ld + L;  // pair 0's xacc
  T* xb = Xbar + static_cast<long long>(n1) * Ld;
  for (int q = threadIdx.x; q < Ld; q += blockDim.x) {
    const int pt = q / d, c = q - pt * d;
    T s = T(0), su = T(0);
    for (int k = 0; k < live; ++k) {
      s += acc0[k * per_pair + pt * (d + 1) + c];
      su += acc0[k * per_pair + pt * (d + 1) + d];
    }
    atomicAdd(xb + q, rbf ? s - xs[q] * su : s);
  }
}

// Wide d: x and y read from global memory (their half norms staged), the
// X̄ sums in the block's slot of work [C][gridDim.x][pairs][L][d + 1]; item
// i, x = X[i / nyb] against the y sequences (i % nyb) * pairs + p, block
// b takes items b, b + gridDim.x, ... Otherwise fused_gram_bwd_kernel's.
template <typename T, int R, int NL, typename G>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
fused_gram_bwd_wide_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                           const T* __restrict__ g, T* __restrict__ Xbar,
                           T* __restrict__ Ybar, T* __restrict__ work,
                           int N1, int N2, int L, int d, int rbf, int W,
                           int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  {  // chain blockIdx.y's sequences, cotangents and gradients
    const long long c = blockIdx.y;
    X += c * N1 * L * d;
    Xbar += c * N1 * L * d;
    Y += c * N2 * L * d;
    Ybar += c * N2 * L * d;
    g += c * (NL + 1) * N1 * N2;
  }
  // the chain's slots of the workspace
  work += static_cast<long long>(blockIdx.y) * gridDim.x *
          (G::kBlock ? 1 : 32 * kPairsPerBlock / G::kLanes) * L * (d + 1);
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int GT = G::kBlock ? 32 * W : G::kLanes;  // threads per pair
  const int pairs = G::kBlock ? 1 : 32 * kPairsPerBlock / G::kLanes;
  const int p = threadIdx.x / GT;
  const int t = threadIdx.x % GT;
  const int nyb = (N2 + pairs - 1) / pairs;
  const int Ld = L * d;
  const int La = L * (d + 1);
  const int Lu = L | 1;
  // nxs [L], then per pair nys [L], u [chunk][Lu]
  const int per_pair = L + chunk * Lu;
  T* nxs = smem;
  T* nys = nxs + L + p * per_pair;
  T* u = nys + L;
  T* buf = nxs + L + pairs * per_pair;
  // the pairs' X̄ sums: pair k's at acc0 + k * La
  const T* acc0 = work + static_cast<long long>(blockIdx.x) * pairs * La;
  T* xacc = work + (static_cast<long long>(blockIdx.x) * pairs + p) * La;
  const long long items = static_cast<long long>(N1) * nyb;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int n1 = static_cast<int>(item / nyb);
    const int n2base = static_cast<int>(item % nyb) * pairs;
    const int n2 = n2base + p;
    const bool active = n2 < N2;
    const int n2c = active ? n2 : N2 - 1;
    const T* xs = X + static_cast<long long>(n1) * Ld;
    const T* ys = Y + static_cast<long long>(n2c) * Ld;
    for (int k = t; k < La; k += GT) xacc[k] = T(0);
    __syncthreads();
    if (rbf) {
      half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
      half_sqnorms(ys, nys, L, d, t, GT);
    }
    __syncthreads();
    {
      const long long plane = static_cast<long long>(N1) * N2;
      const long long pair = static_cast<long long>(n1) * N2 + n2c;
      T w[NL];
#pragma unroll
      for (int m = 0; m < NL; ++m) w[m] = g[(m + 1) * plane + pair];
      G grp(W, buf);
      pair_levels_bwd<T, R, NL>(
          xs, nxs, ys, nys, L, d, rbf != 0, w, xacc, u, Lu, chunk,
          active ? Ybar + static_cast<long long>(n2) * Ld : nullptr, grp);
    }
    __syncthreads();
    // X̄ of this item's x: add the live pairs' sums, then across y blocks
    const int live = min(pairs, N2 - n2base);
    T* xb = Xbar + static_cast<long long>(n1) * Ld;
    for (int q = threadIdx.x; q < Ld; q += blockDim.x) {
      const int pt = q / d, c = q - pt * d;
      T s = T(0), su = T(0);
      for (int k = 0; k < live; ++k) {
        s += acc0[k * La + pt * (d + 1) + c];
        su += acc0[k * La + pt * (d + 1) + d];
      }
      atomicAdd(xb + q, rbf ? s - xs[q] * su : s);
    }
    __syncthreads();  // the next item overwrites the half norms and sums
  }
}

template <typename T, int R, int NL, typename G, bool Staged>
cudaError_t launch_gram_bwd(const void* X, const void* Y, const void* g,
                            void* Xbar, void* Ybar, void* work, int C,
                            int N1, int N2, int L, int d, int rbf, int W,
                            int chunk, int blocks, cudaStream_t stream) {
  constexpr bool staged = Staged;
  const int threads = G::kBlock ? 32 * W : 32 * kPairsPerBlock;
  const int pairs = G::kBlock ? 1 : threads / G::kLanes;
  const size_t Lz = static_cast<size_t>(L);
  const size_t seq = staged ? Lz * (d + 1) : Lz;
  const size_t smem =
      sizeof(T) * (seq + pairs * ((staged ? 2 * seq : Lz) +
                                  chunk * (Lz | 1))) +
      exchange_bytes<T>(W);
  if (smem > kSegSmemBytes) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(X);
  const T* y = static_cast<const T*>(Y);
  const T* gg = static_cast<const T*>(g);
  T* xb = static_cast<T*>(Xbar);
  T* yb = static_cast<T*>(Ybar);
  const dim3 grid(blocks, C);
  if constexpr (Staged) {
    cudaError_t e = allow_smem(fused_gram_bwd_kernel<T, R, NL, G>, smem);
    if (e != cudaSuccess) return e;
    fused_gram_bwd_kernel<T, R, NL, G><<<grid, threads, smem, stream>>>(
        x, y, gg, xb, yb, N1, N2, L, d, rbf, W, chunk);
  } else {
    cudaError_t e =
        allow_smem(fused_gram_bwd_wide_kernel<T, R, NL, G>, smem);
    if (e != cudaSuccess) return e;
    fused_gram_bwd_wide_kernel<T, R, NL, G><<<grid, threads, smem,
                                              stream>>>(
        x, y, gg, xb, yb, static_cast<T*>(work), N1, N2, L, d, rbf, W,
        chunk);
  }
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t by_levels(int nl, const void* X, const void* Y, const void* g,
                      void* Xbar, void* Ybar, void* work, int C, int N1,
                      int N2, int L, int d, int rbf, int W, int chunk,
                      int staged, int blocks, cudaStream_t s) {
#define GPSIG_NL(n)                                                        \
  case n:                                                                  \
    return staged ? launch_gram_bwd<T, 4, n, G, true>(                     \
                        X, Y, g, Xbar, Ybar, work, C, N1, N2, L, d, rbf,   \
                        W, chunk, blocks, s)                               \
                  : launch_gram_bwd<T, 4, n, G, false>(                    \
                        X, Y, g, Xbar, Ybar, work, C, N1, N2, L, d, rbf,   \
                        W, chunk, blocks, s);
  switch (nl) {
    GPSIG_NL(1) GPSIG_NL(2) GPSIG_NL(3) GPSIG_NL(4) GPSIG_NL(5) GPSIG_NL(6)
    GPSIG_NL(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_NL
}

// The plan: 16-lane segments (two pairs a warp), one warp, or W warps; four
// rows a lane in each.
template <typename T>
cudaError_t gram_bwd_dispatch(const void* X, const void* Y, const void* g,
                              void* Xbar, void* Ybar, void* work, int C,
                              int N1, int N2, int L, int d, int nl, int rbf,
                              int S, int W, int chunk, int staged, int blocks,
                              cudaStream_t s) {
  if (W > 1)
    return by_levels<T, BlockGroup<T>>(nl, X, Y, g, Xbar, Ybar, work, C, N1,
                                       N2, L, d, rbf, W, chunk, staged,
                                       blocks, s);
  if (S == 16)
    return by_levels<T, WarpGroup<T, 16>>(nl, X, Y, g, Xbar, Ybar, work, C,
                                          N1, N2, L, d, rbf, 1, chunk,
                                          staged, blocks, s);
  return by_levels<T, WarpGroup<T, 32>>(nl, X, Y, g, Xbar, Ybar, work, C, N1,
                                        N2, L, d, rbf, 1, chunk, staged,
                                        blocks, s);
}

}  // namespace

extern "C" {

// X [C, N1, L, d], Y [C, N2, L, d], g [C, nl + 1, N1, N2] contiguous
// (C = 1: the unbatched shapes); Xbar, Ybar zero-filled [C, N1, L, d],
// [C, N2, L, d], distinct buffers. The plan: segments of S lanes (16: two
// pairs a warp; 32: one warp, or W warps a pair), four rows a lane, tiles
// of `chunk` columns; `staged` (x, y and the X̄ sums in shared memory) or
// not (work: [C][blocks][pairs][L][d + 1]); `blocks` blocks a chain,
// striding over the items. Returns cudaGetLastError() after the launch (0
// on success).
int gpsig_fused_gram_bwd(const void* X, const void* Y, const void* g,
                         void* Xbar, void* Ybar, void* work, int C, int N1,
                         int N2, int L, int d, int nl, int rbf, int S, int W,
                         int chunk, int staged, int blocks, int f64,
                         void* stream) {
  const bool plan = (S == 16 && W == 1) || (S == 32 && W >= 1 &&
                                            W <= kMaxWarps);
  if (L < 2 || d < 1 || nl < 1 || nl > kMaxLevels || !plan ||
      L - 1 > S * W * 4 || (chunk != 8 && chunk != 16 && chunk != 32) ||
      (S * W) % chunk != 0 || blocks < 1 || (!staged && work == nullptr) ||
      C < 1 || C > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? gram_bwd_dispatch<double>(X, Y, g, Xbar, Ybar, work, C, N1,
                                         N2, L, d, nl, rbf, S, W, chunk,
                                         staged, blocks, s)
             : gram_bwd_dispatch<float>(X, Y, g, Xbar, Ybar, work, C, N1, N2,
                                        L, d, nl, rbf, S, W, chunk, staged,
                                        blocks, s);
}

}  // extern "C"
