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
// level below, already rebuilt), so nothing of size O(L) per pair is kept.
// M̄ chains through the double difference (K̄[:, j] = D̄(j-1) - D̄(j),
// D̄(j)[p] = M̄[p-1, j] - M̄[p, j]) and the base kernel:
//     RBF:    ∂k/∂x_i = k (y_j - x_i),   ∂k/∂y_j = k (x_i - y_j);
//     Linear: ∂k/∂x_i = y_j,             ∂k/∂y_j = x_i.
// With u = K̄ k (RBF) or K̄ (Linear), X̄_i = sum_j u_ij y_j - x_i sum_j u_ij
// (second term RBF only), and Ȳ likewise.
//
// Design. The forward kernel's layout: one warp per (x, y) pair, lanes hold
// R = 1, 2 or 4 consecutive increment rows and the R + 1 points around
// them; a block is 4 warps sharing x. The row prefixes are
// __shfl_up_sync scans as in the forward, and the suffixes of R_m are
// __shfl_down_sync scans. A point at a lane boundary is held by two lanes;
// it is owned by the upper lane (point lane*R + r for r >= 1, and point 0
// by lane 0), so its cotangent is counted once. Per column the warp sums
// the Ȳ row with butterfly shuffles and lane 0 adds it to global memory
// (atomics: N1 blocks share a y). The X̄ sums live in shared memory per
// warp, indexed by owned point; at the end the 4 warps' sums are added and
// atomically accumulated across the y blocks. X and Y may be the same
// tensor: X̄ and Ȳ are separate buffers and autograd adds them.
//
// What bounds it on the H100. As the forward: instruction throughput, not
// memory. Per pair it evaluates 2 L^2 base kernels (forward recompute and
// reverse sweep), and per column 2 (nl - 1) warp scans, d + 1 butterfly
// sums and R (d + 1) shared-memory updates per lane: about 3-4x the
// forward's work. Global traffic is the inputs, g, and one atomic per
// (pair-block, point, channel).

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kMaxLevels = 7;
constexpr int kWarpsPerBlock = 4;

// X̄ and Ȳ contributions of one base-kernel column j of the calling warp's
// pair. kv: k(x_p, y_j) at the lane's R + 1 points; kbar: K̄[p, j] there
// (meaningful at owned points only).
template <typename T, int R>
__device__ __forceinline__ void chain_column(
    const T* xs, const T* ys, const int (&xi)[R + 1],
    const bool (&own)[R + 1], const T (&kv)[R + 1], const T (&kbar)[R + 1],
    int j, int d, bool rbf, T* xacc, T* ybar, int lane) {
  T u[R + 1];
  T su = T(0);
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    u[r] = own[r] ? (rbf ? kbar[r] * kv[r] : kbar[r]) : T(0);
    su += u[r];
    if (own[r]) xacc[xi[r] * (d + 1) + d] += u[r];
  }
  const T* yj = ys + j * d;
  const T su_all = rbf ? warp_sum(su) : T(0);
  for (int c = 0; c < d; ++c) {
    const T yc = yj[c];
    T s = T(0);
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      if (own[r]) xacc[xi[r] * (d + 1) + c] += u[r] * yc;
      s += u[r] * xs[xi[r] * d + c];
    }
    s = warp_sum(s);
    if (lane == 0) atomicAdd(ybar + j * d + c, rbf ? s - yc * su_all : s);
  }
}

// Adjoint of one pair's per-level kernels, by the calling (full) warp.
// xs, ys: [L][d] staged sequences; nxs, nys: their -|.|^2/2 (RBF only);
// w[m]: cotangent of level m + 1. Adds Σ_j u y_j and Σ_j u for each point
// into xacc [L][d + 1] (shared, this warp's) and Ȳ into ybar [L][d]
// (global).
template <typename T, int R>
__device__ void pair_levels_bwd(const T* xs, const T* nxs, const T* ys,
                                const T* nys, int L, int d, int nl, bool rbf,
                                const T (&w)[kMaxLevels], T* xacc, T* ybar) {
  const int lane = threadIdx.x & 31;
  const int rows = L - 1;
  int xi[R + 1];
  bool own[R + 1];
  T nx[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    const int p = lane * R + r;
    xi[r] = min(p, L - 1);
    own[r] = p <= L - 1 && (r > 0 || lane == 0);
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
      mcol[r] = (lane * R + r < rows) ? v : T(0);
    }
  };

  // ---- phase 1: forward sweep to the end states C_1 .. C_{nl-1} ----------
  T C[kMaxLevels - 1][R];
#pragma unroll
  for (int m = 0; m < kMaxLevels - 1; ++m)
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
    T pre[kMaxLevels - 1][R];
#pragma unroll
    for (int m = 0; m + 2 < kMaxLevels; ++m)
      if (m + 2 < nl) warp_excl_prefix<T, R>(C[m], pre[m], lane);
#pragma unroll
    for (int r = 0; r < R; ++r) C[0][r] += mcol[r];
#pragma unroll
    for (int m = 1; m < kMaxLevels - 1; ++m)
      if (m + 1 < nl) {
#pragma unroll
        for (int r = 0; r < R; ++r) C[m][r] += mcol[r] * pre[m - 1][r];
      }
  }

  // ---- phase 2: reverse column sweep --------------------------------------
  // khi holds k at column j + 1 (y_{L-1} to start); Rs[m] is R_{m+1}.
  T Rs[kMaxLevels - 1][R];
#pragma unroll
  for (int m = 0; m < kMaxLevels - 1; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) Rs[m][r] = T(0);
  T dprev[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) dprev[r] = T(0);

  for (int j = rows - 1; j >= 0; --j) {
    T klo[R + 1], mcol[R];
    column(j, klo);
    increments(khi, klo, mcol);

    // rebuild C_m and P_m = prefix(C_m) before column j, ascending m
    T P[kMaxLevels - 1][R];
    T a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = mcol[r];  // A_1
#pragma unroll
    for (int m = 0; m < kMaxLevels - 1; ++m) {
      if (m + 1 < nl) {
#pragma unroll
        for (int r = 0; r < R; ++r) C[m][r] -= a[r];
        warp_excl_prefix<T, R>(C[m], P[m], lane);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = mcol[r] * P[m][r];  // A_{m+2}
      }
    }

    // M̄ = Ā_1 + Σ_{m>=2} Ā_m P_{m-1}, with Ā_m = w_m + R_m (R_nl = 0)
    T Mbar[R];
#pragma unroll
    for (int r = 0; r < R; ++r) Mbar[r] = w[0] + (nl > 1 ? Rs[0][r] : T(0));
#pragma unroll
    for (int m = 1; m < kMaxLevels; ++m) {
      if (m < nl) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T abar = w[m] + (m + 1 < nl ? Rs[m][r] : T(0));
          Mbar[r] += abar * P[m - 1][r];
        }
      }
    }
    // R_m += SLᵀ (M ⊙ Ā_{m+1}), ascending m so Ā_{m+1} reads the old R
#pragma unroll
    for (int m = 0; m + 1 < kMaxLevels; ++m) {
      if (m + 1 < nl) {
        T v[R], sfx[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[r] = mcol[r] * (w[m + 1] + (m + 2 < nl ? Rs[m + 1][r] : T(0)));
        warp_excl_suffix<T, R>(v, sfx, lane);
#pragma unroll
        for (int r = 0; r < R; ++r) Rs[m][r] += sfx[r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane * R + r >= rows) Mbar[r] = T(0);

    // D̄(j)[p] = M̄[p-1] - M̄[p] at the lane's points (point lane*R + R
    // reads the next lane's first row; point 0 has no row above it)
    T mnext = __shfl_down_sync(kFull, Mbar[0], 1);
    if (lane == 31) mnext = T(0);
    T dcol[R + 1], kbar[R + 1];
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      const T lo = r > 0 ? Mbar[r - 1] : T(0);
      const T hi = r < R ? Mbar[r] : mnext;
      dcol[r] = lo - hi;
      kbar[r] = dcol[r] - dprev[r];  // K̄ at column j + 1
      dprev[r] = dcol[r];
    }
    chain_column<T, R>(xs, ys, xi, own, khi, kbar, j + 1, d, rbf, xacc, ybar,
                       lane);
#pragma unroll
    for (int r = 0; r <= R; ++r) khi[r] = klo[r];
  }
  T kbar[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) kbar[r] = -dprev[r];  // K̄ at column 0
  chain_column<T, R>(xs, ys, xi, own, khi, kbar, 0, d, rbf, xacc, ybar, lane);
}

// Block b: x = X[b / nyb] against the 4 y sequences (b % nyb) * 4 + warp.
// Xbar, Ybar: [N1, L, d], [N2, L, d], zeroed by the caller.
template <typename T, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_gram_bwd_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                      const T* __restrict__ g, T* __restrict__ Xbar,
                      T* __restrict__ Ybar, int N1, int N2, int L, int d,
                      int nl, int rbf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nyb = (N2 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int n1 = blockIdx.x / nyb;
  const int n2 = (blockIdx.x % nyb) * kWarpsPerBlock + warp;
  const int Ld = L * d;
  const int La = L * (d + 1);
  T* xs = smem;                              // [L][d]
  T* nxs = xs + Ld;                          // [L]
  T* ys = nxs + L + warp * (Ld + L + La);    // [L][d], this warp's y
  T* nys = ys + Ld;                          // [L]
  T* xacc = nys + L;                         // [L][d + 1]
  const bool active = n2 < N2;

  const T* xg = X + static_cast<long long>(n1) * Ld;
  for (int k = threadIdx.x; k < Ld; k += blockDim.x) xs[k] = xg[k];
  for (int k = lane; k < La; k += 32) xacc[k] = T(0);
  if (active) {
    const T* yg = Y + static_cast<long long>(n2) * Ld;
    for (int k = lane; k < Ld; k += 32) ys[k] = yg[k];
  }
  __syncthreads();
  if (rbf) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    if (active) half_sqnorms(ys, nys, L, d, lane, 32);
  }
  __syncthreads();
  if (active) {
    const long long plane = static_cast<long long>(N1) * N2;
    const long long pair = static_cast<long long>(n1) * N2 + n2;
    T w[kMaxLevels];
#pragma unroll
    for (int m = 0; m < kMaxLevels; ++m)
      w[m] = m < nl ? g[(m + 1) * plane + pair] : T(0);
    pair_levels_bwd<T, R>(xs, nxs, ys, nys, L, d, nl, rbf != 0, w, xacc,
                          Ybar + static_cast<long long>(n2) * Ld);
  }
  __syncthreads();
  // X̄ of this block's x: add the 4 warps' sums, then across y blocks
  const int wstride = Ld + L + La;
  const T* acc0 = nxs + L + Ld + L;  // warp 0's xacc
  T* xb = Xbar + static_cast<long long>(n1) * Ld;
  for (int q = threadIdx.x; q < Ld; q += blockDim.x) {
    const int p = q / d, c = q - p * d;
    T s = T(0), su = T(0);
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      s += acc0[w * wstride + p * (d + 1) + c];
      su += acc0[w * wstride + p * (d + 1) + d];
    }
    atomicAdd(xb + q, rbf ? s - xs[q] * su : s);
  }
}

template <typename T, int R>
cudaError_t launch_gram_bwd(const void* X, const void* Y, const void* g,
                            void* Xbar, void* Ybar, int N1, int N2, int L,
                            int d, int nl, int rbf, cudaStream_t stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(L) *
                      ((d + 1) + kWarpsPerBlock * (2 * d + 2));
  cudaError_t e = allow_smem(fused_gram_bwd_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  const long long nyb = (N2 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long blocks = static_cast<long long>(N1) * nyb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fused_gram_bwd_kernel<T, R><<<static_cast<unsigned>(blocks),
                                kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<const T*>(g), static_cast<T*>(Xbar), static_cast<T*>(Ybar),
      N1, N2, L, d, nl, rbf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gram_bwd_dispatch(const void* X, const void* Y, const void* g,
                              void* Xbar, void* Ybar, int N1, int N2, int L,
                              int d, int nl, int rbf, cudaStream_t s) {
  switch (rows_per_lane(L)) {
    case 1:
      return launch_gram_bwd<T, 1>(X, Y, g, Xbar, Ybar, N1, N2, L, d, nl, rbf,
                                   s);
    case 2:
      return launch_gram_bwd<T, 2>(X, Y, g, Xbar, Ybar, N1, N2, L, d, nl, rbf,
                                   s);
    case 4:
      return launch_gram_bwd<T, 4>(X, Y, g, Xbar, Ybar, N1, N2, L, d, nl, rbf,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// X [N1, L, d], Y [N2, L, d], g [nl + 1, N1, N2] contiguous; Xbar, Ybar
// zero-filled [N1, L, d], [N2, L, d], distinct buffers. Returns
// cudaGetLastError() after the launch (0 on success).
int gpsig_fused_gram_bwd(const void* X, const void* Y, const void* g,
                         void* Xbar, void* Ybar, int N1, int N2, int L, int d,
                         int nl, int rbf, int f64, void* stream) {
  if (L < 2 || d < 1 || nl < 1 || nl > kMaxLevels) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? gram_bwd_dispatch<double>(X, Y, g, Xbar, Ybar, N1, N2, L, d,
                                         nl, rbf, s)
             : gram_bwd_dispatch<float>(X, Y, g, Xbar, Ybar, N1, N2, L, d, nl,
                                        rbf, s);
}

}  // extern "C"
