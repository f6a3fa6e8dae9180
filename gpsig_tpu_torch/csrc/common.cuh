// Device helpers shared by the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

namespace gpsig {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float texp(float v) { return expf(v); }
__device__ __forceinline__ double texp(double v) { return exp(v); }
__device__ __forceinline__ float tcos(float v) { return cosf(v); }
__device__ __forceinline__ double tcos(double v) { return cos(v); }
__device__ __forceinline__ float tsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double tsqrt(double v) { return sqrt(v); }

// Base-kernel kinds of the general engines (fused_gram_ho.cu,
// tens_seq_general.cu), passed at run time: every thread of a launch takes
// the same branch. POLY's offset is folded in by the caller as a constant
// channel (x_extra = 1, y_extra = c), so the kernels see (<x, y>)^degree.
enum BaseKind : int { kLinear = 0, kRbf = 1, kCosine = 2, kPoly = 3 };

// Whether a kind adds -|a|^2/2 - |b|^2/2 to the dot product.
__device__ __forceinline__ bool kind_norms(int kind) {
  return kind == kRbf || kind == kCosine;
}

// The base kernel from its accumulator acc = <a, b> (+ the half norms).
// The RBF exponent is not clamped, as the TPU kernels and their plain
// references compute it; the cosine's distance is, as there.
template <typename T>
__device__ __forceinline__ T activate(T acc, int kind, int degree) {
  switch (kind) {
    case kRbf: return texp(acc);
    case kCosine: {
      const T s = T(-2) * acc;
      return tcos(tsqrt((s > T(0) ? s : T(0)) + T(1e-36)));
    }
    case kPoly: {
      T out = acc;
      for (int k = 1; k < degree; ++k) out *= acc;
      return out;
    }
    default: return acc;
  }
}

// k(a, b) of any kind for one point pair; na, nb are -|a|^2/2, -|b|^2/2
// (used by the kinds that need them)
template <typename T>
__device__ __forceinline__ T kind_k(const T* a, T na, const T* b, T nb,
                                    int d, int kind, int degree) {
  T acc = kind_norms(kind) ? na + nb : T(0);
  for (int c = 0; c < d; ++c) acc += a[c] * b[c];
  return activate(acc, kind, degree);
}

// k(a, b) for one point pair; na, nb are -|a|^2/2, -|b|^2/2 (RBF only)
template <typename T>
__device__ __forceinline__ T base_k(const T* a, T na, const T* b, T nb,
                                    int d, bool rbf) {
  T acc = rbf ? na + nb : T(0);
  for (int c = 0; c < d; ++c) acc += a[c] * b[c];
  return rbf ? texp(acc) : acc;
}

// -|x_i|^2/2 for the L points of a staged sequence, written by `nthreads`
// cooperating threads starting at `tid`
template <typename T>
__device__ void half_sqnorms(const T* xs, T* nxs, int L, int d, int tid,
                             int nthreads) {
  for (int i = tid; i < L; i += nthreads) {
    T s = T(0);
    for (int c = 0; c < d; ++c) s += xs[i * d + c] * xs[i * d + c];
    nxs[i] = T(-0.5) * s;
  }
}

// Exclusive prefix over the warp's rows (lane l holds rows l*R .. l*R+R-1):
// out[r] = sum of v over all rows before row lane*R + r.
template <typename T, int R>
__device__ __forceinline__ void warp_excl_prefix(const T (&v)[R], T (&out)[R],
                                                 int lane) {
  T run = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    out[r] = run;
    run += v[r];
  }
  T incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] += excl;
}

// Exclusive suffix over the warp's rows: out[r] = sum of v over all rows
// after row lane*R + r.
template <typename T, int R>
__device__ __forceinline__ void warp_excl_suffix(const T (&v)[R], T (&out)[R],
                                                 int lane) {
  T run = T(0);
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    out[r] = run;
    run += v[r];
  }
  T incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += t;
  }
  T excl = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) excl = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] += excl;
}

// Sum over the warp, returned to every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Rows per lane for L - 1 increment rows; 0 when no instantiation covers L.
inline int rows_per_lane(int L) {
  const int rows = L - 1;
  if (rows <= 32) return 1;
  if (rows <= 64) return 2;
  if (rows <= 128) return 4;
  return 0;
}

// Rows per lane of the run-length kernels (2 or 4); 0 when rows > 128.
inline int rl_rows_per_lane(int rows) {
  if (rows <= 64) return 2;
  if (rows <= 128) return 4;
  return 0;
}

constexpr int kRlLevels = 7;

// ---------------------------------------------------------------------------
// Run-length (any order) column DP of one pair, shared by fused_gram_ho.cu
// (columns built from the sequences) and sig_gram.cu (columns read from a
// prebuilt increment matrix). The recursion is ops/signature.py's
// _higher_order with p = P = min(order, num_levels):
//   level 1: D[0][0] = M;  level m >= 2, R_m = min(P, m):
//     D'[0][0] = M * ecumsum2(sum of all D)
//     D'[r][0] = M/(r+1) * (row cumsum, exclusive, of sum_s D[r-1][s])
//     D'[0][r] = M/(r+1) * (column cumsum, exclusive, of sum_s D[s][r-1])
//     D'[r][s] = M/((r+1)(s+1)) * D[r-1][s-1]
// A warp sweeps the columns j; lane l holds rows l*R .. l*R+R-1. The
// current column's states of all levels are computed level by level into
// one in-place P x P grid; only states with r, s < R_m exist at level m,
// and the grid's extents are compile-time, so no dead state is computed.
// Per level two carries persist across columns: T_m[i] = sum over j' < j
// of all states (its exclusive row prefix, a warp scan, gives ecumsum2)
// and RA_m[q][i] = sum over j' < j of sum_s D[q][s] (the row cumsum). The
// column cumsums are warp scans of the current column. k_m = sum_i T_m[i]
// at the end.
// ---------------------------------------------------------------------------

template <typename T, int R, int P>
struct RunLengthState {
  T grid[P][P][R];
  T tsum[kRlLevels][R];
  T ra[kRlLevels - 1][P > 1 ? P - 1 : 1][R];
};

template <typename T, int R, int P, int M>
__device__ __forceinline__ void rl_level(RunLengthState<T, R, P>& st,
                                         const T (&mcol)[R], int nl,
                                         int lane) {
  if constexpr (M <= kRlLevels) {
    if (M > nl) return;
    constexpr int Rm = P < M ? P : M;
    if constexpr (M == 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) st.grid[0][0][r] = mcol[r];
    } else {
      constexpr int Rp = P < M - 1 ? P : M - 1;  // extent at level M - 1
      constexpr int NQ = Rm > 1 ? Rm - 1 : 1;
      T tot[R], pre[R], colpre[NQ][R], rowsum[NQ][R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tot[r] = T(0);
#pragma unroll
        for (int a = 0; a < Rp; ++a)
#pragma unroll
          for (int b = 0; b < Rp; ++b) tot[r] += st.grid[a][b][r];
      }
#pragma unroll
      for (int q = 0; q + 1 < Rm; ++q) {
        T cs[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cs[r] = T(0);
          rowsum[q][r] = T(0);
#pragma unroll
          for (int a = 0; a < Rp; ++a) {
            cs[r] += st.grid[a][q][r];
            rowsum[q][r] += st.grid[q][a][r];
          }
        }
        warp_excl_prefix<T, R>(cs, colpre[q], lane);
      }
      warp_excl_prefix<T, R>(st.tsum[M - 2], pre, lane);
      // in place, descending, so that D[a-1][b-1] is read before it is
      // overwritten
#pragma unroll
      for (int a = Rm - 1; a >= 1; --a)
#pragma unroll
        for (int b = Rm - 1; b >= 1; --b) {
          const T c = T(1) / T((a + 1) * (b + 1));
#pragma unroll
          for (int r = 0; r < R; ++r)
            st.grid[a][b][r] = mcol[r] * c * st.grid[a - 1][b - 1][r];
        }
#pragma unroll
      for (int a = Rm - 1; a >= 1; --a) {
        const T c = T(1) / T(a + 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          st.grid[a][0][r] = mcol[r] * c * st.ra[M - 2][a - 1][r];
          st.grid[0][a][r] = mcol[r] * c * colpre[a - 1][r];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st.grid[0][0][r] = mcol[r] * pre[r];
        st.tsum[M - 2][r] += tot[r];
#pragma unroll
        for (int q = 0; q + 1 < Rm; ++q) st.ra[M - 2][q][r] += rowsum[q][r];
      }
    }
    if (M == nl) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T s = T(0);
#pragma unroll
        for (int a = 0; a < Rm; ++a)
#pragma unroll
          for (int b = 0; b < Rm; ++b) s += st.grid[a][b][r];
        st.tsum[M - 1][r] += s;
      }
      return;
    }
    rl_level<T, R, P, M + 1>(st, mcol, nl, lane);
  }
}

// Per-level kernels of one pair, computed by the calling (full) warp over
// `ncols` columns; col(j, mcol) fills the lane's R rows of column j (zero
// for rows past the matrix). Lane 0 writes level m to out[m * stride].
template <typename T, int R, int P, typename Col>
__device__ void run_length_levels(Col& col, int ncols, int nl, T* out,
                                  long long stride) {
  const int lane = threadIdx.x & 31;
  RunLengthState<T, R, P> st;
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) st.grid[a][b][r] = T(0);
#pragma unroll
  for (int m = 0; m < kRlLevels; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) st.tsum[m][r] = T(0);
#pragma unroll
  for (int m = 0; m + 1 < kRlLevels; ++m)
#pragma unroll
    for (int q = 0; q < (P > 1 ? P - 1 : 1); ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) st.ra[m][q][r] = T(0);

  for (int j = 0; j < ncols; ++j) {
    T mcol[R];
    col(j, mcol);
    rl_level<T, R, P, 1>(st, mcol, nl, lane);
  }

  if (lane == 0) out[0] = T(1);
#pragma unroll
  for (int m = 0; m < kRlLevels; ++m) {
    if (m < nl) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += st.tsum[m][r];
      s = warp_sum(s);
      if (lane == 0) out[(m + 1) * stride] = s;
    }
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gpsig
