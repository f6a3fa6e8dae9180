// The Goursat (signature-PDE) wavefront, shared by goursat.cu (the
// forwards) and goursat_bwd.cu (the adjoint-PDE gradient).
//
// u on the refined (S+1) x (T+1) grid, u(0, .) = u(., 0) = 1,
//   u[i][j] = u[i][j-1] + u[i-1][j] - u[i-1][j-1]
//             + a(i-1, j-1) (u[i][j-1] + u[i-1][j]) / 2,
// where refined cell (I, J) takes a(I, J) = inc[I >> o, J >> o] / 4^o from
// the pair's unrefined [Su, Tu] block: the refined grid is never built.
#pragma once

#include "common.cuh"

namespace gpsig {

// The largest shared-memory block of an H100 (227 KB of the SM's 256 KB).
constexpr size_t kSmemCap = 232448;
constexpr int kGoursatMaxThreads = 512;

// A grid the sweeps take: dyadic order <= 30, the refined sides' sum (the
// last diagonal's position) below kMaxPositions and a pair's unrefined
// cells below 2^31, so that every position, diagonal, offset within a pair
// and a block's bottom rows (8 warps of C + 1) fit 32 bits
// (ops/cuda/goursat.py's MAX_POSITIONS; offsets across pairs are 64-bit).
constexpr long long kMaxPositions = 1LL << 28;
__host__ __device__ inline bool refined_fits(int Su, int Tu, int o) {
  return Su >= 0 && Tu >= 0 && o >= 0 && o <= 30 &&
         ((static_cast<long long>(Su) + Tu) << o) < kMaxPositions &&
         static_cast<long long>(Su) * Tu < (1LL << 31);
}

// The swept orientation of a pair's refined grid: u(S, T; inc) =
// u(T, S; incᵀ), so the shorter refined side R goes over the threads and
// the longer side C over the diagonals' cells.
__host__ __device__ inline void swept_sides(int Su, int Tu, int o, int& R,
                                            int& C) {
  const int Sr = Su << o, Tr = Tu << o;
  R = Sr < Tr ? Sr : Tr;
  C = Sr < Tr ? Tr : Sr;
}

// Threads per block: R + 1 positions of a diagonal, in whole warps, at
// most kGoursatMaxThreads (a thread then takes every blockDim-th cell).
inline int goursat_threads(int R) {
  const int t = (R + 1 + 31) / 32 * 32;
  return t < kGoursatMaxThreads ? t : kGoursatMaxThreads;
}

// One pair's refined increments in the swept orientation: cell (I, J) of
// the R x C grid reads the unrefined block at offset(I, J).
template <typename T>
struct RefinedGrid {
  const T* inc;
  int rs, cs, o, R, C;
  T scale;  // 1 / 4^o

  __device__ RefinedGrid(const T* inc_, int Su, int Tu, int o_)
      : inc(inc_), o(o_), scale(T(1) / T(1ll << (2 * o_))) {
    swept_sides(Su, Tu, o, R, C);
    const bool swap = (Su << o) > (Tu << o);
    rs = swap ? 1 : Tu;
    cs = swap ? Tu : 1;
  }
  __device__ int offset(int I, int J) const {
    return (I >> o) * rs + (J >> o) * cs;
  }
  __device__ T operator()(int I, int J) const {
    return inc[offset(I, J)] * scale;
  }
};

// Where cell (i, j) of the gradient's u store lies: dense rows (i (C+1) + j)
// in shared memory, diagonal by diagonal ((i+j)(R+1) + i) in device memory,
// where a diagonal's cells are then contiguous.
struct UIndex {
  int R, C;
  bool by_diagonal;
  __device__ long long operator()(int i, int j) const {
    return by_diagonal ? static_cast<long long>(i + j) * (R + 1) + i
                       : static_cast<long long>(i) * (C + 1) + j;
  }
};

// u[i][j] from u[i][j-1] (left), u[i-1][j] (up), u[i-1][j-1] (upleft) and
// the refined cell's increment a(i-1, j-1): the plain sweep's expression,
// in its order (ops/goursat.py), so that the forwards match it bit for bit.
template <typename T>
__device__ __forceinline__ T goursat_cell(T left, T up, T upleft, T a) {
  return left + up - upleft + a * (left + up) * T(0.5);
}

// The block design's forward sweep of one pair (goursat_bwd.cu), by the
// whole block, diagonal d = i + j at a time: the threads stride over the
// diagonal's cells i = max(0, d-C) .. min(R, d), each from two cells of
// diagonal d-1 and one of d-2, kept in three rotating buffers of R + 1
// values in shared memory (buf, 3 (R+1)); one __syncthreads() per
// diagonal. Every cell, boundary included, is also
// written to store when it is given. Returns u(R, C) to every thread.
template <typename T>
__device__ T goursat_sweep(const RefinedGrid<T>& a, T* buf, T* store,
                           UIndex uidx) {
  const int R = a.R, C = a.C;
  T* d2 = buf;
  T* d1 = buf + (R + 1);
  T* d0 = buf + 2 * (R + 1);
  for (int d = 0; d <= R + C; ++d) {
    const int hi = R < d ? R : d;
    for (int i = (d > C ? d - C : 0) + threadIdx.x; i <= hi;
         i += blockDim.x) {
      const int j = d - i;
      T v = T(1);
      if (i > 0 && j > 0)  // u[i][j-1], u[i-1][j], u[i-1][j-1]
        v = goursat_cell(d1[i], d1[i - 1], d2[i - 1], a(i - 1, j - 1));
      d0[i] = v;
      if (store) store[uidx(i, j)] = v;
    }
    __syncthreads();
    T* t = d2;
    d2 = d1;
    d1 = d0;
    d0 = t;
  }
  return d1[R];
}

}  // namespace gpsig
