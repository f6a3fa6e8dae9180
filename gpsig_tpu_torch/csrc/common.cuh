// Device helpers shared by the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

namespace gpsig {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float texp(float v) { return expf(v); }
__device__ __forceinline__ double texp(double v) { return exp(v); }

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

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gpsig
