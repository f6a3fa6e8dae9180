// Goursat (signature-PDE) adjoint gradient for Hopper (sm_90a):
// out[b] = ḡ[b] · ∂u_b(S·f, T·f)/∂inc_b [Su, Tu] in unrefined coordinates.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/goursat_pallas.py:
// _fused_kernel with with_grad (goursat_grad_fused, the custom VJP of
// goursat_corner_refined, goursat.py:337): the same gradient for every
// shape, where the JAX package falls back to its scan adjoint above its
// VMEM budget. Entry point gpsig_goursat_grad, the backward of both
// forwards in goursat.cu (at o = 0 for the given-grid route). The plain
// version is autograd through ops/goursat.py's sweep, whose backward is
// the plain adjoint sweep.
//
// The recursions. Forward, on the refined (R+1) x (C+1) grid from
// u(0, .) = u(., 0) = 1 (goursat.cuh); reverse, from μ[R][C] = 1,
//   μ[i][j] = -μ[i+1][j+1] + μ[i][j+1] (1 + a(i-1, j)/2)
//             + μ[i+1][j] (1 + a(i, j-1)/2),
// each refined cell emitting ∂corner/∂a(i-1, j-1) = μ[i][j] (u[i][j-1] +
// u[i-1][j]) / 2 times ḡ / 4^o into its unrefined cell. The saved tensor
// is the unrefined inc, as in the JAX custom VJP: the refined grid exists
// nowhere.
//
// What bounds it on the H100. Per refined cell the forward's 6 operations,
// 6 more to recompute it and 10 for the adjoint step and its term: 22 Sr
// Tr B operations at 67 TFLOP/s; bytes are inc and ḡ read once and the
// gradient written once, which bound it up to o = 1. Both sweeps are
// chains of dependent cells, so latency and the pairs in flight bound it.
//
// Design for Hopper: one warp a pair up to 256 refined rows (the
// wrapper's warp_plan), a block of threads above.
//  - The warp design. Lane l holds RL = 2, 4 or 8 consecutive refined rows
//    (at least 2^o, so that it owns whole unrefined rows) in registers.
//    The forward is skewed: at step s lane l solves column s - l, taking u
//    of the row above its rows from lane l - 1 by __shfl_up_sync; no
//    barrier of any kind. It keeps no dense u store: it writes that row
//    (bnd) at every column, and its own rows every K columns (16; 8 in
//    float64 past two rows a lane, for registers; ck), to shared memory. The reverse is skewed the
//    other way (lane l + 1 leads, μ of the row below comes by
//    __shfl_down_sync), with each
//    lane's checkpoint columns in its own phase, so that all lanes start a
//    K-column segment at the same step: there each lane recomputes its
//    rows' u over the segment from its checkpoint and bnd alone, into
//    registers indexed at compile time, then walks the adjoint down the
//    segment. The term of a refined cell is added in registers to its
//    refined row's sum; when a unrefined column is done the lane adds its
//    2^o rows' sums in a fixed tree and writes each unrefined cell once:
//    no atomics, and two launches give the same bits. Shared memory is
//    (C + 1 + K-segments x RL) values a lane (about 16 KB a pair at the
//    joint Gram's 98 x 98 refined cells in float32), against the dense
//    store's 39 KB a block, plus the pair's increments where the 48 KB
//    budget takes them (else each is read from device memory), each lane's
//    row offsets into them computed once. A numpy model of this schedule
//    is held against autograd in tests/test_torch_goursat.py.
//  - The block design (more than 256 refined rows, a unrefined row of
//    more than 8 refined rows, or bnd and ck past 48 KB): one block per
//    pair, diagonal d = i + j at a time with one __syncthreads() each, as
//    the forward:
//    1. a forward sweep that keeps every u: in shared memory as a dense
//       (R+1) x (C+1) grid when it fits (the wrapper decides, and passes
//       no workspace), else in a device workspace the wrapper allocates
//       with torch.empty, diagonal by diagonal so that a diagonal's reads
//       are contiguous;
//    2. the reverse sweep in the forward's three shared buffers; each
//       thread owns the same refined rows on every diagonal and adds their
//       terms to per-refined-row sums [R][C >> o] in the workspace, in
//       diagonal order, and each unrefined cell is then the sum of its 2^o
//       rows' sums in row order: no atomics here either, the same bits on
//       every launch.

#include "goursat.cuh"

namespace {

using namespace gpsig;

// The block design: block b takes pair b. Shared memory: the three
// diagonal buffers, the dense u store unless it is in the workspace
// (store_global), and the pair's inc when it fits (stage). The workspace
// of a pair: the u store diagonal by diagonal (store_global), then the
// per-refined-row sums rowacc [R][C >> o].
template <typename T>
__global__ void goursat_grad_kernel(const T* __restrict__ inc,
                                    const T* __restrict__ gbar,
                                    T* __restrict__ out, T* __restrict__ work,
                                    int Su, int Tu, int o, int store_global,
                                    int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long pair = static_cast<long long>(Su) * Tu;
  const T* src = inc + blockIdx.x * pair;
  RefinedGrid<T> a(src, Su, Tu, o);
  const int R = a.R, C = a.C, Cu = C >> o;
  const long long ustore =
      store_global ? static_cast<long long>(R + C + 1) * (R + 1) : 0;
  T* wb = work + blockIdx.x * (ustore + (pair << o));
  T* rowacc = wb + ustore;
  T* buf = smem;
  T* next = smem + 3 * (R + 1);
  const UIndex uidx{R, C, store_global != 0};
  T* store;
  if (store_global) {
    store = wb;
  } else {
    store = next;
    next += static_cast<long long>(R + 1) * (C + 1);
  }
  for (long long k = threadIdx.x; k < (pair << o); k += blockDim.x)
    rowacc[k] = T(0);
  if (stage) {
    for (long long k = threadIdx.x; k < pair; k += blockDim.x)
      next[k] = src[k];
    a.inc = next;
  }
  __syncthreads();
  goursat_sweep(a, buf, store, uidx);  // ends with a barrier

  // thread t owns the refined rows i = t (mod blockDim) on every diagonal
  // and adds their terms to rowacc in diagonal order: no atomics
  const T g = gbar[blockIdx.x] * a.scale;
  const int bd = blockDim.x;
  T* m2 = buf;  // μ diagonals d+2, d+1, d
  T* m1 = buf + (R + 1);
  T* m0 = buf + 2 * (R + 1);
  for (int d = R + C; d >= 2; --d) {
    const int lo = d - C > 1 ? d - C : 1;
    const int hi = R < d - 1 ? R : d - 1;
    for (int i = lo + ((static_cast<int>(threadIdx.x) - lo) % bd + bd) % bd;
         i <= hi; i += bd) {
      const int j = d - i;
      T mu = T(1);  // the seed μ[R][C]
      if (d < R + C) {
        mu = T(0);
        if (i < R && j < C) mu -= m2[i + 1];
        if (j < C) mu += m1[i] * (T(1) + T(0.5) * a(i - 1, j));
        if (i < R) mu += m1[i + 1] * (T(1) + T(0.5) * a(i, j - 1));
      }
      m0[i] = mu;
      rowacc[static_cast<long long>(i - 1) * Cu + ((j - 1) >> o)] +=
          mu * (store[uidx(i, j - 1)] + store[uidx(i - 1, j)]) * T(0.5);
    }
    __syncthreads();
    T* t = m2;
    m2 = m1;
    m1 = m0;
    m0 = t;
  }
  // each unrefined cell: its 2^o refined rows' sums, in row order
  T* dst = out + blockIdx.x * pair;
  const int f = 1 << o;
  for (long long q = threadIdx.x; q < pair; q += blockDim.x) {
    const int I = static_cast<int>(q / Cu), J = static_cast<int>(q % Cu);
    T s = T(0);
    for (int r = 0; r < f; ++r)
      s += rowacc[static_cast<long long>((I << o) + r) * Cu + J];
    dst[a.offset(I << o, J << o)] = s * g;
  }
}

// The warp design's shared-memory budget (ops/cuda/goursat.py's
// WARP_SMEM_BYTES): bnd and ck must fit, the staged increments may.
constexpr size_t kWarpSmem = 48 * 1024;

// The warp design: block b (one warp) takes pair b. Shared memory: bnd
// [(C + 1) x lanes] (u of the row above each lane's rows, by column), ck
// [segments x RL x lanes] (each lane's rows at its checkpoint columns),
// then, when stage, the pair's increments [R >> o][C >> o] in the swept
// orientation (else they are read from device memory).
template <typename T, int RL, int K>
__global__ void __launch_bounds__(32)
goursat_grad_warp_kernel(const T* __restrict__ inc,
                         const T* __restrict__ gbar, T* __restrict__ out,
                         int Su, int Tu, int o, int lanes, int segments,
                         int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long pair = static_cast<long long>(Su) * Tu;
  const RefinedGrid<T> a(inc + blockIdx.x * pair, Su, Tu, o);
  const int R = a.R, C = a.C;
  T* bnd = reinterpret_cast<T*>(smem_raw);
  T* ck = bnd + static_cast<long long>(C + 1) * lanes;
  const int l = threadIdx.x;
  const bool live = l < lanes;
  const int row0 = l * RL;  // the lane's rows are row0 + 1 .. row0 + RL
  const int Q = C + lanes - 1 - l;  // reverse: column Q - s at step s
  // the increments as base[(I >> o) rstride + (J >> o) cstride] for
  // refined cell (I, J)
  const T* base = a.inc;
  int rstride = a.rs, cstride = a.cs;
  if (stage) {
    T* sa = ck + static_cast<long long>(segments) * RL * lanes;
    const int Ru = R >> o, Cu = C >> o;
    for (int k = l; k < Ru * Cu; k += 32) {
      const int I = k / Cu, J = k - I * Cu;
      sa[k] = a.inc[I * a.rs + J * a.cs];
    }
    __syncwarp();
    base = sa;
    rstride = Cu;
    cstride = 1;
  }
  // row r of the lane's rows row0 + r (r = 0 .. RL), -1 past the grid
  int roff[RL + 1];
#pragma unroll
  for (int r = 0; r <= RL; ++r)
    roff[r] = row0 + r < R ? ((row0 + r) >> o) * rstride : -1;
  // refined cell (row0 + r, j)'s increment, 0 on the rows past R
  auto cell_a = [&](int r, int j) {
    return roff[r] >= 0 ? base[roff[r] + (j >> o) * cstride] * a.scale
                        : T(0);
  };

  // ---- forward, lane l at column s - l ------------------------------------
  T u[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) u[r] = T(1);
  T top_prev = T(1), last = T(1);
  // checkpoint columns: j = Q - (g + 1) K for segment g, the first at jc
  int jc = (Q - 1) % K + 1, gck = (Q - jc) / K - 1;
  for (int s = 1; s < C + lanes; ++s) {
    const T sent = __shfl_up_sync(kFull, last, 1);
    const int j = s - l;
    if (live && j >= 1 && j <= C) {
      const T top = l > 0 ? sent : T(1);
      bnd[j * lanes + l] = top;
      T up = top, upleft = top_prev;
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const T left = u[r];
        const T v = goursat_cell(left, up, upleft, cell_a(r, j - 1));
        upleft = left;
        up = v;
        u[r] = v;
      }
      last = u[RL - 1];
      top_prev = top;
      if (j == jc) {
        if (gck >= 0) {
          T* dst = ck + static_cast<long long>(gck) * RL * lanes + l;
#pragma unroll
          for (int r = 0; r < RL; ++r) dst[r * lanes] = u[r];
        }
        jc += K;
        --gck;
      }
    }
  }

  // ---- reverse, lane l at column Q - s, K-column segments ----------------
  const T g = gbar[blockIdx.x] * a.scale;
  T* dst = out + blockIdx.x * pair;
  T mu_prev[RL], acc[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) mu_prev[r] = acc[r] = T(0);
  T below_prev = T(0), first = T(0);
  const int f = 1 << o;
  for (int seg = 0; seg < segments; ++seg) {
    // recompute the lane's rows over columns c0 .. c0 + K: uu[k][r] is
    // u[row0 + r][c0 + k], row 0 of it the lane above's last row
    const int c0 = Q - (seg + 1) * K;
    T uu[K + 1][RL + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      const int col = c0 + k;
      uu[k][0] = live && l > 0 && col >= 1 && col <= C
                     ? bnd[col * lanes + l] : T(1);
    }
    const T* src = ck + static_cast<long long>(seg) * RL * lanes + l;
#pragma unroll
    for (int r = 1; r <= RL; ++r)
      uu[0][r] = live && c0 >= 1 && c0 <= C ? src[(r - 1) * lanes] : T(1);
#pragma unroll
    for (int k = 1; k <= K; ++k) {
      const int col = c0 + k;
      const bool in = live && col >= 1 && col <= C;
#pragma unroll
      for (int r = 1; r <= RL; ++r)
        uu[k][r] = in ? goursat_cell(uu[k - 1][r], uu[k][r - 1],
                                     uu[k - 1][r - 1], cell_a(r - 1, col - 1))
                      : T(1);
    }
    // the adjoint down the segment, column c0 + K - t at step t
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const T sent = __shfl_down_sync(kFull, first, 1);
      const T below = l + 1 < lanes ? sent : T(0);
      const int c = c0 + K - t;
      const int k = K - t;  // static once the loop is unrolled
      if (live && c >= 1 && c <= C) {
        T mb = below, mbp = below_prev;  // μ[i+1][c], μ[i+1][c+1]
#pragma unroll
        for (int r = RL - 1; r >= 0; --r) {
          const int i = row0 + r + 1;
          T mu = T(0);
          if (i == R && c == C) {
            mu = T(1);
          } else if (i <= R) {
            if (i < R && c < C) mu -= mbp;
            if (c < C) mu += mu_prev[r] * (T(1) + T(0.5) * cell_a(r, c));
            if (i < R) mu += mb * (T(1) + T(0.5) * cell_a(r + 1, c - 1));
          }
          acc[r] += mu * (uu[k - 1][r + 1] + uu[k][r]) * T(0.5);
          mbp = mu_prev[r];
          mb = mu;
          mu_prev[r] = mu;
        }
        first = mu_prev[0];
        if (((c - 1) & (f - 1)) == 0) {
          // unrefined column (c - 1) >> o is done: add each unrefined
          // row's 2^o refined rows in a fixed tree, write it once
#pragma unroll
          for (int lev = 0; (1 << lev) < RL; ++lev)
            if ((1 << lev) < f) {
#pragma unroll
              for (int r = 0; r + (1 << lev) < RL; r += 2 << lev)
                acc[r] += acc[r + (1 << lev)];
            }
#pragma unroll
          for (int r = 0; r < RL; ++r) {
            if ((r & (f - 1)) == 0 && row0 + r < R)
              dst[a.offset(row0 + r, c - 1)] = acc[r] * g;
            acc[r] = T(0);
          }
        }
      }
      below_prev = below;
    }
  }
}

template <typename T, int RL>
cudaError_t launch_warp(const void* inc, const void* gbar, void* out, int B,
                        int Su, int Tu, int o, cudaStream_t stream) {
  constexpr int K = sizeof(T) == 4 || RL == 2 ? 16 : 8;
  int R, C;
  swept_sides(Su, Tu, o, R, C);
  const int lanes = (R + RL - 1) / RL;
  const int segments = (C + lanes - 1 + K - 1) / K;
  size_t bytes =
      sizeof(T) * static_cast<size_t>(lanes) * (C + 1 + segments * RL);
  if (lanes > 32 || RL < (1 << o) || bytes > kWarpSmem)
    return cudaErrorInvalidValue;
  // the increments too, where they fit the warp's budget
  const size_t staged = sizeof(T) * static_cast<size_t>(Su) * Tu;
  const int stage = bytes + staged <= kWarpSmem;
  if (stage) bytes += staged;
  goursat_grad_warp_kernel<T, RL, K><<<B, 32, bytes, stream>>>(
      static_cast<const T*>(inc), static_cast<const T*>(gbar),
      static_cast<T*>(out), Su, Tu, o, lanes, segments, stage);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_lane_rows(int RL, const void* inc, const void* gbar,
                         void* out, int B, int Su, int Tu, int o,
                         cudaStream_t s) {
  switch (RL) {
    case 2: return launch_warp<T, 2>(inc, gbar, out, B, Su, Tu, o, s);
    case 4: return launch_warp<T, 4>(inc, gbar, out, B, Su, Tu, o, s);
    case 8: return launch_warp<T, 8>(inc, gbar, out, B, Su, Tu, o, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* inc, const void* gbar, void* out, void* work,
                   int B, int Su, int Tu, int o, int store_global,
                   cudaStream_t stream) {
  int R, C;
  swept_sides(Su, Tu, o, R, C);
  size_t bytes = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  if (!store_global) bytes += static_cast<size_t>(R + 1) * (C + 1) * sizeof(T);
  const size_t block = static_cast<size_t>(Su) * Tu * sizeof(T);
  const int stage = bytes + block <= kSmemCap;
  if (stage) bytes += block;
  if (bytes > kSmemCap) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(goursat_grad_kernel<T>, bytes);
  if (e != cudaSuccess) return e;
  goursat_grad_kernel<T><<<B, goursat_threads(R), bytes, stream>>>(
      static_cast<const T*>(inc), static_cast<const T*>(gbar),
      static_cast<T*>(out), static_cast<T*>(work), Su, Tu, o, store_global,
      stage);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// inc [B, Su, Tu], gbar [B] contiguous -> out [B, Su, Tu] = ḡ ·
// ∂u(Su 2^o, Tu 2^o)/∂inc, every out cell written. RL: the warp design's
// refined rows a lane (the wrapper's warp_plan; work unused), or 0 for the
// block design: work [B, ustore + Su Tu 2^o], ustore = (R+C+1)(R+1) when
// store_global (the wrapper's grad_workspace_elems), else 0 and the u
// store in shared memory. Returns cudaGetLastError() after the launch.
int gpsig_goursat_grad(const void* inc, const void* gbar, void* out,
                       void* work, int B, int Su, int Tu, int o, int RL,
                       int store_global, int f64, void* stream) {
  if (B < 1 || !refined_fits(Su, Tu, o)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (RL)
    return f64 ? by_lane_rows<double>(RL, inc, gbar, out, B, Su, Tu, o, s)
               : by_lane_rows<float>(RL, inc, gbar, out, B, Su, Tu, o, s);
  return f64 ? launch<double>(inc, gbar, out, work, B, Su, Tu, o,
                              store_global, s)
             : launch<float>(inc, gbar, out, work, B, Su, Tu, o,
                             store_global, s);
}

}  // extern "C"
