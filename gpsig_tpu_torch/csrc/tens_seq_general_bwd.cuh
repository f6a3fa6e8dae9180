// Backward of the general inducing-tensor-vs-sequence levels (Kuf), for
// Hopper (sm_90a): any order, difference True or False, increments or not,
// linear / RBF / poly<K> / cosine base, any L and any d.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/tens_seq_general.py:
// _tsg_bwd_kernel (entry point tens_seq_general_bwd_pallas): given Z
// [T, F(, 2), d], X [N, L, d] and the cotangents g [nl + 1, T, N] of the
// forward of tens_seq_general.cu, it returns Z̄ with Z's shape and X̄
// [N, L, d], the VJP of the plain version fused_tens_seq_general_levels_ref
// (_xla_reference_tens_seq_general), num_levels <= 7, RBF exponent
// unclamped. A Poly offset is a constant channel (z_extra = c), so its
// gradient is Z̄'s last channel.
//
// Math. Per (t, n) and level m (factor rows off .. off + m - 1, which no
// other level reads) the forward runs stages a = 0..m-1 at each DP point j
// with R_m = min(p, m) run-length states (tens_seq_general.cu):
//   E^(0) = [U_off],  E^(a)[0] = U_{off+a} P_{a-1},
//   E^(a)[r] = U_{off+a}/(r+1) E^(a-1)[r-1],
// P_{a-1}(j) = sum over j' < j of sum_r E^(a-1)[r](j') (an exclusive prefix
// along time), and k_m sums the last stage. With w_m = g[m], descending a:
//   Ē^(m-1)[r] = w_m,
//   Ū_{off+a} = Ē^(a)[0] P_{a-1} + sum_{r>=1} Ē^(a)[r] E^(a-1)[r-1]/(r+1),
//   Q_a(j) = sum over j' > j of U_{off+a} Ē^(a)[0] (an exclusive suffix),
//   Ē^(a-1)[r] = Q_a + U_{off+a}/(r+2) Ē^(a)[r+1],   Ū_off = Ē^(0)[0].
// Then ḡ_f(i) = Ū_f(i-1) - Ū_f(i) at sequence point i (difference: U(j) =
// g(j+1) - g(j); Ū(-1) = Ū(rows) = 0) or Ū_f(i), and through each factor
// point's activation and accumulator: u = ±ḡ dk/dacc (minus for a pair's
// first point under increments),
//   Z̄_f2 = sum u x_i (- z_f2 sum u),  X̄_i = sum_f2 u z_f2 (- x_i sum u).
//
// Design. One warp takes a pair (t, n): its 32 lanes spread the pair's time
// axis, R = 2 DP points a lane, so a chunk of 64 points; the lanes walk the
// sequence chunk by chunk, any L. At each chunk, level by level (kuf_level:
// inlined into each (NL, P) kernel in float32, one out-of-line copy a level
// and order shared by every kernel in float64; this header is compiled per
// dtype by tens_seq_general_bwd.cu and tens_seq_general_bwd_f64.cu), every
// lane evaluates its points' factor values and derivatives at once (one
// branch on the kind for the level's batch), and the DP's running sums become
// warp scans: an exclusive prefix scan per forward stage (P), an exclusive
// suffix scan per reverse stage (Q), each with a carry from chunk to chunk.
// Pass 1 (more than one chunk only) runs the forward stages over every chunk
// but the last, to the last chunk's start carries; pass 2 walks the chunks
// backwards, rebuilding each chunk's start carries by subtraction (exactly 0
// at the first chunk), so nothing of size O(L) is kept. Ū at the next chunk's
// first point is carried for ḡ. A lane evaluates its R points and the one
// before them (R + 1 slots), so U needs no neighbour; it owns the later R for
// the chain (and the pair's point 0, lane 0 of the first chunk, with
// difference). The chain adds each lane's sums over its points into its own
// column of partial sums: Z̄ (F2 (d + 1) values, summed over every pair the
// lane takes) and X̄ of its points (summed over the levels, added atomically
// into X̄ after the chunk, across the tensors). A block is a tensor against W
// warps × ppw pairs; at its end the block's columns are summed and added
// atomically into Z̄, one atomic per value per block. x and z are read from
// global memory (cached; z warp-uniform), any d. The columns live in shared
// memory where the block's fit (ops/cuda/plan.py's kuf_bwd_plan); past that
// in a device workspace, one region per block, and the grid strides over the
// work items. Z̄ and X̄ are summed with atomics: not bitwise repeatable.
//
// What bounds it on the H100. Per (t, n): L F2 base kernels with their
// derivatives (2d + 2 flops and an exp, or a cos and a sin, each), the
// forward and reverse stages and their scans, L F2 (2d + 1) chain FMAs;
// with more than one chunk a second evaluation of the first chunks' base
// kernels. At the training shape (T = 500, N = 50, L = 50, F2 = 30, d = 2)
// that is 37.5M exps against well under 1 MB of inputs and outputs: bound by
// the FMA and exp pipes (and the scans' shuffles), not by memory.

#pragma once

#include "common.cuh"

namespace gpsig {
namespace kuf_bwd {

constexpr int kLanes = 32;        // plan.KUF_LANES
constexpr int kPoints = 2;        // plan.KUF_POINTS
constexpr int kSlots = kPoints + 1;
constexpr int kChunk = kLanes * kPoints;
constexpr int kMaxThreads = 128;  // four warps

// states alive at stage a of a level with Rm run lengths
__host__ __device__ constexpr int live_states(int Rm, int a) {
  return Rm < a + 1 ? Rm : a + 1;
}

// One pair (t, n) as one warp walks it: what the level functions read, and
// the chunk's sums of u over the levels (su). Held in the kernel's local
// memory; each level function loads what it needs once.
template <typename T>
struct PairState {
  const T* zt;   // the tensor's factor points [F2][d]
  const T* nzs;  // their -|z|^2/2 (shared)
  const T* xn;   // the sequence [L][d]
  T* cols;       // this lane's column: Z̄ sums [F2][d + 1], X̄ [kSlots][d]
  int ct;        // the columns' stride (threads of the block)
  int L, d, rows, kind, degree, lane, nch, zsums, c;
  bool inc, diff, norms;
  T su[kSlots];
};

// The chunk's slots: the sequence point of slot q (clamped for reading) and
// whether the lane owns it for the chain.
template <typename T>
__device__ __forceinline__ int slot_point(const PairState<T>& p, int q) {
  return p.c * kChunk + p.lane * kPoints + q - (p.diff ? 0 : 1);
}

// Level M (p = PM run lengths at most) of the chunk p.c. Pass 1
// (forward = true) runs the forward stages from the carries and adds the
// chunk's totals to them; pass 2 rebuilds the chunk's start carries, runs
// the stages, the adjoints with the reverse carries, ḡ with the next
// chunk's first Ū, and the chain into the lane's column. carry, rcarry
// and ubn point to the level's own carries and Ū. The kernel calls it from
// one place for both passes. GPSIG_KUF_LEVEL says how: inlined into each
// (NL, P) kernel (float32: the scans of one level overlap the next's work,
// 0.45 against 0.66 ms out of line at the training shape), or out of line,
// one copy a (T, M, PM) shared by every kernel (float64: a fifth of the
// code to compile).
#ifndef GPSIG_KUF_LEVEL
#define GPSIG_KUF_LEVEL __noinline__
#endif

template <typename T, int M, int PM>
__device__ GPSIG_KUF_LEVEL void kuf_level(PairState<T>& p, T w, T* carry,
                                          T* rcarry, T* ubn, bool forward) {
  if (M == 1 && forward) return;  // level 1 has no carries
  constexpr int off = M * (M - 1) / 2;
  const int L = p.L, d = p.d, lane = p.lane, c = p.c;
  const bool inc = p.inc, diff = p.diff, norms = p.norms;
  const T* zt = p.zt;
  const T* xs[kSlots];
  T nx[kSlots], live[kPoints];
  bool own[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int s = slot_point(p, q);
    const int sc = s < 0 ? 0 : (s > L - 1 ? L - 1 : s);
    xs[q] = p.xn + static_cast<long long>(sc) * d;
    own[q] = q > 0 ? s <= L - 1 : (diff && c == 0 && lane == 0);
    T ss = T(0);
    if (norms)
      for (int k = 0; k < d; ++k) ss += xs[q][k] * xs[q][k];
    nx[q] = T(-0.5) * ss;
  }
#pragma unroll
  for (int r = 0; r < kPoints; ++r)
    live[r] = c * kChunk + lane * kPoints + r < p.rows ? T(1) : T(0);

  // the factor values g at the slots, each factor point's signed
  // derivative dk (local memory: read once more by the chain), and U
  T g[M][kSlots], dk[2][M][kSlots];
#pragma unroll
  for (int f = 0; f < M; ++f)
#pragma unroll
    for (int q = 0; q < kSlots; ++q) g[f][q] = T(0);
#pragma unroll 1
  for (int h = 0; h < (inc ? 2 : 1); ++h) {
    T a[M * kSlots], gr[M * kSlots];
#pragma unroll
    for (int f = 0; f < M; ++f) {
      const int fp = inc ? 2 * (off + f) + h : off + f;
      const T nz = p.nzs[fp];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) a[f * kSlots + q] = nz + nx[q];
    }
    for (int k = 0; k < d; ++k) {
      T xv[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) xv[q] = xs[q][k];
#pragma unroll
      for (int f = 0; f < M; ++f) {
        const int fp = inc ? 2 * (off + f) + h : off + f;
        const T z = zt[fp * d + k];
#pragma unroll
        for (int q = 0; q < kSlots; ++q) a[f * kSlots + q] += z * xv[q];
      }
    }
    kuf_activate_grad(a, gr, p.kind, p.degree);
    const T sign = inc && h == 0 ? T(-1) : T(1);
#pragma unroll
    for (int f = 0; f < M; ++f)
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        g[f][q] += sign * a[f * kSlots + q];
        dk[h][f][q] = sign * gr[f * kSlots + q];
      }
  }
  T U[M][kPoints];
#pragma unroll
  for (int f = 0; f < M; ++f)
#pragma unroll
    for (int r = 0; r < kPoints; ++r)
      U[f][r] = (g[f][r + 1] - (diff ? g[f][r] : T(0))) * live[r];

  // the forward stages E[a][s] and prefixes Pre[a - 1] = P_{a-1}; pass 1
  // starts each stage from its carry and adds the chunk's total, pass 2
  // rebuilds the start from the carry at the next chunk's start by
  // subtraction (0 at the first chunk, the carry itself at the last)
  T E[M][PM][kPoints], Pre[M][kPoints];
#pragma unroll
  for (int r = 0; r < kPoints; ++r) E[0][0][r] = U[0][r];
#pragma unroll
  for (int a = 1; a < M; ++a) {
    const int lp = live_states(PM, a - 1), ln = live_states(PM, a);
    T tot[kPoints], ex[kPoints];
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      tot[r] = T(0);
#pragma unroll
      for (int s = 0; s < PM; ++s)
        if (s < lp) tot[r] += E[a - 1][s][r];
    }
    const T total = chunk_prefix(tot, ex, lane);
    T start;
    if (forward) {
      start = carry[a - 1];
      carry[a - 1] = start + total;
    } else {
      const T cr = carry[a - 1];
      start = c == 0 ? T(0) : (c == p.nch - 1 ? cr : cr - total);
      carry[a - 1] = start;
    }
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      Pre[a - 1][r] = start + ex[r];
      E[a][0][r] = U[a][r] * Pre[a - 1][r];
#pragma unroll
      for (int s = 1; s < PM; ++s)
        if (s < ln)
          E[a][s][r] = U[a][r] * (T(1) / T(s + 1)) * E[a - 1][s - 1][r];
    }
  }
  if (forward) return;

  // the adjoints, descending the stages, with the reverse carries
  T eb[PM][kPoints], ub[M][kPoints];
#pragma unroll
  for (int s = 0; s < PM; ++s)
#pragma unroll
    for (int r = 0; r < kPoints; ++r)
      eb[s][r] = s < live_states(PM, M - 1) ? w : T(0);
#pragma unroll
  for (int a = M - 1; a >= 1; --a) {
    const int ln = live_states(PM, a), lp = live_states(PM, a - 1);
    T v[kPoints], ex[kPoints];
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      T b = eb[0][r] * Pre[a - 1][r];
#pragma unroll
      for (int s = 1; s < PM; ++s)
        if (s < ln) b += eb[s][r] * E[a - 1][s - 1][r] * (T(1) / T(s + 1));
      ub[a][r] = b;
      v[r] = U[a][r] * eb[0][r];
    }
    const T total = chunk_suffix(v, ex, lane);
    const T rc = rcarry[a - 1];
    rcarry[a - 1] = rc + total;
    T ebn[PM][kPoints];
#pragma unroll
    for (int s = 0; s < PM; ++s)
#pragma unroll
      for (int r = 0; r < kPoints; ++r) {
        T e = T(0);
        if (s < lp) {
          e = rc + ex[r];
          if (s + 1 < ln) e += U[a][r] * (T(1) / T(s + 2)) * eb[s + 1][r];
        }
        ebn[s][r] = e;
      }
#pragma unroll
    for (int s = 0; s < PM; ++s)
#pragma unroll
      for (int r = 0; r < kPoints; ++r) eb[s][r] = ebn[s][r];
  }
#pragma unroll
  for (int r = 0; r < kPoints; ++r) ub[0][r] = eb[0][r];

  // ḡ at the slots: Ū of the point after each lane's last from the next
  // lane, or at the chunk's end from the next chunk (ubn)
  T gb[M][kSlots];
#pragma unroll
  for (int f = 0; f < M; ++f) {
    T ext[kSlots];
#pragma unroll
    for (int r = 0; r < kPoints; ++r) ext[r] = ub[f][r] * live[r];
    T nxt = __shfl_down_sync(kFull, ext[0], 1);
    if (lane == kLanes - 1) nxt = ubn[f];
    ubn[f] = __shfl_sync(kFull, ext[0], 0);
    ext[kPoints] = nxt;
    gb[f][0] = diff ? -ext[0] : T(0);
#pragma unroll
    for (int q = 1; q < kSlots; ++q)
      gb[f][q] = diff ? ext[q - 1] - ext[q] : ext[q - 1];
  }

  // the chain into the lane's column: Z̄ sums of each factor point over the
  // lane's owned slots, X̄ of each slot over the level's factor points
  T* cols = p.cols;
  const int ct = p.ct, zsums = p.zsums;
  T su[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) su[q] = T(0);
#pragma unroll 1
  for (int h = 0; h < (inc ? 2 : 1); ++h) {
    T u[M][kSlots];
#pragma unroll
    for (int f = 0; f < M; ++f) {
      const int fp = inc ? 2 * (off + f) + h : off + f;
      T s = T(0);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        u[f][q] = own[q] ? gb[f][q] * dk[h][f][q] : T(0);
        s += u[f][q];
        su[q] += u[f][q];
      }
      cols[static_cast<long long>(fp * (d + 1) + d) * ct] += s;
    }
    for (int k = 0; k < d; ++k) {
      T xv[kSlots], xp[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        xv[q] = xs[q][k];
        xp[q] = T(0);
      }
#pragma unroll
      for (int f = 0; f < M; ++f) {
        const int fp = inc ? 2 * (off + f) + h : off + f;
        const T z = zt[fp * d + k];
        T s = T(0);
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          s += u[f][q] * xv[q];
          xp[q] += u[f][q] * z;
        }
        cols[static_cast<long long>(fp * (d + 1) + k) * ct] += s;
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
        cols[static_cast<long long>(zsums + q * d + k) * ct] += xp[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kSlots; ++q) p.su[q] += su[q];
}

// X̄ of the chunk's owned points, from the lane's column, into X̄ [N, L, d]
// (atomically: every tensor adds to it).
template <typename T>
__device__ __forceinline__ void flush_xbar(PairState<T>& p, T* xbar_n) {
  for (int q = 0; q < kSlots; ++q) {
    const int s = slot_point(p, q);
    const bool own = q > 0 ? s <= p.L - 1
                           : (p.diff && p.c == 0 && p.lane == 0);
    if (!own) continue;
    const T* x = p.xn + static_cast<long long>(s) * p.d;
    for (int k = 0; k < p.d; ++k) {
      T* cp = p.cols + static_cast<long long>(p.zsums + q * p.d + k) * p.ct;
      T v = *cp;
      *cp = T(0);
      if (p.norms) v -= x[k] * p.su[q];
      atomicAdd(xbar_n + static_cast<long long>(s) * p.d + k, v);
    }
  }
}

template <typename T, int NL, int P>
__global__ void __launch_bounds__(kMaxThreads)
tsg_bwd_kernel(const T* __restrict__ Z, const T* __restrict__ X,
               const T* __restrict__ g, T* __restrict__ Zbar,
               T* __restrict__ Xbar, T* __restrict__ work, int Tn, int N,
               int L, int d, int kind, int degree, int inc, int diff,
               int ppw, int items, int staged) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  const int F2 = inc ? 2 * F : F;
  const bool norms = kind_norms(kind);
  const int nt = blockDim.x;
  const int warps = nt / kLanes;
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int zsums = F2 * (d + 1);
  const int C = zsums + kSlots * d;  // a column's values
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* nzs = reinterpret_cast<T*>(smem_raw);  // [F2]
  T* cols = staged ? nzs + F2
                   : work + static_cast<long long>(blockIdx.x) * C * nt;
  const int per_item = warps * ppw;
  const int nbt = (N + per_item - 1) / per_item;
  const int rows = diff ? L - 1 : L;
  const int nch = (rows + kChunk - 1) / kChunk;
  const long long plane = static_cast<long long>(Tn) * N;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int t = item / nbt;
    const int nb = item - t * nbt;
    const T* zt = Z + static_cast<long long>(t) * F2 * d;
    __syncthreads();  // the previous item's sums are read
    for (int k = 0; k < C; ++k)
      cols[static_cast<long long>(k) * nt + tid] = T(0);
    for (int f = tid; f < F2; f += nt) {
      T s = T(0);
      for (int k = 0; k < d; ++k) s += zt[f * d + k] * zt[f * d + k];
      nzs[f] = norms ? T(-0.5) * s : T(0);
    }
    __syncthreads();

    for (int k = 0; k < ppw; ++k) {
      const int n = nb * per_item + k * warps + warp;
      if (n >= N) break;  // warp-uniform
      PairState<T> p;
      p.zt = zt;
      p.nzs = nzs;
      p.xn = X + static_cast<long long>(n) * L * d;
      p.cols = cols + tid;
      p.ct = nt;
      p.L = L;
      p.d = d;
      p.rows = rows;
      p.kind = kind;
      p.degree = degree;
      p.lane = tid % kLanes;
      p.nch = nch;
      p.zsums = zsums;
      p.inc = inc != 0;
      p.diff = diff != 0;
      p.norms = norms;
      T w[NL], carry[NS], rcarry[NS], ubn[F];
#pragma unroll
      for (int m = 0; m < NL; ++m)
        w[m] = g[(m + 1) * plane + static_cast<long long>(t) * N + n];
#pragma unroll
      for (int s = 0; s < NS; ++s) carry[s] = rcarry[s] = T(0);
#pragma unroll
      for (int f = 0; f < F; ++f) ubn[f] = T(0);
      bool forward = true;
      auto level = [&](auto lv) {
        constexpr int M = decltype(lv)::value;
        constexpr int off = M * (M - 1) / 2, soff = (M - 1) * (M - 2) / 2;
        kuf_level<T, M, (P < M ? P : M)>(p, w[M - 1], carry + soff,
                                         rcarry + soff, ubn + off, forward);
      };
      // pass 1 over chunks 0 .. nch - 2, then pass 2 from nch - 1 down to
      // 0, through one call of the levels
      for (int it = 0; it < 2 * nch - 1; ++it) {
        forward = it < nch - 1;
        p.c = forward ? it : 2 * nch - 2 - it;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) p.su[q] = T(0);
        each_level<1, NL>(level);
        if (!forward) flush_xbar(p, Xbar + static_cast<long long>(n) * L * d);
      }
    }

    // Z̄_t: the block's columns summed (rotated: no bank conflicts), then
    // one atomic a value across the blocks
    __syncthreads();
    T* zb = Zbar + static_cast<long long>(t) * F2 * d;
    for (int q = tid; q < F2 * d; q += nt) {
      const int fp = q / d, k = q - fp * d;
      const T* rs = cols + static_cast<long long>(fp * (d + 1) + k) * nt;
      const T* ru = cols + static_cast<long long>(fp * (d + 1) + d) * nt;
      T s = T(0), su = T(0);
      for (int j = 0; j < nt; ++j) {
        const int l = (j + q) & (nt - 1);
        s += rs[l];
        su += ru[l];
      }
      if (norms) s -= zt[q] * su;
      atomicAdd(zb + q, s);
    }
  }
}

template <typename T, int NL, int P>
cudaError_t launch(const void* Z, const void* X, const void* g, void* Zbar,
                   void* Xbar, void* work, int Tn, int N, int L, int d,
                   int kind, int degree, int inc, int diff, int threads,
                   int ppw, int items, int blocks, int staged,
                   cudaStream_t stream) {
  if constexpr (P > NL) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int F = NL * (NL + 1) / 2;
    const int F2 = (inc ? 2 : 1) * F;
    const size_t C = static_cast<size_t>(F2) * (d + 1) + kSlots * d;
    const size_t smem =
        sizeof(T) * (F2 + (staged ? C * threads : 0));
    if ((threads != 32 && threads != 64 && threads != 128) ||
        ppw < 1 || items < 1 || blocks < 1 || blocks > items ||
        (staged && blocks != items) || (!staged && !work) ||
        smem > kSegSmemBytes)
      return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(tsg_bwd_kernel<T, NL, P>, smem);
    if (e != cudaSuccess) return e;
    tsg_bwd_kernel<T, NL, P><<<blocks, threads, smem, stream>>>(
        static_cast<const T*>(Z), static_cast<const T*>(X),
        static_cast<const T*>(g), static_cast<T*>(Zbar), static_cast<T*>(Xbar),
        static_cast<T*>(work), Tn, N, L, d, kind, degree, inc, diff, ppw,
        items, staged);
    return cudaGetLastError();
  }
}

template <typename T, int NL>
cudaError_t by_order(int P, const void* Z, const void* X, const void* g,
                     void* Zbar, void* Xbar, void* work, int Tn, int N, int L,
                     int d, int kind, int degree, int inc, int diff,
                     int threads, int ppw, int items, int blocks, int staged,
                     cudaStream_t s) {
#define GPSIG_P(p)                                                          \
  case p:                                                                   \
    return launch<T, NL, p>(Z, X, g, Zbar, Xbar, work, Tn, N, L, d, kind,   \
                            degree, inc, diff, threads, ppw, items, blocks, \
                            staged, s);
  switch (P) {
    GPSIG_P(1) GPSIG_P(2) GPSIG_P(3) GPSIG_P(4) GPSIG_P(5) GPSIG_P(6)
    GPSIG_P(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_P
}

template <typename T>
cudaError_t by_levels(int nl, int P, const void* Z, const void* X,
                      const void* g, void* Zbar, void* Xbar, void* work,
                      int Tn, int N, int L, int d, int kind, int degree,
                      int inc, int diff, int threads, int ppw, int items,
                      int blocks, int staged, cudaStream_t s) {
#define GPSIG_NL(q)                                                          \
  case q:                                                                    \
    return by_order<T, q>(P, Z, X, g, Zbar, Xbar, work, Tn, N, L, d, kind,   \
                          degree, inc, diff, threads, ppw, items, blocks,    \
                          staged, s);
  switch (nl) {
    GPSIG_NL(1) GPSIG_NL(2) GPSIG_NL(3) GPSIG_NL(4) GPSIG_NL(5) GPSIG_NL(6)
    GPSIG_NL(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_NL
}

extern template cudaError_t by_levels<float>(
    int, int, const void*, const void*, const void*, void*, void*, void*, int,
    int, int, int, int, int, int, int, int, int, int, int, int, cudaStream_t);
extern template cudaError_t by_levels<double>(
    int, int, const void*, const void*, const void*, void*, void*, void*, int,
    int, int, int, int, int, int, int, int, int, int, int, int, cudaStream_t);

}  // namespace kuf_bwd
}  // namespace gpsig
