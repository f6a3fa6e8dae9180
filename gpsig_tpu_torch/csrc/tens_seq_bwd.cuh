// Backward of the fused inducing-tensor-vs-sequence levels (Kuf) at order
// 1, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/tens_seq.py:
// _tens_seq_bwd_kernel (entry point tens_seq_bwd_pallas): given Z [T, F, d]
// or [T, F, 2, d] (pre-scaled), X [N, L, d] and the cotangents g
// [nl + 1, T, N] of out[m, t, n] = <z_t^(m), S_m(x_n)> (tens_seq.cuh), it
// returns Z̄ with Z's shape and X̄ [N, L, d]: the VJP of the plain version
// fused_tens_seq_levels_ref (_xla_reference_tens_seq in the JAX package),
// order 1, difference=True, RBF or Linear base, num_levels <= 7, d <= 3
// (past that the general backward of tens_seq_general_bwd.cuh at order 1:
// ops/cuda/plan.py's kuf_bwd_plan), RBF distance unclamped.
//
// Math (tens_seq.py:263-278). Per (t, n) the forward takes the factor base
// kernels g_f(i) = k(z_f, x_i) (k(z_b, x_i) - k(z_a, x_i) with
// increments), their differences U_f(j) = g_f(j+1) - g_f(j) at the DP
// points j = 0..L-2, and per level m (factor rows off .. off + m - 1, which
// no other level reads) the stages E^(0) = U_off, E^(a) = U_{off+a} P_{a-1},
// where P_{a-1}(j) = sum_{j' < j} E^(a-1)(j') is an exclusive prefix along
// time; k_m = sum_j E^(m-1)(j). With w_m = g[m], descending a:
//     Ē^(m-1)(j) = w_m,   Ū_{off+a}(j) = Ē^(a)(j) P_{a-1}(j),
//     Ē^(a-1)(j) = sum_{j' > j} U_{off+a}(j') Ē^(a)(j')  (an exclusive
//     suffix),   Ū_off = Ē^(0),
// then ḡ_f(i) = Ū_f(i-1) - Ū_f(i) at sequence point i (Ū(-1) = Ū(L-1) = 0)
// and the base kernel's derivatives: with u = ḡ k (RBF) or ḡ (Linear),
// signed -1 for a pair's first point under increments,
//     Z̄_f = sum_i u x_i - z_f sum_i u,   X̄_i = sum_f u z_f - x_i sum_f u
// (second terms RBF only). At order 1 every stage has one state, so this is
// tens_seq_general_bwd.cuh's recursion with its run lengths gone.
//
// Design. One warp takes a pair (t, n): its 32 lanes spread the pair's time
// axis, kPoints = 2 DP points a lane, and walk it in chunks of 64 points,
// any L (4 points a lane, chunks of 128, took 1.39x the time at L = 50 for
// their registers and gained 3% at L = 150: kuf_variants.py on an H100 at
// 700 W). A lane evaluates its 2 points and the one before (3 slots), all
// F2 factor points of a level at once from the tensor's packed records
// (common.cuh's Rec4: one broadcast 16-byte shared load a factor point,
// x_i in registers), so U needs no neighbour; it owns the later 2 slots
// for the chain (and the pair's point 0, lane 0 of the first chunk). The
// order-1 DP's running sums are warp scans: an exclusive prefix a forward
// stage, an exclusive suffix a reverse stage, each with a carry from chunk
// to chunk, all in registers, the levels one at a time (a level's scans
// overlap the next level's evaluation: everything is inlined). Pass 1 (more
// than one chunk only) runs the forward stages over every chunk but the
// last, to the last chunk's start carries; pass 2 walks the chunks
// backwards, rebuilding each chunk's start carries by subtraction (exactly
// 0 at the first chunk), and carries Ū of the next chunk's first point for
// ḡ, so nothing of size O(L) is kept. The chain sums each factor point's
// Z̄ terms over the lane's slots (sum u x_c, sum u) and adds them to the
// lane's column in shared memory ([F2][4][threads]: a warp's four adds of
// a factor point go to four rows of consecutive words, no bank conflict);
// X̄ of the lane's owned slots is summed over the
// levels in registers and added atomically into X̄ [N, L, d] (every tensor
// adds to it) after the chunk: a pair's points lie together there, so a
// warp's atomics are contiguous and X needs no transpose. A block is one
// tensor against its two warps x ppw pairs (four warps a block took 1.08x
// the time at the training shape and 1.10x at L = 150, as above); at
// its end the block's columns are
// summed and added atomically into Z̄, one atomic a value a block. In
// float32 log2(e) is folded into the staged records (common.cuh's kuf_exp);
// X̄'s z terms are scaled back once a flush. Z̄ and X̄ are summed with
// atomics: not bitwise repeatable. This header is compiled per dtype by
// tens_seq_bwd.cu and tens_seq_bwd_f64.cu.
//
// What bounds it on the H100. Per (t, n): 1.5 (L - 1) F2 base kernels
// (2d + 2 flops and an exp each; one chunk, more the first chunks' again in
// pass 1), 2 (F - nl) scans a chunk (five shuffles and adds each), and
// L F2 (2d + 2) chain FMAs; at the training shape (T = 500, N = 50, L = 50,
// F2 = 30, d = 3) that is 56M exps against well under 1 MB of inputs and
// outputs: bound by the exp and FMA pipes and by the scans' latency, not by
// memory.

#pragma once

#include "common.cuh"

namespace gpsig {
namespace kuf1_bwd {

constexpr int kLanes = 32;     // plan.KUF_LANES
constexpr int kPoints = 2;     // plan.KUF_POINTS
constexpr int kMaxD = 3;       // plan.KUF_TUNED_MAX_D
constexpr int kThreads = 64;   // plan.KUF_TUNED_BWD_THREADS: two warps

template <typename T, int NL, bool INC>
__global__ void __launch_bounds__(kThreads)
ts_bwd_kernel(const T* __restrict__ Z, const T* __restrict__ X,
              const T* __restrict__ g, T* __restrict__ Zbar,
              T* __restrict__ Xbar, int Tn, int N, int L, int d, int rbf,
              int ppw) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int P = INC ? 2 : 1;  // points a factor
  constexpr int F2 = P * F;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  constexpr int KP = kPoints;
  constexpr int KS = KP + 1;       // slots a lane
  constexpr int CH = kLanes * KP;  // DP points a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Rec4<T>* zr = reinterpret_cast<Rec4<T>*>(smem_raw);  // [F2]
  // [F2][kMaxD + 1][nt]: each thread's Z̄ sums (sum u x_c, then sum u)
  T* cols = reinterpret_cast<T*>(zr + F2);
  constexpr int nt = kThreads;
  constexpr int warps = nt / kLanes;
  const int tid = threadIdx.x;
  const int warp = tid / kLanes, lane = tid % kLanes;
  const int per_item = warps * ppw;
  const int nbt = (N + per_item - 1) / per_item;
  const int t = blockIdx.x / nbt;
  const int nb = blockIdx.x - t * nbt;
  const T scale = rbf ? kuf_fold<T>() : T(1);
  const T* zg = Z + static_cast<long long>(t) * F2 * d;

  for (int f = tid; f < F2; f += nt) {
    Rec4<T> rec;
    T s = T(0);
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      const T v = c < d ? zg[f * d + c] : T(0);
      rec.v[c] = scale * v;
      s += v * v;
    }
    rec.v[kMaxD] = rbf ? T(-0.5) * scale * s : T(0);
    zr[f] = rec;
  }
  for (int k = 0; k < F2 * (kMaxD + 1); ++k) cols[k * nt + tid] = T(0);
  __syncthreads();

  const int rows = L - 1;
  const int nch = (rows + CH - 1) / CH;
  const long long plane = static_cast<long long>(Tn) * N;
  const T nscale = rbf ? T(-0.5) * scale : T(0);
  const T iscale = T(1) / scale;

  for (int k = 0; k < ppw; ++k) {
    const int n = nb * per_item + k * warps + warp;
    if (n >= N) break;  // warp-uniform
    const T* xn = X + static_cast<long long>(n) * L * d;
    T* xbn = Xbar + static_cast<long long>(n) * L * d;
    T w[NL], carry[NS], rcarry[NS], ubn[F];
#pragma unroll
    for (int m = 0; m < NL; ++m)
      w[m] = g[(m + 1) * plane + static_cast<long long>(t) * N + n];
#pragma unroll
    for (int s = 0; s < NS; ++s) carry[s] = rcarry[s] = T(0);
#pragma unroll
    for (int f = 0; f < F; ++f) ubn[f] = T(0);

    // pass 1 over chunks 0 .. nch - 2, then pass 2 from nch - 1 down to 0
    for (int it = 0; it < 2 * nch - 1; ++it) {
      const bool forward = it < nch - 1;
      const int c = forward ? it : 2 * nch - 2 - it;
      const int j0 = c * CH + lane * KP;  // the lane's first DP point
      // slot q is sequence point j0 + q (clamped for reading)
      T xs[KS][kMaxD], nx[KS], live[KP];
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const int s = min(j0 + q, L - 1);
#pragma unroll
        for (int cc = 0; cc < kMaxD; ++cc)
          xs[q][cc] = cc < d ? xn[static_cast<long long>(s) * d + cc] : T(0);
        nx[q] = nscale * (xs[q][0] * xs[q][0] + xs[q][1] * xs[q][1] +
                          xs[q][2] * xs[q][2]);
      }
#pragma unroll
      for (int r = 0; r < KP; ++r) live[r] = j0 + r < rows ? T(1) : T(0);
      const bool own0 = c == 0 && lane == 0;  // the pair's point 0
      // X̄ of the slots, summed over the levels: sum u z' and sum u
      T xb[KS][kMaxD], su[KS];
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        su[q] = T(0);
#pragma unroll
        for (int cc = 0; cc < kMaxD; ++cc) xb[q][cc] = T(0);
      }

      auto level = [&](auto lv) {
        constexpr int M = decltype(lv)::value;
        constexpr int off = M * (M - 1) / 2;        // first factor row
        constexpr int soff = (M - 1) * (M - 2) / 2;  // first carry
        if (M == 1 && forward) return;  // level 1 has no carries
        // the level's factor point values at the slots, and U
        T kv[M][P][KS];
#pragma unroll
        for (int f = 0; f < M; ++f)
#pragma unroll
          for (int h = 0; h < P; ++h) {
            const Rec4<T> z = zr[P * (off + f) + h];
#pragma unroll
            for (int q = 0; q < KS; ++q) {
              T acc = nx[q] + z.v[3];
              acc += z.v[0] * xs[q][0];
              acc += z.v[1] * xs[q][1];
              acc += z.v[2] * xs[q][2];
              kv[f][h][q] = acc;
            }
          }
        if (rbf) {
#pragma unroll
          for (int f = 0; f < M; ++f)
#pragma unroll
            for (int h = 0; h < P; ++h)
#pragma unroll
              for (int q = 0; q < KS; ++q) kv[f][h][q] = kuf_exp(kv[f][h][q]);
        }
        T U[M][KP];
#pragma unroll
        for (int f = 0; f < M; ++f)
#pragma unroll
          for (int r = 0; r < KP; ++r) {
            const T g1 = INC ? kv[f][1][r + 1] - kv[f][0][r + 1]
                             : kv[f][0][r + 1];
            const T g0 = INC ? kv[f][1][r] - kv[f][0][r] : kv[f][0][r];
            U[f][r] = (g1 - g0) * live[r];
          }

        // the forward stages: prefixes Pre[a - 1] = P_{a-1}; pass 1 starts
        // each from its carry and adds the chunk's total, pass 2 rebuilds
        // the start from the carry at the next chunk's start (0 at the
        // first chunk, the carry itself at the last)
        T Pre[M > 1 ? M - 1 : 1][KP], E[KP];
#pragma unroll
        for (int r = 0; r < KP; ++r) E[r] = U[0][r];
#pragma unroll
        for (int a = 1; a < M; ++a) {
          T ex[KP];
          const T total = chunk_prefix(E, ex, lane);
          T start;
          if (forward) {
            start = carry[soff + a - 1];
            carry[soff + a - 1] = start + total;
          } else {
            const T cr = carry[soff + a - 1];
            start = c == 0 ? T(0) : (c == nch - 1 ? cr : cr - total);
            carry[soff + a - 1] = start;
          }
#pragma unroll
          for (int r = 0; r < KP; ++r) {
            Pre[a - 1][r] = start + ex[r];
            E[r] = U[a][r] * Pre[a - 1][r];
          }
        }
        if (forward) return;

        // the adjoints, descending the stages, with the reverse carries
        T eb[KP], ub[M][KP];
#pragma unroll
        for (int r = 0; r < KP; ++r) eb[r] = w[M - 1];
#pragma unroll
        for (int a = M - 1; a >= 1; --a) {
          T v[KP], ex[KP];
#pragma unroll
          for (int r = 0; r < KP; ++r) {
            ub[a][r] = eb[r] * Pre[a - 1][r] * live[r];
            v[r] = U[a][r] * eb[r];
          }
          const T total = chunk_suffix(v, ex, lane);
          const T rc = rcarry[soff + a - 1];
          rcarry[soff + a - 1] = rc + total;
#pragma unroll
          for (int r = 0; r < KP; ++r) eb[r] = rc + ex[r];
        }
#pragma unroll
        for (int r = 0; r < KP; ++r) ub[0][r] = eb[r] * live[r];

        // ḡ at the owned slots: Ū of the point after each lane's last from
        // the next lane, or at the chunk's end from the next chunk (ubn)
        T gb[M][KS];
#pragma unroll
        for (int f = 0; f < M; ++f) {
          T nxt = __shfl_down_sync(kFull, ub[f][0], 1);
          if (lane == kLanes - 1) nxt = ubn[off + f];
          ubn[off + f] = __shfl_sync(kFull, ub[f][0], 0);
          gb[f][0] = own0 ? -ub[f][0] : T(0);
#pragma unroll
          for (int q = 1; q < KS; ++q)
            gb[f][q] = (ub[f][q - 1] - (q < KP ? ub[f][q] : nxt)) *
                       live[q - 1];
        }

        // the chain: each factor point's Z̄ terms over the slots into the
        // lane's column, X̄ of the slots in registers
#pragma unroll
        for (int f = 0; f < M; ++f)
#pragma unroll
          for (int h = 0; h < P; ++h) {
            const int fp = P * (off + f) + h;
            const T sign = INC && h == 0 ? T(-1) : T(1);
            const Rec4<T> z = zr[fp];
            T col[kMaxD + 1];
#pragma unroll
            for (int cc = 0; cc <= kMaxD; ++cc) col[cc] = T(0);
#pragma unroll
            for (int q = 0; q < KS; ++q) {
              const T u = sign * gb[f][q] * (rbf ? kv[f][h][q] : T(1));
#pragma unroll
              for (int cc = 0; cc < kMaxD; ++cc) {
                col[cc] += u * xs[q][cc];
                xb[q][cc] += u * z.v[cc];
              }
              col[kMaxD] += u;
              su[q] += u;
            }
            T* cp = cols + fp * (kMaxD + 1) * nt + tid;
#pragma unroll
            for (int cc = 0; cc <= kMaxD; ++cc) cp[cc * nt] += col[cc];
          }
      };
      each_level<1, NL>(level);

      // X̄ of the owned slots (z' = scale z in the records)
      if (!forward) {
#pragma unroll
        for (int q = 0; q < KS; ++q) {
          const bool own = q == 0 ? own0 : live[q - 1] != T(0);
          if (!own) continue;
          T* xp = xbn + static_cast<long long>(j0 + q) * d;
#pragma unroll
          for (int cc = 0; cc < kMaxD; ++cc)
            if (cc < d)
              atomicAdd(xp + cc, iscale * xb[q][cc] -
                                     (rbf ? xs[q][cc] * su[q] : T(0)));
        }
      }
    }
  }

  // Z̄_t: the block's columns summed (rotated: no bank conflicts), then one
  // atomic a value across the blocks
  __syncthreads();
  T* zb = Zbar + static_cast<long long>(t) * F2 * d;
  for (int fp = tid; fp < F2; fp += nt) {
    T s[kMaxD + 1];
#pragma unroll
    for (int cc = 0; cc <= kMaxD; ++cc) s[cc] = T(0);
    for (int j = 0; j < nt; ++j) {
      const int l = (j + fp) & (nt - 1);
#pragma unroll
      for (int cc = 0; cc <= kMaxD; ++cc)
        s[cc] += cols[(fp * (kMaxD + 1) + cc) * nt + l];
    }
#pragma unroll
    for (int cc = 0; cc < kMaxD; ++cc)
      if (cc < d)
        atomicAdd(zb + fp * d + cc,
                  s[cc] - (rbf ? zg[fp * d + cc] * s[kMaxD] : T(0)));
  }
}

template <typename T, int NL, bool INC>
cudaError_t launch(const void* Z, const void* X, const void* g, void* Zbar,
                   void* Xbar, int Tn, int N, int L, int d, int rbf, int ppw,
                   int blocks, cudaStream_t stream) {
  constexpr int F2 = (INC ? 2 : 1) * NL * (NL + 1) / 2;
  constexpr size_t smem = sizeof(Rec4<T>) * F2 * (1 + kThreads);
  const int per_item = kThreads / kLanes * ppw;
  if (ppw < 1 || blocks != Tn * ((N + per_item - 1) / per_item))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ts_bwd_kernel<T, NL, INC>, smem);
  if (e != cudaSuccess) return e;
  ts_bwd_kernel<T, NL, INC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(Z), static_cast<const T*>(X),
      static_cast<const T*>(g), static_cast<T*>(Zbar), static_cast<T*>(Xbar),
      Tn, N, L, d, rbf, ppw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_levels(int nl, int inc, const void* Z, const void* X,
                      const void* g, void* Zbar, void* Xbar, int Tn, int N,
                      int L, int d, int rbf, int ppw, int blocks,
                      cudaStream_t s) {
#define GPSIG_NL(q)                                                          \
  case q:                                                                    \
    return inc ? launch<T, q, true>(Z, X, g, Zbar, Xbar, Tn, N, L, d, rbf,  \
                                    ppw, blocks, s)                          \
               : launch<T, q, false>(Z, X, g, Zbar, Xbar, Tn, N, L, d, rbf, \
                                     ppw, blocks, s);
  switch (nl) {
    GPSIG_NL(1) GPSIG_NL(2) GPSIG_NL(3) GPSIG_NL(4) GPSIG_NL(5) GPSIG_NL(6)
    GPSIG_NL(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_NL
}

extern template cudaError_t by_levels<float>(int, int, const void*,
                                             const void*, const void*, void*,
                                             void*, int, int, int, int, int,
                                             int, int, cudaStream_t);
extern template cudaError_t by_levels<double>(int, int, const void*,
                                              const void*, const void*,
                                              void*, void*, int, int, int,
                                              int, int, int, int,
                                              cudaStream_t);

}  // namespace kuf1_bwd
}  // namespace gpsig
