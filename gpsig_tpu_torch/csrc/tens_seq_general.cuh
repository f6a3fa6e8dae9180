// Fused inducing-tensor-vs-sequence levels (Kuf) of the general engine,
// for Hopper (sm_90a): any order, difference True or False, increments or
// not, linear / RBF / poly<K> / cosine base, any L and any d.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/tens_seq_general.py:
// _tsg_kernel (entry point fused_tens_seq_general_levels):
// out[m, t, n] = <z_t^(m), S_m(x_n)> for rank-1 inducing tensors, at order
// p = min(order, num_levels), num_levels <= 7, on pre-scaled inputs (a
// Poly offset already folded in as a constant channel: x_extra = 1,
// z_extra = c). Factors are stacked level-major, F = nl(nl+1)/2 of them;
// with increments each is a pair (z_a, z_b) standing for phi(z_b) -
// phi(z_a). The plain version is _xla_reference_tens_seq_general
// (tens_seq_general.py), the recursion ops/signature.py's
// signature_kern_tens_vs_seq; the RBF exponent is not clamped, as there.
//
// Design. A block is one tensor against threads x R sequences; a thread takes
// R sequences of the tensor (R = 4, 2 or 1, the most whose DP state fits
// kStateRegs registers: tsg_seqs), so every factor value loaded serves R
// sequences, and sequence n = (block x threads + r x threads + thread) so
// that a warp's loads of one r are contiguous in X passed transposed [L, d,
// N]. The thread walks its sequences once. At each point it takes the levels
// one at a time (a level reads only its own factor rows): the level's factor
// points' accumulators for the R sequences, one activation of the whole batch
// (the kind's branch once a batch, the cosine out of line four values a call:
// common.cuh's kuf_activate), their values g in registers, U = g(i) -
// g(i-1) (difference=True, L - 1 steps) or g(i) (difference=False, L
// steps: every step is a real point, so nothing padded can count), and
// the level's stages a = 0..m-1 at the point, each with R_m = min(p, m)
// run-length states:
//   E^(0) = [U_off],  E^(a)[0] = U_{off+a} * S_{m,a-1},
//   E^(a)[r] = U_{off+a}/(r+1) * E^(a-1)[r-1]  (same point),
// where S_{m,a} = sum over earlier points of sum_r E^(a)[r], one register
// per (level, stage, sequence), added to only after stage a+1 has read it;
// the last stage adds into the level sum. The template on (NL, P) makes the
// live states compile-time: 28 instantiations per dtype (this header,
// compiled per dtype by tens_seq_general.cu and tens_seq_general_f64.cu).
// Kind, difference, increments and d are run-time arguments on which the
// whole launch branches alike; the two points of an increments pair are
// one rolled loop, which halves the code nvcc compiles. x_i's first kXr =
// 2 components are loaded into registers a point ahead (d = 2), the rest
// (Poly's offset channel, wide d) read from global memory where they are
// used; the factor points are read through one pointer, to the tensor's copy in
// shared memory where it fits (ops/cuda/plan.py's kuf_fwd_plan) and else
// to global memory (warp-uniform, cached), so any d runs.
//
// What bounds it on the H100. It reads Z (T F2 d values) and X (N L d) and
// writes (nl + 1) T N values, while it computes T N L F2 base kernels
// (2d + 2 flops and one exp each) and about T N L (F - nl) (p + 2) DP
// multiply-adds: at the order-2 flagship prediction shape (T = 500,
// N = 2048, L = 50, F2 = 30, d = 2) that is 1.5e9 exps against 12 MB of
// output, so it is bound by the exp and FMA pipes, not by memory.

#pragma once

#include "common.cuh"

namespace gpsig {
namespace kuf_fwd {

constexpr int kMaxThreads = 128;
// components of x_i a thread keeps in registers: d = 2, the main path's
// (4 took 5% longer at the flagship shape and 11% at N = 50, measured)
constexpr int kXr = 2;
// 32-bit registers a thread gives to its sequences' DP state (plan.py's
// KUF_STATE_REGS)
constexpr int kStateRegs = 128;

// Sequences a thread: the most of 4, 2, 1 whose state (F previous values,
// F - nl running sums, nl level sums, the half norm) fits kStateRegs
// (plan.py's kuf_fwd_seqs).
template <typename T, int NL>
__host__ __device__ constexpr int tsg_seqs() {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int regs =
      (F + (F - NL > 0 ? F - NL : 1) + NL + 1) * static_cast<int>(sizeof(T)) /
      4;
  return 4 * regs <= kStateRegs ? 4 : 2 * regs <= kStateRegs ? 2 : 1;
}

template <typename T, int NL, int P>
__global__ void __launch_bounds__(kMaxThreads)
tsg_kernel(const T* __restrict__ Z, const T* __restrict__ Xt,
           T* __restrict__ out, int Tn, int N, int L, int d, int kind,
           int degree, int inc, int diff, int staged) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  constexpr int R = tsg_seqs<T, NL>();
  const int F2 = inc ? 2 * F : F;
  const bool norms = kind_norms(kind);
  const int nt = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* nzs = reinterpret_cast<T*>(smem_raw);  // [F2]
  T* zs = nzs + F2;                         // [F2][d] where staged
  const int t = blockIdx.y;
  const T* zg = Z + static_cast<long long>(t) * F2 * d;
  const T* zp = staged ? zs : zg;

  if (staged)
    for (int k = threadIdx.x; k < F2 * d; k += nt) zs[k] = zg[k];
  for (int f = threadIdx.x; f < F2; f += nt) {
    T s = T(0);
    for (int c = 0; c < d; ++c) s += zg[f * d + c] * zg[f * d + c];
    nzs[f] = norms ? T(-0.5) * s : T(0);
  }
  __syncthreads();
  const int n0 = blockIdx.x * nt * R + threadIdx.x;
  if (n0 >= N) return;
  int nv[R];  // the sequences, clamped to N - 1 for reading
#pragma unroll
  for (int r = 0; r < R; ++r) nv[r] = min(n0 + r * nt, N - 1);

  T prev[F][R], S[NS][R], lev[NL][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int f = 0; f < F; ++f) prev[f][r] = T(0);
#pragma unroll
    for (int k = 0; k < NS; ++k) S[k][r] = T(0);
#pragma unroll
    for (int m = 0; m < NL; ++m) lev[m][r] = T(0);
  }

  // x_i of the R sequences: the first kXr components in registers, loaded
  // a point ahead (their latency hides behind the point before), the rest
  // read where they are used
  T xr[R][kXr], xq[R][kXr];
  auto load_x = [&](int i, T (&dst)[R][kXr]) {
    const T* xi = Xt + static_cast<long long>(i) * d * N;
#pragma unroll
    for (int c = 0; c < kXr; ++c)
      if (c < d)
#pragma unroll
        for (int r = 0; r < R; ++r)
          dst[r][c] = xi[static_cast<long long>(c) * N + nv[r]];
  };
  load_x(0, xr);
  for (int i = 0; i < L; ++i) {
    const T* xi = Xt + static_cast<long long>(i) * d * N;
    if (i + 1 < L) load_x(i + 1, xq);
    T nx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) nx[r] = T(0);
#pragma unroll
    for (int c = 0; c < kXr; ++c)
      if (c < d)
#pragma unroll
        for (int r = 0; r < R; ++r) nx[r] += xr[r][c] * xr[r][c];
    for (int c = kXr; c < d; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T v = xi[static_cast<long long>(c) * N + nv[r]];
        nx[r] += v * v;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) nx[r] = norms ? T(-0.5) * nx[r] : T(0);
    const bool dp = !(diff && i == 0);  // U(0) is meaningful only then
    auto level = [&](auto lv) {
      constexpr int M = decltype(lv)::value;
      constexpr int off = M * (M - 1) / 2;        // first factor row
      constexpr int soff = (M - 1) * (M - 2) / 2;  // first running sum
      constexpr int Rm = P < M ? P : M;
      T gv[M][R];
#pragma unroll
      for (int f = 0; f < M; ++f)
#pragma unroll
        for (int r = 0; r < R; ++r) gv[f][r] = T(0);
#pragma unroll 1
      for (int h = 0; h < (inc ? 2 : 1); ++h) {
        T a[M * R];
#pragma unroll
        for (int f = 0; f < M; ++f) {
          const int fp = inc ? 2 * (off + f) + h : off + f;
          const T nz = nzs[fp];
#pragma unroll
          for (int r = 0; r < R; ++r) a[f * R + r] = nz + nx[r];
        }
#pragma unroll
        for (int c = 0; c < kXr; ++c) {
          if (c >= d) break;
#pragma unroll
          for (int f = 0; f < M; ++f) {
            const int fp = inc ? 2 * (off + f) + h : off + f;
            const T z = zp[fp * d + c];
#pragma unroll
            for (int r = 0; r < R; ++r) a[f * R + r] += z * xr[r][c];
          }
        }
        for (int c = kXr; c < d; ++c) {
          T xv[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            xv[r] = xi[static_cast<long long>(c) * N + nv[r]];
#pragma unroll
          for (int f = 0; f < M; ++f) {
            const int fp = inc ? 2 * (off + f) + h : off + f;
            const T z = zp[fp * d + c];
#pragma unroll
            for (int r = 0; r < R; ++r) a[f * R + r] += z * xv[r];
          }
        }
        kuf_activate(a, kind, degree);
        const T sign = inc && h == 0 ? T(-1) : T(1);
#pragma unroll
        for (int f = 0; f < M; ++f)
#pragma unroll
          for (int r = 0; r < R; ++r) gv[f][r] += sign * a[f * R + r];
      }
      T u[M][R];
#pragma unroll
      for (int f = 0; f < M; ++f)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          u[f][r] = diff ? gv[f][r] - prev[off + f][r] : gv[f][r];
          prev[off + f][r] = gv[f][r];
        }
      if (!dp) return;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T cur[P];
        cur[0] = u[0][r];
#pragma unroll
        for (int s = 1; s < P; ++s) cur[s] = T(0);
#pragma unroll
        for (int a = 1; a < M; ++a) {
          const T ua = u[a][r];
          const int live_prev = Rm < a ? Rm : a;     // states of stage a-1
          const int live = Rm < a + 1 ? Rm : a + 1;  // states of stage a
          T sum_prev = T(0);
#pragma unroll
          for (int s = 0; s < P; ++s)
            if (s < live_prev) sum_prev += cur[s];
          T nxt[P];
          nxt[0] = ua * S[soff + a - 1][r];
#pragma unroll
          for (int s = 1; s < P; ++s)
            nxt[s] = s < live ? ua * (T(1) / T(s + 1)) * cur[s - 1] : T(0);
          S[soff + a - 1][r] += sum_prev;
#pragma unroll
          for (int s = 0; s < P; ++s) cur[s] = nxt[s];
        }
        T s = T(0);
#pragma unroll
        for (int q = 0; q < P; ++q)
          if (q < Rm) s += cur[q];
        lev[M - 1][r] += s;
      }
    };
    each_level<1, NL>(level);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < kXr; ++c) xr[r][c] = xq[r][c];
  }

  const long long plane = static_cast<long long>(Tn) * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r * nt;
    if (n >= N) break;
    T* o = out + static_cast<long long>(t) * N + n;
    o[0] = T(1);
#pragma unroll
    for (int m = 0; m < NL; ++m) o[(m + 1) * plane] = lev[m][r];
  }
}

template <typename T, int NL, int P>
cudaError_t launch(const void* Z, const void* Xt, void* out, int Tn, int N,
                   int L, int d, int kind, int degree, int inc, int diff,
                   int threads, int staged, cudaStream_t stream) {
  if constexpr (P > NL) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int F = NL * (NL + 1) / 2;
    constexpr int R = tsg_seqs<T, NL>();
    const int F2 = (inc ? 2 : 1) * F;
    const size_t smem =
        sizeof(T) * static_cast<size_t>(F2) * (staged ? d + 1 : 1);
    if (threads % 32 || threads < 32 || threads > kMaxThreads ||
        smem > kSegSmemBytes)
      return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(tsg_kernel<T, NL, P>, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((N + threads * R - 1) / (threads * R), Tn);
    tsg_kernel<T, NL, P><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(Z), static_cast<const T*>(Xt),
        static_cast<T*>(out), Tn, N, L, d, kind, degree, inc, diff, staged);
    return cudaGetLastError();
  }
}

template <typename T, int NL>
cudaError_t by_order(int P, const void* Z, const void* Xt, void* out, int Tn,
                     int N, int L, int d, int kind, int degree, int inc,
                     int diff, int threads, int staged, cudaStream_t s) {
#define GPSIG_P(p)                                                       \
  case p:                                                                \
    return launch<T, NL, p>(Z, Xt, out, Tn, N, L, d, kind, degree, inc, \
                            diff, threads, staged, s);
  switch (P) {
    GPSIG_P(1) GPSIG_P(2) GPSIG_P(3) GPSIG_P(4) GPSIG_P(5) GPSIG_P(6)
    GPSIG_P(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_P
}

template <typename T>
cudaError_t by_levels(int nl, int P, const void* Z, const void* Xt,
                      void* out, int Tn, int N, int L, int d, int kind,
                      int degree, int inc, int diff, int threads, int staged,
                      cudaStream_t s) {
#define GPSIG_NL(q)                                                         \
  case q:                                                                   \
    return by_order<T, q>(P, Z, Xt, out, Tn, N, L, d, kind, degree, inc, \
                          diff, threads, staged, s);
  switch (nl) {
    GPSIG_NL(1) GPSIG_NL(2) GPSIG_NL(3) GPSIG_NL(4) GPSIG_NL(5) GPSIG_NL(6)
    GPSIG_NL(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_NL
}

extern template cudaError_t by_levels<float>(int, int, const void*,
                                             const void*, void*, int, int,
                                             int, int, int, int, int, int,
                                             int, int, cudaStream_t);
extern template cudaError_t by_levels<double>(int, int, const void*,
                                              const void*, void*, int, int,
                                              int, int, int, int, int, int,
                                              int, int, cudaStream_t);

}  // namespace kuf_fwd
}  // namespace gpsig
