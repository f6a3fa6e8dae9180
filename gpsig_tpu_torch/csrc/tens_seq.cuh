// Fused inducing-tensor-vs-sequence levels (Kuf) at order 1, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/tens_seq.py:_tens_seq_kernel
// (entry point fused_tens_seq_levels): out[m, t, n] = <z_t^(m), S_m(x_n)>
// for rank-1 inducing tensors z^(m) = z_{m,1} x ... x z_{m,m}, order 1,
// difference=True, RBF or Linear base on pre-scaled inputs, num_levels
// <= 7, any d whose factor records fit the shared memory (past that the
// general kernel of tens_seq_general.cuh runs the same function at order 1
// from global memory: ops/cuda/plan.py's kuf_fwd_plan). Factors
// are stacked level-major (level m owns rows off_m .. off_m + m - 1,
// off_m = m(m-1)/2), F = nl(nl+1)/2 of them; with increments each factor
// is a pair (z_a, z_b) standing for phi(z_b) - phi(z_a). The plain version
// is _xla_reference_tens_seq (tens_seq.py) and the recursion
// signature_kern_tens_vs_seq (ops/signature.py, order 1).
//
// Math. Per (t, n) the factor base kernels g_f(i) = k(z_f, x_i) (pair-
// differenced with increments), their differences U_f(i) = g_f(i) -
// g_f(i-1), i = 1..L-1, and per level m the stages E^(0) = U_off,
// E^(a) = U_{off+a} S_{m,a-1}, with S_{m,a} = sum_{i' < i} E^(a)(i') the
// running exclusive sums; k_m = sum_i E^(m-1)(i). Level 0 is 1.
//
// Design. A block is one tensor against `threads` sequences (32, 64 or 128,
// the fewest that cover N: plan.py's kuf_fwd_plan), a thread one sequence
// (n = block x threads + thread, so a warp's loads are contiguous in X
// passed transposed [L, d, N]), which it walks once, x_i in registers,
// loaded a point ahead. Up to d = 3 the tensor's factor points are staged
// once as packed records (common.cuh's Rec4: (z_0, z_1, z_2, -|z|^2/2),
// zero-padded), so a factor point's accumulator is one broadcast 16-byte
// shared load and a = -|x|^2/2 + <rec, (x, 1)>, four FMAs (75 registers at
// nl = 5 with increments: six blocks of 128 an SM). Past d = 3 (WIDE) each
// factor point is ceil(d / 4) Rec4 chunks of z and a half norm: the
// point's accumulators of all F2 factor points are summed chunk by chunk,
// x's first chunk in registers, the others read from global memory once a
// point (each serves all F2 factor points). One sequence a thread: several,
// to share each record load among them, were slower in an earlier version
// of this kernel, whose records nvcc held in registers (not measured on
// this one). At each point the levels go one at a time (a level reads
// only its own factor rows): its accumulators, one branch on the base for
// the batch, g, U against the previous point's values, and the level's
// order-1 DP (descending stages, each running sum added to after the next
// stage has read it). The DP state (F previous values, F - nl running sums,
// nl level sums) stays in registers. In float32 log2(e) is folded into the
// staged records and the half norm, so the exponential is one ex2 on the
// special-function unit (common.cuh's kuf_exp; e^a by expf took 1.8x the
// time at the flagship shape: kuf_variants.py on an H100 at 700 W). This
// header is compiled per dtype by tens_seq.cu and tens_seq_f64.cu.
//
// What bounds it on the H100. It reads Z (T F2 d values) and X (N L d) and
// writes (nl + 1) T N values, while it computes T N L F2 base kernels
// (2d + 2 flops and one exp each) and T N (L - 1)(F - 1) DP multiply-adds:
// at the flagship prediction shape (T = 500, N = 2048, L = 50, F2 = 30,
// d = 3) that is 1.5e9 exps against 6 MB of output, so it is bound by the
// special-function unit and the FP32 pipe, not by memory. The float32
// kernel at nl = 5 with increments holds 31 MUFU, 30 LDS and about 220
// FP32 instructions (118 FFMA, 65 FADD, 37 FMUL: cuobjdump -sass), nearly
// all in its point loop: a warp's point takes 240 clocks of its
// sub-partition's MUFU (4 lanes a clock) and 220 of its FP32 pipe and issue
// slots, so the two bind together. Past d = 3 the dot products' FMAs
// bind (d = 64: 16 chunk loads and 64 FMAs a factor point against one exp).

#pragma once

#include "common.cuh"

namespace gpsig {
namespace kuf1_fwd {

constexpr int kMaxD = 3;  // plan.KUF_TUNED_MAX_D: one packed record
constexpr int kMaxThreads = 128;

// Shared memory of a launch: the packed records, or (WIDE) ceil(d / 4)
// chunks of z and a half norm a factor point (plan.py's kuf_fwd_plan).
template <typename T>
size_t ts_smem(int F2, int d) {
  return d <= kMaxD ? sizeof(Rec4<T>) * F2
                    : (sizeof(Rec4<T>) * ((d + 3) / 4) + sizeof(T)) * F2;
}

template <typename T, int NL, bool INC, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads)
ts_kernel(const T* __restrict__ Z, const T* __restrict__ Xt,
          T* __restrict__ out, int Tn, int N, int L, int d, int rbf) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int P = INC ? 2 : 1;  // points a factor
  constexpr int F2 = P * F;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  const int K4 = WIDE ? (d + 3) / 4 : 1;  // Rec4 chunks a factor point
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Rec4<T>* zr = reinterpret_cast<Rec4<T>*>(smem_raw);  // [F2][K4]
  T* nzs = reinterpret_cast<T*>(zr + F2 * K4);          // [F2] (WIDE)
  const int nt = blockDim.x;
  const int t = blockIdx.y;
  const T scale = rbf ? kuf_fold<T>() : T(1);
  const T* zg = Z + static_cast<long long>(t) * F2 * d;
  if (!WIDE) {
    for (int f = threadIdx.x; f < F2; f += nt) {
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
  } else {
    for (int q = threadIdx.x; q < F2 * K4; q += nt) {
      const int f = q / K4, k = q - f * K4;
      Rec4<T> rec;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * k + j;
        rec.v[j] = c < d ? scale * zg[f * d + c] : T(0);
      }
      zr[q] = rec;
    }
    for (int f = threadIdx.x; f < F2; f += nt) {
      T s = T(0);
      for (int c = 0; c < d; ++c) s += zg[f * d + c] * zg[f * d + c];
      nzs[f] = rbf ? T(-0.5) * scale * s : T(0);
    }
  }
  __syncthreads();
  const int n = blockIdx.x * nt + threadIdx.x;
  if (n >= N) return;

  T prev[F], S[NS], lev[NL];
#pragma unroll
  for (int f = 0; f < F; ++f) prev[f] = T(0);
#pragma unroll
  for (int k = 0; k < NS; ++k) S[k] = T(0);
#pragma unroll
  for (int m = 0; m < NL; ++m) lev[m] = T(0);

  // x_i's first components (past d 0), the next point's loaded while
  // this one is computed
  constexpr int XR = WIDE ? 4 : kMaxD;
  T xr[XR], xq[XR];
  auto load_x = [&](int i, T (&dst)[XR]) {
    const T* xi = Xt + static_cast<long long>(i) * d * N + n;
#pragma unroll
    for (int c = 0; c < XR; ++c)
      dst[c] = c < d ? xi[static_cast<long long>(c) * N] : T(0);
  };
  load_x(0, xr);
  const T nscale = rbf ? T(-0.5) * scale : T(0);
  for (int i = 0; i < L; ++i) {
    if (i + 1 < L) load_x(i + 1, xq);
    T sx = T(0);
#pragma unroll
    for (int c = 0; c < XR; ++c) sx += xr[c] * xr[c];
    // WIDE: every factor point's accumulator, chunk by chunk
    T acc[WIDE ? F2 : 1];
    if constexpr (WIDE) {
#pragma unroll
      for (int fp = 0; fp < F2; ++fp) {
        const Rec4<T> z = zr[fp * K4];
        acc[fp] = z.v[0] * xr[0] + z.v[1] * xr[1] + z.v[2] * xr[2] +
                  z.v[3] * xr[3];
      }
      const T* xi = Xt + static_cast<long long>(i) * d * N + n;
#pragma unroll 1
      for (int k = 1; k < K4; ++k) {
        T xk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * k + j;
          xk[j] = c < d ? xi[static_cast<long long>(c) * N] : T(0);
          sx += xk[j] * xk[j];
        }
#pragma unroll
        for (int fp = 0; fp < F2; ++fp) {
          const Rec4<T> z = zr[fp * K4 + k];
          acc[fp] += z.v[0] * xk[0] + z.v[1] * xk[1] + z.v[2] * xk[2] +
                     z.v[3] * xk[3];
        }
      }
    }
    const T nx = nscale * sx;
    auto level = [&](auto lv) {
      constexpr int M = decltype(lv)::value;
      constexpr int off = M * (M - 1) / 2;        // first factor row
      constexpr int soff = (M - 1) * (M - 2) / 2;  // first running sum
      T a[M][P];
#pragma unroll
      for (int f = 0; f < M; ++f)
#pragma unroll
        for (int h = 0; h < P; ++h) {
          const int fp = P * (off + f) + h;
          if constexpr (WIDE) {
            a[f][h] = acc[fp] + nx + nzs[fp];
          } else {
            const Rec4<T> z = zr[fp];
            T v = nx + z.v[3];
            v += z.v[0] * xr[0];
            v += z.v[1] * xr[1];
            v += z.v[2] * xr[2];
            a[f][h] = v;
          }
        }
      if (rbf) {
#pragma unroll
        for (int f = 0; f < M; ++f)
#pragma unroll
          for (int h = 0; h < P; ++h) a[f][h] = kuf_exp(a[f][h]);
      }
      T u[M];
#pragma unroll
      for (int f = 0; f < M; ++f) {
        const T gv = INC ? a[f][1] - a[f][0] : a[f][0];
        u[f] = gv - prev[off + f];  // meaningful from i = 1 on
        prev[off + f] = gv;
      }
      if (i == 0) return;
      if (M == 1) {
        lev[0] += u[0];
      } else {
        lev[M - 1] += u[M - 1] * S[soff + M - 2];
#pragma unroll
        for (int s = M - 2; s >= 1; --s) S[soff + s] += u[s] * S[soff + s - 1];
        S[soff] += u[0];
      }
    };
    each_level<1, NL>(level);
#pragma unroll
    for (int c = 0; c < XR; ++c) xr[c] = xq[c];
  }

  const long long plane = static_cast<long long>(Tn) * N;
  T* o = out + static_cast<long long>(t) * N + n;
  o[0] = T(1);
#pragma unroll
  for (int m = 0; m < NL; ++m) o[(m + 1) * plane] = lev[m];
}

template <typename T, int NL, bool INC, bool WIDE>
cudaError_t launch_d(const void* Z, const void* Xt, void* out, int Tn, int N,
                     int L, int d, int rbf, int threads,
                     cudaStream_t stream) {
  const size_t smem = ts_smem<T>((INC ? 2 : 1) * NL * (NL + 1) / 2, d);
  if (smem > kSegSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(ts_kernel<T, NL, INC, WIDE>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + threads - 1) / threads, Tn);
  ts_kernel<T, NL, INC, WIDE><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(Z), static_cast<const T*>(Xt),
      static_cast<T*>(out), Tn, N, L, d, rbf);
  return cudaGetLastError();
}

template <typename T, int NL, bool INC>
cudaError_t launch(const void* Z, const void* Xt, void* out, int Tn, int N,
                   int L, int d, int rbf, int threads, cudaStream_t stream) {
  return d <= kMaxD ? launch_d<T, NL, INC, false>(Z, Xt, out, Tn, N, L, d,
                                                  rbf, threads, stream)
                    : launch_d<T, NL, INC, true>(Z, Xt, out, Tn, N, L, d,
                                                 rbf, threads, stream);
}

template <typename T>
cudaError_t by_levels(int nl, int inc, const void* Z, const void* Xt,
                      void* out, int Tn, int N, int L, int d, int rbf,
                      int threads, cudaStream_t s) {
#define GPSIG_NL(q)                                                          \
  case q:                                                                    \
    return inc ? launch<T, q, true>(Z, Xt, out, Tn, N, L, d, rbf, threads,  \
                                    s)                                       \
               : launch<T, q, false>(Z, Xt, out, Tn, N, L, d, rbf, threads, \
                                     s);
  switch (nl) {
    GPSIG_NL(1) GPSIG_NL(2) GPSIG_NL(3) GPSIG_NL(4) GPSIG_NL(5) GPSIG_NL(6)
    GPSIG_NL(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_NL
}

extern template cudaError_t by_levels<float>(int, int, const void*,
                                             const void*, void*, int, int,
                                             int, int, int, int,
                                             cudaStream_t);
extern template cudaError_t by_levels<double>(int, int, const void*,
                                              const void*, void*, int, int,
                                              int, int, int, int,
                                              cudaStream_t);

}  // namespace kuf1_fwd
}  // namespace gpsig
