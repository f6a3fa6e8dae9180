// Backward of the fused inducing-tensor-vs-sequence levels (Kuf), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/tens_seq.py:
// _tens_seq_bwd_kernel (entry point tens_seq_bwd_pallas): given Z [T, F, d]
// or [T, F, 2, d] (pre-scaled), X [N, L, d] and the cotangents g
// [nl + 1, T, N] of out[m, t, n] = <z_t^(m), S_m(x_n)> (tens_seq.cu), it
// returns Z̄ with Z's shape and X̄ [N, L, d]: the VJP of the plain version
// fused_tens_seq_levels_ref (_xla_reference_tens_seq in the JAX package),
// order 1, difference=True, RBF or Linear base, num_levels <= 7, RBF
// distance unclamped.
//
// Math (tens_seq.py:263-278). Per (t, n) the forward takes the factor
// base kernels g_f(i) = k(z_f, x_i) (k(z_b, x_i) - k(z_a, x_i) with
// increments), their differences U_f(i) = g_f(i) - g_f(i-1), i = 1..L-1,
// and per level m (factor rows off .. off + m - 1) the stages
// E^(0) = U_off, E^(a) = U_{off+a} * S^(a-1), where S^(a) is the running
// exclusive sum of E^(a) over i; k_m = sum_i E^(m-1)(i). With w_m = g[m]:
//     Ē^(m-1)(i) = w_m,   Ē^(a-1)(i) = sum_{i' > i} U_{off+a}(i') Ē^(a)(i'),
//     Ū_{off+a}(i) = Ē^(a)(i) S^(a-1)(i),   Ū_off(i) = Ē^(0)(i),
// then ḡ_f(i) = Ū_f(i) - Ū_f(i+1) and the base kernel's derivatives:
//     RBF:    ∂k/∂z = k (x - z),  ∂k/∂x = k (z - x);   Linear: x and z.
// With u = ḡ k (RBF) or ḡ (Linear), signed -1 for the pair's first point
// under increments: Z̄_f = sum_i u x_i - z_f sum_i u and
// X̄_i = sum_f u z_f - x_i sum_f u (second terms RBF only).
//
// Design. The forward kernel's layout: one thread per (tensor t,
// sequence n), a block is one tensor against up to 128 sequences with the
// factors and -|z|^2/2 in shared memory. The thread first runs the forward
// DP to the end states S^(a); then it walks its sequence backwards and
// rebuilds the states by subtraction, ascending a (S^(0) -= U_off, then
// S^(a) -= U_{off+a} S^(a-1) with S^(a-1) already rebuilt), so no stage is
// stored: the reverse suffix sums Ē^(a-1) are running sums of the same
// size. Base kernels are re-evaluated at each step (two L F2 exps per
// thread in all). The per-thread Z̄ sums (F2 (d + 1) values: 120 at nl = 5
// with increments and d = 3) would spill from registers, so they live in
// shared memory, one column per thread (bank-conflict free); the block
// adds the columns at the end and accumulates Z̄_t atomically across the
// sequence blocks. X̄ rows are complete per (t, n, i) and are added
// atomically across the T tensor blocks into a [L, d, N] buffer, so a
// warp's atomics are contiguous. The block size is the largest of 128, 64
// and 32 threads whose shared memory fits.
//
// What bounds it on the H100. Per (t, n): 2 L F2 base kernels (2d + 2
// flops and one exp each), 3 (L - 1)(F - nl) DP multiply-adds and
// L F2 (d + 1) shared-memory updates, and L d global atomics. At the
// training shape (T = 500, N = 50, L = 50, F2 = 30, d = 3) that is 75M exps
// and 3.75M atomics: bound by the exp/FMA pipes and shared-memory traffic,
// with the grid (1 x 500 blocks of 64 threads at N = 50) too small to fill
// 132 SMs for long.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kMaxThreads = 128;

// k(z_f, x_i) for the F2 factor points of the block's tensor at the point
// x_i of this thread's sequence n, staged in xme[c * nt].
template <typename T, int F2>
__device__ __forceinline__ void factor_kernels(const T* zs, const T* nzs,
                                               const T* __restrict__ Xt,
                                               T* xme, int i, int d, int N,
                                               int n, int nt, bool rbf,
                                               T (&k)[F2]) {
  T nx = T(0);
  for (int c = 0; c < d; ++c) {
    const T v = Xt[(static_cast<long long>(i) * d + c) * N + n];
    xme[c * nt] = v;
    nx += v * v;
  }
  nx *= T(-0.5);
#pragma unroll
  for (int f = 0; f < F2; ++f) {
    T a = rbf ? nzs[f] + nx : T(0);
    for (int c = 0; c < d; ++c) a += zs[f * d + c] * xme[c * nt];
    k[f] = rbf ? texp(a) : a;
  }
}

// factor f's g value from its point kernels (pair-differenced with INC)
template <typename T, bool INC, int F2>
__device__ __forceinline__ T factor_g(const T (&k)[F2], int f) {
  return INC ? k[2 * f + 1] - k[2 * f] : k[f];
}

template <typename T, int NL, bool INC>
__global__ void __launch_bounds__(kMaxThreads)
tens_seq_bwd_kernel(const T* __restrict__ Z, const T* __restrict__ Xt,
                    const T* __restrict__ g, T* __restrict__ Zbar,
                    T* __restrict__ XbarT, int Tn, int N, int L, int d,
                    int rbf_flag) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int F2 = INC ? 2 * F : F;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  const bool rbf = rbf_flag != 0;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int t = blockIdx.y;
  const int n = blockIdx.x * nt + tid;
  const int A = F2 * (d + 1);  // Z̄ sums per thread: [f2][c], c = d is Σu
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);  // [F2][d]
  T* nzs = zs + F2 * d;                     // [F2]
  T* xsh = nzs + F2;                        // [2][d][nt]: x_i by parity of i
  T* acc = xsh + 2 * d * nt;                // [A][nt]

  const T* zg = Z + static_cast<long long>(t) * F2 * d;
  for (int k = tid; k < F2 * d; k += nt) zs[k] = zg[k];
  for (int k = 0; k < A; ++k) acc[k * nt + tid] = T(0);
  __syncthreads();
  if (rbf) {
    for (int f = tid; f < F2; f += nt) {
      T s = T(0);
      for (int c = 0; c < d; ++c) s += zs[f * d + c] * zs[f * d + c];
      nzs[f] = T(-0.5) * s;
    }
  }
  __syncthreads();

  if (n < N) {
    // x_i is staged in slot i & 1, so x_i and x_{i-1} are both at hand
    auto xslot = [&](int i) { return xsh + (i & 1) * d * nt + tid; };

    // ---- forward DP to the end states S --------------------------------
    T S[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) S[k] = T(0);
    T kc[F2];
    factor_kernels<T, F2>(zs, nzs, Xt, xslot(0), 0, d, N, n, nt, rbf, kc);
    for (int i = 1; i < L; ++i) {
      T kn[F2];
      factor_kernels<T, F2>(zs, nzs, Xt, xslot(i), i, d, N, n, nt, rbf,
                            kn);
#pragma unroll
      for (int m = 2; m <= NL; ++m) {
        const int off = m * (m - 1) / 2;
        const int soff = (m - 1) * (m - 2) / 2;
#pragma unroll
        for (int a = m - 2; a >= 1; --a)
          S[soff + a] += (factor_g<T, INC>(kn, off + a) -
                          factor_g<T, INC>(kc, off + a)) * S[soff + a - 1];
        S[soff] += factor_g<T, INC>(kn, off) - factor_g<T, INC>(kc, off);
      }
#pragma unroll
      for (int f = 0; f < F2; ++f) kc[f] = kn[f];
    }

    // ---- reverse sweep --------------------------------------------------
    T w[NL];
    const long long plane = static_cast<long long>(Tn) * N;
#pragma unroll
    for (int m = 0; m < NL; ++m)
      w[m] = g[(m + 1) * plane + static_cast<long long>(t) * N + n];
    T Rs[NS];  // Rs[soff + a] = Ē^(a) of level m at the current step
#pragma unroll
    for (int k = 0; k < NS; ++k) Rs[k] = T(0);
    T ubprev[F];  // Ū(i + 1)
#pragma unroll
    for (int f = 0; f < F; ++f) ubprev[f] = T(0);

    // X̄_i and the Z̄ sums of point i, with ḡ_f(i) = gb(f); kc = k(·, x_i)
    auto chain = [&](int i, const T (&kv)[F2], const T (&gb)[F]) {
      const T* xme = xslot(i);
      auto uval = [&](int f2) {
        const T gf = INC ? ((f2 & 1) ? gb[f2 >> 1] : -gb[f2 >> 1]) : gb[f2];
        return rbf ? gf * kv[f2] : gf;
      };
      T su = T(0);
#pragma unroll
      for (int f2 = 0; f2 < F2; ++f2) {
        const T u = uval(f2);
        su += u;
        acc[(f2 * (d + 1) + d) * nt + tid] += u;
      }
      for (int c = 0; c < d; ++c) {
        const T xc = xme[c * nt];
        T xb = T(0);
#pragma unroll
        for (int f2 = 0; f2 < F2; ++f2) {
          const T u = uval(f2);
          acc[(f2 * (d + 1) + c) * nt + tid] += u * xc;
          xb += u * zs[f2 * d + c];
        }
        if (rbf) xb -= xc * su;
        atomicAdd(XbarT + (static_cast<long long>(i) * d + c) * N + n, xb);
      }
    };

    for (int i = L - 1; i >= 1; --i) {
      T kn[F2];
      factor_kernels<T, F2>(zs, nzs, Xt, xslot(i - 1), i - 1, d, N, n,
                            nt, rbf, kn);
      T ub[F];
#pragma unroll
      for (int m = 1; m <= NL; ++m) {
        const int off = m * (m - 1) / 2;
        const int soff = (m - 1) * (m - 2) / 2;
        if (m == 1) {
          ub[0] = w[0];
          continue;
        }
        // S before step i, ascending a
        S[soff] -= factor_g<T, INC>(kc, off) - factor_g<T, INC>(kn, off);
#pragma unroll
        for (int a = 1; a <= m - 2; ++a)
          S[soff + a] -= (factor_g<T, INC>(kc, off + a) -
                          factor_g<T, INC>(kn, off + a)) * S[soff + a - 1];
        // Ū_{off+a}(i) = Ē^(a)(i) S^(a-1), Ē^(m-1) = w_m
        ub[off] = Rs[soff];
#pragma unroll
        for (int a = 1; a <= m - 1; ++a) {
          const T eb = a == m - 1 ? w[m - 1] : Rs[soff + a];
          ub[off + a] = eb * S[soff + a - 1];
        }
        // Ē^(a) of step i - 1 += U_{off+a+1}(i) Ē^(a+1)(i), ascending a
#pragma unroll
        for (int a = 0; a <= m - 2; ++a) {
          const T eb = a + 1 == m - 1 ? w[m - 1] : Rs[soff + a + 1];
          Rs[soff + a] += (factor_g<T, INC>(kc, off + a + 1) -
                           factor_g<T, INC>(kn, off + a + 1)) * eb;
        }
      }
      T gb[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        gb[f] = ub[f] - ubprev[f];
        ubprev[f] = ub[f];
      }
      chain(i, kc, gb);
#pragma unroll
      for (int f = 0; f < F2; ++f) kc[f] = kn[f];
    }
    T gb[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gb[f] = -ubprev[f];
    chain(0, kc, gb);
  }

  // ---- Z̄_t: add the block's columns, then across sequence blocks --------
  __syncthreads();
  for (int r = tid; r < A; r += nt) {
    T s = T(0);
    for (int k = 0; k < nt; ++k) s += acc[r * nt + ((k + r) & (nt - 1))];
    acc[r * nt] = s;
  }
  __syncthreads();
  T* zb = Zbar + static_cast<long long>(t) * F2 * d;
  for (int q = tid; q < F2 * d; q += nt) {
    const int f2 = q / d, c = q - f2 * d;
    T v = acc[(f2 * (d + 1) + c) * nt];
    if (rbf) v -= zs[q] * acc[(f2 * (d + 1) + d) * nt];
    atomicAdd(zb + q, v);
  }
}

template <typename T, int NL, bool INC>
cudaError_t launch(const void* Z, const void* Xt, const void* g, void* Zbar,
                   void* XbarT, int Tn, int N, int L, int d, int rbf,
                   cudaStream_t stream) {
  constexpr int F2 = (INC ? 2 : 1) * NL * (NL + 1) / 2;
  const size_t cap = 227 * 1024;
  int nt = kMaxThreads;
  auto bytes = [&](int threads) {
    return sizeof(T) * (static_cast<size_t>(F2) * (d + 1) +
                        static_cast<size_t>(2 * d + F2 * (d + 1)) * threads);
  };
  while (nt > 32 && (bytes(nt) > cap || nt >= 2 * N)) nt /= 2;
  const size_t smem = bytes(nt);
  if (smem > cap) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(tens_seq_bwd_kernel<T, NL, INC>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + nt - 1) / nt, Tn);
  tens_seq_bwd_kernel<T, NL, INC><<<grid, nt, smem, stream>>>(
      static_cast<const T*>(Z), static_cast<const T*>(Xt),
      static_cast<const T*>(g), static_cast<T*>(Zbar), static_cast<T*>(XbarT),
      Tn, N, L, d, rbf);
  return cudaGetLastError();
}

template <typename T, bool INC>
cudaError_t by_levels(const void* Z, const void* Xt, const void* g,
                      void* Zbar, void* XbarT, int Tn, int N, int L, int d,
                      int nl, int rbf, cudaStream_t s) {
  switch (nl) {
    case 1: return launch<T, 1, INC>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, rbf, s);
    case 2: return launch<T, 2, INC>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, rbf, s);
    case 3: return launch<T, 3, INC>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, rbf, s);
    case 4: return launch<T, 4, INC>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, rbf, s);
    case 5: return launch<T, 5, INC>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, rbf, s);
    case 6: return launch<T, 6, INC>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, rbf, s);
    case 7: return launch<T, 7, INC>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, rbf, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Z [T, F(, 2), d], Xt [L, d, N] (X transposed), g [nl + 1, T, N]
// contiguous; Zbar [T, F(, 2), d] and XbarT [L, d, N] zero-filled. Returns
// cudaGetLastError() after the launch (0 on success).
int gpsig_tens_seq_bwd(const void* Z, const void* Xt, const void* g,
                       void* Zbar, void* XbarT, int Tn, int N, int L, int d,
                       int nl, int rbf, int inc, int f64, void* stream) {
  if (L < 1 || d < 1 || Tn > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return inc ? by_levels<double, true>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d,
                                         nl, rbf, s)
               : by_levels<double, false>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d,
                                          nl, rbf, s);
  return inc ? by_levels<float, true>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, nl,
                                      rbf, s)
             : by_levels<float, false>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, nl,
                                       rbf, s);
}

}  // extern "C"
