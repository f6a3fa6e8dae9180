// Fused inducing-tensor-vs-sequence levels (Kuf), for Hopper (sm_90a).
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/tens_seq.py:_tens_seq_kernel
// (entry point fused_tens_seq_levels): out[m, t, n] = <z_t^(m), S_m(x_n)>
// for rank-1 inducing tensors z^(m) = z_{m,1} x ... x z_{m,m}, order 1,
// difference=True, RBF or Linear base on pre-scaled inputs, num_levels
// <= 7. Factors are stacked level-major (level m owns rows
// off_m .. off_m + m - 1, off_m = m(m-1)/2), F = nl(nl+1)/2 of them; with
// increments each factor is a pair (z_a, z_b) standing for phi(z_b) -
// phi(z_a). The plain version is _xla_reference_tens_seq (tens_seq.py) and
// the recursion signature_kern_tens_vs_seq (ops/signature.py, order 1).
//
// Design. One thread per (tensor t, sequence n); a block is one tensor
// against 128 sequences, so the tensor's factors and -|z|^2/2 sit in shared
// memory and every read of them is a broadcast. The thread walks its
// sequence once. At step i it evaluates the F (or 2F, pair-differenced
// at once) factor base kernels g_f(i) = k(z_f, x_i) in registers, and the
// sequence difference U_f = g_f(i) - g_f(i-1) against the previous step's
// values. Level m keeps the running exclusive sums
// S_{m,a} = sum_{i' < i} E^(a)(i') for a < m - 1; a step updates a from
// high to low, E^(a) = U_{off_m + a} * S_{m,a-1} with E^(0) = U_{off_m},
// and only then adds E^(a) into S_{m,a}: ascending order would make the
// sums inclusive. E^(m-1) adds into the level sum. The whole DP state
// (F previous values, F - nl sums, nl level sums) lives in registers; the
// number of levels is a template parameter so the arrays are sized to it.
// X is passed transposed, [L, d, N], so a warp's loads of x_i are
// contiguous. Level 0 is 1.
//
// What bounds it on the H100. It reads Z (T F2 d values) and X (N L d) and
// writes (nl + 1) T N values, while it computes T N L F2 base kernels
// (2d + 2 flops and one exp each) and T N (L - 1)(F - 1) DP multiply-adds:
// at the flagship prediction shape (T = 500, N = 2048, L = 50, F2 = 30,
// d = 3) that is 1.5e9 exps against 6 MB of output, so it is bound by the
// exp and FMA pipes, not by memory.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kThreads = 128;

template <typename T, int NL, bool INC>
__global__ void __launch_bounds__(kThreads)
tens_seq_kernel(const T* __restrict__ Z, const T* __restrict__ Xt,
                T* __restrict__ out, int Tn, int N, int L, int d, int rbf) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int F2 = INC ? 2 * F : F;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);  // [F2][d]
  T* nzs = zs + F2 * d;                     // [F2]
  T* xsh = nzs + F2;                        // [d][kThreads], per thread
  const int t = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;

  const T* zg = Z + static_cast<long long>(t) * F2 * d;
  for (int k = threadIdx.x; k < F2 * d; k += kThreads) zs[k] = zg[k];
  __syncthreads();
  if (rbf) {
    for (int f = threadIdx.x; f < F2; f += kThreads) {
      T s = T(0);
      for (int c = 0; c < d; ++c) s += zs[f * d + c] * zs[f * d + c];
      nzs[f] = T(-0.5) * s;
    }
  }
  __syncthreads();
  if (n >= N) return;

  T* xme = xsh + threadIdx.x;
  T prev[F], u[F], S[NS], lev[NL];
#pragma unroll
  for (int f = 0; f < F; ++f) prev[f] = T(0);
#pragma unroll
  for (int k = 0; k < NS; ++k) S[k] = T(0);
#pragma unroll
  for (int m = 0; m < NL; ++m) lev[m] = T(0);

  for (int i = 0; i < L; ++i) {
    T nx = T(0);
    for (int c = 0; c < d; ++c) {
      const T v = Xt[(static_cast<long long>(i) * d + c) * N + n];
      xme[c * kThreads] = v;
      nx += v * v;
    }
    nx *= T(-0.5);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      T g;
      if (INC) {
        T a = rbf ? nzs[2 * f] + nx : T(0);
        T b = rbf ? nzs[2 * f + 1] + nx : T(0);
        for (int c = 0; c < d; ++c) {
          const T xc = xme[c * kThreads];
          a += zs[(2 * f) * d + c] * xc;
          b += zs[(2 * f + 1) * d + c] * xc;
        }
        g = rbf ? texp(b) - texp(a) : b - a;
      } else {
        T a = rbf ? nzs[f] + nx : T(0);
        for (int c = 0; c < d; ++c) a += zs[f * d + c] * xme[c * kThreads];
        g = rbf ? texp(a) : a;
      }
      u[f] = g - prev[f];  // meaningful from i = 1 on
      prev[f] = g;
    }
    if (i == 0) continue;
#pragma unroll
    for (int m = 1; m <= NL; ++m) {
      const int off = m * (m - 1) / 2;        // first factor row of level m
      const int soff = (m - 1) * (m - 2) / 2;  // first running sum of level m
      if (m == 1) {
        lev[0] += u[0];
      } else {
        lev[m - 1] += u[off + m - 1] * S[soff + m - 2];
#pragma unroll
        for (int a = m - 2; a >= 1; --a) S[soff + a] += u[off + a] * S[soff + a - 1];
        S[soff] += u[off];
      }
    }
  }

  const long long plane = static_cast<long long>(Tn) * N;
  T* o = out + static_cast<long long>(t) * N + n;
  o[0] = T(1);
#pragma unroll
  for (int m = 0; m < NL; ++m) o[(m + 1) * plane] = lev[m];
}

template <typename T, int NL, bool INC>
cudaError_t launch(const void* Z, const void* Xt, void* out, int Tn, int N,
                   int L, int d, int rbf, cudaStream_t stream) {
  constexpr int F2 = (INC ? 2 : 1) * NL * (NL + 1) / 2;
  const size_t smem = sizeof(T) * (static_cast<size_t>(F2) * (d + 1) +
                                   static_cast<size_t>(d) * kThreads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tens_seq_kernel<T, NL, INC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + kThreads - 1) / kThreads, Tn);
  tens_seq_kernel<T, NL, INC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(Z), static_cast<const T*>(Xt),
      static_cast<T*>(out), Tn, N, L, d, rbf);
  return cudaGetLastError();
}

template <typename T, bool INC>
cudaError_t by_levels(const void* Z, const void* Xt, void* out, int Tn, int N,
                      int L, int d, int nl, int rbf, cudaStream_t s) {
  switch (nl) {
    case 1: return launch<T, 1, INC>(Z, Xt, out, Tn, N, L, d, rbf, s);
    case 2: return launch<T, 2, INC>(Z, Xt, out, Tn, N, L, d, rbf, s);
    case 3: return launch<T, 3, INC>(Z, Xt, out, Tn, N, L, d, rbf, s);
    case 4: return launch<T, 4, INC>(Z, Xt, out, Tn, N, L, d, rbf, s);
    case 5: return launch<T, 5, INC>(Z, Xt, out, Tn, N, L, d, rbf, s);
    case 6: return launch<T, 6, INC>(Z, Xt, out, Tn, N, L, d, rbf, s);
    case 7: return launch<T, 7, INC>(Z, Xt, out, Tn, N, L, d, rbf, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_increments(const void* Z, const void* Xt, void* out, int Tn,
                          int N, int L, int d, int nl, int rbf, int inc,
                          cudaStream_t s) {
  return inc ? by_levels<T, true>(Z, Xt, out, Tn, N, L, d, nl, rbf, s)
             : by_levels<T, false>(Z, Xt, out, Tn, N, L, d, nl, rbf, s);
}

}  // namespace

extern "C" {

// Z [T, F(, 2), d] contiguous, Xt [L, d, N] contiguous -> out [nl + 1, T, N];
// returns cudaGetLastError() after the launch (0 on success).
int gpsig_tens_seq(const void* Z, const void* Xt, void* out, int Tn, int N,
                   int L, int d, int nl, int rbf, int inc, int f64,
                   void* stream) {
  if (L < 1 || d < 1 || Tn > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_increments<double>(Z, Xt, out, Tn, N, L, d, nl, rbf, inc, s)
             : by_increments<float>(Z, Xt, out, Tn, N, L, d, nl, rbf, inc, s);
}

}  // extern "C"
