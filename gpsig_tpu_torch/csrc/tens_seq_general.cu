// Fused inducing-tensor-vs-sequence levels (Kuf) of the general engine,
// for Hopper (sm_90a): any order, difference True or False, increments or
// not, linear / RBF / poly<K> / cosine base.
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
// Design. One thread per (tensor t, sequence n), as tens_seq.cu: a block is
// one tensor against 128 sequences, the tensor's factors and -|z|^2/2 in
// shared memory, X passed transposed [L, d, N] so a warp's loads of x_i
// are contiguous. The thread walks its sequence once. At each point it
// evaluates the F factor values g_f (pair-differenced with increments) in
// a loop that is not unrolled, into its own column of a shared-memory
// buffer: the base kind is a run-time switch, and unrolled over F factors
// and both increments paths its four activations (the cosine's range
// reduction above all) multiplied the compile time several times over.
// Then U_f = g_f(i+1) - g_f(i) (difference=True, L - 1 steps) or g_f(i)
// (difference=False, L steps: every step is a real point, so nothing
// padded can count). Per level m the DP runs its stages a = 0..m-1 at the
// current point, each with R_m = min(p, m) run-length states:
//   E^(0) = [U_off],  E^(a)[0] = U_{off+a} * S_{m,a-1},
//   E^(a)[r] = U_{off+a}/(r+1) * E^(a-1)[r-1]  (same point),
// where S_{m,a} = sum over earlier points of sum_r E^(a)[r], one register
// per (level, stage), added to only after stage a+1 has read it; the last
// stage adds into the level sum. Only states r < min(R_m, a+1) exist at
// stage a; the template on (NL, P) makes that set compile-time, so no dead
// state is computed: 28 instantiations per dtype. Kind, difference and
// increments are run-time arguments on which the whole launch branches
// alike.
//
// What bounds it on the H100. It reads Z (T F2 d values) and X (N L d) and
// writes (nl + 1) T N values, while it computes T N L F2 base kernels
// (2d + 2 flops and one exp each) and about T N L (F - nl) (p + 2) DP
// multiply-adds: at the order-2 flagship prediction shape (T = 500,
// N = 2048, L = 50, F2 = 30, d = 2) that is 1.5e9 exps against 12 MB of
// output, so it is bound by the exp and FMA pipes, not by memory.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kThreads = 128;

template <typename T, int NL, int P>
__global__ void __launch_bounds__(kThreads)
tsg_kernel(const T* __restrict__ Z, const T* __restrict__ Xt,
           T* __restrict__ out, int Tn, int N, int L, int d, int kind,
           int degree, int inc, int diff) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  const int F2 = inc ? 2 * F : F;
  const bool norms = kind_norms(kind);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);  // [F2][d]
  T* nzs = zs + F2 * d;                     // [F2]
  T* xsh = nzs + F2;                        // [d][kThreads], per thread
  T* gsh = xsh + d * kThreads;              // [F][kThreads], per thread
  const int t = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;

  const T* zg = Z + static_cast<long long>(t) * F2 * d;
  for (int k = threadIdx.x; k < F2 * d; k += kThreads) zs[k] = zg[k];
  __syncthreads();
  if (norms) {
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
    T* gme = gsh + threadIdx.x;
#pragma unroll 1
    for (int f = 0; f < F; ++f) {
      T g;
      if (inc) {
        T a = norms ? nzs[2 * f] + nx : T(0);
        T b = norms ? nzs[2 * f + 1] + nx : T(0);
        for (int c = 0; c < d; ++c) {
          const T xc = xme[c * kThreads];
          a += zs[(2 * f) * d + c] * xc;
          b += zs[(2 * f + 1) * d + c] * xc;
        }
        g = activate(b, kind, degree) - activate(a, kind, degree);
      } else {
        T a = norms ? nzs[f] + nx : T(0);
        for (int c = 0; c < d; ++c) a += zs[f * d + c] * xme[c * kThreads];
        g = activate(a, kind, degree);
      }
      gme[f * kThreads] = g;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const T g = gme[f * kThreads];
      u[f] = diff ? g - prev[f] : g;  // the difference is meaningful from i = 1
      prev[f] = g;
    }
    if (diff && i == 0) continue;
#pragma unroll
    for (int m = 1; m <= NL; ++m) {
      const int off = m * (m - 1) / 2;        // first factor row of level m
      const int soff = (m - 1) * (m - 2) / 2;  // first running sum of level m
      const int Rm = P < m ? P : m;
      T cur[P];
      cur[0] = u[off];
#pragma unroll
      for (int r = 1; r < P; ++r) cur[r] = T(0);
#pragma unroll
      for (int a = 1; a < m; ++a) {
        const T ua = u[off + a];
        const int live_prev = Rm < a ? Rm : a;          // states of stage a-1
        const int live = Rm < a + 1 ? Rm : a + 1;       // states of stage a
        T sum_prev = T(0);
#pragma unroll
        for (int r = 0; r < P; ++r)
          if (r < live_prev) sum_prev += cur[r];
        T nxt[P];
        nxt[0] = ua * S[soff + a - 1];
#pragma unroll
        for (int r = 1; r < P; ++r)
          nxt[r] = r < live ? ua * (T(1) / T(r + 1)) * cur[r - 1] : T(0);
        S[soff + a - 1] += sum_prev;
#pragma unroll
        for (int r = 0; r < P; ++r) cur[r] = nxt[r];
      }
      T s = T(0);
#pragma unroll
      for (int r = 0; r < P; ++r)
        if (r < Rm) s += cur[r];
      lev[m - 1] += s;
    }
  }

  const long long plane = static_cast<long long>(Tn) * N;
  T* o = out + static_cast<long long>(t) * N + n;
  o[0] = T(1);
#pragma unroll
  for (int m = 0; m < NL; ++m) o[(m + 1) * plane] = lev[m];
}

template <typename T, int NL, int P>
cudaError_t launch(const void* Z, const void* Xt, void* out, int Tn, int N,
                   int L, int d, int kind, int degree, int inc, int diff,
                   cudaStream_t stream) {
  if constexpr (P > NL) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int F = NL * (NL + 1) / 2;
    const int F2 = (inc ? 2 : 1) * F;
    const size_t smem = sizeof(T) * (static_cast<size_t>(F2) * (d + 1) +
                                     static_cast<size_t>(d + F) * kThreads);
    cudaError_t e = allow_smem(tsg_kernel<T, NL, P>, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((N + kThreads - 1) / kThreads, Tn);
    tsg_kernel<T, NL, P><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(Z), static_cast<const T*>(Xt),
        static_cast<T*>(out), Tn, N, L, d, kind, degree, inc, diff);
    return cudaGetLastError();
  }
}

template <typename T, int NL>
cudaError_t by_order(int P, const void* Z, const void* Xt, void* out, int Tn,
                     int N, int L, int d, int kind, int degree, int inc,
                     int diff, cudaStream_t s) {
#define GPSIG_P(p)                                                       \
  case p:                                                                \
    return launch<T, NL, p>(Z, Xt, out, Tn, N, L, d, kind, degree, inc, \
                            diff, s);
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
                      int degree, int inc, int diff, cudaStream_t s) {
#define GPSIG_NL(q)                                                         \
  case q:                                                                   \
    return by_order<T, q>(P, Z, Xt, out, Tn, N, L, d, kind, degree, inc, \
                          diff, s);
  switch (nl) {
    GPSIG_NL(1) GPSIG_NL(2) GPSIG_NL(3) GPSIG_NL(4) GPSIG_NL(5) GPSIG_NL(6)
    GPSIG_NL(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_NL
}


}  // namespace

extern "C" {

// Z [T, F(, 2), d] contiguous, Xt [L, d, N] contiguous -> out
// [nl + 1, T, N] at order p = min(order, nl); kind as gpsig::BaseKind
// (degree for kPoly); returns cudaGetLastError() after the launch.
int gpsig_tens_seq_general(const void* Z, const void* Xt, void* out, int Tn,
                           int N, int L, int d, int nl, int order, int kind,
                           int degree, int inc, int diff, int f64,
                           void* stream) {
  if (L < (diff ? 2 : 1) || d < 1 || Tn > 65535 || order < 1 ||
      kind < kLinear || kind > kPoly || (kind == kPoly && degree < 1))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_levels<double>(nl, P, Z, Xt, out, Tn, N, L, d, kind,
                                 degree, inc, diff, s)
             : by_levels<float>(nl, P, Z, Xt, out, Tn, N, L, d, kind, degree,
                                inc, diff, s);
}

}  // extern "C"
