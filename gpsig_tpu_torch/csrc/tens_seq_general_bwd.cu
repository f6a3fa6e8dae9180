// Backward of the general inducing-tensor-vs-sequence levels (Kuf), for
// Hopper (sm_90a): any order, difference True or False, increments or not,
// linear / RBF / poly<K> / cosine base.
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
// Math. Per (t, n) and level m (factor rows off .. off + m - 1) the forward
// runs stages a = 0..m-1 at each step i with R_m = min(p, m) run-length
// states (tens_seq_general.cu):
//   E^(0) = [U_off],  E^(a)[0] = U_{off+a} S_a,  E^(a)[r] = U_{off+a}/(r+1)
//   E^(a-1)[r-1],  S_a = sum over earlier steps of sum_r E^(a-1)[r],
// and k_m sums the last stage. With w_m = g[m], at step i, descending a:
//   Ē^(m-1)[r] = w_m,
//   Ē^(a-1)[r] = Q_a + U_{off+a}/(r+2) Ē^(a)[r+1],  Q_a = sum over later
//               steps of U_{off+a} Ē^(a)[0],
//   Ū_{off+a} = Ē^(a)[0] S_a + sum_{r>=1} Ē^(a)[r] E^(a-1)[r-1]/(r+1),
//   Ū_off = Ē^(0)[0].
// Then ḡ_f(i) = Ū_f(i) - Ū_f(i+1) (difference; Ū(L) = 0 and the walk ends
// at i = 0 with ḡ = -Ū(1)) or Ū_f(i) (no difference), and through each
// factor point's activation and accumulator (as fused_gram_ho_bwd.cu):
// u = ±ḡ dk/dacc (minus for a pair's first point under increments),
//   Z̄_f2 = sum_i u x_i (- z_f2 sum_i u),  X̄_i = sum_f2 u z_f2 (- x_i sum u).
//
// Design. tens_seq_bwd.cu's with tens_seq_general.cu's factor buffer: one
// thread per (tensor t, sequence n), a block one tensor against up to 128
// sequences, the factors and -|z|^2/2 in shared memory, X passed
// transposed [L, d, N]. The TPU kernel stores every DP stage; here the
// thread runs the forward walk to the end sums S, then walks back and
// rebuilds each step's stages by subtraction (ascending a, level by level:
// the levels are independent, so one level's stages are live at a time),
// so nothing of size O(L) is kept. Factor values g_f(i) are evaluated by a
// loop that is not unrolled (the base kind is a run-time switch; unrolled,
// its four activations multiplied the compile time, as in the forward)
// into the thread's columns of shared memory, by parity of i so g(i) and
// g(i-1) are both at hand; the chain to the inputs is such a loop too,
// recomputing each factor point's accumulator. What the thread holds, and
// where: S and Q (F - nl each) and one level's stages and adjoints in
// registers; in shared memory, per thread, x_i by parity (2d), the factor
// buffer (2F), Ū(i+1) and ḡ (F each), its X̄_i sums (d) and its Z̄ sums
// (F2 (d + 1): 90 at nl = 5 with increments and d = 2), summed across the
// block at the end and added atomically across sequence blocks. X̄ rows
// are added atomically across the T tensor blocks into [L, d, N]. The block
// is the largest of 128, 64 and 32 threads whose shared memory fits and
// that does not exceed 2N.
//
// What bounds it on the H100. Per (t, n): 3 L F2 base kernels (forward,
// reverse, chain; 2d + 2 flops and an exp or cos each, the chain's with
// its derivative), about 3x the forward's DP multiply-adds, and L F2
// (d + 1) shared-memory updates, L d global atomics. At the training shape
// (T = 500, N = 50, L = 50, F2 = 30, d = 2) the grid is 500 blocks of 64
// threads: exp/FMA and shared-memory traffic, and a grid too small to
// fill 132 SMs for long.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kMaxThreads = 128;

// The forward's DP at one step: S += each stage's states (after use).
template <typename T, int NL, int P>
__device__ __forceinline__ void dp_forward(const T (&U)[NL * (NL + 1) / 2],
                                           T* S) {
#pragma unroll
  for (int m = 2; m <= NL; ++m) {
    const int off = m * (m - 1) / 2;
    const int soff = (m - 1) * (m - 2) / 2;
    const int Rm = P < m ? P : m;
    T cur[P];
    cur[0] = U[off];
#pragma unroll
    for (int r = 1; r < P; ++r) cur[r] = T(0);
#pragma unroll
    for (int a = 1; a < m; ++a) {
      const T ua = U[off + a];
      const int live_prev = Rm < a ? Rm : a;
      const int live = Rm < a + 1 ? Rm : a + 1;
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
  }
}

// One step of the reverse walk: rebuild S to before the step and the
// step's stages, level by level, then the adjoints; Ū of every factor.
template <typename T, int NL, int P>
__device__ __forceinline__ void dp_reverse(const T (&U)[NL * (NL + 1) / 2],
                                           T* S, T* Q, const T (&w)[NL],
                                           T (&ub)[NL * (NL + 1) / 2]) {
#pragma unroll
  for (int m = 1; m <= NL; ++m) {
    const int off = m * (m - 1) / 2;
    const int soff = (m - 1) * (m - 2) / 2;
    const int Rm = P < m ? P : m;
    T stg[NL][P];  // stage a's states
#pragma unroll
    for (int r = 0; r < P; ++r) stg[0][r] = r == 0 ? U[off] : T(0);
#pragma unroll
    for (int a = 1; a < m; ++a) {
      const T ua = U[off + a];
      const int live_prev = Rm < a ? Rm : a;
      const int live = Rm < a + 1 ? Rm : a + 1;
      T sum_prev = T(0);
#pragma unroll
      for (int r = 0; r < P; ++r)
        if (r < live_prev) sum_prev += stg[a - 1][r];
      S[soff + a - 1] -= sum_prev;
      stg[a][0] = ua * S[soff + a - 1];
#pragma unroll
      for (int r = 1; r < P; ++r)
        stg[a][r] = r < live ? ua * (T(1) / T(r + 1)) * stg[a - 1][r - 1]
                             : T(0);
    }
    // eb: Ē of stage a, from the last stage down
    T eb[P];
#pragma unroll
    for (int r = 0; r < P; ++r) eb[r] = r < Rm ? w[m - 1] : T(0);
#pragma unroll
    for (int a = m - 1; a >= 1; --a) {
      const T ua = U[off + a];
      const int live = Rm < a + 1 ? Rm : a + 1;      // states of stage a
      const int live_prev = Rm < a ? Rm : a;         // of stage a - 1
      T v = eb[0] * S[soff + a - 1];
#pragma unroll
      for (int r = 1; r < P; ++r)
        if (r < live) v += eb[r] * stg[a - 1][r - 1] * (T(1) / T(r + 1));
      ub[off + a] = v;
      T ebn[P];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        T e = T(0);
        if (r < live_prev) {
          e = Q[soff + a - 1];
          if (r + 1 < live) e += ua * (T(1) / T(r + 2)) * eb[r + 1];
        }
        ebn[r] = e;
      }
      Q[soff + a - 1] += ua * eb[0];
#pragma unroll
      for (int r = 0; r < P; ++r) eb[r] = ebn[r];
    }
    ub[off] = eb[0];
  }
}

// The minimum of one block per SM lets ptxas use the registers it needs:
// without it, it held the float nl = 5, p = 2 instance (the order-2
// flagship's) to 96 registers and spilled.
template <typename T, int NL, int P>
__global__ void __launch_bounds__(kMaxThreads, 1)
tsg_bwd_kernel(const T* __restrict__ Z, const T* __restrict__ Xt,
               const T* __restrict__ g, T* __restrict__ Zbar,
               T* __restrict__ XbarT, int Tn, int N, int L, int d, int kind,
               int degree, int inc, int diff) {
  constexpr int F = NL * (NL + 1) / 2;
  constexpr int NS = F - NL > 0 ? F - NL : 1;
  const int F2 = inc ? 2 * F : F;
  const bool norms = kind_norms(kind);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int t = blockIdx.y;
  const int n = blockIdx.x * nt + tid;
  const int A = F2 * (d + 1);  // Z̄ sums per thread: [f2][c], c = d is Σu
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);  // [F2][d]
  T* nzs = zs + F2 * d;                     // [F2]
  T* xsh = nzs + F2;                        // [2][d][nt]: x_i by parity
  T* gsh = xsh + 2 * d * nt;                // [2][F][nt]: g(i) by parity
  T* ubsh = gsh + 2 * F * nt;               // [F][nt]: Ū(i + 1)
  T* gbsh = ubsh + F * nt;                  // [F][nt]: ḡ(i)
  T* xbsh = gbsh + F * nt;                  // [d][nt]: X̄_i sums
  T* acc = xbsh + d * nt;                   // [A][nt]

  const T* zg = Z + static_cast<long long>(t) * F2 * d;
  for (int k = tid; k < F2 * d; k += nt) zs[k] = zg[k];
  for (int k = 0; k < A; ++k) acc[k * nt + tid] = T(0);
  for (int f = 0; f < F; ++f) ubsh[f * nt + tid] = T(0);
  __syncthreads();
  if (norms) {
    for (int f = tid; f < F2; f += nt) {
      T s = T(0);
      for (int c = 0; c < d; ++c) s += zs[f * d + c] * zs[f * d + c];
      nzs[f] = T(-0.5) * s;
    }
  }
  __syncthreads();

  if (n < N) {
    auto xslot = [&](int i) { return xsh + (i & 1) * d * nt + tid; };
    auto gslot = [&](int i) { return gsh + (i & 1) * F * nt + tid; };

    // stage x_i and evaluate the factor values g_f(i) into their slots
    auto factors = [&](int i) {
      T* xme = xslot(i);
      T nx = T(0);
      for (int c = 0; c < d; ++c) {
        const T v = Xt[(static_cast<long long>(i) * d + c) * N + n];
        xme[c * nt] = v;
        nx += v * v;
      }
      nx *= T(-0.5);
      T* gme = gslot(i);
#pragma unroll 1
      for (int f = 0; f < F; ++f) {
        T gv;
        if (inc) {
          T a = norms ? nzs[2 * f] + nx : T(0);
          T b = norms ? nzs[2 * f + 1] + nx : T(0);
          for (int c = 0; c < d; ++c) {
            const T xc = xme[c * nt];
            a += zs[(2 * f) * d + c] * xc;
            b += zs[(2 * f + 1) * d + c] * xc;
          }
          gv = activate(b, kind, degree) - activate(a, kind, degree);
        } else {
          T a = norms ? nzs[f] + nx : T(0);
          for (int c = 0; c < d; ++c) a += zs[f * d + c] * xme[c * nt];
          gv = activate(a, kind, degree);
        }
        gme[f * nt] = gv;
      }
    };
    // U(i): g(i) - g(i - 1) with difference, g(i) without
    auto load_u = [&](int i, T (&U)[F]) {
      const T* gi = gslot(i);
      const T* gp = gslot(i - 1);
#pragma unroll
      for (int f = 0; f < F; ++f)
        U[f] = diff ? gi[f * nt] - gp[f * nt] : gi[f * nt];
    };
    // X̄_i and the Z̄ sums of point i, with ḡ_f(i) in gbsh
    auto chain = [&](int i) {
      const T* xme = xslot(i);
      T nx = T(0);
      for (int c = 0; c < d; ++c) {
        nx += xme[c * nt] * xme[c * nt];
        xbsh[c * nt + tid] = T(0);
      }
      nx *= T(-0.5);
      T su = T(0);
#pragma unroll 1
      for (int f2 = 0; f2 < F2; ++f2) {
        const int f = inc ? f2 >> 1 : f2;
        T gb = gbsh[f * nt + tid];
        if (inc && !(f2 & 1)) gb = -gb;
        T a = norms ? nzs[f2] + nx : T(0);
        for (int c = 0; c < d; ++c) a += zs[f2 * d + c] * xme[c * nt];
        const T u = gb * activate_grad(a, kind, degree);
        su += u;
        T* ac = acc + f2 * (d + 1) * nt + tid;
        ac[d * nt] += u;
        for (int c = 0; c < d; ++c) {
          ac[c * nt] += u * xme[c * nt];
          xbsh[c * nt + tid] += u * zs[f2 * d + c];
        }
      }
      for (int c = 0; c < d; ++c) {
        T xb = xbsh[c * nt + tid];
        if (norms) xb -= xme[c * nt] * su;
        atomicAdd(XbarT + (static_cast<long long>(i) * d + c) * N + n, xb);
      }
    };

    // ---- forward walk to the end sums S --------------------------------
    const int i0 = diff ? 1 : 0;
    T S[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) S[k] = T(0);
    if (diff) factors(0);
    for (int i = i0; i < L; ++i) {
      factors(i);
      T U[F];
      load_u(i, U);
      dp_forward<T, NL, P>(U, S);
    }

    // ---- reverse walk ---------------------------------------------------
    T w[NL];
    const long long plane = static_cast<long long>(Tn) * N;
#pragma unroll
    for (int m = 0; m < NL; ++m)
      w[m] = g[(m + 1) * plane + static_cast<long long>(t) * N + n];
    T Q[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) Q[k] = T(0);
    for (int i = L - 1; i >= i0; --i) {
      // g(i) and x_i are in their slots from the step above (or the
      // forward walk's last); with difference g(i - 1) is needed too
      factors(diff ? i - 1 : i);
      T U[F], ub[F];
      load_u(i, U);
      dp_reverse<T, NL, P>(U, S, Q, w, ub);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        T* up = ubsh + f * nt + tid;
        gbsh[f * nt + tid] = diff ? ub[f] - *up : ub[f];
        *up = ub[f];
      }
      chain(i);
    }
    if (diff) {
#pragma unroll
      for (int f = 0; f < F; ++f) gbsh[f * nt + tid] = -ubsh[f * nt + tid];
      chain(0);
    }
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
    if (norms) v -= zs[q] * acc[(f2 * (d + 1) + d) * nt];
    atomicAdd(zb + q, v);
  }
}

template <typename T, int NL, int P>
cudaError_t launch(const void* Z, const void* Xt, const void* g, void* Zbar,
                   void* XbarT, int Tn, int N, int L, int d, int kind,
                   int degree, int inc, int diff, cudaStream_t stream) {
  if constexpr (P > NL) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int F = NL * (NL + 1) / 2;
    const int F2 = (inc ? 2 : 1) * F;
    const size_t cap = 227 * 1024;
    auto bytes = [&](int threads) {
      return sizeof(T) *
             (static_cast<size_t>(F2) * (d + 1) +
              static_cast<size_t>(3 * d + 4 * F + F2 * (d + 1)) * threads);
    };
    int nt = kMaxThreads;
    while (nt > 32 && (bytes(nt) > cap || nt >= 2 * N)) nt /= 2;
    const size_t smem = bytes(nt);
    if (smem > cap) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(tsg_bwd_kernel<T, NL, P>, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((N + nt - 1) / nt, Tn);
    tsg_bwd_kernel<T, NL, P><<<grid, nt, smem, stream>>>(
        static_cast<const T*>(Z), static_cast<const T*>(Xt),
        static_cast<const T*>(g), static_cast<T*>(Zbar),
        static_cast<T*>(XbarT), Tn, N, L, d, kind, degree, inc, diff);
    return cudaGetLastError();
  }
}

template <typename T, int NL>
cudaError_t by_order(int P, const void* Z, const void* Xt, const void* g,
                     void* Zbar, void* XbarT, int Tn, int N, int L, int d,
                     int kind, int degree, int inc, int diff,
                     cudaStream_t s) {
#define GPSIG_P(p)                                                         \
  case p:                                                                  \
    return launch<T, NL, p>(Z, Xt, g, Zbar, XbarT, Tn, N, L, d, kind,      \
                            degree, inc, diff, s);
  switch (P) {
    GPSIG_P(1) GPSIG_P(2) GPSIG_P(3) GPSIG_P(4) GPSIG_P(5) GPSIG_P(6)
    GPSIG_P(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_P
}

template <typename T>
cudaError_t by_levels(int nl, int P, const void* Z, const void* Xt,
                      const void* g, void* Zbar, void* XbarT, int Tn, int N,
                      int L, int d, int kind, int degree, int inc, int diff,
                      cudaStream_t s) {
#define GPSIG_NL(q)                                                        \
  case q:                                                                  \
    return by_order<T, q>(P, Z, Xt, g, Zbar, XbarT, Tn, N, L, d, kind,     \
                          degree, inc, diff, s);
  switch (nl) {
    GPSIG_NL(1) GPSIG_NL(2) GPSIG_NL(3) GPSIG_NL(4) GPSIG_NL(5) GPSIG_NL(6)
    GPSIG_NL(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_NL
}

}  // namespace

extern "C" {

// Z [T, F(, 2), d], Xt [L, d, N] (X transposed), g [nl + 1, T, N]
// contiguous; Zbar [T, F(, 2), d] and XbarT [L, d, N] zero-filled; order,
// kind, degree, inc and diff as gpsig_tens_seq_general. Returns
// cudaGetLastError() after the launch (0 on success).
int gpsig_tens_seq_general_bwd(const void* Z, const void* Xt, const void* g,
                               void* Zbar, void* XbarT, int Tn, int N, int L,
                               int d, int nl, int order, int kind, int degree,
                               int inc, int diff, int f64, void* stream) {
  if (L < (diff ? 2 : 1) || d < 1 || Tn > 65535 || order < 1 ||
      kind < kLinear || kind > kPoly || (kind == kPoly && degree < 1))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_levels<double>(nl, P, Z, Xt, g, Zbar, XbarT, Tn, N, L, d,
                                 kind, degree, inc, diff, s)
             : by_levels<float>(nl, P, Z, Xt, g, Zbar, XbarT, Tn, N, L, d,
                                kind, degree, inc, diff, s);
}

}  // extern "C"
