// Fused signature Gram of the general engine, for Hopper (sm_90a): any
// order, difference True or False, linear / RBF / poly<K> / cosine base.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/fused_gram_ho.py:_ho_kernel
// (entry point fused_gram_ho_levels): out[m, a, b] = k_m(x_a, y_b), the
// level-m truncated signature kernel at order p = min(order, num_levels),
// num_levels <= 7, on pre-scaled sequences (a Poly offset already folded
// in as a constant channel by the kernel layer). The plain version is
// _xla_reference_ho (fused_gram_ho.py), the recursion ops/signature.py's
// _higher_order; the RBF exponent is not clamped, as there.
//
// Design. One group of threads per (x, y) pair, as fused_gram.cu: up to
// 128 rows one warp, four pairs to a block sharing one x sequence; above,
// one block of W <= 8 warps per pair (the wrapper's plan, ops/cuda/
// plan.py), the row scans crossing the warps through shared memory
// (common.cuh's BlockGroup). Group thread t holds the rows i of the
// (virtual) increment matrix M[i, j], R = 2 or 4 consecutive rows from
// t*R (4 for W warps), and the group sweeps the columns j, building each
// column of M
// in registers from the staged sequences: with difference=True the
// double difference of the base-kernel values at the thread's R + 1
// points against the previous column's (L - 1 rows and columns), with
// difference=False the raw values (L rows and columns). Rows past the
// matrix are set to exactly 0 (RBF and cosine are not 0 at zero input, so
// a padded row would otherwise count). The run-length DP over the columns
// is run_length_levels in common.cuh, shared with sig_gram.cu. The
// sequences and -|.|^2/2 are staged in shared memory. Templated on (P, R)
// and the group: 7 x 3 instantiations per dtype (R = 2, 4 on a warp, 4 on
// a block); the kind, difference, num_levels and W are run-time arguments
// on which the whole launch branches alike.
//
// What bounds it on the H100. Per pair it reads 2 L d values and writes
// nl + 1, so memory is not the limit: instruction throughput is. Per pair
// it evaluates about L^2 (1 + 1/R) base kernels (2d + 2 flops and one exp,
// or a cos and a sqrt, each) and, per increment entry and level m, about
// R_m^2 + 3 R_m multiply-adds for the states and their sums, plus R_m
// warp scans of 5 shuffle-adds per column and level (R_m = min(p, m)). At
// order 2 that is about 3x the order-1 kernel's DP work; the design keeps
// every state in registers and spends shuffles, not shared memory, on the
// prefixes.

#include "common.cuh"

namespace {

using namespace gpsig;

// Columns of M for one pair, built from staged sequences.
template <typename T, int R>
struct GramColumns {
  const T* xs;
  const T* ys;
  const T* nys;
  int L, d, kind, degree, rows, t;
  bool diff;
  int xi[R + 1];
  T nx[R + 1];
  T kprev[R + 1];

  __device__ GramColumns(const T* xs_, const T* nxs, const T* ys_,
                         const T* nys_, int L_, int d_, int kind_,
                         int degree_, bool diff_, int t_)
      : xs(xs_), ys(ys_), nys(nys_), L(L_), d(d_), kind(kind_),
        degree(degree_), rows(diff_ ? L_ - 1 : L_), t(t_), diff(diff_) {
    const bool norms = kind_norms(kind);
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      xi[r] = min(t * R + r, L - 1);
      nx[r] = norms ? nxs[xi[r]] : T(0);
    }
    if (diff) {
#pragma unroll
      for (int r = 0; r <= R; ++r) kprev[r] = k(r, 0);
    }
  }

  __device__ T k(int r, int j) const {
    return kind_k(xs + xi[r] * d, nx[r], ys + j * d,
                  kind_norms(kind) ? nys[j] : T(0), d, kind, degree);
  }

  __device__ void operator()(int j, T (&mcol)[R]) {
    if (diff) {
      T knew[R + 1];
#pragma unroll
      for (int r = 0; r <= R; ++r) knew[r] = k(r, j + 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T v = (knew[r + 1] - kprev[r + 1]) - (knew[r] - kprev[r]);
        mcol[r] = (t * R + r < rows) ? v : T(0);
      }
#pragma unroll
      for (int r = 0; r <= R; ++r) kprev[r] = knew[r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        mcol[r] = (t * R + r < rows) ? k(r, j) : T(0);
    }
  }
};

// Block b handles x = X[b / nyb] against the y sequences
// (b % nyb) * pairs + p (one warp each, or the whole block for a
// BlockGroup). out: [nl + 1, N1, N2].
template <typename T, int R, int P, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
gram_ho_kernel(const T* __restrict__ X, const T* __restrict__ Y,
               T* __restrict__ out, int N1, int N2, int L, int d, int nl,
               int kind, int degree, int diff, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const int p = G::kBlock ? 0 : static_cast<int>(threadIdx.x) >> 5;
  const int nyb = (N2 + pairs - 1) / pairs;
  const int n1 = blockIdx.x / nyb;
  const int n2 = (blockIdx.x % nyb) * pairs + p;
  const int Ld = L * d;
  const int gthreads = 32 * W;
  const int gt = static_cast<int>(threadIdx.x) - p * 32;
  T* xs = smem;
  T* nxs = xs + Ld;
  T* ys = nxs + L + p * (Ld + L);
  T* nys = ys + Ld;
  T* buf = xs + (1 + pairs) * (Ld + L);

  const T* xg = X + static_cast<long long>(n1) * Ld;
  for (int k = threadIdx.x; k < Ld; k += blockDim.x) xs[k] = xg[k];
  if (n2 < N2) {
    const T* yg = Y + static_cast<long long>(n2) * Ld;
    for (int k = gt; k < Ld; k += gthreads) ys[k] = yg[k];
  }
  __syncthreads();
  if (kind_norms(kind)) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    if (n2 < N2) half_sqnorms(ys, nys, L, d, gt, gthreads);
  }
  __syncthreads();
  if (n2 >= N2) return;  // whole warps only; a block group is always live
  G g(W, buf);
  GramColumns<T, R> col(xs, nxs, ys, nys, L, d, kind, degree, diff != 0,
                        g.thread());
  run_length_levels<T, R, P>(col, diff ? L - 1 : L, nl,
                             out + static_cast<long long>(n1) * N2 + n2,
                             static_cast<long long>(N1) * N2, g);
}

template <typename T, int R, int P, typename G>
cudaError_t launch(const void* X, const void* Y, void* out, int N1, int N2,
                   int L, int d, int nl, int kind, int degree, int diff,
                   int W, cudaStream_t stream) {
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * (1 + pairs) +
      exchange_bytes<T>(W);
  cudaError_t e = allow_smem(gram_ho_kernel<T, R, P, G>, smem);
  if (e != cudaSuccess) return e;
  const long long nyb = (N2 + pairs - 1) / pairs;
  const long long blocks = static_cast<long long>(N1) * nyb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gram_ho_kernel<T, R, P, G><<<static_cast<unsigned>(blocks),
                               G::kBlock ? 32 * W : 32 * kPairsPerBlock, smem,
                               stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(out), N1, N2, L, d, nl, kind, degree, diff, W);
  return cudaGetLastError();
}

template <typename T, int R, typename G>
cudaError_t by_order(int P, const void* X, const void* Y, void* out, int N1,
                     int N2, int L, int d, int nl, int kind, int degree,
                     int diff, int W, cudaStream_t s) {
#define GPSIG_P(p)                                                          \
  case p:                                                                   \
    return launch<T, R, p, G>(X, Y, out, N1, N2, L, d, nl, kind, degree,    \
                              diff, W, s);
  switch (P) {
    GPSIG_P(1) GPSIG_P(2) GPSIG_P(3) GPSIG_P(4) GPSIG_P(5) GPSIG_P(6)
    GPSIG_P(7)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_P
}

// One warp a pair at R = 2 or 4, or a block of W warps at R = 4.
template <typename T>
cudaError_t by_rows(int P, const void* X, const void* Y, void* out, int N1,
                    int N2, int L, int d, int nl, int kind, int degree,
                    int diff, int W, int R, cudaStream_t s) {
  if (W > 1)
    return by_order<T, 4, BlockGroup<T>>(P, X, Y, out, N1, N2, L, d, nl,
                                         kind, degree, diff, W, s);
  switch (R) {
    case 2: return by_order<T, 2, WarpGroup<T>>(P, X, Y, out, N1, N2, L, d,
                                                nl, kind, degree, diff, 1, s);
    case 4: return by_order<T, 4, WarpGroup<T>>(P, X, Y, out, N1, N2, L, d,
                                                nl, kind, degree, diff, 1, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// X [N1, L, d], Y [N2, L, d] contiguous -> out [nl + 1, N1, N2], at order
// p = min(order, nl); kind as gpsig::BaseKind (degree for kPoly); the rows
// spread as the plan (W warps, R rows a lane) says; returns
// cudaGetLastError() after the launch (0 on success).
int gpsig_fused_gram_ho(const void* X, const void* Y, void* out, int N1,
                        int N2, int L, int d, int nl, int order, int kind,
                        int degree, int diff, int W, int R, int f64,
                        void* stream) {
  if (L < 2 || d < 1 || nl < 1 || nl > kRlLevels || order < 1 ||
      kind < kLinear || kind > kPoly || (kind == kPoly && degree < 1) ||
      !plan_ok(diff ? L - 1 : L, W, R))
    return cudaErrorInvalidValue;
  const int P = order < nl ? order : nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_rows<double>(P, X, Y, out, N1, N2, L, d, nl, kind, degree,
                               diff, W, R, s)
             : by_rows<float>(P, X, Y, out, N1, N2, L, d, nl, kind, degree,
                              diff, W, R, s);
}

}  // extern "C"
