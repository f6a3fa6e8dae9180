// Fused order-1 signature Gram and its diagonal, for Hopper (sm_90a).
//
// Replaces the TPU kernels gpsig_tpu/ops/pallas/fused_gram.py:_fused_kernel
// (per-level Gram k_m(x, y), entry point fused_gram_levels) and
// fused_gram.py:_diag_kernel (self kernels k_m(x, x), entry point
// fused_diag_levels). Semantics: order 1, difference=True, RBF or Linear
// base on pre-scaled sequences, num_levels <= 7; the RBF column build is
// exp(-1/2 (|x|^2 + |y|^2) + <x, y>) without a clamp, as the Pallas kernel
// and its references _xla_reference / _xla_reference_diag compute it.
//
// Design. One group of threads per (x, y) pair (common.cuh): up to 128
// rows one warp (a WarpGroup), four pairs to a block (a block shares one x
// sequence for the Gram, or holds four sequences for the diagonal); above,
// one block of W <= 8 warps per pair (a BlockGroup; the plan (W, R) comes
// from the wrapper, ops/cuda/plan.py). Group thread t holds the rows i of
// the (virtual) increment matrix M[i, j], R consecutive rows from t*R
// (R = 1, 2 or 4 for one warp, 4 for W warps).
// The group sweeps the columns j: each thread builds the base-kernel values
// k(x_i, y_{j+1}) for its R + 1 points and double-differences them
// against the previous column held in registers, so M never exists in
// memory. The DP state per level is the running column sum
// C_m[i] = sum_{j' < j} A_m[i, j'], and the order-1 update for column j is
//     A_1 = M[:, j],   A_m = M[:, j] * (exclusive row prefix of C_{m-1}),
//     C_m += A_m,
// with the prefix taken over C as it was before column j (a warp scan with
// __shfl_up_sync; across warps, the warp totals through shared memory).
// The level sums k_m = sum_i C_m[i] are group reductions at the end;
// level 0 is 1.
// The sequences and -|.|^2/2 are staged in shared memory.
//
// What bounds it on the H100. Per pair it reads 2 L d values and writes
// nl + 1, so memory is not the limit: instruction throughput is. The work
// per pair is L^2 base-kernel evaluations (2d + 2 flops and one exp each,
// about 1/(R+1) of them repeated at thread boundaries), (L-1)^2 increment
// entries at 3 subtractions + (nl - 1) multiply-adds + nl adds each, and
// per column nl - 1 warp scans of 5 shuffle+add steps: O(nl N1 N2 L^2)
// in all, where the TPU kernel's dense triangular matmuls counted
// 2 nl N1 N2 L^2 Lp. The design keeps everything in registers and spends
// shuffles, not shared-memory round trips, on the prefix; the scans of the
// nl - 1 levels are independent and interleave. Above 128 rows the W
// warps of a pair add a shared-memory exchange and a barrier per scan and
// keep R = 4, so the registers per thread do not grow with L; the
// single-warp instantiations never run that code.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kMaxLevels = 7;

// Per-level kernels of one pair, computed by the calling group.
// xs, ys: [L][d] staged sequences; nxs, nys: their -|.|^2/2 (RBF only).
// Group thread 0 writes level m to out[m * stride].
template <typename T, int R, typename G>
__device__ void pair_levels(const T* xs, const T* nxs, const T* ys,
                            const T* nys, int L, int d, int nl, bool rbf,
                            T* out, long long stride, G& g) {
  const int t = g.thread();
  const int rows = L - 1;
  int xi[R + 1];
  T nx[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    xi[r] = min(t * R + r, L - 1);
    nx[r] = rbf ? nxs[xi[r]] : T(0);
  }
  T kprev[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r)
    kprev[r] = base_k(xs + xi[r] * d, nx[r], ys, rbf ? nys[0] : T(0), d, rbf);

  T C[kMaxLevels][R];
#pragma unroll
  for (int m = 0; m < kMaxLevels; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) C[m][r] = T(0);

  for (int j = 0; j < rows; ++j) {
    const T* yj = ys + (j + 1) * d;
    const T nyj = rbf ? nys[j + 1] : T(0);
    T knew[R + 1];
#pragma unroll
    for (int r = 0; r <= R; ++r)
      knew[r] = base_k(xs + xi[r] * d, nx[r], yj, nyj, d, rbf);
    T mcol[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T v = (knew[r + 1] - kprev[r + 1]) - (knew[r] - kprev[r]);
      mcol[r] = (t * R + r < rows) ? v : T(0);
    }
#pragma unroll
    for (int r = 0; r <= R; ++r) kprev[r] = knew[r];

    // exclusive row prefixes of C_1..C_{nl-1}, before this column's update
    T pre[kMaxLevels][R];
#pragma unroll
    for (int m = 0; m + 1 < kMaxLevels; ++m)
      if (m + 1 < nl) g.template prefix<R>(C[m], pre[m]);
#pragma unroll
    for (int r = 0; r < R; ++r) C[0][r] += mcol[r];
#pragma unroll
    for (int m = 1; m < kMaxLevels; ++m) {
      if (m < nl) {
#pragma unroll
        for (int r = 0; r < R; ++r) C[m][r] += mcol[r] * pre[m - 1][r];
      }
    }
  }

  if (t == 0) out[0] = T(1);
#pragma unroll
  for (int m = 0; m < kMaxLevels; ++m) {
    if (m < nl) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += C[m][r];
      s = g.sum(s);
      if (t == 0) out[(m + 1) * stride] = s;
    }
  }
}

// Gram: block b handles x = X[b / nyb] against the y sequences
// (b % nyb) * pairs + p, p the block's pair index (one warp each, or the
// whole block for a BlockGroup). out: [nl + 1, N1, N2].
template <typename T, int R, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
fused_gram_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                  T* __restrict__ out, int N1, int N2, int L, int d, int nl,
                  int rbf, int W) {
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
  if (rbf) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    if (n2 < N2) half_sqnorms(ys, nys, L, d, gt, gthreads);
  }
  __syncthreads();
  if (n2 >= N2) return;  // whole warps only; a block group is always live
  G g(W, buf);
  const long long stride = static_cast<long long>(N1) * N2;
  pair_levels<T, R>(xs, nxs, ys, nys, L, d, nl, rbf != 0,
                    out + static_cast<long long>(n1) * N2 + n2, stride, g);
}

// Diagonal: pair p of block b handles sequence n = b * pairs + p against
// itself. out: [nl + 1, N].
template <typename T, int R, typename G>
__global__ void __launch_bounds__(G::kMaxThreads)
fused_diag_kernel(const T* __restrict__ X, T* __restrict__ out, int N,
                  int L, int d, int nl, int rbf, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const int p = G::kBlock ? 0 : static_cast<int>(threadIdx.x) >> 5;
  const int n = blockIdx.x * pairs + p;
  if (n >= N) return;  // whole warps only; a block group is always live
  const int Ld = L * d;
  const int gthreads = 32 * W;
  const int gt = static_cast<int>(threadIdx.x) - p * 32;
  T* xs = smem + p * (Ld + L);
  T* nxs = xs + Ld;
  T* buf = smem + pairs * (Ld + L);
  const T* xg = X + static_cast<long long>(n) * Ld;
  G g(W, buf);
  for (int k = gt; k < Ld; k += gthreads) xs[k] = xg[k];
  g.sync();
  if (rbf) half_sqnorms(xs, nxs, L, d, gt, gthreads);
  g.sync();
  pair_levels<T, R>(xs, nxs, xs, nxs, L, d, nl, rbf != 0, out + n,
                    static_cast<long long>(N), g);
}

template <typename T, int R, typename G>
cudaError_t launch_gram(const void* X, const void* Y, void* out, int N1,
                        int N2, int L, int d, int nl, int rbf, int W,
                        cudaStream_t stream) {
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * (1 + pairs) +
      exchange_bytes<T>(W);
  cudaError_t e = allow_smem(fused_gram_kernel<T, R, G>, smem);
  if (e != cudaSuccess) return e;
  const long long nyb = (N2 + pairs - 1) / pairs;
  const long long blocks = static_cast<long long>(N1) * nyb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fused_gram_kernel<T, R, G><<<static_cast<unsigned>(blocks),
                               G::kBlock ? 32 * W : 32 * kPairsPerBlock, smem,
                               stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(out), N1, N2, L, d, nl, rbf, W);
  return cudaGetLastError();
}

template <typename T, int R, typename G>
cudaError_t launch_diag(const void* X, void* out, int N, int L, int d,
                        int nl, int rbf, int W, cudaStream_t stream) {
  const int pairs = G::kBlock ? 1 : kPairsPerBlock;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * pairs +
      exchange_bytes<T>(W);
  cudaError_t e = allow_smem(fused_diag_kernel<T, R, G>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (N + pairs - 1) / pairs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fused_diag_kernel<T, R, G><<<static_cast<unsigned>(blocks),
                               G::kBlock ? 32 * W : 32 * kPairsPerBlock, smem,
                               stream>>>(
      static_cast<const T*>(X), static_cast<T*>(out), N, L, d, nl, rbf, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gram_dispatch(const void* X, const void* Y, void* out, int N1,
                          int N2, int L, int d, int nl, int rbf, int W, int R,
                          cudaStream_t s) {
  using WG = WarpGroup<T>;
  if (W > 1)
    return launch_gram<T, 4, BlockGroup<T>>(X, Y, out, N1, N2, L, d, nl, rbf,
                                            W, s);
  switch (R) {
    case 1: return launch_gram<T, 1, WG>(X, Y, out, N1, N2, L, d, nl, rbf, 1,
                                         s);
    case 2: return launch_gram<T, 2, WG>(X, Y, out, N1, N2, L, d, nl, rbf, 1,
                                         s);
    case 4: return launch_gram<T, 4, WG>(X, Y, out, N1, N2, L, d, nl, rbf, 1,
                                         s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t diag_dispatch(const void* X, void* out, int N, int L, int d,
                          int nl, int rbf, int W, int R, cudaStream_t s) {
  using WG = WarpGroup<T>;
  if (W > 1)
    return launch_diag<T, 4, BlockGroup<T>>(X, out, N, L, d, nl, rbf, W, s);
  switch (R) {
    case 1: return launch_diag<T, 1, WG>(X, out, N, L, d, nl, rbf, 1, s);
    case 2: return launch_diag<T, 2, WG>(X, out, N, L, d, nl, rbf, 1, s);
    case 4: return launch_diag<T, 4, WG>(X, out, N, L, d, nl, rbf, 1, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_args(int L, int d, int nl, int W, int R) {
  return L < 2 || d < 1 || nl < 1 || nl > kMaxLevels ||
         !plan_ok(L - 1, W, R);
}

}  // namespace

extern "C" {

// X [N1, L, d], Y [N2, L, d] contiguous -> out [nl + 1, N1, N2], the L - 1
// rows spread as the plan (W warps, R rows a lane) says; returns
// cudaGetLastError() after the launch (0 on success).
int gpsig_fused_gram(const void* X, const void* Y, void* out, int N1, int N2,
                     int L, int d, int nl, int rbf, int W, int R, int f64,
                     void* stream) {
  if (bad_args(L, d, nl, W, R)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? gram_dispatch<double>(X, Y, out, N1, N2, L, d, nl, rbf, W, R,
                                     s)
             : gram_dispatch<float>(X, Y, out, N1, N2, L, d, nl, rbf, W, R,
                                    s);
}

// X [N, L, d] contiguous -> out [nl + 1, N]
int gpsig_fused_diag(const void* X, void* out, int N, int L, int d, int nl,
                     int rbf, int W, int R, int f64, void* stream) {
  if (bad_args(L, d, nl, W, R)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? diag_dispatch<double>(X, out, N, L, d, nl, rbf, W, R, s)
             : diag_dispatch<float>(X, out, N, L, d, nl, rbf, W, R, s);
}

const char* gpsig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
