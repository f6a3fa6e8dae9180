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
// Design. One warp per (x, y) pair. Lanes hold the rows i of the
// (virtual) increment matrix M[i, j], R consecutive rows per lane (R = 1, 2
// or 4 covers L - 1 <= 32, 64, 128). The warp sweeps the columns j: each
// lane builds the base-kernel values k(x_i, y_{j+1}) for its R + 1 points
// and double-differences them against the previous column held in
// registers, so M never exists in memory. The DP state per level is the
// running column sum C_m[i] = sum_{j' < j} A_m[i, j'], and the order-1
// update for column j is
//     A_1 = M[:, j],   A_m = M[:, j] * (exclusive row prefix of C_{m-1}),
//     C_m += A_m,
// with the prefix taken over C as it was before column j (a warp scan with
// __shfl_up_sync). The level sums k_m = sum_i C_m[i] are warp reductions at
// the end; level 0 is 1. A block is 4 warps sharing one x sequence (Gram)
// or 4 independent sequences (diagonal); the sequences and -|.|^2/2 are
// staged in shared memory.
//
// What bounds it on the H100. Per pair it reads 2 L d values and writes
// nl + 1, so memory is not the limit: instruction throughput is. The work
// per pair is L^2 base-kernel evaluations (2d + 2 flops and one exp each,
// about 1/(R+1) of them repeated at lane boundaries), (L-1)^2 increment
// entries at 3 subtractions + (nl - 1) multiply-adds + nl adds each, and
// per column nl - 1 warp scans of 5 shuffle+add steps: O(nl N1 N2 L^2)
// in all, where the TPU kernel's dense triangular matmuls counted
// 2 nl N1 N2 L^2 Lp. The design keeps everything in registers and spends
// shuffles, not shared-memory round trips, on the prefix; the scans of the
// nl - 1 levels are independent and interleave.

#include "common.cuh"

namespace {

using namespace gpsig;

constexpr int kMaxLevels = 7;
constexpr int kWarpsPerBlock = 4;

// Per-level kernels of one pair, computed by the calling (full) warp.
// xs, ys: [L][d] staged sequences; nxs, nys: their -|.|^2/2 (RBF only).
// Lane 0 writes level m to out[m * stride].
template <typename T, int R>
__device__ void pair_levels(const T* xs, const T* nxs, const T* ys,
                            const T* nys, int L, int d, int nl, bool rbf,
                            T* out, long long stride) {
  const int lane = threadIdx.x & 31;
  const int rows = L - 1;
  int xi[R + 1];
  T nx[R + 1];
#pragma unroll
  for (int r = 0; r <= R; ++r) {
    xi[r] = min(lane * R + r, L - 1);
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
      mcol[r] = (lane * R + r < rows) ? v : T(0);
    }
#pragma unroll
    for (int r = 0; r <= R; ++r) kprev[r] = knew[r];

    // exclusive row prefixes of C_1..C_{nl-1}, before this column's update
    T pre[kMaxLevels][R];
#pragma unroll
    for (int m = 0; m + 1 < kMaxLevels; ++m)
      if (m + 1 < nl) warp_excl_prefix<T, R>(C[m], pre[m], lane);
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

  if (lane == 0) out[0] = T(1);
#pragma unroll
  for (int m = 0; m < kMaxLevels; ++m) {
    if (m < nl) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += C[m][r];
      s = warp_sum(s);
      if (lane == 0) out[(m + 1) * stride] = s;
    }
  }
}

// Gram: block b handles x = X[b / nyb] against the 4 y sequences
// (b % nyb) * 4 + warp. out: [nl + 1, N1, N2].
template <typename T, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_gram_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                  T* __restrict__ out, int N1, int N2, int L, int d, int nl,
                  int rbf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nyb = (N2 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int n1 = blockIdx.x / nyb;
  const int n2 = (blockIdx.x % nyb) * kWarpsPerBlock + warp;
  const int Ld = L * d;
  T* xs = smem;
  T* nxs = xs + Ld;
  T* ys = nxs + L + warp * (Ld + L);
  T* nys = ys + Ld;

  const T* xg = X + static_cast<long long>(n1) * Ld;
  for (int k = threadIdx.x; k < Ld; k += blockDim.x) xs[k] = xg[k];
  if (n2 < N2) {
    const T* yg = Y + static_cast<long long>(n2) * Ld;
    for (int k = lane; k < Ld; k += 32) ys[k] = yg[k];
  }
  __syncthreads();
  if (rbf) {
    half_sqnorms(xs, nxs, L, d, threadIdx.x, blockDim.x);
    if (n2 < N2) half_sqnorms(ys, nys, L, d, lane, 32);
  }
  __syncthreads();
  if (n2 >= N2) return;
  const long long stride = static_cast<long long>(N1) * N2;
  pair_levels<T, R>(xs, nxs, ys, nys, L, d, nl, rbf != 0,
                    out + static_cast<long long>(n1) * N2 + n2, stride);
}

// Diagonal: warp w of block b handles sequence n = b * 4 + w against
// itself. out: [nl + 1, N].
template <typename T, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_diag_kernel(const T* __restrict__ X, T* __restrict__ out, int N,
                  int L, int d, int nl, int rbf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;  // whole warps only; no block-wide barrier follows
  const int Ld = L * d;
  T* xs = smem + warp * (Ld + L);
  T* nxs = xs + Ld;
  const T* xg = X + static_cast<long long>(n) * Ld;
  for (int k = lane; k < Ld; k += 32) xs[k] = xg[k];
  __syncwarp();
  if (rbf) half_sqnorms(xs, nxs, L, d, lane, 32);
  __syncwarp();
  pair_levels<T, R>(xs, nxs, xs, nxs, L, d, nl, rbf != 0, out + n,
                    static_cast<long long>(N));
}

template <typename T, int R>
cudaError_t launch_gram(const void* X, const void* Y, void* out, int N1,
                        int N2, int L, int d, int nl, int rbf,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * (1 + kWarpsPerBlock);
  cudaError_t e = allow_smem(fused_gram_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  const long long nyb = (N2 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long blocks = static_cast<long long>(N1) * nyb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fused_gram_kernel<T, R><<<static_cast<unsigned>(blocks),
                            kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<T*>(out), N1, N2, L, d, nl, rbf);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_diag(const void* X, void* out, int N, int L, int d,
                        int nl, int rbf, cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * static_cast<size_t>(L) * (d + 1) * kWarpsPerBlock;
  cudaError_t e = allow_smem(fused_diag_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_diag_kernel<T, R><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(X), static_cast<T*>(out), N, L, d, nl, rbf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gram_dispatch(const void* X, const void* Y, void* out, int N1,
                          int N2, int L, int d, int nl, int rbf,
                          cudaStream_t s) {
  switch (rows_per_lane(L)) {
    case 1: return launch_gram<T, 1>(X, Y, out, N1, N2, L, d, nl, rbf, s);
    case 2: return launch_gram<T, 2>(X, Y, out, N1, N2, L, d, nl, rbf, s);
    case 4: return launch_gram<T, 4>(X, Y, out, N1, N2, L, d, nl, rbf, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t diag_dispatch(const void* X, void* out, int N, int L, int d,
                          int nl, int rbf, cudaStream_t s) {
  switch (rows_per_lane(L)) {
    case 1: return launch_diag<T, 1>(X, out, N, L, d, nl, rbf, s);
    case 2: return launch_diag<T, 2>(X, out, N, L, d, nl, rbf, s);
    case 4: return launch_diag<T, 4>(X, out, N, L, d, nl, rbf, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_args(int L, int d, int nl) {
  return L < 2 || d < 1 || nl < 1 || nl > kMaxLevels;
}

}  // namespace

extern "C" {

// X [N1, L, d], Y [N2, L, d] contiguous -> out [nl + 1, N1, N2]; returns
// cudaGetLastError() after the launch (0 on success).
int gpsig_fused_gram(const void* X, const void* Y, void* out, int N1, int N2,
                     int L, int d, int nl, int rbf, int f64, void* stream) {
  if (bad_args(L, d, nl)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? gram_dispatch<double>(X, Y, out, N1, N2, L, d, nl, rbf, s)
             : gram_dispatch<float>(X, Y, out, N1, N2, L, d, nl, rbf, s);
}

// X [N, L, d] contiguous -> out [nl + 1, N]
int gpsig_fused_diag(const void* X, void* out, int N, int L, int d, int nl,
                     int rbf, int f64, void* stream) {
  if (bad_args(L, d, nl)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? diag_dispatch<double>(X, out, N, L, d, nl, rbf, s)
             : diag_dispatch<float>(X, out, N, L, d, nl, rbf, s);
}

const char* gpsig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
