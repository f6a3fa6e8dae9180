// Goursat (signature-PDE) adjoint gradient for Hopper (sm_90a):
// out[b] = ḡ[b] · ∂u_b(S·f, T·f)/∂inc_b [Su, Tu] in unrefined coordinates.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/goursat_pallas.py:
// _fused_kernel with with_grad (goursat_grad_fused, the custom VJP of
// goursat_corner_refined, goursat.py:337): the same gradient for every
// shape, where the JAX package falls back to its scan adjoint above its
// VMEM budget. Entry point gpsig_goursat_grad, the backward of both
// forwards in goursat.cu (at o = 0 for the given-grid route). The plain
// version is autograd through ops/goursat.py's sweep, whose backward is
// the plain adjoint sweep.
//
// Design. One block per pair, swept as the forward (goursat.cuh):
//  1. a forward sweep that keeps every u: in shared memory as a dense
//     (R+1) x (C+1) grid when it fits (the wrapper decides, and passes no
//     workspace), else in a device workspace the wrapper allocates with
//     torch.empty, diagonal by diagonal so that a diagonal's reads are
//     contiguous;
//  2. the reverse sweep of the adjoint recursion from μ[R][C] = 1, diagonal
//     by diagonal in the forward's three shared buffers,
//       μ[i][j] = -μ[i+1][j+1] + μ[i][j+1] (1 + a(i-1, j)/2)
//                 + μ[i+1][j] (1 + a(i, j-1)/2),
//     each cell emitting ∂corner/∂a(i-1, j-1) = μ[i][j] (u[i][j-1] +
//     u[i-1][j]) / 2 times ḡ / 4^o into its unrefined cell. For o >= 1
//     several refined cells of one diagonal share an unrefined cell, so
//     the sums are shared-memory atomicAdd (f32 and f64 both exist on
//     sm_90) into the pair's [Su, Tu] block, written out once at the end;
//     where the block does not fit beside the u store, device-memory
//     atomics into the zeroed output. The order of the adds changes from
//     run to run.
// The saved tensor is the unrefined inc, as in the JAX custom VJP: the
// refined grid exists nowhere.
//
// What bounds it on the H100. Per refined cell the forward's 6 operations
// plus 11 for the adjoint step and 5 for the emitted term: 22 Sr Tr B
// operations at 67 TFLOP/s; bytes are inc and ḡ read once and the
// gradient written once, which bound it up to o = 1. As the forward it is
// a chain of dependent diagonals with a barrier each, now twice as long,
// and a pair whose u store takes shared memory (39 KB at the training
// shape, 98 x 98 refined cells in float32) holds fewer blocks per SM.

#include "goursat.cuh"

namespace {

using namespace gpsig;

template <typename T>
__global__ void goursat_grad_kernel(const T* __restrict__ inc,
                                    const T* __restrict__ gbar,
                                    T* __restrict__ out, T* __restrict__ work,
                                    int Su, int Tu, int o, int acc_smem,
                                    int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long pair = static_cast<long long>(Su) * Tu;
  const T* src = inc + blockIdx.x * pair;
  RefinedGrid<T> a(src, Su, Tu, o);
  const int R = a.R, C = a.C;
  T* buf = smem;
  T* next = smem + 3 * (R + 1);
  const UIndex uidx{R, C, work != nullptr};
  T* store;
  if (work) {
    store = work + blockIdx.x * static_cast<long long>(R + C + 1) * (R + 1);
  } else {
    store = next;
    next += static_cast<long long>(R + 1) * (C + 1);
  }
  T* acc = out + blockIdx.x * pair;
  if (acc_smem) {
    acc = next;
    next += pair;
    for (long long k = threadIdx.x; k < pair; k += blockDim.x) acc[k] = T(0);
  }
  if (stage) {
    for (long long k = threadIdx.x; k < pair; k += blockDim.x)
      next[k] = src[k];
    a.inc = next;
  }
  __syncthreads();
  goursat_sweep(a, buf, store, uidx);  // ends with a barrier

  const T g = gbar[blockIdx.x] * a.scale;
  T* m2 = buf;  // μ diagonals d+2, d+1, d
  T* m1 = buf + (R + 1);
  T* m0 = buf + 2 * (R + 1);
  for (int d = R + C; d >= 2; --d) {
    const int hi = R < d - 1 ? R : d - 1;
    for (int i = (d - C > 1 ? d - C : 1) + threadIdx.x; i <= hi;
         i += blockDim.x) {
      const int j = d - i;
      T mu = T(1);  // the seed μ[R][C]
      if (d < R + C) {
        mu = T(0);
        if (i < R && j < C) mu -= m2[i + 1];
        if (j < C) mu += m1[i] * (T(1) + T(0.5) * a(i - 1, j));
        if (i < R) mu += m1[i + 1] * (T(1) + T(0.5) * a(i, j - 1));
      }
      m0[i] = mu;
      const T gv = g * mu * (store[uidx(i, j - 1)] + store[uidx(i - 1, j)]) *
                   T(0.5);
      atomicAdd(acc + a.offset(i - 1, j - 1), gv);
    }
    __syncthreads();
    T* t = m2;
    m2 = m1;
    m1 = m0;
    m0 = t;
  }
  if (acc_smem) {
    T* dst = out + blockIdx.x * pair;
    for (long long k = threadIdx.x; k < pair; k += blockDim.x) dst[k] = acc[k];
  }
}

template <typename T>
cudaError_t launch(const void* inc, const void* gbar, void* out, void* work,
                   int B, int Su, int Tu, int o, cudaStream_t stream) {
  int R, C;
  swept_sides(Su, Tu, o, R, C);
  size_t bytes = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  if (!work) bytes += static_cast<size_t>(R + 1) * (C + 1) * sizeof(T);
  const size_t block = static_cast<size_t>(Su) * Tu * sizeof(T);
  const int acc_smem = bytes + block <= kSmemCap;
  if (acc_smem) bytes += block;
  const int stage = bytes + block <= kSmemCap;
  if (stage) bytes += block;
  if (bytes > kSmemCap) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(goursat_grad_kernel<T>, bytes);
  if (e != cudaSuccess) return e;
  goursat_grad_kernel<T><<<B, goursat_threads(R), bytes, stream>>>(
      static_cast<const T*>(inc), static_cast<const T*>(gbar),
      static_cast<T*>(out), static_cast<T*>(work), Su, Tu, o, acc_smem,
      stage);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// inc [B, Su, Tu], gbar [B] contiguous, out [B, Su, Tu] zeroed -> out =
// ḡ · ∂u(Su 2^o, Tu 2^o)/∂inc. work: null when the u store fits shared
// memory (the wrapper's grad_workspace_elems), else [B, (R+C+1)(R+1)];
// returns cudaGetLastError() after the launch.
int gpsig_goursat_grad(const void* inc, const void* gbar, void* out,
                       void* work, int B, int Su, int Tu, int o, int f64,
                       void* stream) {
  if (B < 1 || Su < 0 || Tu < 0 || o < 0 || o > 10 ||
      (Su > Tu ? Su : Tu) > (1 << 15) >> o)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(inc, gbar, out, work, B, Su, Tu, o, s)
             : launch<float>(inc, gbar, out, work, B, Su, Tu, o, s);
}

}  // extern "C"
