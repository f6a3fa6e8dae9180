// Goursat (signature-PDE) wavefront forwards for Hopper (sm_90a): the
// corner u(S·f, T·f), f = 2^o, of each pair's solve, from its increment
// grid inc [B, Su, Tu].
//
// Replaces the TPU kernels gpsig_tpu/ops/pallas/goursat_pallas.py:_kernel
// (entry point gpsig_goursat: the corner on a given grid, o = 0, as
// goursat_corner_pallas) and goursat_pallas.py:_fused_kernel without
// with_grad (entry point gpsig_goursat_refined: refinement inside the
// solve, as goursat_corner_fused): one kernel, the refinement shift o a
// run-time argument; each entry point has its own launch counter in
// ops/cuda/goursat.py. The plain version is ops/goursat.py's sweep.
//
// Design (goursat.cuh). One block per pair, the threads over the positions
// of an antidiagonal, the shorter refined side R on the threads (the
// scheme is symmetric under transposing inc), up to 512 threads with a
// loop over cells beyond that, so L = 200 at o = 3 (1,592 refined rows)
// works. Three rotating diagonals in shared memory and one __syncthreads()
// per diagonal. A refined cell reads inc[I >> o, J >> o] / 4^o, from the
// pair's unrefined block staged in shared memory when block and diagonals
// fit in 48 KB (49 x 49 x 4 B = 9.6 KB at L = 50), else from device memory
// through the cache. Only the corner is written. None of the TPU layout is
// carried over: no skewed diagonal-major copy, no 128-lane padding, no
// one-hot expansion matmul.
//
// What bounds it on the H100. A refined cell costs 6 operations (3 adds,
// the increment's scale and 2 multiplies) and a pair reads its Su Tu
// values once: the bytes bound it up to o = 1 (Kuf at prediction: 90 MB
// of increments for 65,536 pairs of 14 x 98 refined cells, 27 us at
// 3.35 TB/s), the 6 Sr Tr B operations at 67 TFLOP/s from o = 2, where a
// cell of inc becomes 4^o cells. The sweep itself is a chain of R + C + 1
// dependent diagonals per pair with a block barrier each, so it is
// latency-bound unless enough pairs are in flight on every SM.

#include "goursat.cuh"

namespace {

using namespace gpsig;

template <typename T>
__global__ void goursat_fwd_kernel(const T* __restrict__ inc,
                                   T* __restrict__ out, int Su, int Tu, int o,
                                   int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long pair = static_cast<long long>(Su) * Tu;
  const T* src = inc + blockIdx.x * pair;
  RefinedGrid<T> a(src, Su, Tu, o);
  if (stage) {
    T* staged = smem + 3 * (a.R + 1);
    for (long long k = threadIdx.x; k < pair; k += blockDim.x)
      staged[k] = src[k];
    a.inc = staged;
    __syncthreads();
  }
  const T corner = goursat_sweep(a, smem, static_cast<T*>(nullptr),
                                 UIndex{a.R, a.C, false});
  if (threadIdx.x == 0) out[blockIdx.x] = corner;
}

template <typename T>
cudaError_t launch(const void* inc, void* out, int B, int Su, int Tu, int o,
                   cudaStream_t stream) {
  int R, C;
  swept_sides(Su, Tu, o, R, C);
  size_t bytes = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  const size_t block = static_cast<size_t>(Su) * Tu * sizeof(T);
  const int stage = bytes + block <= 48 * 1024;
  if (stage) bytes += block;
  if (bytes > kSmemCap) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(goursat_fwd_kernel<T>, bytes);
  if (e != cudaSuccess) return e;
  goursat_fwd_kernel<T><<<B, goursat_threads(R), bytes, stream>>>(
      static_cast<const T*>(inc), static_cast<T*>(out), Su, Tu, o, stage);
  return cudaGetLastError();
}

int run(const void* inc, void* out, int B, int Su, int Tu, int o, int f64,
        void* stream) {
  if (B < 1 || Su < 0 || Tu < 0 || o < 0 || o > 10 ||
      (Su > Tu ? Su : Tu) > (1 << 15) >> o)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(inc, out, B, Su, Tu, o, s)
             : launch<float>(inc, out, B, Su, Tu, o, s);
}

}  // namespace

extern "C" {

// inc [B, S, T] contiguous -> out [B] = u(S, T) on the grid as given (the
// TPU's _kernel); returns cudaGetLastError() after the launch.
int gpsig_goursat(const void* inc, void* out, int B, int S, int T, int f64,
                  void* stream) {
  return run(inc, out, B, S, T, 0, f64, stream);
}

// inc [B, Su, Tu] contiguous (unrefined) -> out [B] = u(Su 2^o, Tu 2^o) of
// the refined solve (the TPU's _fused_kernel forward).
int gpsig_goursat_refined(const void* inc, void* out, int B, int Su, int Tu,
                          int o, int f64, void* stream) {
  return run(inc, out, B, Su, Tu, o, f64, stream);
}

}  // extern "C"
