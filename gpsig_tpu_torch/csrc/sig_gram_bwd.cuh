// Backward of the per-pair signature DP over prebuilt increment matrices,
// for Hopper (sm_90a): M̄ [B, L1, L2] from the level cotangents w
// [nl + 1, B] of out[m, b] = k_m(M_b) (sig_gram.cuh). Shared by the
// sources that compile it: sig_gram_bwd.cu (the entry point and float32
// segments), sig_gram_bwd_f64.cu (float64 segments), sig_gram_bwd_band.cu
// and sig_gram_bwd_band_f64.cu (bands), sig_gram_bwd_deep.cu and
// sig_gram_bwd_deep_f64.cu (past 7 levels), so that their instantiations
// build in parallel.
//
// Replaces the TPU kernels gpsig_tpu/ops/pallas/sig_gram.py:_bwd_kernel
// (order 1, the custom VJP of sig_gram_levels) and sig_gram.py:
// _bwd_kernel_ho (order >= 2, of sig_gram_levels_ho): the VJP of the
// plain version signature_kern, order 1 being the P = 1 instantiation of
// the same source, as in the forward.
//
// Design (redesigned for Hopper). The forward's segments and bands and
// its orientation: the DP it differentiates is the one the forward ran, on
// M's rows, so the M̄ it produces for "column" i, thread entry j is
// ∂/∂M[b, i, j] itself and is stored there, a coalesced row, each entry
// written once (no transpose, no atomics; lanes past L2 write nothing).
// The adjoint is common.cuh's rl_reverse (deep_levels.cuh's deep_reverse
// past 7 levels): a forward sweep to the end carries, then a reverse sweep
// that rebuilds each column's states by subtraction and walks the levels
// down. Its rows per lane come from the larger state (sg_rows<..., true>).
// A segment runs both sweeps in registers. A band cannot: its reverse
// sweep needs, at each column, the prefixes of the bands above (the
// rebuild) and the suffixes of the bands below (the adjoint). So the band
// design runs two wavefronts. The forward pass goes down the bands, each
// band keeping every column's outgoing prefix carries (not a ring: the
// rebuild reads them again) and its end carries. The reverse pass goes up:
// band b rebuilds from the forward's carries of the band above, which are
// complete once band b's own forward has ended, and takes its suffix
// carries from the band below as that band leaves them. A warp takes its
// bands ascending in the forward pass and descending in the reverse pass,
// so no band waits on a band its own warp has still to run.
//
// What bounds it on the H100. It reads M (B L1 L2 values) and writes M̄ of
// the same size, 2 × 19.2 MB at B = 2048, L = 49 in float32: 11.5 us at
// 3.35 TB/s. Per entry it does the forward's DP work twice (forward
// sweep, rebuild) and the adjoint's, about 3-4x the forward's operations,
// plus about twice its scans, so at the training shapes (B = 50 or 150)
// it is bound by its L1 serial column steps per segment or band: latency,
// with fewer warps than the card holds.

#pragma once

#include "sig_gram.cuh"

namespace gpsig {

// M̄ of one column: the thread's R entries of row i (lanes past L2 write
// nothing).
template <typename T, int R>
struct RowSink {
  T* Mbar;
  int L2, t;

  template <typename G>
  __device__ __forceinline__ void operator()(int i, const T (&mbar)[R],
                                             G&) const {
    T* row = Mbar + static_cast<long long>(i) * L2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jj = t * R + r;
      if (jj < L2) row[jj] = mbar[r];
    }
  }
};

// Segment q of a block takes matrices as in sig_gram_seg_kernel; a dead
// segment runs on the last matrix and writes nothing.
template <typename T, int S, typename DP>
__global__ void __launch_bounds__(32 * kPairsPerBlock)
sig_gram_bwd_seg_kernel(const T* __restrict__ M, const T* __restrict__ gw,
                        T* __restrict__ Mbar, T* work, int B, int L1, int L2,
                        int nl, int per_seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = DP::R;
  constexpr int kSegs = 32 * kPairsPerBlock / S;
  const int q = static_cast<int>(threadIdx.x) / S;
  const int t = static_cast<int>(threadIdx.x) % S;
  T* state = (work ? work + static_cast<long long>(blockIdx.x) * kSegs *
                                per_seg
                   : reinterpret_cast<T*>(smem_raw)) +
             static_cast<long long>(q) * per_seg;
  WarpGroup<T, S> g;
  for (long long b0 = static_cast<long long>(blockIdx.x) * kSegs; b0 < B;
       b0 += static_cast<long long>(gridDim.x) * kSegs) {
    const bool live = b0 + q < B;
    const long long b = live ? b0 + q : B - 1;
    const long long off = b * L1 * L2;
    MatrixRows<T, R> rows{M + off, L2, t};
    // a dead segment's sink writes past every row (nothing)
    RowSink<T, R> sink{Mbar + off, live ? L2 : 0, t};
    DP dp(state, S, t, nl);
    dp.forward(rows, L1, nl, g);
    dp.reverse(rows, sink, L1, nl, gw, B, b, g);
  }
}

// The band design's backward: block b takes matrices b, b + gridDim.x,
// ...; shared memory the forward and reverse marks, then the area where
// area_smem (else the block's workspace slot of `area` elements): both
// passes' carries and each band's states (BandArea).
template <typename T, typename DP>
__global__ void __launch_bounds__(32 * kSgBandWarps)
sig_gram_bwd_band_kernel(const T* __restrict__ M, const T* __restrict__ gw,
                         T* __restrict__ Mbar, T* work, int B, int L1,
                         int L2, int nl, int P, int bands, int area_smem,
                         int area) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = DP::R;
  const int W = static_cast<int>(blockDim.x) >> 5;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int K = sg_carries(nl, P);
  int* mf = reinterpret_cast<int*>(smem_raw);
  int* mr = mf + bands;
  T* base = area_smem ? reinterpret_cast<T*>(smem_raw + sg_marks_bytes(bands))
                      : work + static_cast<long long>(blockIdx.x) * area;
  const BandArea<T> ar(base, bands, L1, K,
                       DP::slots(nl, true) + DP::kBetween, R, true);
  const long long step = static_cast<long long>(L1) * K;
  const int last = warp + (bands - 1 - warp) / W * W;  // this warp's last
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();  // the previous matrix is done
    for (int k = threadIdx.x; k < bands; k += blockDim.x) {
      mf[k] = 0;
      mr[k] = L1;
    }
    __syncthreads();
    const long long off = b * L1 * L2;
    for (int band = warp; band < bands; band += W) {
      BandGroup<T> g(K, L1, false,
                     band > 0 ? ar.pf + (band - 1) * step : nullptr,
                     band + 1 < bands ? ar.pf + band * step : nullptr,
                     nullptr, nullptr, band > 0 ? mf + band - 1 : nullptr,
                     band + 1 < bands ? mf + band : nullptr);
      BandColumns<T, R> col{{M + off, L2, band * 32 + lane}, &g};
      DP dp(ar.st + band * ar.per_band, 32, lane, nl);
      dp.forward(col, L1, nl, g);
      g.finish();
      dp.save();
    }
    for (int band = last; band >= 0; band -= W) {
      BandGroup<T> g(K, L1, true,
                     band > 0 ? ar.pf + (band - 1) * step : nullptr, nullptr,
                     band + 1 < bands ? ar.sf + band * step : nullptr,
                     band > 0 ? ar.sf + (band - 1) * step : nullptr,
                     band + 1 < bands ? mr + band + 1 : nullptr,
                     band > 0 ? mr + band : nullptr);
      BandColumns<T, R> col{{M + off, L2, band * 32 + lane}, &g};
      RowSink<T, R> sink{Mbar + off, L2, band * 32 + lane};
      DP dp(ar.st + band * ar.per_band, 32, lane, nl);
      dp.load();
      dp.reverse(col, sink, L1, nl, gw, B, b, g);
      g.finish();
    }
  }
}

// Band: the band design (else segments); each source compiles one.
template <typename T, typename DP, bool Band>
cudaError_t sg_launch_bwd(const SgArgs& a, cudaStream_t stream) {
  if (!sg_plan_ok(a, DP::R) || (a.bands > 1) != Band)
    return cudaErrorInvalidValue;
  const T* M = static_cast<const T*>(a.M);
  const T* gw = static_cast<const T*>(a.g);
  T* Mbar = static_cast<T*>(a.out);
  T* work = static_cast<T*>(a.work);
  if constexpr (Band) {
    const size_t smem = sg_marks_bytes(a.bands) +
                        (a.area_smem ? sizeof(T) * a.area : 0);
    const long long need = BandArea<T>::elems(
        a.bands, a.L1, sg_carries(a.nl, a.P),
        DP::slots(a.nl, true) + DP::kBetween, DP::R, true);
    if (smem > kSegSmemBytes || a.area < need ||
        (!a.area_smem && work == nullptr))
      return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(sig_gram_bwd_band_kernel<T, DP>, smem);
    if (e != cudaSuccess) return e;
    sig_gram_bwd_band_kernel<T, DP><<<a.blocks, 32 * a.W, smem, stream>>>(
        M, gw, Mbar, work, a.B, a.L1, a.L2, a.nl, a.P, a.bands, a.area_smem,
        a.area);
    return cudaGetLastError();
  } else {
  const int per_seg = DP::slots(a.nl, true) > 0 ? a.area : 0;
  if (per_seg < DP::slots(a.nl, true) * a.S * DP::R)
    return cudaErrorInvalidValue;
  const size_t smem =
      work ? 0 : sizeof(T) * static_cast<size_t>(32 * kPairsPerBlock / a.S) *
                     per_seg;
  if (smem > kSegSmemBytes) return cudaErrorInvalidValue;
#define GPSIG_SEG(s)                                                         \
  case s: {                                                                  \
    cudaError_t e = allow_smem(sig_gram_bwd_seg_kernel<T, s, DP>, smem);     \
    if (e != cudaSuccess) return e;                                          \
    sig_gram_bwd_seg_kernel<T, s, DP><<<a.blocks, 32 * kPairsPerBlock, smem, \
                                        stream>>>(M, gw, Mbar, work, a.B,    \
                                                  a.L1, a.L2, a.nl,          \
                                                  per_seg);                  \
    return cudaGetLastError();                                               \
  }
  switch (a.S) {
    GPSIG_SEG(8) GPSIG_SEG(16) GPSIG_SEG(32)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_SEG
  }
}

// The backwards of one dtype: the register path's segments
// (sig_gram_bwd.cu, sig_gram_bwd_f64.cu) and bands (sig_gram_bwd_band.cu,
// sig_gram_bwd_band_f64.cu), and the deep path (sig_gram_bwd_deep.cu,
// sig_gram_bwd_deep_f64.cu).
template <typename T, bool Band>
cudaError_t sg_bwd(const SgArgs& a, cudaStream_t s) {
#define GPSIG_CASE(P, NLM)                                                 \
  return sg_launch_bwd<T, RegDP<T, sg_rows<T, P, NLM, true>(), P, NLM>,    \
                       Band>(a, s);
  GPSIG_SG_REGISTER(a.P, a.nl, GPSIG_CASE)
#undef GPSIG_CASE
}

template <typename T>
cudaError_t sg_bwd_deep(const SgArgs& a, cudaStream_t s) {
#define GPSIG_CASE(P)                                                      \
  return a.bands > 1 ? sg_launch_bwd<T, DeepDP<T, P>, true>(a, s)          \
                     : sg_launch_bwd<T, DeepDP<T, P>, false>(a, s);
  GPSIG_SG_DEEP(a.P, GPSIG_CASE)
#undef GPSIG_CASE
}

extern template cudaError_t sg_bwd<float, false>(const SgArgs&,
                                                 cudaStream_t);
extern template cudaError_t sg_bwd<double, false>(const SgArgs&,
                                                  cudaStream_t);
extern template cudaError_t sg_bwd<float, true>(const SgArgs&, cudaStream_t);
extern template cudaError_t sg_bwd<double, true>(const SgArgs&,
                                                 cudaStream_t);
extern template cudaError_t sg_bwd_deep<float>(const SgArgs&, cudaStream_t);
extern template cudaError_t sg_bwd_deep<double>(const SgArgs&,
                                                cudaStream_t);

}  // namespace gpsig
