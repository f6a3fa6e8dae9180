// Per-pair signature DP over prebuilt increment matrices, for Hopper
// (sm_90a): out[m, b] = k_m(M_b) for M [B, L1, L2], and its backward
// (sig_gram_bwd.cuh). Shared by the sources that compile the forward
// (sig_gram.cu: the entry point and float32; sig_gram_f64.cu;
// sig_gram_deep.cu: past 7 levels) and the backward.
//
// Replaces the TPU kernels gpsig_tpu/ops/pallas/sig_gram.py:_fwd_kernel
// (order 1, entry point sig_gram_levels) and sig_gram.py:_fwd_kernel_ho
// (order >= 2, entry point sig_gram_levels_ho): the same function for any
// order p = min(order, num_levels) <= 7 and num_levels <= 127, order 1
// being the P = 1 instantiation of the same source. The plain version is
// ops/signature.py's signature_kern. In the port it computes the
// normalisation diagonal of every configuration that the tuned
// _diag_kernel does not take (order >= 2, difference=False, Poly/Cosine),
// every Gram between sequences of two lengths, every Gram past 7 levels and
// every Gram past the fused Grams' 1024 rows, from increment matrices the
// kernel layer builds in PyTorch.
//
// Orientation. The group streams M's rows M[b, i, :] as the DP's columns
// and spreads j over its lanes as the DP's rows: each read is a contiguous
// row, coalesced. The truncated signature kernel is symmetric under
// transposing M (swapping the roles of i and j swaps the run lengths r and
// s, and the recursion treats them alike), so the kernel layer lays the
// shorter side on L2, the rows.
//
// Design (redesigned for Hopper; ops/cuda/plan.py's sig_gram_plan).
// - Segments, up to what one warp holds: a segment of S = 8, 16 or 32
//   lanes (a WarpGroup<T, S>) takes one matrix at R rows a lane, 32 / S
//   matrices a warp, four warps a block, no barrier. R is the most of 8, 4,
//   2 whose DP state fits kSgStateRegs 32-bit registers (the Gram
//   forwards' rule at a larger budget) at the level bound NLM (4 up to 4
//   levels, else 7); S the fewest lanes with S R >= L2. The forward may
//   take fewer rows a lane (4 or 2) on more lanes: a batch too short to
//   fill the card is latency-bound and runs faster on more warps.
// - Bands, past one warp's rows: the rows go in bands of 32 R on a
//   wavefront of up to kSgBandWarps warps, a block a matrix, band b on warp
//   b mod W. Every cross-row step of the DP is a row scan (exclusive
//   prefixes in the forward and the reverse sweep's rebuild, exclusive
//   suffixes in the adjoint); a BandGroup runs each as the warp's scan
//   started from the sum over the rows of the bands above (prefix) or below
//   (suffix), which the neighbouring band left at this column, one carry a
//   scan, and leaves its own. The carries pass through the block's shared
//   memory where they fit, else a device workspace (the grid then strides
//   over the matrices); progress marks every kSgMark columns let a band run
//   a few columns behind the one it reads.
// - The deep path (num_levels 8 .. 127) takes the same segments and bands
//   at R = 2 with deep_levels.cuh's loop over levels, the per-level slots of
//   each segment or band in shared memory or the workspace.
//
// What bounds it on the H100. It reads B L1 L2 values once and writes
// (nl + 1) B: at the flagship diagonal (B = 2048, L1 = L2 = 49, float32)
// that is 19.7 MB, 5.9 us at 3.35 TB/s, against about L1 L2 (R_m^2 +
// 3 R_m) multiply-adds per level and pair plus R_m segment scans per
// column and level, so instruction throughput bounds it, and L1 serial
// column steps per segment its latency when B is small.

#pragma once

#include "common.cuh"
#include "deep_levels.cuh"

namespace gpsig {

// Warps a banded matrix at most (plan.py's SIG_GRAM_BAND_WARPS), columns
// between a band's progress marks, and the deep path's rows a lane
// (plan.py's SIG_GRAM_DEEP_ROWS).
constexpr int kSgBandWarps = 8;
constexpr int kSgMark = 8;
constexpr int kSgDeepRows = 2;

// The register path's rows a lane at level bound NLM (4 up to 4 levels,
// else 7; plan.py's sig_gram_rows_per_lane): the most of 8, 4, 2 whose
// state fits kSgStateRegs 32-bit registers, p² + NLM + (NLM - 1)(p - 1)
// values a row, and for the backward (NLM - 1)(p² + 2p) + p² + p more.
// The budget is above the Gram forwards' kSegStateRegs: at 160 order 3 at
// nl = 4 takes 8 rows a lane, so L' = 149 fits one warp (0.40 ms against
// two bands at 4 rows a lane, 0.72, on the H100; every backward keeps its
// rows a lane).
constexpr int kSgStateRegs = 160;

template <typename T, int P, int NLM, bool Bwd>
constexpr int sg_rows() {
  constexpr int regs = static_cast<int>(sizeof(T) / 4) *
                       (P * P + NLM + (NLM - 1) * (P - 1) +
                        (Bwd ? (NLM - 1) * (P * P + 2 * P) + P * P + P : 0));
  return 8 * regs <= kSgStateRegs ? 8 : 4 * regs <= kSgStateRegs ? 4 : 2;
}

// Row scans a column takes at num_levels nl and order p (each level m >= 2
// takes min(p, m)): the carries a band leaves a column, in the forward and
// the rebuild (prefixes) and in the adjoint (suffixes) alike.
__host__ __device__ inline int sg_carries(int nl, int P) {
  int k = 0;
  for (int m = 2; m <= nl; ++m) k += P < m ? P : m;
  return k;
}

// Shared memory of a band block's progress marks: forward and reverse, one
// int a band each, in 16-byte steps.
__host__ __device__ inline size_t sg_marks_bytes(int bands) {
  return static_cast<size_t>(2 * bands + 3) / 4 * 16;
}

// One band of a matrix's rows: 32 lanes, rows (band 32 + lane) R + r. The
// DP code's row scans run as the warp's scans from the carry of the band
// above (prefix) or below (suffix) at this column, read by the lane that
// starts the scan once that band's progress mark has passed the column;
// the lane that ends it leaves the band's own carry for the next band.
// Forward pass (reverse = false): prefix carries in from pin (waiting on
// the band above's forward marks), out to pout, this band's forward marks
// in `mark`. Reverse pass: prefix carries from pin as the forward left them
// (complete: no wait), none out; suffix carries in from sin (waiting on the
// band below's reverse marks), out to sout, this band's reverse marks in
// `mark`. Carries are [L1][K]; a null pointer is a matrix edge.
template <typename T>
struct BandGroup {
  WarpGroup<T, 32> w;
  int K, ncols;
  bool reverse;
  const T* pin;
  T* pout;
  const T* sin;
  T* sout;
  const volatile int* wait;  // the marks this band reads, or null
  volatile int* mark;        // its own, or null (no band reads them)
  int j, kp, ks, seen;

  __device__ BandGroup(int K_, int ncols_, bool reverse_, const T* pin_,
                       T* pout_, const T* sin_, T* sout_, const int* wait_,
                       int* mark_)
      : w(), K(K_), ncols(ncols_), reverse(reverse_), pin(pin_), pout(pout_),
        sin(sin_), sout(sout_), wait(wait_), mark(mark_), j(0), kp(0), ks(0),
        seen(reverse_ ? ncols_ : 0) {}
  __device__ T sum(T v) { return w.sum(v); }

  // The lane that writes this pass's outgoing carries, and so its marks.
  __device__ bool marker() const {
    return mark != nullptr && w.lane == (reverse ? 0 : 31);
  }

  // Column jj begins: publish the columns done (forward: those below jj;
  // reverse: those above) every kSgMark columns.
  __device__ __forceinline__ void column(int jj) {
    if (marker()) {
      const int done = reverse ? jj + 1 : jj;
      if (done % kSgMark == 0 && done > 0 && done < ncols) {
        __threadfence_block();
        *mark = done;
      }
    }
    j = jj;
    kp = 0;
    ks = 0;
  }

  // The pass is over: every column done.
  __device__ __forceinline__ void finish() {
    if (marker()) {
      __threadfence_block();
      *mark = reverse ? 0 : ncols;
    }
  }

  template <int R>
  __device__ __forceinline__ void prefix(const T (&v)[R], T (&out)[R]) {
    T from = T(0);
    if (pin != nullptr && w.lane == 0) {
      if (!reverse && j >= seen) {
        while ((seen = *wait) <= j) {
        }
        __threadfence_block();
      }
      from = *reinterpret_cast<const volatile T*>(
          pin + static_cast<long long>(j) * K + kp);
    }
    const T incl = w.template prefix_from<R>(v, out, from);
    if (pout != nullptr && w.lane == 31)
      pout[static_cast<long long>(j) * K + kp] = incl;
    ++kp;
  }

  template <int R>
  __device__ __forceinline__ void suffix(const T (&v)[R], T (&out)[R]) {
    T from = T(0);
    if (sin != nullptr && w.lane == 31) {
      if (j < seen) {
        while ((seen = *wait) > j) {
        }
        __threadfence_block();
      }
      from = *reinterpret_cast<const volatile T*>(
          sin + static_cast<long long>(j) * K + ks);
    }
    const T incl = w.template suffix_from<R>(v, out, from);
    if (sout != nullptr && w.lane == 0)
      sout[static_cast<long long>(j) * K + ks] = incl;
    ++ks;
  }
};

// M's rows as a band's columns: each column first tells the group.
template <typename T, int R>
struct BandColumns {
  MatrixRows<T, R> rows;
  BandGroup<T>* g;

  __device__ __forceinline__ void operator()(int i, T (&mcol)[R]) const {
    g->column(i);
    rows(i, mcol);
  }
};

// ---------------------------------------------------------------------------
// The two DP engines, one interface. A segment or band constructs one over
// its state memory (base, GT threads, thread t; unused by the register
// path), runs forward() over the columns, then reads its threads' shares
// of the level sums (shares) or runs reverse() for M̄. save()/load() keep
// the register path's end carries in memory between a band's passes.
// ---------------------------------------------------------------------------

template <typename T, int R_, int P, int NLM>
struct RegDP {
  static constexpr int R = R_;
  static constexpr int kQ = P > 1 ? P - 1 : 1;
  // memory slots a row: none in a pass; the end carries a band of the
  // backward keeps between its passes
  static constexpr int kBetween = NLM + (NLM - 1) * kQ;
  RunLengthState<T, R, P, NLM> fw;
  DeepStore<T, R> mem;

  __device__ RegDP(T* base, int gt, int t, int) : mem{base, gt, t} {}
  __host__ __device__ static int slots(int, bool) { return 0; }

  template <typename Col, typename G>
  __device__ __forceinline__ void forward(Col& col, int ncols, int nl,
                                          G& g) {
    rl_forward<T, R, P>(fw, col, ncols, nl, g);
  }

  // fn(m, s) for m < nl with this thread's share s of k_{m+1}
  template <typename Fn>
  __device__ __forceinline__ void shares(int nl, Fn fn) const {
#pragma unroll
    for (int m = 0; m < NLM; ++m) {
      if (m < nl) {
        T s = T(0);
#pragma unroll
        for (int r = 0; r < R; ++r) s += fw.tsum[m][r];
        fn(m, s);
      }
    }
  }

  __device__ void save() const {
#pragma unroll
    for (int m = 0; m < NLM; ++m) mem.store(m, fw.tsum[m]);
#pragma unroll
    for (int m = 0; m + 1 < NLM; ++m)
#pragma unroll
      for (int q = 0; q < kQ; ++q) mem.store(NLM + m * kQ + q, fw.ra[m][q]);
  }

  __device__ void load() {
#pragma unroll
    for (int m = 0; m < NLM; ++m) mem.load(m, fw.tsum[m]);
#pragma unroll
    for (int m = 0; m + 1 < NLM; ++m)
#pragma unroll
      for (int q = 0; q < kQ; ++q) mem.load(NLM + m * kQ + q, fw.ra[m][q]);
  }

  // gw [nl + 1, B]: the cotangents of matrix b
  template <typename Rev, typename Sink, typename G>
  __device__ __forceinline__ void reverse(Rev& rev, Sink& sink, int ncols,
                                          int nl, const T* gw, long long B,
                                          long long b, G& g) {
    T w[NLM];
#pragma unroll
    for (int m = 0; m < NLM; ++m) w[m] = m < nl ? gw[(m + 1) * B + b] : T(0);
    rl_reverse<T, R, P>(fw, rev, sink, ncols, nl, w, g);
  }
};

template <typename T, int P>
struct DeepDP {
  static constexpr int R = kSgDeepRows;
  DeepStore<T, R> mem;
  DeepSlots<P> sl;

  // memory slots a row (plan.py's deep_slots); the end carries stay there
  // between a band's passes
  static constexpr int kBetween = 0;

  __device__ DeepDP(T* base, int gt, int t, int nl)
      : mem{base, gt, t}, sl{nl} {}
  __host__ __device__ static int slots(int nl, bool bwd) {
    const int fwd = nl + (nl - 1) * (P - 1);
    return bwd ? fwd + (nl - 1) * (P * P + 2 * P) : fwd;
  }

  template <typename Col, typename G>
  __device__ __forceinline__ void forward(Col& col, int ncols, int nl,
                                          G& g) {
    deep_forward<T, R, P>(col, ncols, nl, sl, mem, g);
  }

  template <typename Fn>
  __device__ __forceinline__ void shares(int nl, Fn fn) const {
    for (int m = 0; m < nl; ++m) {
      T v[R];
      mem.load(sl.tsum(m), v);
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += v[r];
      fn(m, s);
    }
  }

  __device__ void save() const {}
  __device__ void load() {}

  template <typename Rev, typename Sink, typename G>
  __device__ __forceinline__ void reverse(Rev& rev, Sink& sink, int ncols,
                                          int nl, const T* gw, long long B,
                                          long long b, G& g) {
    auto w = [&](int m) { return gw[(m + 1) * B + b]; };
    deep_reverse<T, R, P>(rev, sink, ncols, nl, w, mem, g);
  }
};

// The launch arguments of one call (the plan's, plan.py's sig_gram_plan):
// S lanes a segment and R rows a lane; bands (1: segments) on W warps;
// the band design's carries and states (`area` elements a matrix) in shared
// memory (area_smem) or the workspace at `area` a block, or the deep
// segments' states (`area` elements a segment); the grid.
struct SgArgs {
  const void* M;
  const void* g;
  void* out;
  void* work;
  int B, L1, L2, nl, P, S, R, bands, W, area_smem, blocks, area;
};

// A band design's layout in its area: the prefix carries [bands - 1][L1][K]
// (boundary b written by band b), for the backward the suffix carries
// [bands - 1][L1][K] (boundary b written by band b + 1), then each band's
// state slots [bands][slots][R][32].
template <typename T>
struct BandArea {
  T* pf;
  T* sf;
  T* st;
  long long per_band;

  __device__ BandArea(T* a, int bands, int L1, int K, int slots, int R,
                      bool bwd) {
    const long long carries = static_cast<long long>(bands - 1) * L1 * K;
    pf = a;
    sf = a + carries;
    st = a + (bwd ? 2 : 1) * carries;
    per_band = static_cast<long long>(slots) * R * 32;
  }
  __host__ __device__ static long long elems(int bands, int L1, int K,
                                             int slots, int R, bool bwd) {
    return (bwd ? 2LL : 1LL) * (bands - 1) * L1 * K +
           static_cast<long long>(bands) * slots * R * 32;
  }
};

// The plan is one the kernels take: the segment design (bands == 1, S of
// 8, 16, 32 covering L2) or the band design (S = 32, the fewest bands of
// 32 R rows, W = min(bands, kSgBandWarps)), R as the engine's.
inline bool sg_plan_ok(const SgArgs& a, int R) {
  if (a.R != R || a.blocks < 1 || a.B < 1 || a.L1 < 1 || a.L2 < 1)
    return false;
  if (a.bands == 1)
    return (a.S == 8 || a.S == 16 || a.S == 32) && a.S * R >= a.L2;
  const int bands = (a.L2 + 32 * R - 1) / (32 * R);
  return a.S == 32 && a.bands == bands && bands > 1 &&
         a.W == (bands < kSgBandWarps ? bands : kSgBandWarps);
}

// ---------------------------------------------------------------------------
// Forward kernels.
// ---------------------------------------------------------------------------

// Segment q of a block takes matrices b0 + q, b0 + q + stride, ... (a dead
// segment runs on the last matrix and writes nothing); its deep state is
// its `per_seg` elements of shared memory (work null) or of the block's
// workspace slot. out: [nl + 1, B].
template <typename T, int S, typename DP>
__global__ void __launch_bounds__(32 * kPairsPerBlock)
sig_gram_seg_kernel(const T* __restrict__ M, T* __restrict__ out, T* work,
                    int B, int L1, int L2, int nl, int per_seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
    MatrixRows<T, DP::R> rows{M + b * L1 * L2, L2, t};
    DP dp(state, S, t, nl);
    dp.forward(rows, L1, nl, g);
    if (live && t == 0) out[b] = T(1);
    dp.shares(nl, [&](int m, T s) {
      s = g.sum(s);
      if (live && t == 0) out[(m + 1) * static_cast<long long>(B) + b] = s;
    });
  }
}

// The band design's forward: block b takes matrices b, b + gridDim.x, ...;
// its W warps the bands w, w + W, ... Shared memory: the marks, the warps'
// level sums [W][nl], then the area where area_smem (else the block's
// workspace slot of `area` elements). out: [nl + 1, B].
template <typename T, typename DP>
__global__ void __launch_bounds__(32 * kSgBandWarps)
sig_gram_band_kernel(const T* __restrict__ M, T* __restrict__ out, T* work,
                     int B, int L1, int L2, int nl, int P, int bands,
                     int area_smem, int area) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = static_cast<int>(blockDim.x) >> 5;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int K = sg_carries(nl, P);
  int* marks = reinterpret_cast<int*>(smem_raw);
  T* sums = reinterpret_cast<T*>(smem_raw + sg_marks_bytes(bands));
  T* base = area_smem ? sums + W * nl
                      : work + static_cast<long long>(blockIdx.x) * area;
  const BandArea<T> ar(base, bands, L1, K, DP::slots(nl, false), DP::R,
                       false);
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();  // the previous matrix is done
    for (int k = threadIdx.x; k < bands; k += blockDim.x) marks[k] = 0;
    for (int k = threadIdx.x; k < W * nl; k += blockDim.x) sums[k] = T(0);
    __syncthreads();
    for (int band = warp; band < bands; band += W) {
      const long long step = static_cast<long long>(L1) * K;
      BandGroup<T> g(K, L1, false,
                     band > 0 ? ar.pf + (band - 1) * step : nullptr,
                     band + 1 < bands ? ar.pf + band * step : nullptr,
                     nullptr, nullptr, band > 0 ? marks + band - 1 : nullptr,
                     band + 1 < bands ? marks + band : nullptr);
      BandColumns<T, DP::R> col{
          {M + b * L1 * L2, L2, band * 32 + lane}, &g};
      DP dp(ar.st + band * ar.per_band, 32, lane, nl);
      dp.forward(col, L1, nl, g);
      g.finish();
      dp.shares(nl, [&](int m, T s) {
        s = g.sum(s);
        if (lane == 0) sums[warp * nl + m] += s;
      });
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      out[b] = T(1);
      for (int m = 0; m < nl; ++m) {
        T s = T(0);
        for (int w = 0; w < W; ++w) s += sums[w * nl + m];
        out[(m + 1) * static_cast<long long>(B) + b] = s;
      }
    }
  }
}

// Band: the band design (else segments).
template <typename T, typename DP, bool Band>
cudaError_t sg_launch_fwd(const SgArgs& a, cudaStream_t stream) {
  if (!sg_plan_ok(a, DP::R) || (a.bands > 1) != Band)
    return cudaErrorInvalidValue;
  const T* M = static_cast<const T*>(a.M);
  T* out = static_cast<T*>(a.out);
  T* work = static_cast<T*>(a.work);
  if constexpr (Band) {
    const size_t smem = sg_marks_bytes(a.bands) +
                        sizeof(T) * (static_cast<size_t>(a.W) * a.nl +
                                     (a.area_smem ? a.area : 0));
    const long long need =
        BandArea<T>::elems(a.bands, a.L1, sg_carries(a.nl, a.P),
                           DP::slots(a.nl, false), DP::R, false);
    if (smem > kSegSmemBytes || a.area < need ||
        (!a.area_smem && work == nullptr))
      return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(sig_gram_band_kernel<T, DP>, smem);
    if (e != cudaSuccess) return e;
    sig_gram_band_kernel<T, DP><<<a.blocks, 32 * a.W, smem, stream>>>(
        M, out, work, a.B, a.L1, a.L2, a.nl, a.P, a.bands, a.area_smem,
        a.area);
    return cudaGetLastError();
  } else {
  // segments: the deep state `area` elements a segment, in shared memory
  // unless a workspace is given
  const int per_seg = DP::slots(a.nl, false) > 0 ? a.area : 0;
  if (per_seg < DP::slots(a.nl, false) * a.S * DP::R)
    return cudaErrorInvalidValue;
  const size_t smem =
      work ? 0 : sizeof(T) * static_cast<size_t>(32 * kPairsPerBlock / a.S) *
                     per_seg;
  if (smem > kSegSmemBytes) return cudaErrorInvalidValue;
#define GPSIG_SEG(s)                                                      \
  case s: {                                                               \
    cudaError_t e = allow_smem(sig_gram_seg_kernel<T, s, DP>, smem);      \
    if (e != cudaSuccess) return e;                                       \
    sig_gram_seg_kernel<T, s, DP><<<a.blocks, 32 * kPairsPerBlock, smem,  \
                                    stream>>>(M, out, work, a.B, a.L1,    \
                                              a.L2, a.nl, per_seg);       \
    return cudaGetLastError();                                            \
  }
  switch (a.S) {
    GPSIG_SEG(8) GPSIG_SEG(16) GPSIG_SEG(32)
    default: return cudaErrorInvalidValue;
  }
#undef GPSIG_SEG
  }
}

// The register path's forward at (P, NLM): bands at the most rows a lane
// the state takes (sg_rows), segments at that R or fewer, 4 or 2 (the plan
// takes fewer rows a lane on more lanes where that launches more warps: a
// short batch is latency-bound).
template <typename T, int P, int NLM>
cudaError_t sg_fwd_register(const SgArgs& a, cudaStream_t s) {
  constexpr int Rmax = sg_rows<T, P, NLM, false>();
  if (a.bands > 1)
    return sg_launch_fwd<T, RegDP<T, Rmax, P, NLM>, true>(a, s);
  if (a.R == Rmax)
    return sg_launch_fwd<T, RegDP<T, Rmax, P, NLM>, false>(a, s);
  if constexpr (Rmax > 4) {
    if (a.R == 4) return sg_launch_fwd<T, RegDP<T, 4, P, NLM>, false>(a, s);
  }
  if constexpr (Rmax > 2) {
    if (a.R == 2) return sg_launch_fwd<T, RegDP<T, 2, P, NLM>, false>(a, s);
  }
  return cudaErrorInvalidValue;
}

// CASE(P, NLM) at the run-time order and level bound of the register path,
// P = 1 .. min(nl, 7) and NLM = 4 up to 4 levels, else 7, and CASE(P) at the deep
// path's order, 1 .. 7 (each CASE returns).
#define GPSIG_SG_REGISTER(P_, nl_, CASE)                                   \
  if ((nl_) <= 4) {                                                        \
    switch (P_) {                                                          \
      case 1: CASE(1, 4)                                                   \
      case 2: CASE(2, 4)                                                   \
      case 3: CASE(3, 4)                                                   \
      case 4: CASE(4, 4)                                                   \
      default: return cudaErrorInvalidValue;                               \
    }                                                                      \
  }                                                                        \
  switch (P_) {                                                            \
    case 1: CASE(1, 7)                                                     \
    case 2: CASE(2, 7)                                                     \
    case 3: CASE(3, 7)                                                     \
    case 4: CASE(4, 7)                                                     \
    case 5: CASE(5, 7)                                                     \
    case 6: CASE(6, 7)                                                     \
    case 7: CASE(7, 7)                                                     \
    default: return cudaErrorInvalidValue;                                 \
  }

#define GPSIG_SG_DEEP(P_, CASE)                                            \
  switch (P_) {                                                            \
    case 1: CASE(1)                                                        \
    case 2: CASE(2)                                                        \
    case 3: CASE(3)                                                        \
    case 4: CASE(4)                                                        \
    case 5: CASE(5)                                                        \
    case 6: CASE(6)                                                        \
    case 7: CASE(7)                                                        \
    default: return cudaErrorInvalidValue;                                 \
  }

// The forwards of one dtype: the register path (sig_gram.cu for float,
// sig_gram_f64.cu for double) and the deep path (sig_gram_deep.cu).
template <typename T>
cudaError_t sg_fwd(const SgArgs& a, cudaStream_t s) {
#define GPSIG_CASE(P, NLM) return sg_fwd_register<T, P, NLM>(a, s);
  GPSIG_SG_REGISTER(a.P, a.nl, GPSIG_CASE)
#undef GPSIG_CASE
}

template <typename T>
cudaError_t sg_fwd_deep(const SgArgs& a, cudaStream_t s) {
#define GPSIG_CASE(P)                                                      \
  return a.bands > 1 ? sg_launch_fwd<T, DeepDP<T, P>, true>(a, s)          \
                     : sg_launch_fwd<T, DeepDP<T, P>, false>(a, s);
  GPSIG_SG_DEEP(a.P, GPSIG_CASE)
#undef GPSIG_CASE
}

extern template cudaError_t sg_fwd<float>(const SgArgs&, cudaStream_t);
extern template cudaError_t sg_fwd<double>(const SgArgs&, cudaStream_t);
extern template cudaError_t sg_fwd_deep<float>(const SgArgs&, cudaStream_t);
extern template cudaError_t sg_fwd_deep<double>(const SgArgs&,
                                                cudaStream_t);

}  // namespace gpsig
