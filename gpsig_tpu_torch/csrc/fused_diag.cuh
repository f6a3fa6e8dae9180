// Order-1 signature self-kernels (the Gram's diagonal), for Hopper
// (sm_90a). Shared by fused_diag.cu (the entry point and the float32
// instantiations) and fused_diag_f64.cu (float64), compiled apart so that
// they build in parallel.
//
// Replaces the TPU kernel gpsig_tpu/ops/pallas/fused_gram.py:_diag_kernel
// (entry point fused_diag_levels): out[m, n] = k_m(x_n, x_n), order 1,
// difference=True, RBF or Linear base on pre-scaled sequences, num_levels
// <= 7; the RBF column build exp(-1/2 (|x|^2 + |y|^2) + <x, y>) without a
// clamp, as the reference _xla_reference_diag. Its backward is autograd
// through the plain version, as in the JAX package (_diag_vjp_bwd).
//
// Design (redesigned for Hopper; ops/cuda/plan.py's diag_plan). A segment
// of S = 8, 16 or 32 lanes at R = 8, 4 or 2 rows a lane takes one
// sequence, 32 / S sequences a warp, kDiagWarps warps a block, no
// barrier: the Gram forwards' segment sweep (fused_gram.cu) with x on both
// sides, one warp a block (a batch of N sequences launches N S / 32 warps). Lane t holds rows i0 .. i0 + R - 1 of the (virtual) increment
// matrix M and sweeps the columns j, building M[:, j] in registers from
// the base values at its R + 1 points against x_{j+1}, double-differenced
// against the previous column's. Level m's running column sums C_m are
// updated in descending m from the exclusive row prefix of C_{m-1}, one
// segment scan each (log2(S) + 1 shuffles), every level up to the level
// count NL (a template argument: no level is updated that is not read).
// The plan takes the largest R whose warps still fill the card, so a short
// batch spreads its rows over more lanes. Where it fits, each segment
// stages its sequence [L][d] with the half norms at an odd stride and its
// lanes' R + 1 points lane major (no bank conflicts); at wider d only the
// lanes' points (restaged for each band), the column points then read from
// global memory with their half norms taken on the fly, in the same order
// (the same bits); at the widest d nothing, so every d runs. Past one segment's rows (S
// = 32, R = 8: 256 rows) the segment sweeps the rows in bands of 32 R, one
// band after another: at column j, level m's prefix in band b starts from
// the carry c_m(j) = the sum over the rows above the band of C_m before
// column j, which lane 0 reads, and the band's last lane leaves c_m(j) plus
// the band's sum (WarpGroup::prefix_from) for band b + 1: nl - 1 values a
// column, in shared memory where they fit, else in a workspace (the grid
// then strides over the sequences). Bands take every L. The Gram's own
// segment kernel is not reused on the pairs (n, n): its block shares one x
// over all its pairs where a diagonal's pairs each have their own, and it
// has no bands. In float32 the RBF exponential is 2^(a log2 e) on the
// special-function unit (kuf_exp: ex2.approx.ftz, relative error below
// 2^-22), a few instructions where expf takes about ten.
//
// What bounds it on the H100. Per sequence it reads L d values and writes
// nl + 1: instruction throughput and latency bound it, not memory. The
// work per sequence is about L^2 (1 + 1/R) base values (2d + 2 flops and
// one exp each), (L - 1)^2 increment entries at 2 subtractions, nl - 1
// multiply-adds and nl adds each, and per column nl - 1 segment scans.

#pragma once

#include "common.cuh"

namespace gpsig {

// Warps a block of the segment design (plan.py's diag_plan takes one), and
// of the band design at most (plan.py's DIAG_BAND_WARPS).
constexpr int kDiagWarps = 1;
constexpr int kDiagBandWarps = 8;

// What a segment stages in shared memory (plan.py's diag_plan): its
// sequence with the half norms and its lanes' points (kStageAll), the
// lanes' points only (kStageOwn: the column points read from global
// memory, their half norms on the fly), or nothing (kStageNone).
enum DiagStage : int { kStageNone = 0, kStageOwn = 1, kStageAll = 2 };

// Columns of M = the double difference of k(x_i, x_j) for the lane's rows
// i0 .. i0 + R - 1 (i0 = b0 + t R in band b0), against the column points
// x_j. kStageAll: the sequence xs and its half norms nxs in shared memory;
// else xs in global memory and the half norms taken on the fly (in the
// same order as half_sqnorms, so all give the same bits). The lane's R + 1
// points lane major at xl[(n d + c) S] (xl offset by the lane) unless
// kStageNone, which reads them from xs.
template <typename T, int R, int S, int Stage>
struct DiagColumns {
  const T* xs;
  const T* nxs;
  const T* xl;
  int d, rows, i0;
  bool rbf;
  int pt[R + 1];  // the lane's points' offsets (clamped to L - 1), unstaged
  T nx[R + 1];
  T kprev[R + 1];

  __device__ DiagColumns(const T* xs_, const T* nxs_, const T* xl_, int L,
                         int d_, int i0_, bool rbf_)
      : xs(xs_), nxs(nxs_), xl(xl_), d(d_), rows(L - 1), i0(i0_),
        rbf(rbf_) {
#pragma unroll
    for (int n = 0; n <= R; ++n) {
      const int i = min(i0 + n, L - 1);
      pt[n] = i * d;
      if constexpr (Stage == kStageAll) {
        nx[n] = rbf ? nxs[i] : T(0);
      } else {
        nx[n] = rbf ? half_norm(xs + pt[n]) : T(0);
      }
    }
    values<R + 1>(0, kprev);
  }

  __device__ __forceinline__ T half_norm(const T* a) const {
    T s = T(0);
    for (int c = 0; c < d; ++c) s += a[c] * a[c];
    return T(-0.5) * s;
  }

  // base values k(x_{i0 + n}, x_j) for n < N
  template <int N>
  __device__ __forceinline__ void values(int j, T (&k)[N]) const {
    const T* yj = xs + j * d;
    T ny = T(0);
    if (rbf) {
      if constexpr (Stage == kStageAll) {
        ny = nxs[j];
      } else {
        ny = half_norm(yj);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) k[n] = rbf ? nx[n] + ny : T(0);
    for (int c = 0; c < d; ++c) {
      const T yc = yj[c];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        if constexpr (Stage != kStageNone) {
          k[n] += xl[(n * d + c) * S] * yc;
        } else {
          k[n] += xs[pt[n] + c] * yc;
        }
      }
    }
    if (rbf) {
#pragma unroll
      for (int n = 0; n < N; ++n) k[n] = kuf_exp(k[n] * kuf_fold<T>());
    }
  }

  __device__ __forceinline__ void operator()(int j, T (&mcol)[R]) {
    T knew[R + 1];
    values<R + 1>(j + 1, knew);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T v = (knew[r + 1] - kprev[r + 1]) - (knew[r] - kprev[r]);
      mcol[r] = (i0 + r < rows) ? v : T(0);
    }
#pragma unroll
    for (int r = 0; r <= R; ++r) kprev[r] = knew[r];
  }
};

// One band of one sequence by a segment (lane t of S): rows i0 = b0 + t R
// .. + R - 1 of the band from b0, swept over all columns. Staged (Stage
// != kStageNone): the lanes' points are restaged lane major into xl first.
// At column j level m's prefix starts from cin[(m - 1) rows + j], the
// rows above the band (null for the first band), read once the band
// above's progress mark `above` has passed j; the band's last lane leaves
// cin's value plus the band's sum in cout (null for the last band) and
// publishes its own progress in `mark` every kDiagMark columns. The band's
// level sums are added to lv (every lane).
constexpr int kDiagMark = 16;

template <typename T, int R, int S, int NL, int Stage>
__device__ __forceinline__ void diag_band(const T* xs, const T* nxs, T* xl,
                                          int L, int d, int nl, bool rbf,
                                          int b0, const T* cin,
                                          const int* above, T* cout,
                                          int* mark, WarpGroup<T, S>& g,
                                          T (&lv)[NL]) {
  const int t = g.thread();
  const int rows = L - 1;
  const int i0 = b0 + t * R;
  if constexpr (Stage != kStageNone) {
    __syncwarp();  // the previous band's reads are done
    for (int r = 0; r <= R; ++r) {
      const int i = min(i0 + r, L - 1);
      for (int c = 0; c < d; ++c) xl[(r * d + c) * S + t] = xs[i * d + c];
    }
    __syncwarp();
  }
  DiagColumns<T, R, S, Stage> col(xs, nxs, xl + t, L, d, i0, rbf);
  T C[NL][R];
#pragma unroll
  for (int m = 0; m < NL; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) C[m][r] = T(0);
  int seen = 0;  // the band above's progress, as lane 0 last read it
  for (int j = 0; j < rows; ++j) {
    T mcol[R];
    col(j, mcol);
    if (cin != nullptr && t == 0 && j >= seen) {
      while ((seen = *reinterpret_cast<const volatile int*>(above)) <= j) {
      }
      __threadfence_block();
    }
    // levels in descending order (as the Gram's seg_order1), each prefix
    // from the carry of the rows above the band
#pragma unroll
    for (int m = NL - 1; m >= 1; --m) {
      const bool carried = m < nl;
      const long long cj = static_cast<long long>(m - 1) * rows + j;
      const T from =
          (carried && cin != nullptr && t == 0)
              ? *reinterpret_cast<const volatile T*>(cin + cj)
              : T(0);
      T pre[R];
      const T incl = g.template prefix_from<R>(C[m - 1], pre, from);
      if (carried && cout != nullptr && t == S - 1) cout[cj] = incl;
#pragma unroll
      for (int r = 0; r < R; ++r) C[m][r] += mcol[r] * pre[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) C[0][r] += mcol[r];
    if (cout != nullptr && t == S - 1 &&
        ((j + 1) % kDiagMark == 0 || j + 1 == rows)) {
      __threadfence_block();
      *reinterpret_cast<volatile int*>(mark) = j + 1;
    }
  }
#pragma unroll
  for (int m = 0; m < NL; ++m) {
    T s = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) s += C[m][r];
    lv[m] += g.sum(s);
  }
}

// The segment design (one band, everything staged): segment q of block b
// takes sequence n = b * kSegs + q against itself, nl <= NL levels (NL,
// the levels updated, is nl in float32). Shared memory a segment: the
// sequence [L][d] and its half norms at an odd stride, then the lanes'
// points lane major. out: [nl + 1, N].
template <typename T, int R, int S, int NL>
__global__ void __launch_bounds__(32 * kDiagWarps)
diag_kernel(const T* __restrict__ X, T* __restrict__ out, int N, int L,
            int d, int nl, int rbf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kSegs = 32 * kDiagWarps / S;
  const int q = static_cast<int>(threadIdx.x) / S;
  const int t = static_cast<int>(threadIdx.x) % S;
  const long long Ld = static_cast<long long>(L) * d;
  const int seq_elems = (L * (d + 1)) | 1;
  T* ys = reinterpret_cast<T*>(smem_raw) +
          q * (seq_elems + (R + 1) * d * S);
  T* ny = ys + Ld;
  const long long n = static_cast<long long>(blockIdx.x) * kSegs + q;
  const bool live = n < N;  // a dead segment runs on the last sequence
  stage_copy(ys, X + (live ? n : N - 1) * Ld, Ld, t, S);
  __syncwarp();
  if (rbf) half_sqnorms(ys, ny, L, d, t, S);
  WarpGroup<T, S> g;
  T lv[NL];
#pragma unroll
  for (int m = 0; m < NL; ++m) lv[m] = T(0);
  diag_band<T, R, S, NL, kStageAll>(ys, ny, ys + seq_elems, L, d, nl,
                                    rbf != 0, 0, nullptr, nullptr, nullptr,
                                    nullptr, g, lv);
  if (live && t == 0) {
    out[n] = T(1);
#pragma unroll
    for (int m = 0; m < NL; ++m)
      if (m < nl) out[static_cast<long long>(m + 1) * N + n] = lv[m];
  }
}

// The band design (32 lanes at 8 rows a lane; more than 256 rows, or a
// sequence that does not fit the segment design's shared memory): block b
// takes sequences b, b + gridDim.x, ..., its W warps the bands of 256 rows
// w, w + W, ..., as a wavefront: band b's carries go to a ring of W
// buffers [nl - 1][L - 1] (in shared memory with carry_smem, else the
// block's slot of work [gridDim.x][W][nl - 1][L - 1]) and its progress to
// marks[b]; band b + 1 reads them a column after they are written. Shared
// memory: the marks (16-byte steps), the sequence and its half norms
// (kStageAll), each warp's lanes' points (Stage != kStageNone), the ring,
// the warps' level sums. out: [nl + 1, N].
template <typename T, int NL, int Stage>
__global__ void __launch_bounds__(32 * kDiagBandWarps)
diag_band_kernel(const T* __restrict__ X, T* __restrict__ out,
                 T* __restrict__ work, int N, int L, int d, int nl, int rbf,
                 int bands, int carry_smem) {
  constexpr int R = 8, S = 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = static_cast<int>(blockDim.x) >> 5;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int t = static_cast<int>(threadIdx.x) & 31;
  const int rows = L - 1;
  const long long Ld = static_cast<long long>(L) * d;
  int* marks = reinterpret_cast<int*>(smem_raw);
  T* sm = reinterpret_cast<T*>(smem_raw + (bands + 3) / 4 * 16);
  const int seq_elems = Stage == kStageAll ? (L * (d + 1)) | 1 : 0;
  const int own_elems = Stage != kStageNone ? (R + 1) * d * S : 0;
  const long long ring_elems = static_cast<long long>(nl - 1) * rows;
  T* xl = sm + seq_elems + warp * own_elems;
  T* ring = carry_smem ? sm + seq_elems + W * own_elems
                       : work + blockIdx.x * W * ring_elems;
  T* sums = sm + seq_elems + W * own_elems + (carry_smem ? W * ring_elems : 0);
  WarpGroup<T, S> g;
  for (long long n = blockIdx.x; n < N; n += gridDim.x) {
    __syncthreads();  // the previous sequence is done
    for (int k = threadIdx.x; k < bands; k += blockDim.x) marks[k] = 0;
    const T* xg = X + n * Ld;
    const T* xs = xg;
    const T* nxs = nullptr;
    if constexpr (Stage == kStageAll) {
      T* ys = sm;
      stage_copy(ys, xg, Ld, threadIdx.x, blockDim.x);
      __syncthreads();
      if (rbf) half_sqnorms(ys, ys + Ld, L, d, threadIdx.x, blockDim.x);
      xs = ys;
      nxs = ys + Ld;
    }
    __syncthreads();
    T lv[NL];
#pragma unroll
    for (int m = 0; m < NL; ++m) lv[m] = T(0);
    for (int b = warp; b < bands; b += W) {
      diag_band<T, R, S, NL, Stage>(
          xs, nxs, xl, L, d, nl, rbf != 0, b * S * R,
          b > 0 ? ring + (b - 1) % W * ring_elems : nullptr,
          b > 0 ? marks + b - 1 : nullptr,
          b + 1 < bands ? ring + b % W * ring_elems : nullptr, marks + b, g,
          lv);
    }
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < NL; ++m) sums[warp * NL + m] = lv[m];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      out[n] = T(1);
      for (int m = 0; m < nl; ++m) {
        T s = T(0);
        for (int w = 0; w < W; ++w) s += sums[w * NL + m];
        out[static_cast<long long>(m + 1) * N + n] = s;
      }
    }
  }
}

template <typename T, int R, int S, int NL>
cudaError_t launch_diag(const void* X, void* out, int N, int L, int d,
                        int nl, int rbf, cudaStream_t stream) {
  constexpr int kSegs = 32 * kDiagWarps / S;
  const size_t smem =
      sizeof(T) * kSegs *
      (((static_cast<size_t>(L) * (d + 1)) | 1) +
       static_cast<size_t>(R + 1) * d * S);
  if (smem > kSegSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(diag_kernel<T, R, S, NL>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (N + kSegs - 1) / kSegs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  diag_kernel<T, R, S, NL><<<static_cast<unsigned>(blocks), 32 * kDiagWarps,
                             smem, stream>>>(
      static_cast<const T*>(X), static_cast<T*>(out), N, L, d, nl, rbf);
  return cudaGetLastError();
}

template <typename T, int NL, int Stage>
cudaError_t launch_diag_band(const void* X, void* out, void* work, int N,
                             int L, int d, int nl, int rbf, int W, int bands,
                             int carry_smem, int blocks,
                             cudaStream_t stream) {
  const size_t seq =
      Stage == kStageAll ? (static_cast<size_t>(L) * (d + 1)) | 1 : 0;
  const size_t own = Stage != kStageNone ? static_cast<size_t>(9) * d * 32
                                         : 0;
  const size_t ring =
      carry_smem ? static_cast<size_t>(nl - 1) * (L - 1) : 0;
  const size_t smem = static_cast<size_t>(bands + 3) / 4 * 16 +
                      sizeof(T) * (seq + W * (own + ring + NL));
  if (smem > kSegSmemBytes || W < 1 || W > kDiagBandWarps)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(diag_band_kernel<T, NL, Stage>, smem);
  if (e != cudaSuccess) return e;
  diag_band_kernel<T, NL, Stage><<<blocks, 32 * W, smem, stream>>>(
      static_cast<const T*>(X), static_cast<T*>(out), static_cast<T*>(work),
      N, L, d, nl, rbf, bands, carry_smem);
  return cudaGetLastError();
}

// The launch arguments of one call (the plan's, plan.py's diag_plan).
struct DiagArgs {
  const void* X;
  void* out;
  void* work;
  int N, L, d, nl, rbf, S, R, W, bands, stage, carry_smem, blocks;
};

// The instantiated plans of a level count NL: the segment design (one
// band, staging all) in float32 at R = 8 and S = 8, 16, 32, R = 4 and
// S = 16, 32, R = 2 and S = 32, in float64 at R = 8 only (its kernels are
// checked, not timed); the band design (S = 32, R = 8) at each stage.
template <typename T, int NL>
cudaError_t diag_by_plan(const DiagArgs& a, cudaStream_t s) {
  if (a.W > 0) {
    if (a.S != 32 || a.R != 8) return cudaErrorInvalidValue;
    switch (a.stage) {
#define GPSIG_STAGE(st)                                                    \
  case st:                                                                 \
    return launch_diag_band<T, NL, st>(a.X, a.out, a.work, a.N, a.L, a.d, \
                                       a.nl, a.rbf, a.W, a.bands,         \
                                       a.carry_smem, a.blocks, s);
      GPSIG_STAGE(kStageNone) GPSIG_STAGE(kStageOwn) GPSIG_STAGE(kStageAll)
#undef GPSIG_STAGE
      default: return cudaErrorInvalidValue;
    }
  }
  if (a.stage != kStageAll || a.bands != 1) return cudaErrorInvalidValue;
  switch (a.S * 16 + a.R) {
    case 8 * 16 + 8:
      return launch_diag<T, 8, 8, NL>(a.X, a.out, a.N, a.L, a.d, a.nl, a.rbf,
                                      s);
    case 16 * 16 + 8:
      return launch_diag<T, 8, 16, NL>(a.X, a.out, a.N, a.L, a.d, a.nl,
                                       a.rbf, s);
    case 32 * 16 + 8:
      return launch_diag<T, 8, 32, NL>(a.X, a.out, a.N, a.L, a.d, a.nl,
                                       a.rbf, s);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {
    switch (a.S * 16 + a.R) {
      case 16 * 16 + 4:
        return launch_diag<T, 4, 16, NL>(a.X, a.out, a.N, a.L, a.d, a.nl,
                                         a.rbf, s);
      case 32 * 16 + 4:
        return launch_diag<T, 4, 32, NL>(a.X, a.out, a.N, a.L, a.d, a.nl,
                                         a.rbf, s);
      case 32 * 16 + 2:
        return launch_diag<T, 2, 32, NL>(a.X, a.out, a.N, a.L, a.d, a.nl,
                                         a.rbf, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// Every level count 1..7 in float32; float64 at 4 or 7 (the level bound
// of the Gram forwards: a level past nl is updated and never read).
template <typename T>
cudaError_t diag_dispatch(const DiagArgs& a, cudaStream_t s) {
  if constexpr (sizeof(T) == 8) {
    return a.nl <= 4 ? diag_by_plan<T, 4>(a, s) : diag_by_plan<T, 7>(a, s);
  } else {
    switch (a.nl) {
      case 1: return diag_by_plan<T, 1>(a, s);
      case 2: return diag_by_plan<T, 2>(a, s);
      case 3: return diag_by_plan<T, 3>(a, s);
      case 4: return diag_by_plan<T, 4>(a, s);
      case 5: return diag_by_plan<T, 5>(a, s);
      case 6: return diag_by_plan<T, 6>(a, s);
      case 7: return diag_by_plan<T, 7>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

// Each dtype's instantiation is compiled by one source (the note above).
extern template cudaError_t diag_dispatch<float>(const DiagArgs&,
                                                 cudaStream_t);
extern template cudaError_t diag_dispatch<double>(const DiagArgs&,
                                                  cudaStream_t);

}  // namespace gpsig
