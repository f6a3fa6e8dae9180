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
// Design (redesigned for Hopper: one warp, or one segment, a pair; plan.py's
// goursat_fwd_plan). The shorter refined side R goes over the lanes (the
// scheme is symmetric under transposing inc, bit for bit), the longer C
// over the steps. Lane t holds RL = 2, 4 or 8 consecutive refined rows (at
// least 2^o up to 8, so that a lane's rows share their unrefined rows) in
// registers, and the sweep is the adjoint's skewed forward
// (goursat_bwd.cu): at step s lane t solves column j = s - t, taking u of
// the row above its rows from lane t - 1 by __shfl_up_sync; no shared-
// memory diagonals and no barrier. Short pairs share a warp: a segment of
// S = 4, 8, 16 or 32 lanes takes a pair (the fewest with S·RL >= R, the
// fewest RL first), 32 / S pairs a warp, one warp a block (the Kuf at
// prediction, 14 x 98 refined cells, takes 7 lanes of 8 at RL = 2). The
// warp's pairs are consecutive in memory, so it reads their increments
// once, coalesced, with asynchronous copies (all of them in flight at
// once) into shared memory where they fit. On a given grid whose rows lie
// along memory, where fewer than plan.py's GOURSAT_STAGE_BLOCKS such
// blocks would fit an SM, a step takes V = 16 / sizeof(T) columns instead,
// from tiles of the lanes' next columns that the warp copies coalesced
// (goursat_cols); where neither applies each lane reads a value of each of
// its rows a step through the cache. Past 32 lanes at RL = 8 (256 refined rows) the rows
// go in bands of 256, and a block of W = min(bands, 8) warps takes one
// pair, warp w the bands w, w + W, ...: band b's last lane leaves its bottom row (C + 1
// values, in a ring of W rows in shared memory, or in a workspace where
// those do not fit) and publishes its progress every 16 columns; band
// b + 1's lane 0 reads the row once that progress has passed its column,
// so the bands run as a wavefront across the warps, one band's lead ahead
// of the next. The cell is goursat_cell, the plain sweep's expression in
// its order, so the corner is bitwise equal to the plain version's.
//
// What bounds it on the H100. A refined cell costs 6 operations (3 adds,
// the increment's scale and 2 multiplies) and a pair reads its Su Tu
// values once: the bytes bound it up to o = 1 (Kuf at prediction: 90 MB
// of increments for 65,536 pairs of 14 x 98 refined cells, 27 us at
// 3.35 TB/s), the 6 Sr Tr B operations at 67 TFLOP/s from o = 2, where a
// cell of inc becomes 4^o cells. The sweep is a chain of C + lanes - 1
// dependent steps of RL cells a pair, so it needs enough pairs in flight
// on every SM; the segments put 32 / S of them on one warp.

#include "goursat.cuh"

namespace {

using namespace gpsig;

// Bands a block of the banded design at most (ops/cuda/plan.py's
// GOURSAT_BAND_WARPS), and the columns between two progress marks.
constexpr int kFwdBandWarps = 8;
constexpr int kFwdMark = 16;

// One band of a pair by a segment of S lanes (lane t of it): rows b0 + 1
// .. b0 + S·RL of the refined grid, lane t the RL from b0 + t·RL + 1.
// top: the band's top row (b0 > 0), read from bin once progress (the band
// above's mark) has passed the column; bout / mark: where this band's
// bottom row and progress go (null for the last band). Returns u(R, C) to
// the lane that holds row R (and 0 elsewhere). OS = min(o, log2 RL): a
// lane's rows span RL >> OS unrefined rows (row0 is a multiple of RL), so
// it loads that many increments a step, each shared by 2^OS rows. Rows
// past R (in the last lane) take the last unrefined row's increments:
// their values reach no row up to R.
template <typename T, int RL, int OS>
__device__ __forceinline__ T goursat_band(const T* base, int rs, int cs,
                                          int o, T scale, int R, int C,
                                          int S, int t, int b0,
                                          const T* bin, const int* above,
                                          T* bout, int* mark) {
  constexpr int U = RL >> OS;
  const int rows = min(S * RL, R - b0);
  const int lanes = (rows + RL - 1) / RL;
  const int row0 = b0 + t * RL;  // the lane's rows are row0 + 1 .. + RL
  const bool in = t < lanes;
  const int Ru = R >> o;  // unrefined rows (R = Ru 2^o)
  int uoff[U];
#pragma unroll
  for (int k = 0; k < U; ++k)
    uoff[k] = min((row0 >> o) + k, Ru - 1) * rs;
  T u[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r) u[r] = T(1);
  T top_prev = T(1), last = T(1), corner = T(0);
  int seen = 0;  // the band above's progress, as lane 0 last read it
  for (int s = 1; s < C + lanes; ++s) {
    const T sent = __shfl_up_sync(kFull, last, 1, S);
    const int j = s - t;
    if (in && j >= 1 && j <= C) {
      T top = sent;
      if (t == 0) {
        top = T(1);
        if (bin != nullptr) {
          if (j > seen) {
            while ((seen = *reinterpret_cast<const volatile int*>(above)) <
                   j) {
            }
            __threadfence_block();
          }
          top = *reinterpret_cast<const volatile T*>(bin + j);
        }
      }
      T up = top, upleft = top_prev;
      const int cj = ((j - 1) >> o) * cs;
      T a[U];
#pragma unroll
      for (int k = 0; k < U; ++k) a[k] = base[uoff[k] + cj] * scale;
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const T v = goursat_cell(u[r], up, upleft, a[r >> OS]);
        upleft = u[r];
        up = v;
        u[r] = v;
      }
      last = u[RL - 1];
      top_prev = top;
      if (bout != nullptr && t == lanes - 1) {
        bout[j] = last;
        if (j % kFwdMark == 0 || j == C) {
          __threadfence_block();
          *reinterpret_cast<volatile int*>(mark) = j;
        }
      }
      if (j == C) {
#pragma unroll
        for (int r = 0; r < RL; ++r)
          if (row0 + r == R - 1) corner = u[r];
      }
    }
  }
  return corner;
}

// 16 bytes of T, the vector goursat_cols reads from its tiles.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  __device__ static void load(const float* p, float (&a)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    a[0] = x.x;
    a[1] = x.y;
    a[2] = x.z;
    a[3] = x.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  __device__ static void load(const double* p, double (&a)[2]) {
    const double2 x = *reinterpret_cast<const double2*>(p);
    a[0] = x.x;
    a[1] = x.y;
  }
};

// Steps a tile of goursat_cols spans, and its shared memory: two tiles a
// lane (one filling while the other is read) of RL rows x kColSteps 16-byte
// vectors, each lane's tile 16 bytes past a whole row of vectors, so that
// 8 lanes reading a vector each hit 8 distinct bank groups.
constexpr int kColStepsLog2 = 2;
constexpr int kColSteps = 1 << kColStepsLog2;
__host__ __device__ constexpr int col_tile_vecs(int RL) {
  return RL * kColSteps + 1;
}
__host__ __device__ constexpr int col_smem(int RL) {
  return 2 * 32 * col_tile_vecs(RL) * 16;
}

// One warp's pairs on a given grid (o = 0), unstaged, their rows along
// memory (cs = 1), a segment of S lanes a pair (lane t of it): at step s
// lane t solves the V = 16 / sizeof(T) columns of block s - t (the last
// block those up to C), the row above arriving V values a step. A lane's
// cells come from its tile in shared memory: for the kColSteps steps of a
// chunk it needs RL rows x kColSteps blocks, which the warp copies for all
// its lanes at once, consecutive lanes a row's 64 bytes in 16-byte copies
// where the rows are 16-byte aligned (else 8-byte, else a value), so that
// a pair is read coalesced (a value a lane a step would read a line a lane, which
// thrashes the cache); the next chunk's copies are in flight (cp.async)
// while this chunk is swept. Each cell is goursat_cell on goursat_band's
// inputs, so the corner is the same bits. first: the warp's first pair;
// tiles: col_smem(RL) bytes. Returns u(R, C) to the lane that holds row R
// (and 0 elsewhere).
template <typename T, int RL>
__device__ __forceinline__ T goursat_cols(const T* __restrict__ inc,
                                          long long first, int B,
                                          long long cells, int rs, int R,
                                          int C, int S, T* tiles) {
  constexpr int V = 16 / sizeof(T);
  constexpr int TV = col_tile_vecs(RL);
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int t = lane % S;
  const int lanes = (R + RL - 1) / RL;
  const int nb = (C + V - 1) / V;
  const int steps = nb + lanes - 1;
  // the copies: 16 bytes where the rows are 16-byte aligned, else 8 where
  // they are 8-byte aligned, else a value (2^wsh bytes, 2^csh a tile row,
  // 2^nsh a lane's tile; the columns then end on a whole copy)
  const size_t align =
      reinterpret_cast<size_t>(inc) | static_cast<size_t>(rs) * sizeof(T);
  const int wsh = (align & 15) == 0 ? 4
                  : (align & 7) == 0 ? 3
                                     : (sizeof(T) == 8 ? 3 : 2);
  const int csh = 4 + kColStepsLog2 - wsh;
  const int nsh = csh + (RL == 8 ? 3 : RL == 4 ? 2 : 1);
  const int ssh = __ffs(S) - 1;
  const int vsh = wsh - (sizeof(T) == 8 ? 3 : 2);  // log2 values a copy
  auto fill = [&](int k) {
    T* buf = tiles + (k & 1) * 32 * TV * V;
    for (int i = lane; i < 32 << nsh; i += 32) {
      const int L = i >> nsh, w = i & ((1 << nsh) - 1);
      const int r = w >> csh, c = (w & ((1 << csh) - 1)) << vsh;
      const int tL = L & (S - 1);
      const int col = (k * kColSteps - tL) * V + c;
      if (tL < lanes && col >= 0 && col < C) {
        const long long pr =
            min(first + (L >> ssh), static_cast<long long>(B) - 1);
        const T* src = inc + pr * cells +
                       static_cast<long long>(min(tL * RL + r, R - 1)) * rs +
                       col;
        T* dst = buf + (L * TV + r * kColSteps) * V + c;
        if (wsh == 4)
          __pipeline_memcpy_async(dst, src, 16);
        else if (wsh == 3)
          __pipeline_memcpy_async(dst, src, 8);
        else
          __pipeline_memcpy_async(dst, src, 4);
      }
    }
    __pipeline_commit();
  };
  const int row0 = t * RL;
  const bool in = t < lanes;
  T u[RL], last[V];
#pragma unroll
  for (int r = 0; r < RL; ++r) u[r] = T(1);
#pragma unroll
  for (int v = 0; v < V; ++v) last[v] = T(1);
  T top_prev = T(1), corner = T(0);
  fill(0);
  for (int k = 0; k * kColSteps < steps; ++k) {
    fill(k + 1);
    __pipeline_wait_prior(1);
    __syncwarp();
    const T* tile = tiles + ((k & 1) * 32 * TV + lane * TV) * V;
    const int s1 = min((k + 1) * kColSteps, steps);
    for (int s = k * kColSteps; s < s1; ++s) {
      T sent[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        sent[v] = __shfl_up_sync(kFull, last[v], 1, S);
      const int jb = s - t;
      if (in && jb >= 0 && jb < nb) {
        T a[RL][V];
#pragma unroll
        for (int r = 0; r < RL; ++r)
          Vec16<T>::load(tile + (r * kColSteps + s - k * kColSteps) * V,
                         a[r]);
        const int vn = min(V, C - jb * V);  // the block's columns
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (v >= vn) break;
          const T top = t == 0 ? T(1) : sent[v];
          T up = top, upleft = top_prev;
#pragma unroll
          for (int r = 0; r < RL; ++r) {
            const T val = goursat_cell(u[r], up, upleft, a[r][v]);
            upleft = u[r];
            up = val;
            u[r] = val;
          }
          last[v] = u[RL - 1];
          top_prev = top;
        }
        if (jb == nb - 1) {
#pragma unroll
          for (int r = 0; r < RL; ++r)
            if (row0 + r == R - 1) corner = u[r];
        }
      }
    }
    __syncwarp();  // the tile is read before chunk k + 2 refills it
  }
  __pipeline_wait_prior(0);
  return corner;
}

// Segment design (bands == 1): block b, one warp, takes pairs b·P .. b·P +
// P - 1 (P = 32 / S), one a segment, staged when stage. Banded (bands >
// 1, S = 32): block b, W warps, takes pair b, warp w its bands w, w + W,
// ...; shared memory: the bands' progress marks, then the ring of W bottom
// rows (bnd_smem; else the block's slot of work [B][W][C + 1]), then the
// pair's increments when stage. Cols: the segment design by goursat_cols.
template <typename T, int RL, int OS, bool Cols>
__global__ void __launch_bounds__(32 * kFwdBandWarps)
goursat_fwd_kernel(const T* __restrict__ inc, T* __restrict__ out,
                   T* __restrict__ work, int B, int Su, int Tu, int o,
                   int S, int bands, int stage, int bnd_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int W = static_cast<int>(blockDim.x) >> 5;
  const int P = 32 / S;
  const int t = lane % S;
  const long long cells = static_cast<long long>(Su) * Tu;
  const long long first = bands > 1 ? blockIdx.x
                                    : static_cast<long long>(blockIdx.x) * P;
  const long long pair = bands > 1 ? first : first + lane / S;
  const bool live = pair < B;  // a dead segment runs on the last pair
  RefinedGrid<T> a(inc + (live ? pair : B - 1) * cells, Su, Tu, o);
  const int R = a.R, C = a.C;
  int* marks = reinterpret_cast<int*>(smem_raw);
  const int nmarks = bands > 1 ? (bands + 3) / 4 * 4 : 0;  // 16-byte steps
  T* sm = reinterpret_cast<T*>(smem_raw + nmarks * sizeof(int));
  T* bnd = bnd_smem ? sm : work + static_cast<long long>(blockIdx.x) * W *
                                      (C + 1);
  T* sinc = sm + (bands > 1 && bnd_smem ? W * (C + 1) : 0);
  for (int k = threadIdx.x; k < nmarks; k += blockDim.x) marks[k] = 0;
  if (stage) {
    const long long rest = B - first;
    const long long n = (bands > 1 ? 1 : (rest < P ? rest : P)) * cells;
    stage_copy(sinc, inc + first * cells, n, threadIdx.x, blockDim.x);
    if (live) a.inc = sinc + (pair - first) * cells;
  }
  __syncthreads();
  T corner = T(0);
  if constexpr (Cols) {
    corner = goursat_cols<T, RL>(inc, first, B, cells, a.rs, R, C, S,
                                 reinterpret_cast<T*>(smem_raw));
  } else if (bands == 1) {
    corner = goursat_band<T, RL, OS>(a.inc, a.rs, a.cs, o, a.scale, R, C, S,
                                     t, 0, nullptr, nullptr, nullptr,
                                     nullptr);
  } else {
    for (int b = warp; b < bands; b += W) {
      const T c = goursat_band<T, RL, OS>(
          a.inc, a.rs, a.cs, o, a.scale, R, C, 32, t, b * 32 * RL,
          b > 0 ? bnd + (b - 1) % W * (C + 1) : nullptr,
          b > 0 ? marks + b - 1 : nullptr,
          b + 1 < bands ? bnd + b % W * (C + 1) : nullptr, marks + b);
      if (b == bands - 1) corner = c;
    }
  }
  // the corner's lane: row R in the last band (R = 0: u = 1, lane 0)
  const int bl = bands > 1 ? (bands - 1) * 32 * RL : 0;
  if (live && (R == 0 ? t == 0 : (R - 1 - bl) / RL == t && R - 1 >= bl) &&
      (bands == 1 || warp == (bands - 1) % W))
    out[pair] = R == 0 ? T(1) : corner;
}

template <typename T, int RL, int OS, bool Cols>
cudaError_t launch(const void* inc, void* out, void* work, int B, int Su,
                   int Tu, int o, int S, int bands, int W, int stage,
                   int bnd_smem, cudaStream_t stream) {
  int R, C;
  swept_sides(Su, Tu, o, R, C);
  const int lanes_needed = (R + RL - 1) / RL;
  if (bands != (bands > 1 ? (R + 32 * RL - 1) / (32 * RL) : 1) ||
      (bands == 1 ? (W != 1 || lanes_needed > S)
                  : (S != 32 || W < 2 || W > kFwdBandWarps || W > bands)))
    return cudaErrorInvalidValue;
  const size_t cells = static_cast<size_t>(Su) * Tu;
  const int P = 32 / S;
  size_t smem = 0;
  if (bands > 1) {
    smem = (bands + 3) / 4 * 4 * sizeof(int) +
           (bnd_smem ? sizeof(T) * W * (C + 1) : 0);
  }
  if (stage) smem += sizeof(T) * cells * (bands > 1 ? 1 : P);
  if (Cols) smem = col_smem(RL);
  if (smem > kSmemCap) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(goursat_fwd_kernel<T, RL, OS, Cols>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = bands > 1 ? B : (B + P - 1) / P;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  goursat_fwd_kernel<T, RL, OS, Cols><<<static_cast<unsigned>(blocks),
                                        32 * W, smem, stream>>>(
      static_cast<const T*>(inc), static_cast<T*>(out), static_cast<T*>(work),
      B, Su, Tu, o, S, bands, stage, bnd_smem);
  return cudaGetLastError();
}

// RL rows a lane and OS = min(o, log2 RL), the shift within a lane's rows
// (cols: o = 0, checked by run)
template <typename T, int RL>
cudaError_t by_shift(const void* inc, void* out, void* work, int B, int Su,
                     int Tu, int o, int S, int bands, int W, int stage,
                     int bnd_smem, int cols, cudaStream_t s) {
  if (cols)
    return launch<T, RL, 0, true>(inc, out, work, B, Su, Tu, o, S, bands, W,
                                  stage, bnd_smem, s);
#define GPSIG_OS(k)                                                        \
  if constexpr ((1 << k) <= RL) {                                          \
    if (o == k || (k == 0 ? false : (1 << k) == RL && o > k))              \
      return launch<T, RL, k, false>(inc, out, work, B, Su, Tu, o, S,      \
                                     bands, W, stage, bnd_smem, s);        \
  }
  GPSIG_OS(0) GPSIG_OS(1) GPSIG_OS(2) GPSIG_OS(3)
#undef GPSIG_OS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_rows(const void* inc, void* out, void* work, int B, int Su,
                    int Tu, int o, int RL, int S, int bands, int W,
                    int stage, int bnd_smem, int cols, cudaStream_t s) {
  if (cols && (o != 0 || bands != 1 || stage || Su > Tu))
    return cudaErrorInvalidValue;
  switch (RL) {
    case 2: return by_shift<T, 2>(inc, out, work, B, Su, Tu, o, S, bands, W,
                                  stage, bnd_smem, cols, s);
    case 4: return by_shift<T, 4>(inc, out, work, B, Su, Tu, o, S, bands, W,
                                  stage, bnd_smem, cols, s);
    case 8: return by_shift<T, 8>(inc, out, work, B, Su, Tu, o, S, bands, W,
                                  stage, bnd_smem, cols, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* inc, void* out, void* work, int B, int Su, int Tu,
        int o, int RL, int S, int bands, int W, int stage, int bnd_smem,
        int cols, int f64, void* stream) {
  if (B < 1 || !refined_fits(Su, Tu, o) ||
      (S != 4 && S != 8 && S != 16 && S != 32) ||
      (bands > 1 && !bnd_smem && work == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? by_rows<double>(inc, out, work, B, Su, Tu, o, RL, S, bands, W,
                               stage, bnd_smem, cols, s)
             : by_rows<float>(inc, out, work, B, Su, Tu, o, RL, S, bands, W,
                              stage, bnd_smem, cols, s);
}

}  // namespace

extern "C" {

// inc [B, S, T] contiguous -> out [B] = u(S, T) on the grid as given (the
// TPU's _kernel); the plan (RL rows a lane, S lanes a pair, bands, W warps
// a block, stage, bnd_smem, cols; work [B][W][C + 1] where the bands' rows
// are not in shared memory) from ops/cuda/plan.py's goursat_fwd_plan.
// Returns cudaGetLastError() after the launch.
int gpsig_goursat(const void* inc, void* out, void* work, int B, int S,
                  int T, int RL, int lanes, int bands, int W, int stage,
                  int bnd_smem, int cols, int f64, void* stream) {
  return run(inc, out, work, B, S, T, 0, RL, lanes, bands, W, stage,
             bnd_smem, cols, f64, stream);
}

// inc [B, Su, Tu] contiguous (unrefined) -> out [B] = u(Su 2^o, Tu 2^o) of
// the refined solve (the TPU's _fused_kernel forward); the plan as above.
int gpsig_goursat_refined(const void* inc, void* out, void* work, int B,
                          int Su, int Tu, int o, int RL, int lanes, int bands,
                          int W, int stage, int bnd_smem, int cols, int f64,
                          void* stream) {
  return run(inc, out, work, B, Su, Tu, o, RL, lanes, bands, W, stage,
             bnd_smem, cols, f64, stream);
}

}  // extern "C"
