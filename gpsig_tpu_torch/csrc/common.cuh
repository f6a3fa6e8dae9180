// Device helpers shared by the kernels in this directory.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace gpsig {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float texp(float v) { return expf(v); }
__device__ __forceinline__ double texp(double v) { return exp(v); }
__device__ __forceinline__ float tcos(float v) { return cosf(v); }
__device__ __forceinline__ double tcos(double v) { return cos(v); }
__device__ __forceinline__ float tsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double tsqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float tsin(float v) { return sinf(v); }
__device__ __forceinline__ double tsin(double v) { return sin(v); }

// Base-kernel kinds of the general engines (fused_gram_ho.cu,
// tens_seq_general.cu), passed at run time: every thread of a launch takes
// the same branch. POLY's offset is folded in by the caller as a constant
// channel (x_extra = 1, y_extra = c), so the kernels see (<x, y>)^degree.
enum BaseKind : int { kLinear = 0, kRbf = 1, kCosine = 2, kPoly = 3 };

// Whether a kind adds -|a|^2/2 - |b|^2/2 to the dot product.
__device__ __forceinline__ bool kind_norms(int kind) {
  return kind == kRbf || kind == kCosine;
}

// The base kernel from its accumulator acc = <a, b> (+ the half norms).
// The RBF exponent is not clamped, as the TPU kernels and their plain
// references compute it; the cosine's distance is, as there.
template <typename T>
__device__ __forceinline__ T activate(T acc, int kind, int degree) {
  switch (kind) {
    case kRbf: return texp(acc);
    case kCosine: {
      const T s = T(-2) * acc;
      return tcos(tsqrt((s > T(0) ? s : T(0)) + T(1e-36)));
    }
    case kPoly: {
      T out = acc;
      for (int k = 1; k < degree; ++k) out *= acc;
      return out;
    }
    default: return acc;
  }
}

// d activate / d acc, as autodiff of the plain versions gives it: the
// cosine's clamp passes the gradient where -2 acc >= 0, i.e. acc <= 0.
template <typename T>
__device__ __forceinline__ T activate_grad(T acc, int kind, int degree) {
  switch (kind) {
    case kRbf: return texp(acc);
    case kCosine: {
      if (acc > T(0)) return T(0);
      const T t = tsqrt(T(-2) * acc + T(1e-36));
      return tsin(t) / t;
    }
    case kPoly: {
      T out = T(degree);
      for (int k = 1; k < degree; ++k) out *= acc;
      return out;
    }
    default: return T(1);
  }
}

// k(a, b) of any kind for one point pair; na, nb are -|a|^2/2, -|b|^2/2
// (used by the kinds that need them)
template <typename T>
__device__ __forceinline__ T kind_k(const T* a, T na, const T* b, T nb,
                                    int d, int kind, int degree) {
  T acc = kind_norms(kind) ? na + nb : T(0);
  for (int c = 0; c < d; ++c) acc += a[c] * b[c];
  return activate(acc, kind, degree);
}

// k(a, b) for one point pair; na, nb are -|a|^2/2, -|b|^2/2 (RBF only)
template <typename T>
__device__ __forceinline__ T base_k(const T* a, T na, const T* b, T nb,
                                    int d, bool rbf) {
  T acc = rbf ? na + nb : T(0);
  for (int c = 0; c < d; ++c) acc += a[c] * b[c];
  return rbf ? texp(acc) : acc;
}

// -|x_i|^2/2 for the L points of a staged sequence, written by `nthreads`
// cooperating threads starting at `tid`
template <typename T>
__device__ void half_sqnorms(const T* xs, T* nxs, int L, int d, int tid,
                             int nthreads) {
  for (int i = tid; i < L; i += nthreads) {
    T s = T(0);
    for (int c = 0; c < d; ++c) s += xs[i * d + c] * xs[i * d + c];
    nxs[i] = T(-0.5) * s;
  }
}

// Compile-time level M of a kernel templated on its level count: each_level
// calls fn(Level<M>{}) for M = M0 .. NL, so a lambda body sees M as a
// constant (the Kuf kernels take their levels one at a time).
template <int M>
struct Level {
  static constexpr int value = M;
};

template <int M, int NL, typename Fn>
__device__ __forceinline__ void each_level(Fn& fn) {
  if constexpr (M <= NL) {
    fn(Level<M>{});
    each_level<M + 1, NL>(fn);
  }
}

// The order-1 Kuf kernels' packed factor point (tens_seq.cuh,
// tens_seq_bwd.cuh), d <= 3: (z_0, z_1, z_2, -|z|^2/2) zero-padded, so one
// 16-byte shared load (two in float64) gives the point's accumulator
// a = -|x|^2/2 + <rec, (x_0, x_1, x_2, 1)>; the same vector layout carries
// a lane's Z̄ sums (sum u x_c, sum u).
template <typename T>
struct alignas(16) Rec4 {
  T v[4];
};

// The order-1 Kuf kernels' RBF exponential: in float32 2^a on the
// special-function unit (ex2.approx.ftz: relative error below 2^-22,
// results below 2^-126 flushed to 0), with log2(e) folded into the staged
// factor points and the half norms (kuf_fold) so that it costs no
// multiply; in float64 e^a.
__device__ __forceinline__ float kuf_exp(float a) {
#ifdef __CUDA_ARCH__
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
#else
  return exp2f(a);
#endif
}
__device__ __forceinline__ double kuf_exp(double a) { return exp(a); }

template <typename T>
__host__ __device__ constexpr T kuf_fold() {
  return sizeof(T) == 4 ? T(1.4426950408889634) : T(1);
}

// The Kuf backwards' scans along a pair's time axis (tens_seq_bwd.cuh,
// tens_seq_general_bwd.cuh): a warp's 32 lanes hold KP consecutive points
// each. Exclusive prefix over the chunk's points (lane major) and the
// chunk's total.
template <typename T, int KP>
__device__ __forceinline__ T chunk_prefix(const T (&v)[KP], T (&out)[KP],
                                          int lane) {
  T run = T(0);
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    out[r] = run;
    run += v[r];
  }
  T incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const T total = __shfl_sync(kFull, incl, 31);
  T ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = T(0);
#pragma unroll
  for (int r = 0; r < KP; ++r) out[r] += ex;
  return total;
}

// Exclusive suffix over a chunk's points and the chunk's total.
template <typename T, int KP>
__device__ __forceinline__ T chunk_suffix(const T (&v)[KP], T (&out)[KP],
                                          int lane) {
  T run = T(0);
#pragma unroll
  for (int r = KP - 1; r >= 0; --r) {
    out[r] = run;
    run += v[r];
  }
  T incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += t;
  }
  const T total = __shfl_sync(kFull, incl, 0);
  T ex = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) ex = T(0);
#pragma unroll
  for (int r = 0; r < KP; ++r) out[r] += ex;
  return total;
}

// Sum over the warp, returned to every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Row partition. The DP rows of one pair are spread over a group of
// threads; group thread t holds rows t*R .. t*R+R-1. Two kinds of group,
// passed to the DP code as a type:
// - WarpGroup<T, S>: one warp (S = 32) or a segment of S = 16 or 8 lanes
//   of one (fused_gram_bwd.cu puts two pairs on a warp; the Gram forwards'
//   segments, below, up to four). A row scan is a chain
//   of shuffles, as the kernels always did; nothing else is in its way, so
//   the compiler interleaves the independent scans of a column.
// - BlockGroup<T>: a block of W warps (up to 8) for more than 128 rows.
//   Each scan is the warp's shuffle chain plus an exchange of the warp
//   totals through shared memory with one barrier. The buffer buf[2][W]
//   alternates halves: an exchange's reads end before its threads reach
//   the next exchange's barrier, so the one after may overwrite the half.
//   Every thread of the block runs the same exchanges (W, nl and the column
//   count are uniform), so a block group never returns early.
// The two are separate instantiations: weaving the exchange into the
// single-warp code, even behind a branch, cost 40-70% at L <= 129
// (measured), because it splits the shuffle chains that the scheduler
// interleaves. Each group names the block size its kernels launch with
// (kMaxThreads, their __launch_bounds__): the bound steers ptxas's
// register choice, so the warp instantiations keep the four-warp bound
// they always had (a 256-thread bound moved the order-2 Gram backward from
// 168 to 172 registers, three blocks an SM to two, 1.4x slower at L = 50).
// ---------------------------------------------------------------------------

// A launch plan (ops/cuda/plan.py): one warp per pair, kPairsPerBlock
// pairs to a block, R = 1, 2 or 4 rows a lane; or one block of W warps
// per pair (a BlockGroup), R = 4. The two Gram forwards take segments of
// S = 8, 16 or 32 lanes instead (SegBlock, below).
constexpr int kPairsPerBlock = 4;
constexpr int kMaxWarps = 8;

template <typename T, int S = 32>
struct WarpGroup {
  static constexpr bool kBlock = false;
  static constexpr int kLanes = S;
  static constexpr int kMaxThreads = 32 * kPairsPerBlock;
  int lane;

  __device__ explicit WarpGroup(int = 1, T* = nullptr)
      : lane(static_cast<int>(threadIdx.x) % S) {}
  __device__ int thread() const { return lane; }
  __device__ int size() const { return S; }
  __device__ void sync() const { __syncwarp(); }

  // Exclusive prefix over the group's rows: out[r] = sum of v over all
  // rows before row t*R + r.
  template <int R>
  __device__ __forceinline__ void prefix(const T (&v)[R], T (&out)[R]) {
    prefix_from<R>(v, out, T(0));
  }

  // The exclusive prefix plus `from`, which group thread 0 passes (the
  // others pass 0): the sum of the rows before the group's (the
  // diagonal's bands). Returns the thread's inclusive total, at thread
  // S - 1 `from` plus the group's sum.
  template <int R>
  __device__ __forceinline__ T prefix_from(const T (&v)[R], T (&out)[R],
                                           T from) {
    T run = from;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      out[r] = run;
      run += v[r];
    }
    T incl = run;
#pragma unroll
    for (int off = 1; off < S; off <<= 1) {
      const T t = __shfl_up_sync(kFull, incl, off, S);
      if (lane >= off) incl += t;
    }
    T excl = __shfl_up_sync(kFull, incl, 1, S);
    if (lane == 0) excl = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] += excl;
    return incl;
  }

  // The exclusive suffix plus `from`, which group thread S - 1 passes (the
  // others pass 0): the sum of the rows after the group's (sig_gram's
  // bands). Returns the thread's inclusive suffix total, at thread 0
  // `from` plus the group's sum.
  template <int R>
  __device__ __forceinline__ T suffix_from(const T (&v)[R], T (&out)[R],
                                           T from) {
    T run = from;
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      out[r] = run;
      run += v[r];
    }
    T incl = run;
#pragma unroll
    for (int off = 1; off < S; off <<= 1) {
      const T t = __shfl_down_sync(kFull, incl, off, S);
      if (lane + off < S) incl += t;
    }
    T excl = __shfl_down_sync(kFull, incl, 1, S);
    if (lane == S - 1) excl = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] += excl;
    return incl;
  }

  // Exclusive suffix over the group's rows: out[r] = sum of v over all
  // rows after row t*R + r.
  template <int R>
  __device__ __forceinline__ void suffix(const T (&v)[R], T (&out)[R]) {
    T run = T(0);
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      out[r] = run;
      run += v[r];
    }
    T incl = run;
#pragma unroll
    for (int off = 1; off < S; off <<= 1) {
      const T t = __shfl_down_sync(kFull, incl, off, S);
      if (lane + off < S) incl += t;
    }
    T excl = __shfl_down_sync(kFull, incl, 1, S);
    if (lane == S - 1) excl = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] += excl;
  }

  // Sum over the group, returned to every thread.
  __device__ __forceinline__ T sum(T v) {
#pragma unroll
    for (int off = S / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off, S);
    return v;
  }

  // The value v of group thread t + 1, and 0 at the group's last thread.
  __device__ __forceinline__ T next(T v) {
    T n = __shfl_down_sync(kFull, v, 1, S);
    return lane == S - 1 ? T(0) : n;
  }
};

template <typename T>
struct BlockGroup {
  static constexpr bool kBlock = true;
  static constexpr int kLanes = 32;
  static constexpr int kMaxThreads = 32 * kMaxWarps;
  WarpGroup<T> w;  // this warp
  int warp, W, phase;
  T* buf;  // shared [2][W]

  __device__ BlockGroup(int W_, T* buf_)
      : w(), warp(static_cast<int>(threadIdx.x) >> 5), W(W_), phase(0),
        buf(buf_) {}
  __device__ int thread() const { return warp * 32 + w.lane; }
  __device__ int size() const { return 32 * W; }
  __device__ void sync() const { __syncthreads(); }

  // Publish this warp's value v (from lane `src`) and return the sum of
  // the published values of the warps w' with lo <= w' < hi.
  __device__ __forceinline__ T exchange(T v, int src, int lo, int hi) {
    T* b = buf + phase * W;
    if (w.lane == src) b[warp] = v;
    __syncthreads();
    T s = T(0);
    for (int k = lo; k < hi; ++k) s += b[k];
    phase ^= 1;
    return s;
  }

  template <int R>
  __device__ __forceinline__ void prefix(const T (&v)[R], T (&out)[R]) {
    w.template prefix<R>(v, out);
    // lane 31's inclusive total is out[R-1] + v[R-1]
    const T total = out[R - 1] + v[R - 1];
    const T before = exchange(total, 31, 0, warp);
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] += before;
  }

  template <int R>
  __device__ __forceinline__ void suffix(const T (&v)[R], T (&out)[R]) {
    w.template suffix<R>(v, out);
    const T total = out[0] + v[0];  // lane 0's inclusive total
    const T after = exchange(total, 0, warp + 1, W);
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] += after;
  }

  __device__ __forceinline__ T sum(T v) {
    return exchange(w.sum(v), 0, 0, W);
  }

  __device__ __forceinline__ T next(T v) {
    const T n = __shfl_down_sync(kFull, v, 1);
    const T first = exchange(v, 0, warp + 1, warp + 2 <= W ? warp + 2 : W);
    return w.lane == 31 ? first : n;
  }
};

// ---------------------------------------------------------------------------
// Segments: the Gram forwards' row groups (fused_gram.cu, fused_gram_ho.cu).
// A segment of S = 8, 16 or 32 lanes (a WarpGroup<T, S>) takes one pair at
// R = 2, 4 or 8 rows a lane, so a warp takes 32 / S pairs and one warp
// covers up to 256 rows with no barrier. A scan is log2(S) + 1 shuffles,
// shared by the warp's pairs. Every lane of the warp runs every scan (the
// shuffles take the full mask), whether or not its segment's pair is
// written out.
// ---------------------------------------------------------------------------

// Rows a lane of a segment plan: the most of 8, 4, 2 whose DP state of
// `per_row` values a row fits kSegStateRegs 32-bit registers (the same
// table as ops/cuda/plan.py's gram_fwd_rows_per_lane).
constexpr int kSegStateRegs = 128;

template <typename T>
constexpr int seg_rows(int per_row) {
  return 8 * per_row * static_cast<int>(sizeof(T) / 4) <= kSegStateRegs ? 8
         : 4 * per_row * static_cast<int>(sizeof(T) / 4) <= kSegStateRegs
             ? 4
             : 2;
}

// The activation of N accumulators of one kind: one branch for all N.
template <typename T, int N>
__device__ __forceinline__ void activate_all(T (&a)[N], int kind,
                                             int degree) {
  switch (kind) {
    case kRbf:
#pragma unroll
      for (int n = 0; n < N; ++n) a[n] = texp(a[n]);
      break;
    case kCosine:
#pragma unroll
      for (int n = 0; n < N; ++n) a[n] = activate(a[n], kCosine, 0);
      break;
    case kPoly:
#pragma unroll
      for (int n = 0; n < N; ++n) a[n] = activate(a[n], kPoly, degree);
      break;
    default: break;
  }
}

// The general Kuf kernels' activations (tens_seq_general*.cuh) of a batch
// of N accumulators, one branch on the kind for the batch: RBF (the main
// path's kind) and Poly inline, Linear nothing, the cosine's value (and
// derivative) out of line, so that a kernel unrolled over its factor
// points compiles one copy of the cosine's range reduction. (A rolled
// loop over a local copy of the batch instead took 1.56x the parent's time
// for the cosine forward, measured.)
template <typename T>
__device__ __noinline__ T cosine_value(T acc) {
  return activate(acc, kCosine, 0);
}

template <typename T>
struct ValueGrad {
  T v, g;
};

template <typename T>
__device__ __noinline__ ValueGrad<T> cosine_value_grad(T acc) {
  const T s = T(-2) * acc;
  const T t = tsqrt((s > T(0) ? s : T(0)) + T(1e-36));
  return {tcos(t), acc > T(0) ? T(0) : tsin(t) / t};
}

// four cosine values in one call: their chains interleave
template <typename T>
struct Four {
  T v[4];
};

template <typename T>
__device__ __noinline__ Four<T> cosine_values4(T a0, T a1, T a2, T a3) {
  return {{activate(a0, kCosine, 0), activate(a1, kCosine, 0),
           activate(a2, kCosine, 0), activate(a3, kCosine, 0)}};
}

template <typename T, int N>
__device__ __forceinline__ void kuf_activate(T (&a)[N], int kind,
                                             int degree) {
  switch (kind) {
    case kRbf:
#pragma unroll
      for (int n = 0; n < N; ++n) a[n] = texp(a[n]);
      break;
    case kCosine:
#pragma unroll
      for (int n = 0; n + 4 <= N; n += 4) {
        const Four<T> c = cosine_values4(a[n], a[n + 1], a[n + 2], a[n + 3]);
#pragma unroll
        for (int k = 0; k < 4; ++k) a[n + k] = c.v[k];
      }
#pragma unroll
      for (int n = N - N % 4; n < N; ++n) a[n] = cosine_value(a[n]);
      break;
    case kPoly:
#pragma unroll
      for (int n = 0; n < N; ++n) a[n] = activate(a[n], kPoly, degree);
      break;
    default: break;
  }
}

// values into a, d value / d acc into g (activate_grad)
template <typename T, int N>
__device__ __forceinline__ void kuf_activate_grad(T (&a)[N], T (&g)[N],
                                                  int kind, int degree) {
  switch (kind) {
    case kRbf:
#pragma unroll
      for (int n = 0; n < N; ++n) g[n] = a[n] = texp(a[n]);
      break;
    case kCosine:
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const ValueGrad<T> vg = cosine_value_grad(a[n]);
        a[n] = vg.v;
        g[n] = vg.g;
      }
      break;
    case kPoly:
#pragma unroll
      for (int n = 0; n < N; ++n) {
        g[n] = activate_grad(a[n], kPoly, degree);
        a[n] = activate(a[n], kPoly, degree);
      }
      break;
    default:
#pragma unroll
      for (int n = 0; n < N; ++n) g[n] = T(1);
      break;
  }
}

// Copy n values from global src to shared dst by `count` threads from
// `tid` with asynchronous copies (cp.async), 16 bytes a copy where both
// ends are 16-byte aligned: all of a thread's values in flight at once,
// none through its registers (a loop that loads and stores a value at a
// time waits out the memory's latency once a value), then a wait for all
// of them. The caller's barrier makes them visible to the other threads.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* __restrict__ src,
                                           long long n, int tid, int count) {
  constexpr int kVec = 16 / sizeof(T);
  long long head = 0;
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
       15) == 0) {
    head = n / kVec * kVec;
    for (long long k = tid; k < n / kVec; k += count)
      __pipeline_memcpy_async(dst + k * kVec, src + k * kVec, 16);
  }
  for (long long k = head + tid; k < n; k += count)
    __pipeline_memcpy_async(dst + k, src + k, sizeof(T));
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Shared memory one block may use on Hopper (plan.py's SMEM_BYTES).
constexpr size_t kSegSmemBytes = 227 * 1024;

// One block of a segment launch: kPairsPerBlock warps of 32 / S pairs, all
// of one x sequence X[n1] against y sequences Y[y0 + p]. x is staged lane
// major: segment lane t's point r (i = min(t*R + r, L - 1)) at
// xl[(r * d + c) * S + t], so a segment's lanes read consecutive words and
// the warp's segments the same ones (no bank conflicts). Each pair stages
// its y and -|y|^2/2 at an odd stride (the warp's segments read their y in
// distinct banks); where the block's y do not fit the shared memory (wide
// d), only the half norms, and the segment reads its y from global memory
// (each of its loads one address, cached). Pairs past N2 stage Y[N2 - 1]
// and are not written; with `sym` (Y = X, out symmetric) so are the pairs
// below the diagonal, and a block none of whose pairs is on or above it
// returns before staging.
template <typename T, int R, int S>
struct SegBlock {
  static constexpr int kPairs = 32 * kPairsPerBlock / S;
  int n1, n2;
  bool live;  // this segment's pair is solved and written
  const T* xl;
  const T* ys;  // the pair's y: staged, or in global memory
  const T* nys;

  static __host__ __device__ int pair_stride(int L, int d, bool stage_y) {
    return stage_y ? (L * (d + 1)) | 1 : L | 1;
  }
  static __host__ __device__ size_t smem_elems(int L, int d, bool stage_y) {
    return static_cast<size_t>(R + 1) * d * S +
           static_cast<size_t>(kPairs) * pair_stride(L, d, stage_y);
  }
  // y staged in shared memory where it fits
  static __host__ __device__ bool stages_y(int L, int d) {
    return sizeof(T) * smem_elems(L, d, true) <= kSegSmemBytes;
  }
  static __host__ __device__ long long blocks(int N1, int N2) {
    return static_cast<long long>(N1) * ((N2 + kPairs - 1) / kPairs);
  }

  // Returns false (the whole block alike) when the block has nothing to
  // solve; otherwise stages x and the pairs' y (or their half norms only),
  // ending in a barrier.
  __device__ bool stage(const T* X, const T* Y, int N1, int N2, int L,
                        int d, bool norms, bool sym, bool stage_y, T* smem) {
    const int nyb = (N2 + kPairs - 1) / kPairs;
    n1 = static_cast<int>(blockIdx.x) / nyb;
    const int y0 = (static_cast<int>(blockIdx.x) % nyb) * kPairs;
    if (sym && y0 + kPairs - 1 < n1) return false;
    const int p = static_cast<int>(threadIdx.x) / S;
    const int t = static_cast<int>(threadIdx.x) % S;
    n2 = y0 + p;
    live = n2 < N2 && !(sym && n2 < n1);
    T* x_l = smem;
    T* y_s = x_l + (R + 1) * d * S + p * pair_stride(L, d, stage_y);
    T* ny_s = stage_y ? y_s + L * d : y_s;
    const T* xg = X + static_cast<long long>(n1) * L * d;
    for (int k = threadIdx.x; k < (R + 1) * S; k += blockDim.x) {
      const int r = k / S, lt = k % S;
      const int i = min(lt * R + r, L - 1);
      for (int c = 0; c < d; ++c) x_l[(r * d + c) * S + lt] = xg[i * d + c];
    }
    const T* yg = Y + static_cast<long long>(min(n2, N2 - 1)) * L * d;
    for (int i = t; i < L; i += S) {
      T s = T(0);
      for (int c = 0; c < d; ++c) {
        const T v = yg[i * d + c];
        if (stage_y) y_s[i * d + c] = v;
        s += v * v;
      }
      ny_s[i] = norms ? T(-0.5) * s : T(0);
    }
    xl = x_l;
    ys = stage_y ? y_s : yg;
    nys = ny_s;
    __syncthreads();
    return true;
  }

  // Level m's value v of the pair (group thread 0 calls it): out[m, n1, n2]
  // and, with sym, out[m, n2, n1].
  __device__ void write(T* out, int m, T v, int N1, int N2,
                        bool sym) const {
    const long long stride = static_cast<long long>(N1) * N2;
    out[m * stride + static_cast<long long>(n1) * N2 + n2] = v;
    if (sym && n2 != n1)
      out[m * stride + static_cast<long long>(n2) * N2 + n1] = v;
  }
};

// Columns of M for one pair of a segment block, built in registers from
// the staged sequences (as GramColumns in fused_gram_ho.cu): with `diff`
// the double difference of the base values at the lane's R + 1 points
// against the previous column's (L - 1 rows and columns), else the raw
// values (L rows and columns); rows past the matrix are exactly 0.
template <typename T, int R, int S>
struct SegColumns {
  const T* xl;
  const T* ys;
  const T* nys;
  int d, kind, degree, rows, t;
  bool diff, norms;
  T nx[R + 1];
  T kprev[R + 1];

  __device__ SegColumns(const SegBlock<T, R, S>& b, int L, int d_,
                        int kind_, int degree_, bool diff_, int t_)
      : xl(b.xl + t_), ys(b.ys), nys(b.nys), d(d_), kind(kind_),
        degree(degree_), rows(diff_ ? L - 1 : L), t(t_), diff(diff_),
        norms(kind_norms(kind_)) {
#pragma unroll
    for (int n = 0; n <= R; ++n) {
      T s = T(0);
      for (int c = 0; c < d; ++c) {
        const T v = xl[(n * d + c) * S];
        s += v * v;
      }
      nx[n] = T(-0.5) * s;
    }
    if (diff) values<R + 1>(0, kprev);
  }

  // base values k(x_{t*R + n}, y_j) for n < N
  template <int N>
  __device__ __forceinline__ void values(int j, T (&k)[N]) const {
    const T* yj = ys + j * d;
    const T ny = norms ? nys[j] : T(0);
#pragma unroll
    for (int n = 0; n < N; ++n) k[n] = norms ? nx[n] + ny : T(0);
    for (int c = 0; c < d; ++c) {
      const T yc = yj[c];
#pragma unroll
      for (int n = 0; n < N; ++n) k[n] += xl[(n * d + c) * S] * yc;
    }
    activate_all(k, kind, degree);
  }

  __device__ __forceinline__ void operator()(int j, T (&mcol)[R]) {
    if (diff) {
      T knew[R + 1];
      values<R + 1>(j + 1, knew);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T v = (knew[r + 1] - kprev[r + 1]) - (knew[r] - kprev[r]);
        mcol[r] = (t * R + r < rows) ? v : T(0);
      }
#pragma unroll
      for (int r = 0; r <= R; ++r) kprev[r] = knew[r];
    } else {
      values<R>(j, mcol);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (t * R + r >= rows) mcol[r] = T(0);
    }
  }
};

constexpr int kRlLevels = 7;

// ---------------------------------------------------------------------------
// Run-length (any order) column DP of one pair, shared by fused_gram_ho.cu
// (columns built from the sequences) and sig_gram.cu (columns read from a
// prebuilt increment matrix). The recursion is ops/signature.py's
// _higher_order with p = P = min(order, num_levels):
//   level 1: D[0][0] = M;  level m >= 2, R_m = min(P, m):
//     D'[0][0] = M * ecumsum2(sum of all D)
//     D'[r][0] = M/(r+1) * (row cumsum, exclusive, of sum_s D[r-1][s])
//     D'[0][r] = M/(r+1) * (column cumsum, exclusive, of sum_s D[s][r-1])
//     D'[r][s] = M/((r+1)(s+1)) * D[r-1][s-1]
// A group (WarpGroup or BlockGroup) sweeps the columns j; its thread t
// holds rows
// t*R .. t*R+R-1. The
// current column's states of all levels are computed level by level into
// one in-place P x P grid; only states with r, s < R_m exist at level m,
// and the grid's extents are compile-time, so no dead state is computed.
// Per level two carries persist across columns: T_m[i] = sum over j' < j
// of all states (its exclusive row prefix, a row scan, gives ecumsum2)
// and RA_m[q][i] = sum over j' < j of sum_s D[q][s] (the row cumsum). The
// column cumsums are row scans of the current column. k_m = sum_i T_m[i]
// at the end.
// ---------------------------------------------------------------------------

// NLM bounds the levels a state holds (nl <= NLM): the register path's 7,
// or fewer for an instantiation that takes only that many.
template <typename T, int R, int P, int NLM = kRlLevels>
struct RunLengthState {
  T grid[P][P][R];
  T tsum[NLM][R];
  T ra[NLM > 1 ? NLM - 1 : 1][P > 1 ? P - 1 : 1][R];
};

template <typename T, int R, int P, int M, typename G, int NLM>
__device__ __forceinline__ void rl_level(RunLengthState<T, R, P, NLM>& st,
                                         const T (&mcol)[R], int nl,
                                         G& g) {
  if constexpr (M <= NLM) {
    if (M > nl) return;
    constexpr int Rm = P < M ? P : M;
    if constexpr (M == 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) st.grid[0][0][r] = mcol[r];
    } else {
      constexpr int Rp = P < M - 1 ? P : M - 1;  // extent at level M - 1
      constexpr int NQ = Rm > 1 ? Rm - 1 : 1;
      T tot[R], pre[R], colpre[NQ][R], rowsum[NQ][R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tot[r] = T(0);
#pragma unroll
        for (int a = 0; a < Rp; ++a)
#pragma unroll
          for (int b = 0; b < Rp; ++b) tot[r] += st.grid[a][b][r];
      }
#pragma unroll
      for (int q = 0; q + 1 < Rm; ++q) {
        T cs[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cs[r] = T(0);
          rowsum[q][r] = T(0);
#pragma unroll
          for (int a = 0; a < Rp; ++a) {
            cs[r] += st.grid[a][q][r];
            rowsum[q][r] += st.grid[q][a][r];
          }
        }
        g.template prefix<R>(cs, colpre[q]);
      }
      g.template prefix<R>(st.tsum[M - 2], pre);
      // in place, descending, so that D[a-1][b-1] is read before it is
      // overwritten
#pragma unroll
      for (int a = Rm - 1; a >= 1; --a)
#pragma unroll
        for (int b = Rm - 1; b >= 1; --b) {
          const T c = T(1) / T((a + 1) * (b + 1));
#pragma unroll
          for (int r = 0; r < R; ++r)
            st.grid[a][b][r] = mcol[r] * c * st.grid[a - 1][b - 1][r];
        }
#pragma unroll
      for (int a = Rm - 1; a >= 1; --a) {
        const T c = T(1) / T(a + 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          st.grid[a][0][r] = mcol[r] * c * st.ra[M - 2][a - 1][r];
          st.grid[0][a][r] = mcol[r] * c * colpre[a - 1][r];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st.grid[0][0][r] = mcol[r] * pre[r];
        st.tsum[M - 2][r] += tot[r];
#pragma unroll
        for (int q = 0; q + 1 < Rm; ++q) st.ra[M - 2][q][r] += rowsum[q][r];
      }
    }
    if (M == nl) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T s = T(0);
#pragma unroll
        for (int a = 0; a < Rm; ++a)
#pragma unroll
          for (int b = 0; b < Rm; ++b) s += st.grid[a][b][r];
        st.tsum[M - 1][r] += s;
      }
      return;
    }
    rl_level<T, R, P, M + 1>(st, mcol, nl, g);
  }
}

// The forward sweep over `ncols` columns from zero carries; col(j, mcol)
// fills the thread's R rows of column j (zero for rows past the matrix).
// Afterwards st.tsum[m - 1] holds T_m and st.ra[m - 1][q] RA_m[q] over all
// columns (m < nl), and st.tsum[nl - 1] the thread's share of k_nl.
template <typename T, int R, int P, typename Col, typename G, int NLM>
__device__ __forceinline__ void rl_forward(RunLengthState<T, R, P, NLM>& st,
                                           Col& col, int ncols, int nl,
                                           G& g) {
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) st.grid[a][b][r] = T(0);
#pragma unroll
  for (int m = 0; m < NLM; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) st.tsum[m][r] = T(0);
#pragma unroll
  for (int m = 0; m + 1 < NLM; ++m)
#pragma unroll
    for (int q = 0; q < (P > 1 ? P - 1 : 1); ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) st.ra[m][q][r] = T(0);

  for (int j = 0; j < ncols; ++j) {
    T mcol[R];
    col(j, mcol);
    rl_level<T, R, P, 1>(st, mcol, nl, g);
  }
}

// The level sums of one pair by a segment (the Gram forward's
// counterpart of run_length_levels below, with the state bounded by NLM
// levels): lv[m] = k_{m+1} in every lane of the segment, for m < nl.
template <typename T, int R, int P, int NLM, typename Col, typename G>
__device__ __forceinline__ void run_length_sums(Col& col, int ncols, int nl,
                                                T (&lv)[NLM], G& g) {
  RunLengthState<T, R, P, NLM> st;
  rl_forward<T, R, P>(st, col, ncols, nl, g);
#pragma unroll
  for (int m = 0; m < NLM; ++m) {
    if (m < nl) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += st.tsum[m][r];
      lv[m] = g.sum(s);
    }
  }
}

// Per-level kernels of one pair, computed by the calling group over
// `ncols` columns. Group thread 0 writes level m to out[m * stride].
template <typename T, int R, int P, typename Col, typename G>
__device__ void run_length_levels(Col& col, int ncols, int nl, T* out,
                                  long long stride, G& g) {
  RunLengthState<T, R, P> st;
  rl_forward<T, R, P>(st, col, ncols, nl, g);

  const bool first = g.thread() == 0;
  if (first) out[0] = T(1);
#pragma unroll
  for (int m = 0; m < kRlLevels; ++m) {
    if (m < nl) {
      T s = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) s += st.tsum[m][r];
      s = g.sum(s);
      if (first) out[(m + 1) * stride] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Reverse of the run-length column DP: M̄ column by column, for the
// backward kernels of fused_gram_ho_bwd.cu and sig_gram_bwd.cu (the
// adjoint derived in gpsig_tpu/ops/pallas/fused_gram_ho_bwd.py). With
// w_m the cotangent of k_m and Ā_m[r][s] that of state (r, s) of level m:
//   Ā_m[r][s] = w_m + Rtot_m + Rrow_m[r] + inj_m[r][s]      (m < nl)
//   Rtot_m  = exclusive row suffix, summed over later columns, of
//             M ⊙ Ā_{m+1}[0][0]                (from the ecumsum2 carry)
//   Rrow_m[q] = sum over later columns of M/(q+2) ⊙ Ā_{m+1}[q+1][0]
//   inj_m[s][r-1] += row suffix of M/(r+1) ⊙ Ā_{m+1}[0][r]   (same column)
//   inj_m[r-1][s-1] += M/((r+1)(s+1)) ⊙ Ā_{m+1}[r][s]         (same column)
//   M̄ = Ā_1 + sum_{m>=2} [Ā_m[0][0] E_m + sum_r Ā_m[r][0]/(r+1) RA_{m-1}[r-1]
//        + sum_r Ā_m[0][r]/(r+1) CP_m[r-1]
//        + sum_{r,s} Ā_m[r][s]/((r+1)(s+1)) D_{m-1}[r-1][s-1]],
// with E_m, CP_m the row prefixes the forward took at level m and RA the
// row-cumsum carry before the column. The forward sweep runs first, to the
// end carries; the reverse sweep rebuilds each column's states from them by
// subtraction, ascending levels (level 1 is M itself, and level m's carries
// lose column j's level m-1 totals before level m reads them), then walks
// the levels down computing Ā. Rtot_m and Rrow_m are read by level m before
// level m+1's pieces of the same column are added to them. Every state,
// carry and adjoint stays in registers; nothing of size O(columns) is kept.
// ---------------------------------------------------------------------------

template <typename T, int R, int P, int NLM = kRlLevels>
struct RunLengthBwd {
  static constexpr int Q = P > 1 ? P - 1 : 1;
  static constexpr int NM = NLM > 1 ? NLM - 1 : 1;
  T st[NM][P][P][R];  // D_m of this column at [m - 1], m < nl
  T pre[NM][R];       // E_m at [m - 2]
  T colpre[NM][Q][R];  // CP_m[q] at [m - 2]
  T rtot[NM][R];      // Rtot_m at [m - 1]
  T rrow[NM][Q][R];   // Rrow_m[q] at [m - 1]
  T inj[P][P][R];                // same-column injection of the level below
  T ptot[R];                     // M ⊙ Ā_{m+1}[0][0], not yet in Rtot_m
  T prow[Q][R];                  // M/(q+2) ⊙ Ā_{m+1}[q+1][0], not in Rrow_m
};

// Rebuild level M's states of the current column (reverse sweep): take
// column j's level M-1 totals off the carries, then the forward's formulas.
template <typename T, int R, int P, int M, typename G, int NLM>
__device__ __forceinline__ void rl_rebuild(RunLengthState<T, R, P, NLM>& fw,
                                           RunLengthBwd<T, R, P, NLM>& bw,
                                           const T (&mcol)[R], int nl,
                                           G& g) {
  if constexpr (M <= NLM) {
    if (M > nl) return;
    constexpr int Rm = P < M ? P : M;
    constexpr int Rp = P < M - 1 ? P : M - 1;
    constexpr int NQ = Rm > 1 ? Rm - 1 : 1;
    T cs[NQ][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T tot = T(0);
#pragma unroll
      for (int a = 0; a < Rp; ++a)
#pragma unroll
        for (int b = 0; b < Rp; ++b) tot += bw.st[M - 2][a][b][r];
      fw.tsum[M - 2][r] -= tot;
    }
#pragma unroll
    for (int q = 0; q + 1 < Rm; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T row = T(0);
        cs[q][r] = T(0);
#pragma unroll
        for (int a = 0; a < Rp; ++a) {
          cs[q][r] += bw.st[M - 2][a][q][r];
          row += bw.st[M - 2][q][a][r];
        }
        fw.ra[M - 2][q][r] -= row;
      }
      g.template prefix<R>(cs[q], bw.colpre[M - 2][q]);
    }
    g.template prefix<R>(fw.tsum[M - 2], bw.pre[M - 2]);
    if constexpr (M < NLM) {
      if (M < nl) {  // level nl's own states are never read
#pragma unroll
        for (int a = 1; a < Rm; ++a)
#pragma unroll
          for (int b = 1; b < Rm; ++b) {
            const T c = T(1) / T((a + 1) * (b + 1));
#pragma unroll
            for (int r = 0; r < R; ++r)
              bw.st[M - 1][a][b][r] =
                  mcol[r] * c * bw.st[M - 2][a - 1][b - 1][r];
          }
#pragma unroll
        for (int a = 1; a < Rm; ++a) {
          const T c = T(1) / T(a + 1);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            bw.st[M - 1][a][0][r] = mcol[r] * c * fw.ra[M - 2][a - 1][r];
            bw.st[M - 1][0][a][r] = mcol[r] * c * bw.colpre[M - 2][a - 1][r];
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          bw.st[M - 1][0][0][r] = mcol[r] * bw.pre[M - 2][r];
      }
    }
    rl_rebuild<T, R, P, M + 1>(fw, bw, mcol, nl, g);
  }
}

// Level M's adjoint of the current column, then the levels below (M from
// NLM down to 1; levels above nl are skipped). Adds into mbar.
template <typename T, int R, int P, int M, typename G, int NLM>
__device__ __forceinline__ void rl_adjoint(RunLengthState<T, R, P, NLM>& fw,
                                           RunLengthBwd<T, R, P, NLM>& bw,
                                           const T (&mcol)[R],
                                           const T (&w)[NLM], int nl,
                                           G& g, T (&mbar)[R]) {
  if constexpr (M >= 1) {
    if (M <= nl) {
      constexpr int Rm = P < M ? P : M;
      T A[Rm][Rm][R];
#pragma unroll
      for (int a = 0; a < Rm; ++a)
#pragma unroll
        for (int b = 0; b < Rm; ++b)
#pragma unroll
          for (int r = 0; r < R; ++r) A[a][b][r] = w[M - 1];
      if constexpr (M < NLM) {
        if (M < nl) {
          constexpr int Rn = P < M + 1 ? P : M + 1;  // extent at level M+1
#pragma unroll
          for (int a = 0; a < Rm; ++a)
#pragma unroll
            for (int b = 0; b < Rm; ++b)
#pragma unroll
              for (int r = 0; r < R; ++r) {
                T v = bw.rtot[M - 1][r] + bw.inj[a][b][r];
                if (a + 1 < Rn) v += bw.rrow[M - 1][a][r];
                A[a][b][r] += v;
              }
          // level M+1's pieces of this column join the carries only now
          T sfx[R];
          g.template suffix<R>(bw.ptot, sfx);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            bw.rtot[M - 1][r] += sfx[r];
#pragma unroll
            for (int q = 0; q + 1 < Rn; ++q)
              bw.rrow[M - 1][q][r] += bw.prow[q][r];
          }
        }
      }
      if constexpr (M >= 2) {
        constexpr int Rp = P < M - 1 ? P : M - 1;
#pragma unroll
        for (int a = 0; a < Rp; ++a)
#pragma unroll
          for (int b = 0; b < Rp; ++b)
#pragma unroll
            for (int r = 0; r < R; ++r) bw.inj[a][b][r] = T(0);
#pragma unroll
        for (int r = 0; r < R; ++r) mbar[r] += A[0][0][r] * bw.pre[M - 2][r];
#pragma unroll
        for (int q = 1; q < Rm; ++q) {
          const T c = T(1) / T(q + 1);
          T v[R], sfx[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            mbar[r] += c * (A[q][0][r] * fw.ra[M - 2][q - 1][r] +
                            A[0][q][r] * bw.colpre[M - 2][q - 1][r]);
            v[r] = mcol[r] * c * A[0][q][r];
          }
          g.template suffix<R>(v, sfx);
#pragma unroll
          for (int a = 0; a < Rp; ++a)
#pragma unroll
            for (int r = 0; r < R; ++r) bw.inj[a][q - 1][r] += sfx[r];
        }
#pragma unroll
        for (int a = 1; a < Rm; ++a)
#pragma unroll
          for (int b = 1; b < Rm; ++b) {
            const T c = T(1) / T((a + 1) * (b + 1));
#pragma unroll
            for (int r = 0; r < R; ++r) {
              mbar[r] += c * A[a][b][r] * bw.st[M - 2][a - 1][b - 1][r];
              bw.inj[a - 1][b - 1][r] += mcol[r] * c * A[a][b][r];
            }
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          bw.ptot[r] = mcol[r] * A[0][0][r];
#pragma unroll
          for (int q = 0; q + 1 < Rm; ++q)
            bw.prow[q][r] = mcol[r] * (T(1) / T(q + 2)) * A[q + 1][0][r];
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) mbar[r] += A[0][0][r];
      }
    }
    rl_adjoint<T, R, P, M - 1>(fw, bw, mcol, w, nl, g, mbar);
  }
}

// The reverse sweep of run_length_levels_bwd from the forward's end
// carries fw (sig_gram's bands run the two sweeps apart).
template <typename T, int R, int P, typename Rev, typename Sink, typename G,
          int NLM>
__device__ __forceinline__ void rl_reverse(RunLengthState<T, R, P, NLM>& fw,
                                           Rev& rev, Sink& sink, int ncols,
                                           int nl, const T (&w)[NLM], G& g) {
  RunLengthBwd<T, R, P, NLM> bw;
#pragma unroll
  for (int m = 0; m + 1 < NLM; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bw.rtot[m][r] = T(0);
#pragma unroll
      for (int q = 0; q < RunLengthBwd<T, R, P, NLM>::Q; ++q)
        bw.rrow[m][q][r] = T(0);
    }
  for (int j = ncols - 1; j >= 0; --j) {
    T mcol[R], mbar[R];
    rev(j, mcol);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bw.st[0][0][0][r] = mcol[r];
      mbar[r] = T(0);
    }
    rl_rebuild<T, R, P, 2>(fw, bw, mcol, nl, g);
    rl_adjoint<T, R, P, NLM>(fw, bw, mcol, w, nl, g, mbar);
    sink(j, mbar, g);
  }
}

// Adjoint of run_length_levels for one pair, by the calling group:
// w[m] is the cotangent of level m + 1. fwd(j, mcol) gives the columns in
// ascending order, then rev(j, mcol) in descending order (each as col in
// run_length_levels); sink(j, mbar) receives M̄ of column j, in descending
// j, with the thread's R rows (rows past the matrix carry values the
// caller drops), and the group, for exchanges of its own.
template <typename T, int R, int P, typename Fwd, typename Rev,
          typename Sink, typename G, int NLM>
__device__ void run_length_levels_bwd(Fwd& fwd, Rev& rev, Sink& sink,
                                      int ncols, int nl,
                                      const T (&w)[NLM],
                                      G& g) {
  RunLengthState<T, R, P, NLM> fw;
  rl_forward<T, R, P>(fw, fwd, ncols, nl, g);
  rl_reverse<T, R, P>(fw, rev, sink, ncols, nl, w, g);
}

// Rows of one increment matrix M_b [L1, L2] read as the DP's columns,
// group thread t holding entries t*R .. t*R+R-1 (sig_gram.cuh; a band's
// threads count from the band's first row): each row is read
// contiguously, coalesced.
template <typename T, int R>
struct MatrixRows {
  const T* Mb;
  int L2, t;

  __device__ void operator()(int i, T (&mcol)[R]) const {
    const T* row = Mb + static_cast<long long>(i) * L2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jj = t * R + r;
      mcol[r] = jj < L2 ? row[jj] : T(0);
    }
  }
};

// The plan (W, R) covers `rows` and is one the kernels take.
inline bool plan_ok(int rows, int W, int R) {
  return W >= 1 && W <= kMaxWarps && rows <= 32 * W * R &&
         (W == 1 || R == 4);
}

// Shared memory of a BlockGroup's exchange buffer (none for a warp).
template <typename T>
inline size_t exchange_bytes(int W) {
  return W > 1 ? sizeof(T) * 2 * W : 0;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gpsig
