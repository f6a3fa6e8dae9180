// Per-pair signature DP over prebuilt increment matrices at orders past 7,
// for Hopper (sm_90a): out[m, b] = k_m(M_b) and its backward M̄, for
// p = min(order, num_levels) = 8 .. 127 (so num_levels 8 .. 127). Compiled
// per dtype by sig_gram_order.cu (float32) and sig_gram_order_f64.cu, and
// called by the entry points gpsig_sig_gram (sig_gram.cu) and
// gpsig_sig_gram_bwd (sig_gram_bwd.cu) where p > kDeepOrder.
//
// Replaces, at those orders, the TPU kernels gpsig_tpu/ops/pallas/
// sig_gram.py:_fwd_kernel_ho (entry point sig_gram_levels_ho) and
// sig_gram.py:_bwd_kernel_ho (its custom VJP). The plain versions are
// ops/signature.py's signature_kern and autograd through it.
//
// Why a separate instance. sig_gram.cuh's paths template the DP on the
// order P and keep a row's P x P state grid in registers up to P = 7; past
// 7 levels deep_levels.cuh keeps the per-level carries in shared memory.
// Here the order is a run-time argument 8 .. 127. The plan (plan.py's
// sig_gram_order_plan, order_slots) picks one of three routes from the
// shape alone:
// - register (p = kOrderRegP = 8, at most one row a thread): D's grid, the
//   scans' values and the adjoint's pieces in registers, levels 2 .. 8 at
//   compile-time sizes, past them a loop at full size; the carries over
//   columns (and the backward's E, CP and grids) in shared memory;
// - smem: every value a row keeps in shared memory;
// - workspace: the same slots in a device workspace the wrapper allocates,
//   where one matrix's exceed shared memory.
//
// Design (redesigned for Hopper).
// - A block of W = ceil(L2 / 32) warps (at most kOrderWarps) takes one
//   matrix at a time, its NT = 32 W threads one DP row each; rows past NT
//   come in C = ceil(L2 / NT) chunks (row c NT + t). The DP streams M's
//   rows M[b, i, :] as its columns (the orientation of sig_gram.cuh); a
//   column's M values are staged in a slot and read there at every level.
// - The state is [slot][L2]: a slot's rows are neighbouring words, so a
//   warp's accesses are conflict-free in shared memory and coalesced in a
//   workspace. Slots are packed: level m's grid takes min(p, m)² slots and
//   its carries min(p, m) - 1 (OrderLayout).
// - Every cross-row step is an exclusive prefix (the forward, the reverse
//   sweep's build) or suffix (the adjoint) over the rows, of the level's
//   min(p, m) values at once: each warp scans by shuffles and leaves its
//   totals in shared memory, one barrier, then each warp adds the totals
//   of the warps before (after) it; across chunks the first (last) thread
//   carries the chunk's total in shared memory (OrderBlock::scan). One
//   barrier a level and chunk, none with one warp.
// - Forward, column i, level m = 2 .. nl: one grid, updated in place. Pass
//   one puts the scans' inputs (T_m's carry and D_{m-1}'s column sums) into
//   scan slots; pass two walks D_{m-1}'s rows last first, adding each row
//   into its carry over columns and moving it one diagonal step into D_m
//   (the shift needs no second grid: a cell is read before the row above
//   overwrites it), then the scan and D_m's first row. The top level only
//   sums its cells into a register (k_nl).
// - Backward: checkpoints, nothing subtracted. The forward sweep (its top
//   level updates the carries only) saves a row's carries over columns
//   (T_m's and the RA carries, OrderCkpt) before every K-th column: K = 1
//   where the carries before every column take at most kOrderCkptAllBytes
//   a matrix, else K = ceil(sqrt(L1)). The reverse sweep takes the
//   segments of K columns last first: it restores the segment's
//   checkpoint, recomputes the segment's columns forward keeping the
//   carries before each (none at K = 1), then walks them last first. A
//   column's grids are built from its carries by the forward's own
//   arithmetic (every level's grid kept, packed, with E and CP), so they
//   are the forward's values; then the adjoint from level nl down to 1
//   (deep_levels.cuh's deep_adjoint): the pieces it hands the level below
//   (the diagonal ones in place, ascending, and two sets of the row and
//   column pieces and the total), their suffixes scanned by the level that
//   made them, and M̄ summed in a slot. The checkpoints (L1 sets a row at
//   K = 1, else ceil(L1 / K) + K - 1) are in a workspace region a block on
//   every route (after the slots on the workspace route); the grid strides
//   over the matrices on the blocks that stay resident.
// - The divisions by (a + 1)(b + 1) and q + 1 are products of a table of
//   1 / n in shared memory (compile-time constants on the register route).
// tests/test_torch_sig_gram_order.py holds a float64 torch model of this
// loop order (warps, chunks, packed slots) against the JAX package's
// kernels and jax.grad.
//
// What bounds it on the H100. It reads M (B L1 L2 values) and writes
// (nl + 1) B, or M̄ (B L1 L2) in the backward, and does about
// Σ_m 2 min(p, m)² + min(p, m) operations per entry (the forward): the
// operations bind, at 0.36 ms (forward) and 1.07 ms (backward) for the
// order-8 GPR's 150² matrices of L' = 49. Each column's level-by-level
// chain of scans and barriers, and the blocks an SM (6 to 8 forward, 4
// backward: its 255 registers and 48 KB of shared memory a matrix), bound
// it in practice: 11-12 ms forward and ~95 ms backward there on an H100
// (PERF.md), of which ~12 ms the checkpoints' saves and loads. The smem
// and workspace routes pay a shared-memory or global access for every
// state: 31 and 229 ms at that shape (measured before the checkpoints).

#pragma once

#include "sig_gram.cuh"

namespace gpsig {

// The warps a block at most (plan.py's SIG_GRAM_ORDER_WARPS).
constexpr int kOrderWarps = 8;

// Warps a block for L2 rows (plan.py's order_warps).
__host__ __device__ inline int order_warps(int L2) {
  const int w = (L2 + 31) / 32;
  return w < kOrderWarps ? w : kOrderWarps;
}

// A row's slots, packed (plan.py's order_slots counts them). Level m's
// grid has min(p, m) rows and columns, its carries over columns RA_m[q]
// (and in the backward CP_m[q] and Rrow_{m-1}[q]) min(p, m) - 1 entries.
//   forward:  x; tsum[m - 2] for levels m = 2 .. nl (T_m's carry); ra;
//             the scan slots (p); one p x p grid, in place
//   backward: x, mb (M̄'s sum over levels); tsum; ra; ec, level m's
//             [E_m, CP_m[0 .. min(p, m) - 2]]; the grids of levels 1 ..
//             nl - 1; rt[m - 1] and rr (Rtot_m, Rrow_m: carries over
//             columns of the adjoint); inj (p - 1)², the diagonal pieces,
//             in place; two sets of [ptot, injc[0 .. p - 2]] and of
//             prow[0 .. p - 2]
// The backward's forward sweep keeps its in-place grid (stride p) at the
// grids' slots and its scan slots at ec. The register route (reg) keeps
// the column's M value, the grid, the scan values and the adjoint's
// pieces in registers: its forward has tsum and ra only, its backward
// tsum, ra, ec, the grids, rt and rr.
struct OrderLayout {
  int nl, p;
  int ts, ra0, ec0, g0, rt0, rr0, inj0, set0, prow0, buf0, total;

  __host__ __device__ OrderLayout(int nl_, int p_, bool bwd, bool reg = false)
      : nl(nl_), p(p_) {
    const int R = rsum(nl + 1);
    ts = reg ? 0 : bwd ? 2 : 1;
    ra0 = ts + nl - 1;
    ec0 = g0 = rt0 = rr0 = inj0 = set0 = prow0 = buf0 = 0;
    if (bwd) {
      ec0 = ra0 + R;
      g0 = ec0 + R + nl - 1;
      rt0 = g0 + gsum(nl);
      rr0 = rt0 + nl - 1;
      inj0 = rr0 + R;
      set0 = inj0 + (p - 1) * (p - 1);
      prow0 = set0 + 2 * p;
      total = reg ? inj0 : prow0 + 2 * (p - 1);
    } else {
      buf0 = ra0 + R;
      g0 = buf0 + p;
      total = reg ? buf0 : g0 + p * p;
    }
  }
  // Σ_{m' = 2}^{m - 1} (min(p, m') - 1)
  __host__ __device__ int rsum(int m) const {
    return m - 1 <= p ? (m - 2) * (m - 1) / 2
                      : (p - 1) * p / 2 + (m - 1 - p) * (p - 1);
  }
  // Σ_{m' = 1}^{m - 1} min(p, m')²
  __host__ __device__ int gsum(int m) const {
    return m - 1 <= p ? (m - 1) * m * (2 * m - 1) / 6
                      : p * (p + 1) * (2 * p + 1) / 6 + (m - 1 - p) * p * p;
  }
  __device__ int tsum(int m) const { return ts + m - 2; }
  __device__ int ra(int m, int q) const { return ra0 + rsum(m) + q; }
  __device__ int ec(int m, int k) const { return ec0 + rsum(m) + m - 2 + k; }
  __device__ int grid(int m) const { return g0 + gsum(m); }
  __device__ int rt(int m) const { return rt0 + m - 1; }
  __device__ int rr(int m, int q) const { return rr0 + rsum(m + 1) + q; }
  __device__ int inj(int a, int b) const { return inj0 + a * (p - 1) + b; }
  __device__ int set(int s, int k) const { return set0 + s * p + k; }
  __device__ int prow(int s, int q) const {
    return prow0 + s * (p - 1) + q;
  }
};

// The most bytes a matrix's checkpoints of every column may take
// (plan.py's ORDER_CKPT_ALL_BYTES): up to it the backward keeps the
// carries before every column and recomputes none.
constexpr long long kOrderCkptAllBytes = 1 << 20;

// Columns a segment of the backward's reverse sweep (plan.py's
// order_segments): 1 where the carries before every column (nc values a
// row, L2 rows, `item` bytes) take at most kOrderCkptAllBytes, else
// ceil(sqrt(L1)).
__host__ __device__ inline int order_seg_len(int L1, int nc, int L2,
                                             int item) {
  if (static_cast<long long>(L1) * nc * L2 * item <= kOrderCkptAllBytes)
    return 1;
  int K = 1;
  while (static_cast<long long>(K) * K < L1) ++K;
  return K;
}

// The backward's checkpoint region (plan.py's order_checkpoints): sets of
// a row's nc carries over columns (slots ly.ts .. ly.ts + nc - 1: T_m's and
// the RA carries), each [nc][L2]; set s holds those before segment s's
// first column, set segs + k - 1 those before a segment's column k >= 1.
struct OrderCkpt {
  int nc, K, segs;
  __host__ __device__ OrderCkpt(int L1, int L2, int item,
                                const OrderLayout& ly)
      : nc(ly.nl - 1 + ly.rsum(ly.nl + 1)), K(order_seg_len(L1, nc, L2, item)),
        segs((L1 + K - 1) / K) {}
  __host__ __device__ int set(int s, int k) const {
    return k ? segs + k - 1 : s;
  }
  __host__ __device__ long long elems(int L2) const {
    return static_cast<long long>(segs + K - 1) * nc * L2;
  }
};

// Copy n values of a row from src to dst, both strided by L2 (a slot's
// rows are neighbouring words): kCopyBatch loads in flight before their
// stores, so that a load from the workspace does not wait on the store
// before it.
constexpr int kCopyBatch = 8;
template <typename T>
__device__ __forceinline__ void order_copy(T* __restrict__ dst,
                                           const T* __restrict__ src, int n,
                                           int L2) {
  for (int s0 = 0; s0 < n; s0 += kCopyBatch) {
    T v[kCopyBatch];
#pragma unroll
    for (int k = 0; k < kCopyBatch; ++k)
      if (s0 + k < n) v[k] = src[static_cast<long long>(s0 + k) * L2];
#pragma unroll
    for (int k = 0; k < kCopyBatch; ++k)
      if (s0 + k < n) dst[static_cast<long long>(s0 + k) * L2] = v[k];
  }
}

// The block's small shared arrays, before the slots where those are in
// shared memory: 1 / n (n <= p + 1), the warps' scan totals [2][p][W], the
// chunk carries [2][p] (prefix, suffix), the forward's level sums [nl][W].
__host__ __device__ inline int order_small(int nl, int p, int W) {
  return p + 2 + 2 * p * W + 2 * p + nl * W;
}

// The forward's output for matrix b: out[0] = 1, out[m] (m = 1 .. nl) the
// sum over the block's threads of value(m), each warp's by shuffles, then
// the warps' in order through red [nl][W].
template <typename T, typename F>
__device__ void order_reduce(F value, T* out, T* red, int nl, int W,
                             long long B, long long b) {
  const int t = static_cast<int>(threadIdx.x), lane = t & 31, w = t >> 5;
  for (int m = 1; m <= nl; ++m) {
    T v = value(m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (W == 1) {
      if (lane == 0) out[m * B + b] = v;
    } else if (lane == 0) {
      red[(m - 1) * W + w] = v;
    }
  }
  if (t == 0) out[b] = T(1);
  if (W == 1) return;
  __syncthreads();
  if (t == 0)
    for (int m = 1; m <= nl; ++m) {
      T v = T(0);
      for (int u = 0; u < W; ++u) v += red[(m - 1) * W + u];
      out[m * B + b] = v;
    }
}

constexpr int kX = 0;   // the column's M values
constexpr int kMb = 1;  // backward: M̄'s sum over the column's levels

// One block's matrix: the state at S ([slot][L2]), this thread's rows
// c NT + t (none past L2: it reads 0, writes nothing, and takes part in
// the scans and barriers).
template <typename T>
struct OrderBlock {
  T* S;
  T* ck;  // the backward's checkpoint sets (OrderCkpt), in the workspace
  T* inv;
  T* xw;
  T* chunks;
  T* red;
  int L2, nl, p, W, NT, C, t, w, lane, par;
  OrderLayout ly;

  __device__ OrderBlock(T* small, T* S_, int L2_, int nl_, int p_, bool bwd)
      : S(S_), ck(nullptr), L2(L2_), nl(nl_), p(p_),
        W(static_cast<int>(blockDim.x) >> 5),
        NT(static_cast<int>(blockDim.x)), t(static_cast<int>(threadIdx.x)),
        w(static_cast<int>(threadIdx.x) >> 5),
        lane(static_cast<int>(threadIdx.x) & 31), par(0),
        ly(nl_, p_, bwd) {
    C = (L2 + NT - 1) / NT;
    inv = small;
    xw = inv + p + 2;
    chunks = xw + 2 * p * W;
    red = chunks + 2 * p;
    for (int n = t; n < p + 2; n += NT) inv[n] = n ? T(1) / T(n) : T(0);
    __syncthreads();
  }

  __device__ int row(int c) const { return c * NT + t; }
  __device__ T ld(int s, int j) const { return j < L2 ? S[s * L2 + j] : T(0); }
  __device__ void st(int s, int j, T v) const {
    if (j < L2) S[s * L2 + j] = v;
  }

  // The exclusive prefix (Suffix: suffix) over the rows of slots base ..
  // base + K - 1, in place, for chunk c; chunks go in ascending (Suffix:
  // descending) order, the first (last) thread carrying their totals.
  template <bool Suffix>
  __device__ void scan(int base, int K, int c) {
    const int j = row(c);
    const bool first = Suffix ? c == C - 1 : c == 0;
    const bool holder = Suffix ? t == NT - 1 : t == 0;
    T* cy = chunks + (Suffix ? p : 0);
    T* xs = xw + par * p * W;
    for (int k = 0; k < K; ++k) {
      const T v = ld(base + k, j);
      T incl = holder && !first ? v + cy[k] : v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        if (Suffix) {
          const T u = __shfl_down_sync(kFull, incl, off);
          if (lane + off < 32) incl += u;
        } else {
          const T u = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += u;
        }
      }
      st(base + k, j, incl - v);
      if (W == 1) {
        const T tot = __shfl_sync(kFull, incl, Suffix ? 0 : 31);
        if (holder && C > 1) cy[k] = tot;
      } else if (lane == (Suffix ? 0 : 31)) {
        xs[k * W + w] = incl;
      }
    }
    if (W == 1) {
      __syncwarp();
      return;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      T off = T(0);
      if (Suffix)
        for (int u = W - 1; u > w; --u) off += xs[k * W + u];
      else
        for (int u = 0; u < w; ++u) off += xs[k * W + u];
      if (Suffix ? w < W - 1 : w > 0) st(base + k, j, ld(base + k, j) + off);
      if (holder && C > 1) {
        T tot = T(0);
        for (int u = 0; u < W; ++u) tot += xs[k * W + u];
        cy[k] = tot;
      }
    }
    par ^= 1;
  }

  // Zero slots [s0, s1) of every row.
  __device__ void zero(int s0, int s1) {
    for (int s = s0; s < s1; ++s)
      for (int c = 0; c < C; ++c) st(s, row(c), T(0));
  }

  // Column i of M [L1, L2] into slot kX.
  __device__ void stage(const T* M, int i) {
    for (int c = 0; c < C; ++c) {
      const int j = row(c);
      if (j < L2) S[kX * L2 + j] = M[static_cast<long long>(i) * L2 + j];
    }
  }

  // Forward level m >= 2 of the column in slot kX: D_m from D_{m-1} in
  // place in the grid at slot g (row stride p), the scans through slots
  // buf .. buf + min(p, m) - 1, the carries over columns advanced. mode 0:
  // D_m written; 1 (the forward's top level): D_m's cells summed into acc,
  // not written; 2 (the backward's top level): the carries only.
  __device__ void forward_level(int m, int g, int buf, int mode, T& acc) {
    const int Rp = p < m - 1 ? p : m - 1;
    const int Rm = p < m ? p : m;
    const bool scans = mode != 2, write = mode == 0;
    for (int c = 0; c < C; ++c) {
      const int j = row(c);
      const T x = ld(kX, j);
      const T ts = ld(ly.tsum(m), j);
      if (scans) {
        st(buf, j, ts);
        for (int q = 0; q + 1 < Rm; ++q) {
          T cs = T(0);
          for (int a = 0; a < Rp; ++a) cs += ld(g + a * p + q, j);
          st(buf + 1 + q, j, cs);
        }
      }
      T tot = T(0);
      for (int a = Rp - 1; a >= 0; --a) {
        const bool moves = a + 1 < Rm;
        const T xa = x * inv[a + 2];
        T rs = T(0);
        for (int b = Rp - 1; b >= 0; --b) {
          const T v = ld(g + a * p + b, j);
          rs += v;
          if (scans && moves && b + 1 < Rm) {
            const T nv = xa * inv[b + 2] * v;
            if (write)
              st(g + (a + 1) * p + b + 1, j, nv);
            else
              acc += nv;
          }
        }
        tot += rs;
        if (moves) {
          const int s = ly.ra(m, a);
          const T r = ld(s, j);
          st(s, j, r + rs);
          if (scans) {
            if (write)
              st(g + (a + 1) * p, j, xa * r);
            else
              acc += xa * r;
          }
        }
      }
      st(ly.tsum(m), j, ts + tot);
      if (!scans) continue;
      scan<false>(buf, Rm, c);
      T e = x * ld(buf, j);
      if (write)
        st(g, j, e);
      else
        acc += e;
      for (int q = 0; q + 1 < Rm; ++q) {
        e = x * inv[q + 2] * ld(buf + 1 + q, j);
        if (write)
          st(g + q + 1, j, e);
        else
          acc += e;
      }
    }
  }

  // Column i of the sweep: every level's grid in place at slot g (stride
  // p), the carries advanced. The forward's top level sums k_nl into acc,
  // the backward's (bwd) updates the carries only; the scan slots are buf
  // (forward) or ec (backward).
  __device__ void column(const T* M, int i, int g, bool bwd, T& acc) {
    stage(M, i);
    for (int c = 0; c < C; ++c) st(g, row(c), ld(kX, row(c)));
    for (int m = 2; m <= nl; ++m)
      forward_level(m, g, bwd ? ly.ec(m, 0) : ly.buf0,
                    m < nl ? 0 : bwd ? 2 : 1, acc);
  }

  // The carries over columns (nc slots from ly.ts) of this thread's rows
  // into (save) or from (load) checkpoint set n.
  __device__ void save(int n, int nc) {
    for (int c = 0; c < C; ++c) {
      const int j = row(c);
      if (j < L2)
        order_copy(ck + static_cast<long long>(n) * nc * L2 + j,
                   S + ly.ts * L2 + j, nc, L2);
    }
  }
  __device__ void load(int n, int nc) {
    for (int c = 0; c < C; ++c) {
      const int j = row(c);
      if (j < L2)
        order_copy(S + ly.ts * L2 + j,
                   ck + static_cast<long long>(n) * nc * L2 + j, nc, L2);
    }
  }

  // The reverse sweep's level m >= 2 of the column from the carries before
  // it (restored from a checkpoint set): E_m and CP_m by prefix scans into
  // ec, and (below the top) D_m's grid from D_{m-1}'s, by forward_level's
  // arithmetic.
  __device__ void build(int m) {
    const int Rp = p < m - 1 ? p : m - 1;
    const int Rm = p < m ? p : m;
    const bool write = m < nl;
    const int gp = ly.grid(m - 1), gc = write ? ly.grid(m) : 0;
    const int e0 = ly.ec(m, 0);
    for (int c = 0; c < C; ++c) {
      const int j = row(c);
      const T x = ld(kX, j);
      for (int q = 0; q + 1 < Rm; ++q) {
        T cs = T(0);
        for (int a = 0; a < Rp; ++a) cs += ld(gp + a * Rp + q, j);
        st(e0 + 1 + q, j, cs);
      }
      if (write)
        for (int a = 0; a + 1 < Rm; ++a) {
          const T xa = x * inv[a + 2];
          for (int b = 0; b + 1 < Rm; ++b)
            st(gc + (a + 1) * Rm + b + 1, j,
               xa * inv[b + 2] * ld(gp + a * Rp + b, j));
          st(gc + (a + 1) * Rm, j, xa * ld(ly.ra(m, a), j));
        }
      st(e0, j, ld(ly.tsum(m), j));
      scan<false>(e0, Rm, c);
      if (write) {
        st(gc, j, x * ld(e0, j));
        for (int q = 0; q + 1 < Rm; ++q)
          st(gc + q + 1, j, x * inv[q + 2] * ld(e0 + 1 + q, j));
      }
    }
  }

  // Level m's adjoint of the column (deep_levels.cuh's deep_adjoint): wm
  // the cotangent of k_m; level m + 1's pieces in set m & 1 (their
  // suffixes scanned) and inj, level m's own for level m - 1 into set
  // (m - 1) & 1 and inj (in place: cell (a, b) is read before (a + 1,
  // b + 1) writes it), then scanned; the carries over columns take level
  // m + 1's pieces after their use; M̄'s row written at level 1.
  __device__ void adjoint(int m, T wm, T* mbar) {
    const int Rm = p < m ? p : m;
    const int Rn = p < m + 1 ? p : m + 1;
    const int Rp = p < m - 1 ? p : m - 1;
    const bool below = m < nl;
    const int ki = m & 1, ko = (m - 1) & 1;
    const int gp = m >= 2 ? ly.grid(m - 1) : 0;
    for (int c = 0; c < C; ++c) {
      const int j = row(c);
      const T x = ld(kX, j);
      const T base = below ? wm + ld(ly.rt(m), j) : wm;
      auto rowp = [&](int a) {
        return below && a + 1 < Rn ? ld(ly.rr(m, a), j) : T(0);
      };
      auto colp = [&](int b) {
        return below && b + 1 < Rn ? ld(ly.set(ki, 1 + b), j) : T(0);
      };
      auto injv = [&](int a, int b) {
        return below && a + 1 < Rn && b + 1 < Rn ? ld(ly.inj(a, b), j) : T(0);
      };
      const T r0 = base + rowp(0), c0 = colp(0);
      const T a00 = r0 + c0 + injv(0, 0);
      T mb = m == nl ? T(0) : ld(kMb, j);
      if (m >= 2) {
        mb += a00 * ld(ly.ec(m, 0), j);
        for (int q = 1; q < Rm; ++q) {
          const T k = inv[q + 1];
          const T aq0 = base + rowp(q) + c0 + injv(q, 0);
          const T a0q = r0 + colp(q) + injv(0, q);
          mb += k * (aq0 * ld(ly.ra(m, q - 1), j) + a0q * ld(ly.ec(m, q), j));
          st(ly.set(ko, q), j, x * k * a0q);
          st(ly.prow(ko, q - 1), j, x * k * aq0);
        }
        for (int a = 1; a < Rm; ++a) {
          const T ra = base + rowp(a);
          const T ka = inv[a + 1], xa = x * ka;
          for (int b = 1; b < Rm; ++b) {
            const T kb = inv[b + 1];
            const T ab = ra + colp(b) + injv(a, b);
            mb += ka * kb * ab * ld(gp + (a - 1) * Rp + b - 1, j);
            st(ly.inj(a - 1, b - 1), j, xa * kb * ab);
          }
        }
        st(ly.set(ko, 0), j, x * a00);
      } else {
        mb += a00;
      }
      if (below) {
        st(ly.rt(m), j, ld(ly.rt(m), j) + ld(ly.set(ki, 0), j));
        for (int q = 0; q + 1 < Rn; ++q)
          st(ly.rr(m, q), j, ld(ly.rr(m, q), j) + ld(ly.prow(ki, q), j));
      }
      if (m > 1)
        st(kMb, j, mb);
      else if (j < L2)
        mbar[j] = mb;
    }
    if (m >= 2)
      for (int c = C - 1; c >= 0; --c) scan<true>(ly.set(ko, 0), Rm, c);
  }

  // The forward's output for matrix b: out[m] the sum over rows of tsum (m
  // < nl) or of acc (m = nl).
  __device__ void reduce(T acc, T* out, long long B, long long b) {
    order_reduce(
        [&](int m) {
          T v = T(0);
          if (m == nl) return acc;
          for (int c = 0; c < C; ++c) v += ld(ly.tsum(m + 1), row(c));
          return v;
        },
        out, red, nl, W, B, b);
  }
};

// Smem: the slots in shared memory (after the small arrays), else the
// block's region of `area` elements in the workspace. Block k takes
// matrices k, then a stride of the grid. out: [nl + 1, B].
template <typename T, bool Smem>
__global__ void __launch_bounds__(32 * kOrderWarps)
sig_gram_order_kernel(const T* __restrict__ M, T* __restrict__ out, T* work,
                      int B, int L1, int L2, int nl, int P, int area) {
  extern __shared__ __align__(16) unsigned char order_smem[];
  T* small = reinterpret_cast<T*>(order_smem);
  const int W = static_cast<int>(blockDim.x) >> 5;
  T* S = Smem ? small + order_small(nl, P, W)
              : work + static_cast<long long>(blockIdx.x) * area;
  OrderBlock<T> ob(small, S, L2, nl, P, false);
  const OrderLayout& ly = ob.ly;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    T acc = T(0);
    ob.zero(ly.ts, ly.ra0 + ly.rsum(nl + 1));
    for (int i = 0; i < L1; ++i) ob.column(M + b * L1 * L2, i, ly.g0, false,
                                           acc);
    ob.reduce(acc, out, B, b);
  }
}

// The backward: gw [nl + 1, B] -> Mbar [B, L1, L2], every entry written.
// Block k's workspace region: its slots (`area`, the workspace route),
// then its checkpoint sets (OrderCkpt).
template <typename T, bool Smem>
__global__ void __launch_bounds__(32 * kOrderWarps)
sig_gram_order_bwd_kernel(const T* __restrict__ M, const T* __restrict__ gw,
                          T* __restrict__ Mbar, T* work, int B, int L1,
                          int L2, int nl, int P, int area) {
  extern __shared__ __align__(16) unsigned char order_smem[];
  T* small = reinterpret_cast<T*>(order_smem);
  const int W = static_cast<int>(blockDim.x) >> 5;
  const OrderCkpt ck(L1, L2, sizeof(T), OrderLayout(nl, P, true));
  const long long own = Smem ? 0 : area;
  T* region = work + static_cast<long long>(blockIdx.x) * (own + ck.elems(L2));
  OrderBlock<T> ob(small, Smem ? small + order_small(nl, P, W) : region, L2,
                   nl, P, true);
  ob.ck = region + own;
  const OrderLayout& ly = ob.ly;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const T* Mb = M + b * L1 * L2;
    T* Mbarb = Mbar + b * L1 * L2;
    T acc = T(0);
    ob.zero(ly.ts, ly.ts + ck.nc);
    for (int i = 0; i < L1; ++i) {
      if (i % ck.K == 0) ob.save(i / ck.K, ck.nc);
      ob.column(Mb, i, ly.g0, true, acc);
    }
    ob.zero(ly.rt0, ly.rt0 + nl - 1);
    ob.zero(ly.rr0, ly.rr0 + ly.rsum(nl + 1));
    for (int s = ck.segs - 1; s >= 0; --s) {
      const int c0 = s * ck.K, n = L1 - c0 < ck.K ? L1 - c0 : ck.K;
      ob.load(s, ck.nc);
      for (int k = 1; k < n; ++k) {
        ob.column(Mb, c0 + k - 1, ly.g0, true, acc);
        ob.save(ck.set(s, k), ck.nc);
      }
      // the carries before the segment's last column are loaded already
      for (int k = n - 1; k >= 0; --k) {
        if (k < n - 1) ob.load(ck.set(s, k), ck.nc);
        ob.stage(Mb, c0 + k);
        for (int c = 0; c < ob.C; ++c)
          ob.st(ly.grid(1), ob.row(c), ob.ld(kX, ob.row(c)));
        for (int m = 2; m <= nl; ++m) ob.build(m);
        for (int m = nl; m >= 1; --m)
          ob.adjoint(m, gw[m * static_cast<long long>(B) + b],
                     Mbarb + static_cast<long long>(c0 + k) * L2);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The register route: p = kOrderRegP, at most one row a thread (L2 <= 32
// kOrderWarps). The same loop order with the column's M value, D's grid
// (p x p, zero outside the current level's), the scans' values and the
// adjoint's pieces in registers, every loop over a grid's rows and columns
// unrolled (a level's size min(p, m) a uniform guard), the coefficients
// compile-time constants; shared memory holds the carries over columns
// and, in the backward, the column's E, CP and grids for the adjoint
// (OrderLayout with reg).
// ---------------------------------------------------------------------------

// The register route's order (plan.py's ORDER_REGISTER_P).
constexpr int kOrderRegP = 8;

template <typename T, int P>
struct RegBlock {
  T* S;
  T* ck;  // the backward's checkpoint sets (OrderCkpt), in the workspace
  T* xw;
  T* red;
  int L2, nl, W, t, w, lane, par;
  bool live;
  OrderLayout ly;
  T g[P][P];
  T inj[P - 1][P - 1];  // the backward: level m + 1's diagonal pieces
  T ci[P];              // [ptot, injc[0 .. P - 2]] of level m + 1, scanned
  T pi[P - 1];          // prow of level m + 1

  __device__ RegBlock(T* small, T* S_, int L2_, int nl_, bool bwd)
      : S(S_), ck(nullptr), L2(L2_), nl(nl_),
        W(static_cast<int>(blockDim.x) >> 5), t(static_cast<int>(threadIdx.x)),
        w(static_cast<int>(threadIdx.x) >> 5),
        lane(static_cast<int>(threadIdx.x) & 31), par(0), live(t < L2_),
        ly(nl_, P, bwd, true) {
    xw = small;
    red = xw + 2 * P * W;
  }

  __device__ __forceinline__ T ld(int s) const {
    return live ? S[s * L2 + t] : T(0);
  }
  __device__ __forceinline__ void st(int s, T v) const {
    if (live) S[s * L2 + t] = v;
  }
  static __device__ __forceinline__ T c(int n) { return T(1) / T(n + 1); }

  // The exclusive prefix (Suffix: suffix) over the rows of v[0 .. n - 1].
  template <bool Suffix>
  __device__ __forceinline__ void scan(T (&v)[P], int n) {
    T incl[P];
#pragma unroll
    for (int k = 0; k < P; ++k) incl[k] = v[k];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (k < n) {
          if (Suffix) {
            const T u = __shfl_down_sync(kFull, incl[k], off);
            if (lane + off < 32) incl[k] += u;
          } else {
            const T u = __shfl_up_sync(kFull, incl[k], off);
            if (lane >= off) incl[k] += u;
          }
        }
    if (W > 1) {
      T* xs = xw + par * P * W;
      if (lane == (Suffix ? 0 : 31))
#pragma unroll
        for (int k = 0; k < P; ++k)
          if (k < n) xs[k * W + w] = incl[k];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (k < n) {
          T o = T(0);
          if (Suffix)
            for (int u = W - 1; u > w; --u) o += xs[k * W + u];
          else
            for (int u = 0; u < w; ++u) o += xs[k * W + u];
          incl[k] += o;
        }
      par ^= 1;
    }
#pragma unroll
    for (int k = 0; k < P; ++k) v[k] = incl[k] - v[k];
  }

  // D_{m-1}'s row sums rs and column sums (into sv[1 + b]) over its RP x
  // RP cells, and their total.
  template <int RP>
  __device__ __forceinline__ T sums(T (&rs)[P], T (&sv)[P]) {
    T tot = T(0);
#pragma unroll
    for (int k = 0; k < P; ++k) rs[k] = sv[k] = T(0);
#pragma unroll
    for (int a = 0; a < RP; ++a) {
#pragma unroll
      for (int b = 0; b < RP; ++b) {
        rs[a] += g[a][b];
        if (b + 1 < P) sv[b + 1] += g[a][b];
      }
      tot += rs[a];
    }
    return tot;
  }

  // D_m's cells past its first row and column from D_{m-1}'s (a row moves
  // one diagonal step, last first); Top: summed, not written.
  template <int RM, bool Top>
  __device__ __forceinline__ T shift(T x) {
    T s = T(0);
#pragma unroll
    for (int a = RM - 2; a >= 0; --a) {
      const T xa = x * c(a + 1);
#pragma unroll
      for (int b = RM - 2; b >= 0; --b) {
        const T v = xa * c(b + 1) * g[a][b];
        if (Top)
          s += v;
        else
          g[a + 1][b + 1] = v;
      }
    }
    return s;
  }

  // D_m's first row and column: E_m and CP_m (the scanned sv), RA_m's
  // carries before this column (er); Top: summed, not written.
  template <int RM, bool Top>
  __device__ __forceinline__ T edges(T x, const T (&sv)[P],
                                     const T (&er)[P]) {
    T s = x * sv[0];
    if (!Top) g[0][0] = s;
#pragma unroll
    for (int q = 0; q + 1 < RM; ++q) {
      const T k = x * c(q + 1);
      const T u = k * er[q], v = k * sv[q + 1];
      if (Top) {
        s += u + v;
      } else {
        g[q + 1][0] = u;
        g[0][q + 1] = v;
      }
    }
    return s;
  }

  // Forward level m >= 2 at RP = min(p, m - 1), RM = min(p, m)
  // (OrderBlock::forward_level): mode 0 D_m kept, 1 its cells summed into
  // acc, 2 the carries only.
  template <int RP, int RM>
  __device__ __forceinline__ void level(int m, T x, int mode, T& acc) {
    T rs[P], sv[P], er[P];
    const T tot = sums<RP>(rs, sv);
    const int r0 = ly.ra(m, 0);
#pragma unroll
    for (int a = 0; a + 1 < RM; ++a) {
      er[a] = ld(r0 + a);
      st(r0 + a, er[a] + rs[a]);
    }
    const T ts = ld(ly.tsum(m));
    st(ly.tsum(m), ts + tot);
    if (mode == 2) return;
    sv[0] = ts;
    if (mode == 0)
      shift<RM, false>(x);
    else
      acc += shift<RM, true>(x);
    scan<false>(sv, RM);
    if (mode == 0)
      edges<RM, false>(x, sv, er);
    else
      acc += edges<RM, true>(x, sv, er);
  }

  // Levels M .. P of a column (compile-time sizes), then the rest.
  template <int M>
  __device__ __forceinline__ void levels(T x, int top, T& acc) {
    if constexpr (M <= P) {
      level<M - 1, M>(M, x, M < nl ? 0 : top, acc);
      levels<M + 1>(x, top, acc);
    } else {
      for (int m = P + 1; m <= nl; ++m)
        level<P, P>(m, x, m < nl ? 0 : top, acc);
    }
  }

  // A column of the sweep, its M value x (OrderBlock::column).
  __device__ __forceinline__ void column(T x, bool bwd, T& acc) {
    g[0][0] = x;
    levels<2>(x, bwd ? 2 : 1, acc);
  }

  // The carries over columns into (save) or from (load) checkpoint set n
  // (OrderBlock::save, load).
  __device__ void save(int n, int nc) const {
    if (live)
      order_copy(ck + static_cast<long long>(n) * nc * L2 + t,
                 S + ly.ts * L2 + t, nc, L2);
  }
  __device__ void load(int n, int nc) const {
    if (live)
      order_copy(S + ly.ts * L2 + t,
                 ck + static_cast<long long>(n) * nc * L2 + t, nc, L2);
  }

  // The reverse sweep's level m (OrderBlock::build): E_m and CP_m into ec
  // from the carries before the column; below the top, D_m in the
  // registers and into its grid's slots, by level's arithmetic.
  template <int RP, int RM>
  __device__ __forceinline__ void build(int m, T x) {
    T rs[P], sv[P], er[P];
    sums<RP>(rs, sv);
    const int r0 = ly.ra(m, 0);
#pragma unroll
    for (int a = 0; a + 1 < RM; ++a) er[a] = ld(r0 + a);
    sv[0] = ld(ly.tsum(m));
    scan<false>(sv, RM);
    const int e0 = ly.ec(m, 0);
#pragma unroll
    for (int k = 0; k < RM; ++k) st(e0 + k, sv[k]);
    if (m == nl) return;
    shift<RM, false>(x);
    edges<RM, false>(x, sv, er);
    const int gc = ly.grid(m);
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < RM; ++b) st(gc + a * RM + b, g[a][b]);
  }

  template <int M>
  __device__ __forceinline__ void builds(T x) {
    if constexpr (M <= P) {
      build<M - 1, M>(M, x);
      builds<M + 1>(x);
    } else {
      for (int m = P + 1; m <= nl; ++m) build<P, P>(m, x);
    }
  }

  // Level m's adjoint at RM = min(p, m), RN = min(p, m + 1), RP = min(p,
  // m - 1) (OrderBlock::adjoint), the pieces in registers; mb M̄'s sum over
  // the column's levels.
  template <int RM, int RN, int RP>
  __device__ __forceinline__ void adjoint(int m, T wm, T x, T& mb) {
    const bool below = m < nl;
    const T base = below ? wm + ld(ly.rt(m)) : wm;
    T rp[P];
#pragma unroll
    for (int a = 0; a < P; ++a)
      rp[a] = below && a + 1 < RN ? ld(ly.rr(m, a)) : T(0);
    auto colp = [&](int b) { return below && b + 1 < RN ? ci[1 + b] : T(0); };
    auto injv = [&](int a, int b) {
      return below && a + 1 < RN && b + 1 < RN ? inj[a][b] : T(0);
    };
    const T r0 = base + rp[0], c0 = colp(0);
    const T a00 = r0 + c0 + injv(0, 0);
    if (below) {
      st(ly.rt(m), ld(ly.rt(m)) + ci[0]);
#pragma unroll
      for (int q = 0; q + 1 < RN; ++q)
        st(ly.rr(m, q), rp[q] + pi[q]);
    }
    if constexpr (RM < 2) {
      mb += a00;
    } else {
      T co[P], po[P - 1];
#pragma unroll
      for (int q = 0; q + 1 < P; ++q) co[q + 1] = po[q] = T(0);
      mb += a00 * ld(ly.ec(m, 0));
      const int ra0 = ly.ra(m, 0), e0 = ly.ec(m, 0);
#pragma unroll
      for (int q = 1; q < RM; ++q) {
        const T aq0 = base + rp[q] + c0 + injv(q, 0);
        const T a0q = r0 + colp(q) + injv(0, q);
        mb += c(q) * (aq0 * ld(ra0 + q - 1) + a0q * ld(e0 + q));
        co[q] = x * c(q) * a0q;
        po[q - 1] = x * c(q) * aq0;
      }
      const int gp = ly.grid(m - 1);
#pragma unroll
      for (int a = 1; a < RM; ++a) {
        const T ra = base + rp[a];
#pragma unroll
        for (int b = 1; b < RM; ++b) {
          const T k = c(a) * c(b);
          const T ab = ra + colp(b) + injv(a, b);
          mb += k * ab * ld(gp + (a - 1) * RP + b - 1);
          inj[a - 1][b - 1] = x * k * ab;
        }
      }
      co[0] = x * a00;
      scan<true>(co, RM);
#pragma unroll
      for (int k = 0; k < P; ++k) ci[k] = co[k];
#pragma unroll
      for (int k = 0; k + 1 < P; ++k) pi[k] = po[k];
    }
  }

  __device__ __forceinline__ void clear_pieces() {
#pragma unroll
    for (int a = 0; a + 1 < P; ++a) {
      pi[a] = ci[a + 1] = T(0);
#pragma unroll
      for (int b = 0; b + 1 < P; ++b) inj[a][b] = T(0);
    }
    ci[0] = T(0);
  }

  template <int M>
  __device__ __forceinline__ void adjoints(const T* gw, long long B,
                                           long long b, T x, T& mb) {
    constexpr int RM = M < P ? M : P, RN = M + 1 < P ? M + 1 : P;
    constexpr int RP = M - 1 < P ? M - 1 : P;
    adjoint<RM, RN, RP>(M, gw[M * B + b], x, mb);
    if constexpr (M > 1) adjoints<M - 1>(gw, B, b, x, mb);
  }

  // The forward's output for matrix b (OrderBlock::reduce).
  __device__ void reduce(T acc, T* out, long long B, long long b) {
    order_reduce([&](int m) { return m < nl ? ld(ly.tsum(m + 1)) : acc; },
                 out, red, nl, W, B, b);
  }
};

// The register route's small shared arrays: the warps' scan totals
// [2][P][W] and the forward's level sums [nl][W].
__host__ __device__ inline int order_reg_small(int nl, int W) {
  return 2 * kOrderRegP * W + nl * W;
}

// The forward in float32 at 128 registers: 8 blocks of two warps an SM
// rather than 6 (11.30 against 12.15 ms at the order-8 GPR's 150² matrices
// of L' = 49 on an H100); in float64 that would spill.
template <typename T, int P>
__global__ void __launch_bounds__(32 * kOrderWarps, sizeof(T) == 4 ? 2 : 1)
sig_gram_order_reg_kernel(const T* __restrict__ M, T* __restrict__ out,
                          int B, int L1, int L2, int nl) {
  extern __shared__ __align__(16) unsigned char order_smem[];
  T* small = reinterpret_cast<T*>(order_smem);
  const int W = static_cast<int>(blockDim.x) >> 5;
  RegBlock<T, P> rb(small, small + order_reg_small(nl, W), L2, nl, false);
  const OrderLayout& ly = rb.ly;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const T* Mb = M + b * L1 * L2;
    T acc = T(0);
    for (int s = ly.ts; s < ly.ra0 + ly.rsum(nl + 1); ++s) rb.st(s, T(0));
    for (int i = 0; i < L1; ++i)
      rb.column(rb.live ? Mb[static_cast<long long>(i) * L2 + rb.t] : T(0),
                false, acc);
    rb.reduce(acc, out, B, b);
  }
}

// The register route's backward (the loop order of sig_gram_order_bwd_
// kernel); block k's workspace region is its checkpoint sets.
template <typename T, int P>
__global__ void __launch_bounds__(32 * kOrderWarps)
sig_gram_order_reg_bwd_kernel(const T* __restrict__ M,
                              const T* __restrict__ gw, T* __restrict__ Mbar,
                              T* work, int B, int L1, int L2, int nl) {
  extern __shared__ __align__(16) unsigned char order_smem[];
  T* small = reinterpret_cast<T*>(order_smem);
  const int W = static_cast<int>(blockDim.x) >> 5;
  RegBlock<T, P> rb(small, small + order_reg_small(nl, W), L2, nl, true);
  const OrderLayout& ly = rb.ly;
  const OrderCkpt ck(L1, L2, sizeof(T), ly);
  rb.ck = work + static_cast<long long>(blockIdx.x) * ck.elems(L2);
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const T* Mb = M + b * L1 * L2;
    auto x_at = [&](int i) {
      return rb.live ? Mb[static_cast<long long>(i) * L2 + rb.t] : T(0);
    };
    T acc = T(0);
    for (int s = ly.ts; s < ly.ts + ck.nc; ++s) rb.st(s, T(0));
    for (int i = 0; i < L1; ++i) {
      if (i % ck.K == 0) rb.save(i / ck.K, ck.nc);
      rb.column(x_at(i), true, acc);
    }
    for (int s = ly.rt0; s < ly.rr0 + ly.rsum(nl + 1); ++s) rb.st(s, T(0));
    for (int s = ck.segs - 1; s >= 0; --s) {
      const int c0 = s * ck.K, n = L1 - c0 < ck.K ? L1 - c0 : ck.K;
      rb.load(s, ck.nc);
      for (int k = 1; k < n; ++k) {
        rb.column(x_at(c0 + k - 1), true, acc);
        rb.save(ck.set(s, k), ck.nc);
      }
      // the carries before the segment's last column are loaded already
      for (int k = n - 1; k >= 0; --k) {
        if (k < n - 1) rb.load(ck.set(s, k), ck.nc);
        const T x = x_at(c0 + k);
        rb.g[0][0] = x;
        rb.st(ly.grid(1), x);
        rb.template builds<2>(x);
        // the top level reads none of the pieces: cleared here, they hold
        // no registers through the builds
        rb.clear_pieces();
        T mb = T(0);
        for (int m = nl; m > P; --m)
          rb.template adjoint<P, P, P>(
              m, gw[m * static_cast<long long>(B) + b], x, mb);
        rb.template adjoints<P>(gw, B, b, x, mb);
        if (rb.live)
          Mbar[b * L1 * L2 + static_cast<long long>(c0 + k) * L2 + rb.t] = mb;
      }
    }
  }
}

// The launch arguments are sig_gram.cuh's SgArgs, as plan.py's
// sig_gram_order_plan fills them: S = 32, R = 1, bands = 1, W =
// order_warps(L2), `area` = OrderLayout(nl, P, bwd, reg).total L2 elements
// a matrix, area_smem 2 (the register route, P = kOrderRegP, L2 <= 32
// kOrderWarps, the slots in shared memory), 1 (the slots in shared
// memory) or 0 (a workspace region a block), `blocks` blocks striding
// over the matrices. The backward always has a workspace: a region a
// block of its slots (area_smem 0) and its checkpoint sets.
inline size_t sg_order_smem(const SgArgs& a, size_t item) {
  const size_t slots = a.area_smem ? static_cast<size_t>(a.area) : 0;
  return item * ((a.area_smem == 2 ? order_reg_small(a.nl, a.W)
                                   : order_small(a.nl, a.P, a.W)) +
                 slots);
}

inline bool sg_order_ok(const SgArgs& a, bool bwd, size_t item) {
  const bool reg = a.area_smem == 2;
  return a.P > kDeepOrder && a.P <= a.nl && a.nl <= kDeepLevels &&
         a.S == 32 && a.R == 1 && a.bands == 1 && a.L2 >= 1 &&
         a.W == order_warps(a.L2) && a.blocks >= 1 && a.B >= 1 &&
         a.L1 >= 1 && a.area_smem >= 0 && a.area_smem <= 2 &&
         (!reg || (a.P == kOrderRegP && a.L2 <= 32 * kOrderWarps)) &&
         a.area == static_cast<long long>(
                       OrderLayout(a.nl, a.P, bwd, reg).total) * a.L2 &&
         (bwd ? a.work != nullptr : a.area_smem || a.work != nullptr) &&
         sg_order_smem(a, item) <= kSegSmemBytes;
}

template <typename T>
cudaError_t sg_fwd_order(const SgArgs& a, cudaStream_t stream) {
  if (!sg_order_ok(a, false, sizeof(T))) return cudaErrorInvalidValue;
  const size_t smem = sg_order_smem(a, sizeof(T));
  const T* M = static_cast<const T*>(a.M);
  T* out = static_cast<T*>(a.out);
  if (a.area_smem == 2) {
    auto kern = sig_gram_order_reg_kernel<T, kOrderRegP>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<a.blocks, 32 * a.W, smem, stream>>>(M, out, a.B, a.L1, a.L2,
                                               a.nl);
    return cudaGetLastError();
  }
  auto kern = a.area_smem ? sig_gram_order_kernel<T, true>
                          : sig_gram_order_kernel<T, false>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<a.blocks, 32 * a.W, smem, stream>>>(
      M, out, static_cast<T*>(a.work), a.B, a.L1, a.L2, a.nl, a.P, a.area);
  return cudaGetLastError();
}

// The backward's grid: the plan's blocks (its workspace's regions), at most
// as many as the card keeps resident, so that no block's strided loop over
// the matrices starts after another's has ended.
template <typename K>
cudaError_t order_resident_grid(K kern, int threads, size_t smem,
                                int& blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident >= 1 && resident < blocks) blocks = static_cast<int>(resident);
  return cudaSuccess;
}

template <typename T>
cudaError_t sg_bwd_order(const SgArgs& a, cudaStream_t stream) {
  if (!sg_order_ok(a, true, sizeof(T))) return cudaErrorInvalidValue;
  const size_t smem = sg_order_smem(a, sizeof(T));
  const T* M = static_cast<const T*>(a.M);
  const T* g = static_cast<const T*>(a.g);
  T* Mbar = static_cast<T*>(a.out);
  T* work = static_cast<T*>(a.work);
  int blocks = a.blocks;
  if (a.area_smem == 2) {
    auto kern = sig_gram_order_reg_bwd_kernel<T, kOrderRegP>;
    cudaError_t e = allow_smem(kern, smem);
    if (e == cudaSuccess) e = order_resident_grid(kern, 32 * a.W, smem, blocks);
    if (e != cudaSuccess) return e;
    kern<<<blocks, 32 * a.W, smem, stream>>>(M, g, Mbar, work, a.B, a.L1,
                                             a.L2, a.nl);
    return cudaGetLastError();
  }
  auto kern = a.area_smem ? sig_gram_order_bwd_kernel<T, true>
                          : sig_gram_order_bwd_kernel<T, false>;
  cudaError_t e = allow_smem(kern, smem);
  if (e == cudaSuccess) e = order_resident_grid(kern, 32 * a.W, smem, blocks);
  if (e != cudaSuccess) return e;
  kern<<<blocks, 32 * a.W, smem, stream>>>(M, g, Mbar, work, a.B, a.L1, a.L2,
                                           a.nl, a.P, a.area);
  return cudaGetLastError();
}

extern template cudaError_t sg_fwd_order<float>(const SgArgs&, cudaStream_t);
extern template cudaError_t sg_fwd_order<double>(const SgArgs&,
                                                 cudaStream_t);
extern template cudaError_t sg_bwd_order<float>(const SgArgs&, cudaStream_t);
extern template cudaError_t sg_bwd_order<double>(const SgArgs&,
                                                 cudaStream_t);

}  // namespace gpsig
