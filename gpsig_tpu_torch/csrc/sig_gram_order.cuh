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
// order P and keep a row's P x P state grid in registers; past 7 levels
// deep_levels.cuh keeps the per-level carries in shared memory. A row's
// backward state grows as (nl - 1) p²: 617 values at p = nl = 8, two
// million at p = nl = 127. So here the order is a run-time argument and
// every value a row keeps lives in a device workspace that the wrapper
// allocates (plan.py's sig_gram_order_plan, order_slots).
//
// Design (simple first: one warp a matrix).
// - A warp takes one matrix at a time, grid-strided over the batch; its
//   workspace region holds the matrix's rows' slots as [slot][L2], so the
//   lanes of a chunk touch neighbouring addresses (coalesced).
// - The DP streams M's rows M[b, i, :] as its columns (the orientation of
//   sig_gram.cuh) and takes the column's L2 rows in chunks of 32, one row
//   a lane. Every cross-row step of a column is a warp scan that a chunk
//   starts from the carry of the chunks before it (prefixes, chunks
//   ascending) or after it (suffixes, chunks descending); a level runs one
//   pass over the chunks per scan, so each pass carries one value. A row
//   is always on the same lane, so a lane reads only what it wrote: no
//   barrier, no shared memory.
// - Forward, column i, level m = 2 .. nl: level m's grid from level
//   m - 1's (two grids in turn), the carries over columns (T_m, RA_m[q])
//   used, then advanced; level nl's grid sums into its carry, k_nl.
// - Backward: the forward sweep to the end carries, then the reverse sweep
//   over the columns, last first: the levels' grids of the column rebuilt
//   by subtraction from the carries (deep_levels.cuh's deep_rebuild, every
//   level's grid kept), then the adjoint from level nl down to 1
//   (deep_adjoint): its same-column pieces for the level below (injected
//   cotangents, their column suffixes, the row and total pieces) pass
//   through two sets of slots in turn, its carries over columns (Rtot,
//   Rrow) stay a slot each, and M̄ adds up in the output row.
// tests/test_torch_sig_gram_order.py holds a float64 torch model of this
// loop order against the JAX package's kernels and jax.grad.
//
// What bounds it on the H100. It reads M (B L1 L2 values) and writes
// (nl + 1) B, or M̄ (B L1 L2) in the backward, but per entry it does about
// Σ_m 2 min(p, m)² + min(p, m) operations (the forward) and keeps them in
// the workspace: every state is a load and a store of L1 or L2, so the
// workspace traffic, a few times the operations in bytes, and one warp's
// L1 serial columns times nl levels of dependent loads bind it, far above
// the bound from M's bytes or the operations.

#pragma once

#include "sig_gram.cuh"

namespace gpsig {

// The warps a block at most (plan.py's SIG_GRAM_ORDER_WARPS).
constexpr int kOrderWarps = 4;

// A row's slots (plan.py's order_slots):
//   tsum[m]        m < nl                 T_{m+1}: carry over columns; k
//   ra[m][q]       m < nl - 1, q < p - 1  RA_{m+2}[q]: carry over columns
//   grid[k][a][b]  k < G, a, b < p        G = 2 (forward: two grids in
//                                         turn), nl - 1 (backward: D_1 ..
//                                         D_{nl-1} of the column)
// and for the backward only:
//   pre[m], colpre[m][q]                  E_{m+2}, CP_{m+2}[q]
//   rtot[m], rrow[m][q]                   Rtot_{m+1}, Rrow_{m+1}[q]
//   inj[k][a][b], injc[k][b], ptot[k], prow[k][q]   k < 2: the pieces one
//                                         level's adjoint hands the next
struct OrderSlots {
  int nl, p;
  long long f0, b0, b1;

  __host__ __device__ OrderSlots(int nl_, int p_)
      : nl(nl_), p(p_),
        f0(nl_ + static_cast<long long>(nl_ - 1) * (p_ - 1)),
        b0(f0 + static_cast<long long>(nl_ - 1) * p_ * p_),
        b1(b0 + 2LL * (nl_ - 1) * p_) {}
  __host__ __device__ static long long count(int nl, int p, bool bwd) {
    const OrderSlots s(nl, p);
    return bwd ? s.b1 + 2LL * p * p + 4LL * p + 2 : s.f0 + 2LL * p * p;
  }
  __device__ long long tsum(int m) const { return m; }
  __device__ long long ra(int m, int q) const {
    return nl + static_cast<long long>(m) * (p - 1) + q;
  }
  __device__ long long grid(int k, int a, int b) const {
    return f0 + (static_cast<long long>(k) * p + a) * p + b;
  }
  __device__ long long pre(int m) const { return b0 + m; }
  __device__ long long colpre(int m, int q) const {
    return b0 + (nl - 1) + static_cast<long long>(m) * (p - 1) + q;
  }
  __device__ long long rtot(int m) const {
    return b0 + static_cast<long long>(nl - 1) * p + m;
  }
  __device__ long long rrow(int m, int q) const {
    return b0 + static_cast<long long>(nl - 1) * (p + 1) +
           static_cast<long long>(m) * (p - 1) + q;
  }
  __device__ long long inj(int k, int a, int b) const {
    return b1 + (static_cast<long long>(k) * p + a) * p + b;
  }
  __device__ long long injc(int k, int b) const {
    return b1 + 2LL * p * p + static_cast<long long>(k) * p + b;
  }
  __device__ long long ptot(int k) const { return b1 + 2LL * p * p + 2 * p + k; }
  __device__ long long prow(int k, int q) const {
    return b1 + 2LL * p * p + 2 * p + 2 + static_cast<long long>(k) * p + q;
  }
};

// One warp's matrix: M [L1, L2], its rows' slots [slot][L2] at `mem`, the
// lane's row of chunk c is 32 c + lane (none past L2: it reads 0, writes
// nothing, and still takes part in the scans).
template <typename T>
struct OrderDP {
  const T* M;
  T* mem;
  int L1, L2, nl, p, lane, chunks;
  OrderSlots sl;
  WarpGroup<T, 32> g;

  __device__ OrderDP(T* mem_, int L1_, int L2_, int nl_, int p_)
      : M(nullptr), mem(mem_), L1(L1_), L2(L2_), nl(nl_), p(p_),
        lane(static_cast<int>(threadIdx.x) & 31), chunks((L2_ + 31) / 32),
        sl(nl_, p_), g() {}

  __device__ int row(int c) const { return 32 * c + lane; }
  __device__ T ld(long long s, int j) const {
    return j < L2 ? mem[s * L2 + j] : T(0);
  }
  __device__ void st(long long s, int j, T v) const {
    if (j < L2) mem[s * L2 + j] = v;
  }
  __device__ T x(int i, int j) const {
    return j < L2 ? M[static_cast<long long>(i) * L2 + j] : T(0);
  }

  // The exclusive prefix (suffix) of v over the rows, plus the carry of
  // the chunks before (after) this one; the carry moves past this chunk.
  __device__ T prefix(T v, T& carry) {
    T in[1] = {v}, out[1];
    const T incl = g.template prefix_from<1>(in, out, lane == 0 ? carry : T(0));
    carry = __shfl_sync(kFull, incl, 31);
    return out[0];
  }
  __device__ T suffix(T v, T& carry) {
    T in[1] = {v}, out[1];
    const T incl = g.template suffix_from<1>(in, out, lane == 31 ? carry : T(0));
    carry = __shfl_sync(kFull, incl, 0);
    return out[0];
  }

  // Level m >= 2 of column i: D_m's grid from D_{m-1}'s. Forward: the
  // carries before column i build it, then take column i's sums; k_nl's
  // carry takes level nl's grid. Rebuild (the reverse sweep): the carries
  // drop column i's sums first (they held them), E and CP are kept for
  // the adjoint, and level nl's grid is not written (never read).
  __device__ void level(int i, int m, bool rebuild) {
    const int Rp = p < m - 1 ? p : m - 1;
    const int Rm = p < m ? p : m;
    const int kp = rebuild ? m - 2 : (m - 2) & 1;
    const int kc = rebuild ? m - 1 : (m - 1) & 1;
    const bool write = !rebuild || m < nl;
    const bool top = !rebuild && m == nl;
    T carry = T(0);
    for (int c = 0; c < chunks; ++c) {
      const int j = row(c);
      const T xv = x(i, j);
      T tot = T(0);
      for (int a = 0; a < Rp; ++a)
        for (int b = 0; b < Rp; ++b) tot += ld(sl.grid(kp, a, b), j);
      T ts = ld(sl.tsum(m - 2), j);
      if (rebuild) {
        ts -= tot;
        st(sl.tsum(m - 2), j, ts);
      }
      const T pre = prefix(ts, carry);
      if (rebuild)
        st(sl.pre(m - 2), j, pre);
      else
        st(sl.tsum(m - 2), j, ts + tot);
      if (write) {
        T s = xv * pre;
        st(sl.grid(kc, 0, 0), j, s);
        for (int a = 1; a < Rm; ++a)
          for (int b = 1; b < Rm; ++b) {
            const T v = xv / T((a + 1) * (b + 1)) *
                        ld(sl.grid(kp, a - 1, b - 1), j);
            st(sl.grid(kc, a, b), j, v);
            s += v;
          }
        if (top) st(sl.tsum(nl - 1), j, ld(sl.tsum(nl - 1), j) + s);
      }
    }
    for (int q = 0; q + 1 < Rm; ++q) {
      carry = T(0);
      for (int c = 0; c < chunks; ++c) {
        const int j = row(c);
        T cs = T(0), rs = T(0);
        for (int a = 0; a < Rp; ++a) {
          cs += ld(sl.grid(kp, a, q), j);
          rs += ld(sl.grid(kp, q, a), j);
        }
        const T cp = prefix(cs, carry);
        T r = ld(sl.ra(m - 2, q), j);
        if (rebuild) {
          r -= rs;
          st(sl.ra(m - 2, q), j, r);
          st(sl.colpre(m - 2, q), j, cp);
        } else {
          st(sl.ra(m - 2, q), j, r + rs);
        }
        if (write) {
          const T k = x(i, j) / T(q + 2);
          const T u = k * r, v = k * cp;
          st(sl.grid(kc, q + 1, 0), j, u);
          st(sl.grid(kc, 0, q + 1), j, v);
          if (top) st(sl.tsum(nl - 1), j, ld(sl.tsum(nl - 1), j) + u + v);
        }
      }
    }
  }

  // Column i begins: D_1 = M's row into grid 0.
  __device__ void first(int i) {
    for (int c = 0; c < chunks; ++c) st(sl.grid(0, 0, 0), row(c), x(i, row(c)));
  }

  // The forward sweep over the columns: the carries end in the slots,
  // tsum[m] holding the rows' shares of k_{m+1}.
  __device__ void forward() {
    for (long long s = 0; s < sl.f0; ++s)
      for (int c = 0; c < chunks; ++c) st(s, row(c), T(0));
    for (int i = 0; i < L1; ++i) {
      first(i);
      for (int m = 2; m <= nl; ++m) level(i, m, false);
    }
  }

  // Level m's adjoint of column i (deep_levels.cuh's deep_adjoint): w the
  // cotangent of k_m; the pieces of level m + 1 in set m & 1, its own for
  // level m - 1 into set (m - 1) & 1; M̄'s row set at level nl, then added.
  __device__ void adjoint(int i, int m, T w, T* mbar) {
    const int Rm = p < m ? p : m;
    const int Rn = p < m + 1 ? p : m + 1;
    const int ki = m & 1, ko = (m - 1) & 1;
    const bool below = m < nl;
    for (int c = 0; c < chunks; ++c) {
      const int j = row(c);
      const T xv = x(i, j);
      const T rt = below ? ld(sl.rtot(m - 1), j) : T(0);
      // the cotangent of D_m[a][b] at this entry
      auto A = [&](int a, int b) {
        T v = w;
        if (below) {
          v += rt;
          if (a + 1 < Rn) v += ld(sl.rrow(m - 1, a), j);
          if (b + 1 < Rn) {
            v += ld(sl.injc(ki, b), j);
            if (a + 1 < Rn) v += ld(sl.inj(ki, a, b), j);
          }
        }
        return v;
      };
      T mb;
      if (m >= 2) {
        const T a00 = A(0, 0);
        mb = a00 * ld(sl.pre(m - 2), j);
        for (int q = 1; q < Rm; ++q) {
          const T k = T(1) / T(q + 1);
          const T aq0 = A(q, 0), a0q = A(0, q);
          mb += k * (aq0 * ld(sl.ra(m - 2, q - 1), j) +
                     a0q * ld(sl.colpre(m - 2, q - 1), j));
          st(sl.injc(ko, q - 1), j, xv * k * a0q);
          st(sl.prow(ko, q - 1), j, xv * k * aq0);
        }
        for (int a = 1; a < Rm; ++a)
          for (int b = 1; b < Rm; ++b) {
            const T k = T(1) / T((a + 1) * (b + 1));
            const T ab = A(a, b);
            mb += k * ab * ld(sl.grid(m - 2, a - 1, b - 1), j);
            st(sl.inj(ko, a - 1, b - 1), j, xv * k * ab);
          }
        st(sl.ptot(ko), j, xv * a00);
      } else {
        mb = A(0, 0);
      }
      if (below)
        for (int q = 0; q + 1 < Rn; ++q)
          st(sl.rrow(m - 1, q), j,
             ld(sl.rrow(m - 1, q), j) + ld(sl.prow(ki, q), j));
      if (j < L2) {
        T* out = mbar + static_cast<long long>(i) * L2 + j;
        *out = m == nl ? mb : *out + mb;
      }
    }
    // the scans, chunks descending: level m + 1's total pieces join the
    // carry over columns only now; level m's column pieces become their
    // suffixes
    if (below) {
      T carry = T(0);
      for (int c = chunks - 1; c >= 0; --c) {
        const int j = row(c);
        const T sfx = suffix(ld(sl.ptot(ki), j), carry);
        st(sl.rtot(m - 1), j, ld(sl.rtot(m - 1), j) + sfx);
      }
    }
    if (m >= 2)
      for (int q = 1; q < Rm; ++q) {
        T carry = T(0);
        for (int c = chunks - 1; c >= 0; --c) {
          const int j = row(c);
          st(sl.injc(ko, q - 1), j, suffix(ld(sl.injc(ko, q - 1), j), carry));
        }
      }
  }

  // The reverse sweep after forward(): gw [nl + 1, B], matrix b; M̄ of
  // every entry into mbar [L1, L2].
  __device__ void reverse(const T* gw, long long B, long long b, T* mbar) {
    for (int m = 0; m + 1 < nl; ++m)
      for (int c = 0; c < chunks; ++c) {
        st(sl.rtot(m), row(c), T(0));
        for (int q = 0; q + 1 < p; ++q) st(sl.rrow(m, q), row(c), T(0));
      }
    for (int i = L1 - 1; i >= 0; --i) {
      first(i);
      for (int m = 2; m <= nl; ++m) level(i, m, true);
      for (int m = nl; m >= 1; --m) adjoint(i, m, gw[m * B + b], mbar);
    }
  }
};

// The launch arguments are sig_gram.cuh's SgArgs, as plan.py's
// sig_gram_order_plan fills them: S = 32, R = 1, bands = 1, W warps a
// block (1 .. kOrderWarps), the workspace `area` elements a warp
// (order_slots L2 at least), `blocks` blocks striding over the matrices.
inline bool sg_order_ok(const SgArgs& a, bool bwd) {
  return a.P > kDeepOrder && a.P <= a.nl && a.nl <= kDeepLevels &&
         a.S == 32 && a.R == 1 && a.bands == 1 && a.W >= 1 &&
         a.W <= kOrderWarps && !a.area_smem && a.work != nullptr &&
         a.blocks >= 1 && a.B >= 1 && a.L1 >= 1 && a.L2 >= 1 &&
         a.area >= OrderSlots::count(a.nl, a.P, bwd) * a.L2;
}

// Warp w of block k takes matrices k W + w, then a stride of the grid's
// warps. out: [nl + 1, B].
template <typename T>
__global__ void __launch_bounds__(32 * kOrderWarps)
sig_gram_order_kernel(const T* __restrict__ M, T* __restrict__ out, T* work,
                      int B, int L1, int L2, int nl, int P, int area) {
  const int W = static_cast<int>(blockDim.x) >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * W +
                      (static_cast<int>(threadIdx.x) >> 5);
  OrderDP<T> dp(work + w * area, L1, L2, nl, P);
  for (long long b = w; b < B; b += static_cast<long long>(gridDim.x) * W) {
    dp.M = M + b * L1 * L2;
    dp.forward();
    if (dp.lane == 0) out[b] = T(1);
    for (int m = 0; m < nl; ++m) {
      T s = T(0);
      for (int c = 0; c < dp.chunks; ++c) s += dp.ld(dp.sl.tsum(m), dp.row(c));
      s = dp.g.sum(s);
      if (dp.lane == 0) out[(m + 1) * static_cast<long long>(B) + b] = s;
    }
  }
}

// The backward: gw [nl + 1, B] -> Mbar [B, L1, L2], every entry written.
template <typename T>
__global__ void __launch_bounds__(32 * kOrderWarps)
sig_gram_order_bwd_kernel(const T* __restrict__ M, const T* __restrict__ gw,
                          T* __restrict__ Mbar, T* work, int B, int L1,
                          int L2, int nl, int P, int area) {
  const int W = static_cast<int>(blockDim.x) >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * W +
                      (static_cast<int>(threadIdx.x) >> 5);
  OrderDP<T> dp(work + w * area, L1, L2, nl, P);
  for (long long b = w; b < B; b += static_cast<long long>(gridDim.x) * W) {
    const long long off = b * L1 * L2;
    dp.M = M + off;
    dp.forward();
    dp.reverse(gw, B, b, Mbar + off);
  }
}

template <typename T>
cudaError_t sg_fwd_order(const SgArgs& a, cudaStream_t stream) {
  if (!sg_order_ok(a, false)) return cudaErrorInvalidValue;
  sig_gram_order_kernel<T><<<a.blocks, 32 * a.W, 0, stream>>>(
      static_cast<const T*>(a.M), static_cast<T*>(a.out),
      static_cast<T*>(a.work), a.B, a.L1, a.L2, a.nl, a.P, a.area);
  return cudaGetLastError();
}

template <typename T>
cudaError_t sg_bwd_order(const SgArgs& a, cudaStream_t stream) {
  if (!sg_order_ok(a, true)) return cudaErrorInvalidValue;
  sig_gram_order_bwd_kernel<T><<<a.blocks, 32 * a.W, 0, stream>>>(
      static_cast<const T*>(a.M), static_cast<const T*>(a.g),
      static_cast<T*>(a.out), static_cast<T*>(a.work), a.B, a.L1, a.L2,
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
