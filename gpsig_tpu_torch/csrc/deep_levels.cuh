// The run-length column DP and its reverse for num_levels 8 .. 127, shared
// by the sig_gram kernels (sig_gram.cuh, sig_gram_bwd.cuh).
//
// common.cuh's run_length_levels keeps one pair's whole DP state in
// registers, unrolled over kRlLevels = 7 levels. Past that the state is
// too large for registers and the level count is a run-time value: the
// same recursion (the same formulas, in the same order) runs as a loop
// over levels, with the current column's P x P state grid in registers and
// every per-level carry in memory. The memory is either the block's shared
// memory or a device workspace that the wrapper allocates (torch.empty),
// one region per segment or band in flight; the kernel sees a plain
// pointer to either. A group thread's R rows of slot s live at
// base[(s R + r) GT + t] (GT threads in the group), so neighbouring
// threads touch neighbouring addresses.
//
// Slots of one pair (ops/cuda/plan.py's deep_slots counts them):
//   tsum[m]        m < nl                T_{m+1}: ecumsum2 carry, then k
//   ra[m][q]       m < nl - 1, q < P - 1 RA_{m+2}[q]: row-cumsum carry
// and for the backward only, per level m < nl - 1:
//   st[m][a][b]    D_{m+1} of the current column
//   pre[m], colpre[m][q]                 E_{m+2}, CP_{m+2}[q]
//   rtot[m], rrow[m][q]                  Rtot_{m+1}, Rrow_{m+1}[q]
// Forward nl + (nl-1)(P-1) slots, backward nl + (nl-1)(P² + 3P - 1).
#pragma once

#include "common.cuh"

namespace gpsig {

// The deep path's bounds: num_levels + 1 <= 128, as the JAX sig_gram
// kernels take (the wrappers raise ValueError above it); p = min(order,
// num_levels) <= 7, as the register path (above it the entry points take
// the run-time-order instance, sig_gram_order.cuh).
constexpr int kDeepLevels = 127;
constexpr int kDeepOrder = 7;

template <int P>
struct DeepSlots {
  int nl;
  __device__ int tsum(int m) const { return m; }
  __device__ int ra(int m, int q) const { return nl + m * (P - 1) + q; }
  __device__ int fwd() const { return nl + (nl - 1) * (P - 1); }
  __device__ int st(int m, int a, int b) const {
    return fwd() + (m * P + a) * P + b;
  }
  __device__ int pre(int m) const { return fwd() + (nl - 1) * P * P + m; }
  __device__ int colpre(int m, int q) const {
    return fwd() + (nl - 1) * (P * P + 1) + m * (P - 1) + q;
  }
  __device__ int rtot(int m) const {
    return fwd() + (nl - 1) * (P * P + P) + m;
  }
  __device__ int rrow(int m, int q) const {
    return fwd() + (nl - 1) * (P * P + P + 1) + m * (P - 1) + q;
  }
};

// A group thread's view of its pair's state memory.
template <typename T, int R>
struct DeepStore {
  T* base;
  int gt, t;

  __device__ T* at(int slot, int r) const {
    return base + (static_cast<long long>(slot) * R + r) * gt + t;
  }
  __device__ void load(int slot, T (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = *at(slot, r);
  }
  __device__ void store(int slot, const T (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) *at(slot, r) = v[r];
  }
  __device__ void add(int slot, const T (&v)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) *at(slot, r) += v[r];
  }
  __device__ void zero(int lo, int hi) const {
    for (int s = lo; s < hi; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) *at(s, r) = T(0);
  }
};

// Level m >= 2 of the forward's current column, in place in grid (level
// m - 1's states on entry, level m's on exit): common.cuh's rl_level with
// run-time m.
template <typename T, int R, int P, typename G>
__device__ __forceinline__ void deep_level(T (&grid)[P][P][R],
                                           const T (&mcol)[R], int m, int nl,
                                           const DeepSlots<P>& sl,
                                           const DeepStore<T, R>& mem, G& g) {
  const int Rm = P < m ? P : m;
  const int Rp = P < m - 1 ? P : m - 1;
  T tot[R], pre[R], ts[R], colpre[P][R], rowsum[P][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tot[r] = T(0);
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b)
        if (a < Rp && b < Rp) tot[r] += grid[a][b][r];
  }
#pragma unroll
  for (int q = 0; q + 1 < P; ++q) {
    if (q + 1 < Rm) {
      T cs[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cs[r] = T(0);
        rowsum[q][r] = T(0);
#pragma unroll
        for (int a = 0; a < P; ++a)
          if (a < Rp) {
            cs[r] += grid[a][q][r];
            rowsum[q][r] += grid[q][a][r];
          }
      }
      g.template prefix<R>(cs, colpre[q]);
    }
  }
  mem.load(sl.tsum(m - 2), ts);
  g.template prefix<R>(ts, pre);
#pragma unroll
  for (int a = P - 1; a >= 1; --a)
#pragma unroll
    for (int b = P - 1; b >= 1; --b)
      if (a < Rm && b < Rm) {
        const T c = T(1) / T((a + 1) * (b + 1));
#pragma unroll
        for (int r = 0; r < R; ++r)
          grid[a][b][r] = mcol[r] * c * grid[a - 1][b - 1][r];
      }
#pragma unroll
  for (int a = P - 1; a >= 1; --a)
    if (a < Rm) {
      const T c = T(1) / T(a + 1);
      T ra[R];
      mem.load(sl.ra(m - 2, a - 1), ra);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        grid[a][0][r] = mcol[r] * c * ra[r];
        grid[0][a][r] = mcol[r] * c * colpre[a - 1][r];
      }
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    grid[0][0][r] = mcol[r] * pre[r];
    ts[r] += tot[r];
  }
  mem.store(sl.tsum(m - 2), ts);
#pragma unroll
  for (int q = 0; q + 1 < P; ++q)
    if (q + 1 < Rm) mem.add(sl.ra(m - 2, q), rowsum[q]);
}

// The forward sweep over `ncols` columns (common.cuh's rl_forward): the
// carries end in memory, tsum[nl - 1] holding the thread's share of k_nl.
template <typename T, int R, int P, typename Col, typename G>
__device__ void deep_forward(Col& col, int ncols, int nl,
                             const DeepSlots<P>& sl,
                             const DeepStore<T, R>& mem, G& g) {
  mem.zero(0, sl.fwd());
  T grid[P][P][R];
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) grid[a][b][r] = T(0);
  for (int j = 0; j < ncols; ++j) {
    T mcol[R];
    col(j, mcol);
#pragma unroll
    for (int r = 0; r < R; ++r) grid[0][0][r] = mcol[r];
    for (int m = 2; m <= nl; ++m) deep_level<T, R, P>(grid, mcol, m, nl, sl,
                                                      mem, g);
    const int Rm = P < nl ? P : nl;
    T s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = T(0);
#pragma unroll
      for (int a = 0; a < P; ++a)
#pragma unroll
        for (int b = 0; b < P; ++b)
          if (a < Rm && b < Rm) s[r] += grid[a][b][r];
    }
    mem.add(sl.tsum(nl - 1), s);
  }
}

// Rebuild level m's states of the current column (common.cuh's rl_rebuild
// with run-time m): column j's level m-1 totals leave the carries, then
// the forward's formulas give level m's states (for m < nl).
template <typename T, int R, int P, typename G>
__device__ __forceinline__ void deep_rebuild(const T (&mcol)[R], int m,
                                             int nl, const DeepSlots<P>& sl,
                                             const DeepStore<T, R>& mem,
                                             G& g) {
  const int Rm = P < m ? P : m;
  const int Rp = P < m - 1 ? P : m - 1;
  T prev[P][P][R];  // D_{m-1} of this column
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b)
      if (a < Rp && b < Rp) mem.load(sl.st(m - 2, a, b), prev[a][b]);
  T ts[R], pre[R], colpre[P][R];
  mem.load(sl.tsum(m - 2), ts);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T tot = T(0);
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b)
        if (a < Rp && b < Rp) tot += prev[a][b][r];
    ts[r] -= tot;
  }
  mem.store(sl.tsum(m - 2), ts);
  T ra[P][R];
#pragma unroll
  for (int q = 0; q + 1 < P; ++q) {
    if (q + 1 < Rm) {
      T cs[R];
      mem.load(sl.ra(m - 2, q), ra[q]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T row = T(0);
        cs[r] = T(0);
#pragma unroll
        for (int a = 0; a < P; ++a)
          if (a < Rp) {
            cs[r] += prev[a][q][r];
            row += prev[q][a][r];
          }
        ra[q][r] -= row;
      }
      mem.store(sl.ra(m - 2, q), ra[q]);
      g.template prefix<R>(cs, colpre[q]);
      mem.store(sl.colpre(m - 2, q), colpre[q]);
    }
  }
  g.template prefix<R>(ts, pre);
  mem.store(sl.pre(m - 2), pre);
  if (m < nl) {  // level nl's own states are never read
#pragma unroll
    for (int a = 1; a < P; ++a)
#pragma unroll
      for (int b = 1; b < P; ++b)
        if (a < Rm && b < Rm) {
          const T c = T(1) / T((a + 1) * (b + 1));
          T v[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            v[r] = mcol[r] * c * prev[a - 1][b - 1][r];
          mem.store(sl.st(m - 1, a, b), v);
        }
#pragma unroll
    for (int a = 1; a < P; ++a)
      if (a < Rm) {
        const T c = T(1) / T(a + 1);
        T v[R], u[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r] = mcol[r] * c * ra[a - 1][r];
          u[r] = mcol[r] * c * colpre[a - 1][r];
        }
        mem.store(sl.st(m - 1, a, 0), v);
        mem.store(sl.st(m - 1, 0, a), u);
      }
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = mcol[r] * pre[r];
    mem.store(sl.st(m - 1, 0, 0), v);
  }
}

// The same-column pieces that one level's adjoint hands to the level below
// (common.cuh's RunLengthBwd::inj, ptot, prow), in registers.
template <typename T, int R, int P>
struct DeepPass {
  T inj[P][P][R];
  T ptot[R];
  T prow[P][R];
};

// Level m's adjoint of the current column (common.cuh's rl_adjoint with
// run-time m; levels are walked from nl down to 1). Adds into mbar.
template <typename T, int R, int P, typename G>
__device__ __forceinline__ void deep_adjoint(DeepPass<T, R, P>& ps,
                                             const T (&mcol)[R], T wm, int m,
                                             int nl, const DeepSlots<P>& sl,
                                             const DeepStore<T, R>& mem,
                                             G& g, T (&mbar)[R]) {
  const int Rm = P < m ? P : m;
  T A[P][P][R];
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) A[a][b][r] = wm;
  if (m < nl) {
    const int Rn = P < m + 1 ? P : m + 1;  // extent at level m + 1
    T rtot[R], rrow[P][R];
    mem.load(sl.rtot(m - 1), rtot);
#pragma unroll
    for (int q = 0; q + 1 < P; ++q)
      if (q + 1 < Rn) mem.load(sl.rrow(m - 1, q), rrow[q]);
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b)
        if (a < Rm && b < Rm) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            T v = rtot[r] + ps.inj[a][b][r];
            if (a + 1 < Rn) v += rrow[a < P - 1 ? a : 0][r];
            A[a][b][r] += v;
          }
        }
    // level m+1's pieces of this column join the carries only now
    T sfx[R];
    g.template suffix<R>(ps.ptot, sfx);
#pragma unroll
    for (int r = 0; r < R; ++r) rtot[r] += sfx[r];
    mem.store(sl.rtot(m - 1), rtot);
#pragma unroll
    for (int q = 0; q + 1 < P; ++q)
      if (q + 1 < Rn) {
#pragma unroll
        for (int r = 0; r < R; ++r) rrow[q][r] += ps.prow[q][r];
        mem.store(sl.rrow(m - 1, q), rrow[q]);
      }
  }
  if (m >= 2) {
    const int Rp = P < m - 1 ? P : m - 1;
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b)
        if (a < Rp && b < Rp)
#pragma unroll
          for (int r = 0; r < R; ++r) ps.inj[a][b][r] = T(0);
    T pre[R];
    mem.load(sl.pre(m - 2), pre);
#pragma unroll
    for (int r = 0; r < R; ++r) mbar[r] += A[0][0][r] * pre[r];
#pragma unroll
    for (int q = 1; q < P; ++q)
      if (q < Rm) {
        const T c = T(1) / T(q + 1);
        T ra[R], cp[R], v[R], sfx[R];
        mem.load(sl.ra(m - 2, q - 1), ra);
        mem.load(sl.colpre(m - 2, q - 1), cp);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mbar[r] += c * (A[q][0][r] * ra[r] + A[0][q][r] * cp[r]);
          v[r] = mcol[r] * c * A[0][q][r];
        }
        g.template suffix<R>(v, sfx);
#pragma unroll
        for (int a = 0; a < P; ++a)
          if (a < Rp)
#pragma unroll
            for (int r = 0; r < R; ++r) ps.inj[a][q - 1][r] += sfx[r];
      }
#pragma unroll
    for (int a = 1; a < P; ++a)
#pragma unroll
      for (int b = 1; b < P; ++b)
        if (a < Rm && b < Rm) {
          const T c = T(1) / T((a + 1) * (b + 1));
          T st[R];
          mem.load(sl.st(m - 2, a - 1, b - 1), st);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            mbar[r] += c * A[a][b][r] * st[r];
            ps.inj[a - 1][b - 1][r] += mcol[r] * c * A[a][b][r];
          }
        }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ps.ptot[r] = mcol[r] * A[0][0][r];
#pragma unroll
      for (int q = 0; q + 1 < P; ++q)
        if (q + 1 < Rm)
          ps.prow[q][r] = mcol[r] * (T(1) / T(q + 2)) * A[q + 1][0][r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) mbar[r] += A[0][0][r];
  }
}

// The reverse sweep of the adjoint of deep_forward for one pair (common.cuh's
// rl_reverse with the state in memory), from the forward's end carries
// that deep_forward left in mem: w(m) is the cotangent of level m + 1;
// rev and sink as there.
template <typename T, int R, int P, typename Rev, typename Sink,
          typename Wts, typename G>
__device__ void deep_reverse(Rev& rev, Sink& sink, int ncols, int nl,
                             Wts& w, const DeepStore<T, R>& mem, G& g) {
  const DeepSlots<P> sl{nl};
  for (int m = 0; m + 1 < nl; ++m) {
    T z[R];
#pragma unroll
    for (int r = 0; r < R; ++r) z[r] = T(0);
    mem.store(sl.rtot(m), z);
#pragma unroll
    for (int q = 0; q + 1 < P; ++q) mem.store(sl.rrow(m, q), z);
  }
  DeepPass<T, R, P> ps;
  for (int j = ncols - 1; j >= 0; --j) {
    T mcol[R], mbar[R];
    rev(j, mcol);
#pragma unroll
    for (int r = 0; r < R; ++r) mbar[r] = T(0);
    if (nl > 1) mem.store(sl.st(0, 0, 0), mcol);
    for (int m = 2; m <= nl; ++m) deep_rebuild<T, R, P>(mcol, m, nl, sl, mem,
                                                        g);
    for (int m = nl; m >= 1; --m)
      deep_adjoint<T, R, P>(ps, mcol, w(m - 1), m, nl, sl, mem, g, mbar);
    sink(j, mbar, g);
  }
}

}  // namespace gpsig
