"""sig_gram past order 7: the run-time-order instance
(``csrc/sig_gram_order.cuh``, ``plan.sig_gram_order_plan``).

- A float64 torch model of the kernels' loop order: a block of warps a
  matrix, a row a thread, the rows past the block in chunks; every scan
  the warps' scans, their totals added across the warps and carried from
  chunk to chunk; every value a row keeps in packed slots laid out as
  ``OrderLayout``; the forward's grid updated in place; the backward's
  forward sweep keeping the carries before every K-th column (K =
  ceil(sqrt(L1))), then the reverse sweep over the segments of K columns,
  last first, each recomputed forward from its checkpoint, each column's
  grids built from its carries (nothing subtracted) and the adjoint walked
  down the levels. Held at (num_levels, order) (8, 8) and (10, 9) against the
  JAX package's Pallas kernels (``sig_gram_levels_ho``, interpret mode)
  and ``jax.vjp`` (through their custom VJP, ``_bwd_kernel_ho``, at
  (8, 8); through the XLA ``signature_kern`` at (10, 9)), scaled error 1e-5
  (their in-kernel triangular products accumulate in float32 even on
  float64 inputs, as ``test_torch_sig_gram.py`` states), and against the
  port's plain version and autograd, scaled error 1e-10 (float64, other
  summation order only); the segments where K does not divide L1, at
  L1 = 1, at a segment longer than L1 and at a column a segment; and in
  float32 at p = nl = 20, within 5 times the plain version's own error.
- The plan at p > 7: the packed slots, the backward's checkpoint sets,
  the warps a block, the register route at p = 8, the shared-memory route
  where a matrix's slots fit and the workspace route with its L2-bounded
  grid where they do not, the backward's checkpoint region on every route
  and its resident grid, and the workspace refusal. (The register route
  runs the same loop order with the grid and the adjoint's pieces in
  registers.)
- ``SignatureRBF(2, 8, order=8)``: K, Kdiag and the SVGP ELBO's gradients
  on the CPU against the JAX package, rtol 1e-8 (as ``test_torch_svgp.py``).
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import inducing as jind
from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu.ops.signature import signature_kern
from gpsig_tpu.ops.pallas.sig_gram import sig_gram_levels_ho
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.models import svgp as tsvgp
from gpsig_tpu_torch.ops.cuda import plan
from gpsig_tpu_torch.ops.cuda import sig_gram as sg

torch.set_num_threads(1)


def scaled(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- a float64 model of the loop order ------------------------------------------

class Layout:
    """A row's packed slots (``csrc/sig_gram_order.cuh``'s OrderLayout)."""

    def __init__(self, nl, p, backward):
        self.nl, self.p = nl, p
        R = self.rsum(nl + 1)
        self.ts = 2 if backward else 1
        self.ra0 = self.ts + nl - 1
        if backward:
            self.ec0 = self.ra0 + R
            self.g0 = self.ec0 + R + nl - 1
            self.rt0 = self.g0 + self.gsum(nl)
            self.rr0 = self.rt0 + nl - 1
            self.inj0 = self.rr0 + R
            self.set0 = self.inj0 + (p - 1) ** 2
            self.prow0 = self.set0 + 2 * p
            self.total = self.prow0 + 2 * (p - 1)
        else:
            self.buf0 = self.ra0 + R
            self.g0 = self.buf0 + p
            self.total = self.g0 + p * p

    def rsum(self, m):
        return sum(min(self.p, k) - 1 for k in range(2, m))

    def gsum(self, m):
        return sum(min(self.p, k) ** 2 for k in range(1, m))

    def tsum(self, m):
        return self.ts + m - 2

    def ra(self, m, q):
        return self.ra0 + self.rsum(m) + q

    def ec(self, m, k):
        return self.ec0 + self.rsum(m) + m - 2 + k

    def grid(self, m):
        return self.g0 + self.gsum(m)

    def rt(self, m):
        return self.rt0 + m - 1

    def rr(self, m, q):
        return self.rr0 + self.rsum(m + 1) + q

    def inj(self, a, b):
        return self.inj0 + a * (self.p - 1) + b

    def set(self, s, k):
        return self.set0 + s * self.p + k

    def prow(self, s, q):
        return self.prow0 + s * (self.p - 1) + q


X_SLOT, MB_SLOT = 0, 1


class OrderModel:
    """``OrderBlock`` on every matrix of M [B, L1, L2] at once: slot s of
    row j is mem[:, s, j]; a block of W warps of ``lanes`` threads (32 on
    the card), W = min(ceil(L2 / lanes), max_warps), NT = W lanes threads
    a chunk, row c NT + t; a chunk's values are [B, NT] tensors, rows past
    L2 reading 0 and writing nothing. Each scan is the warps' scans, their
    totals added across the warps, the first (last) thread's carry across
    the chunks."""

    def __init__(self, M, nl, order, lanes, max_warps, backward):
        self.M, (self.B, self.L1, self.L2) = M, M.shape
        self.nl, self.p = nl, min(order, nl)
        self.lanes = lanes
        self.W = min(-(-self.L2 // lanes), max_warps)
        self.NT = self.W * lanes
        self.C = -(-self.L2 // self.NT)
        self.ly = Layout(nl, self.p, backward)
        assert self.ly.total == plan.order_slots(nl, self.p, backward)
        self.mem = torch.full((self.B, self.ly.total, self.L2), float("nan"),
                              dtype=M.dtype)
        self.carry = {}
        self.inv = [0.0] + [1.0 / n for n in range(1, self.p + 2)]

    def ld(self, s, c):
        v = torch.zeros(self.B, self.NT, dtype=self.M.dtype)
        n = min(self.NT, self.L2 - c * self.NT)
        v[:, :n] = self.mem[:, s, c * self.NT:c * self.NT + n]
        return v

    def st(self, s, c, v):
        n = min(self.NT, self.L2 - c * self.NT)
        self.mem[:, s, c * self.NT:c * self.NT + n] = v[:, :n]

    def scan(self, base, K, c, suffix):
        first = c == (self.C - 1 if suffix else 0)
        for k in range(K):
            v = self.ld(base + k, c)
            inc = v.clone()
            hold = -1 if suffix else 0
            if not first:
                inc[:, hold] += self.carry[suffix, k]
            w = inc.reshape(self.B, self.W, self.lanes)
            if suffix:
                incl = torch.flip(torch.cumsum(torch.flip(w, [-1]), -1), [-1])
                tot = incl[:, :, 0]
                off = torch.flip(torch.cumsum(torch.flip(tot, [-1]), -1),
                                 [-1]) - tot
            else:
                incl = torch.cumsum(w, -1)
                tot = incl[:, :, -1]
                off = torch.cumsum(tot, -1) - tot
            incl = (incl + off[:, :, None]).reshape(self.B, self.NT)
            self.st(base + k, c, incl - v)
            self.carry[suffix, k] = tot.sum(-1)

    def zero(self, s0, s1):
        self.mem[:, s0:s1] = 0

    def stage(self, i):
        self.mem[:, X_SLOT] = self.M[:, i]

    def forward_level(self, m, g, buf, mode, acc):
        p, ly, ld, st, inv = self.p, self.ly, self.ld, self.st, self.inv
        Rp, Rm = min(p, m - 1), min(p, m)
        scans, write = mode != 2, mode == 0
        for c in range(self.C):
            x = ld(X_SLOT, c)
            ts = ld(ly.tsum(m), c)
            if scans:
                st(buf, c, ts)
                for q in range(Rm - 1):
                    st(buf + 1 + q, c, sum(ld(g + a * p + q, c)
                                           for a in range(Rp)))
            tot = 0
            for a in reversed(range(Rp)):
                moves = a + 1 < Rm
                xa = x * inv[a + 2]
                rs = 0
                for b in reversed(range(Rp)):
                    v = ld(g + a * p + b, c)
                    rs = rs + v
                    if scans and moves and b + 1 < Rm:
                        nv = xa * inv[b + 2] * v
                        if write:
                            st(g + (a + 1) * p + b + 1, c, nv)
                        else:
                            acc[c] = acc[c] + nv
                tot = tot + rs
                if moves:
                    r = ld(ly.ra(m, a), c)
                    st(ly.ra(m, a), c, r + rs)
                    if scans:
                        if write:
                            st(g + (a + 1) * p, c, xa * r)
                        else:
                            acc[c] = acc[c] + xa * r
            st(ly.tsum(m), c, ts + tot)
            if not scans:
                continue
            self.scan(buf, Rm, c, False)
            edges = [x * ld(buf, c)] + [x * inv[q + 2] * ld(buf + 1 + q, c)
                                        for q in range(Rm - 1)]
            for q, e in enumerate(edges):
                if write:
                    st(g + q, c, e)
                else:
                    acc[c] = acc[c] + e

    def forward(self):
        ly = self.ly
        acc = [0] * self.C
        self.zero(ly.ts, ly.ra0 + ly.rsum(self.nl + 1))
        for i in range(self.L1):
            self.stage(i)
            for c in range(self.C):
                self.st(ly.g0, c, self.ld(X_SLOT, c))
            for m in range(2, self.nl + 1):
                self.forward_level(m, ly.g0, ly.buf0,
                                   0 if m < self.nl else 1, acc)
        rows = self.mem[:, self.ly.ts:self.ly.ts + self.nl - 1].sum(-1)
        top = sum(a.sum(-1) for a in acc)
        return torch.cat([torch.ones(1, self.B, dtype=self.M.dtype), rows.T,
                          top[None]])

    def build(self, m):
        """Level m of a column of the reverse sweep from the carries before
        it (restored, not rebuilt): E_m and CP_m by prefix scans into ec,
        and (below the top) D_m's grid from D_{m-1}'s, by the forward's
        own arithmetic."""
        p, ly, ld, st, inv = self.p, self.ly, self.ld, self.st, self.inv
        Rp, Rm = min(p, m - 1), min(p, m)
        write = m < self.nl
        gp, gc, e0 = ly.grid(m - 1), ly.grid(m) if write else 0, ly.ec(m, 0)
        for c in range(self.C):
            x = ld(X_SLOT, c)
            for q in range(Rm - 1):
                st(e0 + 1 + q, c, sum(ld(gp + a * Rp + q, c)
                                      for a in range(Rp)))
            if write:
                for a in range(Rm - 1):
                    xa = x * inv[a + 2]
                    for b in range(Rm - 1):
                        st(gc + (a + 1) * Rm + b + 1, c,
                           xa * inv[b + 2] * ld(gp + a * Rp + b, c))
                    st(gc + (a + 1) * Rm, c, xa * ld(ly.ra(m, a), c))
            st(e0, c, ld(ly.tsum(m), c))
            self.scan(e0, Rm, c, False)
            if write:
                st(gc, c, x * ld(e0, c))
                for q in range(Rm - 1):
                    st(gc + q + 1, c, x * inv[q + 2] * ld(e0 + 1 + q, c))

    def adjoint(self, m, wm, Mbar, i):
        p, nl, ly, ld, st, inv = (self.p, self.nl, self.ly, self.ld, self.st,
                                  self.inv)
        Rm, Rn, Rp = min(p, m), min(p, m + 1), min(p, m - 1)
        below = m < nl
        ki, ko = m & 1, (m - 1) & 1
        gp = ly.grid(m - 1) if m >= 2 else 0
        for c in range(self.C):
            x = ld(X_SLOT, c)
            base = wm[:, None] + (ld(ly.rt(m), c) if below else 0)

            def rowp(a):
                return ld(ly.rr(m, a), c) if below and a + 1 < Rn else 0

            def colp(b):
                return ld(ly.set(ki, 1 + b), c) if below and b + 1 < Rn else 0

            def injv(a, b):
                return (ld(ly.inj(a, b), c)
                        if below and a + 1 < Rn and b + 1 < Rn else 0)
            r0, c0 = base + rowp(0), colp(0)
            a00 = r0 + c0 + injv(0, 0)
            mb = 0 if m == nl else ld(MB_SLOT, c)
            if m >= 2:
                mb = mb + a00 * ld(ly.ec(m, 0), c)
                for q in range(1, Rm):
                    k = inv[q + 1]
                    aq0 = base + rowp(q) + c0 + injv(q, 0)
                    a0q = r0 + colp(q) + injv(0, q)
                    mb = mb + k * (aq0 * ld(ly.ra(m, q - 1), c)
                                   + a0q * ld(ly.ec(m, q), c))
                    st(ly.set(ko, q), c, x * k * a0q)
                    st(ly.prow(ko, q - 1), c, x * k * aq0)
                for a in range(1, Rm):
                    ra = base + rowp(a)
                    ka = inv[a + 1]
                    for b in range(1, Rm):
                        kb = inv[b + 1]
                        ab = ra + colp(b) + injv(a, b)
                        mb = mb + ka * kb * ab * ld(gp + (a - 1) * Rp + b - 1,
                                                    c)
                        st(ly.inj(a - 1, b - 1), c, x * ka * kb * ab)
                st(ly.set(ko, 0), c, x * a00)
            else:
                mb = mb + a00
            if below:
                st(ly.rt(m), c, ld(ly.rt(m), c) + ld(ly.set(ki, 0), c))
                for q in range(Rn - 1):
                    st(ly.rr(m, q), c, ld(ly.rr(m, q), c)
                       + ld(ly.prow(ki, q), c))
            if m > 1:
                st(MB_SLOT, c, mb)
            else:
                n = min(self.NT, self.L2 - c * self.NT)
                Mbar[:, i, c * self.NT:c * self.NT + n] = mb[:, :n]
        if m >= 2:
            for c in reversed(range(self.C)):
                self.scan(ly.set(ko, 0), Rm, c, True)

    # the backward's checkpoint region: sets of a row's carries over
    # columns (slots ly.ts .. ly.ts + NC - 1), set s the carries before
    # segment s's first column, set segments + k - 1 those before its
    # column k >= 1
    def carry_set(self, s, k):
        return s if k == 0 else self.segments + k - 1

    def save(self, n):
        nc = self.ly.ra0 + self.ly.rsum(self.nl + 1) - self.ly.ts
        self.ck[:, n] = self.mem[:, self.ly.ts:self.ly.ts + nc]

    def load(self, n):
        nc = self.ck.shape[2]
        self.mem[:, self.ly.ts:self.ly.ts + nc] = self.ck[:, n]

    def column(self, i):
        """Column i of the forward sweep: every level's grid in place at
        the grids' slots (stride p), the carries advanced."""
        ly = self.ly
        self.stage(i)
        for c in range(self.C):
            self.st(ly.g0, c, self.ld(X_SLOT, c))
        for m in range(2, self.nl + 1):
            self.forward_level(m, ly.g0, ly.ec(m, 0),
                               0 if m < self.nl else 2, None)

    def backward(self, w, K=None):
        """The forward sweep keeping the carries before every K-th column
        (K as the kernel takes it, ``plan.order_segments``, or given), then
        the segments last first: the segment's columns recomputed forward
        from its checkpoint, keeping the carries before each, then its
        columns last first, each column's grids built from its carries and
        the adjoint run down the levels. Nothing is subtracted."""
        ly, nl, L1 = self.ly, self.nl, self.L1
        rule = plan.order_segments(L1, nl, self.p, self.L2,
                                   self.M.element_size())
        K = rule[0] if K is None else K
        self.segments = -(-L1 // K)
        nc = ly.ra0 + ly.rsum(nl + 1) - ly.ts
        assert nc == plan.order_carries(nl, self.p)
        sets = self.segments + K - 1
        assert K != rule[0] or sets * nc == plan.order_checkpoints(
            L1, nl, self.p, self.L2, self.M.element_size())
        self.ck = torch.full((self.B, sets, nc, self.L2), float("nan"),
                             dtype=self.M.dtype)
        self.zero(ly.ts, ly.ts + nc)
        for i in range(L1):
            if i % K == 0:
                self.save(i // K)
            self.column(i)
        self.zero(ly.rt0, ly.rt0 + nl - 1)
        self.zero(ly.rr0, ly.rr0 + ly.rsum(nl + 1))
        Mbar = torch.zeros_like(self.M)
        for s in reversed(range(self.segments)):
            c0 = s * K
            n = min(K, L1 - c0)
            self.load(s)
            for k in range(1, n):
                self.column(c0 + k - 1)
                self.save(self.carry_set(s, k))
            # the carries before the segment's last column are loaded
            for k in reversed(range(n)):
                if k < n - 1:
                    self.load(self.carry_set(s, k))
                self.stage(c0 + k)
                for c in range(self.C):
                    self.st(ly.grid(1), c, self.ld(X_SLOT, c))
                for m in range(2, nl + 1):
                    self.build(m)
                for m in range(nl, 0, -1):
                    self.adjoint(m, w[m], Mbar, c0 + k)
        return Mbar


@pytest.mark.parametrize("nl,order,shape,lanes,max_warps,pallas_vjp", [
    # p = nl: 2 warps of 2 lanes, 2 chunks, the last one ragged
    (8, 8, (2, 5, 7), 2, 2, True),
    # p < nl (the grid stops growing at 9): 2 warps of 4 lanes, 2 chunks
    (10, 9, (2, 4, 9), 4, 2, False),
])
def test_order_model_matches_jax_and_its_grad(nl, order, shape, lanes,
                                              max_warps, pallas_vjp):
    """The loop order's forward against the JAX Pallas kernel
    ``_fwd_kernel_ho`` in interpret mode, and its backward against
    ``jax.vjp``: through the Pallas kernel's custom VJP
    (``_bwd_kernel_ho``, interpret mode) at (8, 8), through the JAX
    package's XLA ``signature_kern`` at (10, 9), where the interpreted
    backward would cost the file ~10 s more; both against the port's plain
    version and autograd through it. Narrow warps give the scans' carries
    across warps and chunks at these few rows."""
    rng = np.random.default_rng(nl + order)
    M = 0.5 * rng.standard_normal(shape)
    w = rng.standard_normal((nl + 1, shape[0]))
    ref = sig_gram_levels_ho if pallas_vjp else (
        lambda m, nl, order, _: signature_kern(m, nl, order, True))
    _, vjp = jax.vjp(lambda m: ref(m, nl, order, True), jnp.asarray(M))
    (wgrad,) = vjp(jnp.asarray(w))
    want = sig_gram_levels_ho(jnp.asarray(M), nl, order, True)
    Mt = torch.as_tensor(M)
    fwd = OrderModel(Mt, nl, order, lanes, max_warps, False)
    assert (fwd.W, fwd.C) == (2, 2)
    got = fwd.forward()
    assert scaled(got, want) < 1e-5
    plain = sg.sig_gram_levels_ho_ref(Mt, nl, order)
    pgrad = sg.sig_gram_levels_ho_bwd_ref(Mt, torch.as_tensor(w), nl, order)
    assert scaled(got, plain) < 1e-10
    # the kernel's K at this shape (1: every column's carries kept) and
    # ceil(sqrt(L1)) (its segments recomputed), as at larger shapes
    assert plan.order_segments(shape[1], nl, min(order, nl), shape[2],
                               8)[0] == 1
    for K in (None, math.isqrt(shape[1] - 1) + 1):
        ggrad = OrderModel(Mt, nl, order, lanes, max_warps, True).backward(
            torch.as_tensor(w), K)
        assert scaled(ggrad, wgrad) < 1e-5
        assert scaled(ggrad, pgrad) < 1e-10


@pytest.mark.parametrize("L1,K", [
    # K = 3 = ceil(sqrt(7)): segments of 3, 3 and 1 columns
    (7, 3),
    # one column: one segment, its checkpoint the zero carries
    (1, None),
    # a segment longer than M's columns (the kernel's K = ceil(sqrt(L1))
    # never is: the model takes K as given)
    (3, 5),
    # a segment a column: the checkpoints alone
    (4, 1),
])
def test_order_model_segments(L1, K):
    """The reverse sweep's segments where K does not divide L1, at one
    column, at a segment longer than L1 and at one column a segment (the
    kernel's K at small shapes: every column's carries kept): the
    model's backward (p = nl = 8, 2 warps of 2 lanes, 2 chunks) against
    ``jax.vjp`` through the JAX package's XLA ``signature_kern`` and the
    port's plain version, float64, scaled error 1e-10."""
    nl = order = 8
    rng = np.random.default_rng(L1)
    M = 0.5 * rng.standard_normal((2, L1, 5))
    w = rng.standard_normal((nl + 1, 2))
    _, vjp = jax.vjp(lambda m: signature_kern(m, nl, order, True),
                     jnp.asarray(M))
    (wgrad,) = vjp(jnp.asarray(w))
    Mt, wt = torch.as_tensor(M), torch.as_tensor(w)
    model = OrderModel(Mt, nl, order, 2, 2, True)
    assert (model.W, model.C) == (2, 2)
    got = model.backward(wt, K)
    assert scaled(got, wgrad) < 1e-10
    assert scaled(got, sg.sig_gram_levels_ho_bwd_ref(Mt, wt, nl, order)) < 1e-10


@pytest.mark.parametrize("K", [None, 4])
def test_order_model_float32_backward_at_20_levels(K):
    """p = nl = 20 in float32, where an early column's carries are small
    against the end's: the model's backward, which builds each column from
    a checkpoint of the carries before it (K = 1, the kernel's at this
    shape) or recomputes it from its segment's (K = 4 = ceil(sqrt(10))),
    stays within 5 times the plain version's own float32 error (both
    scaled against the plain version in float64). A reverse sweep that
    rebuilt the carries by subtracting each column's sums from the end
    carries was 22.5 times it on this draw."""
    rng = np.random.default_rng(0)
    M = torch.as_tensor(0.4 * rng.standard_normal((1, 10, 16)))
    w = torch.as_tensor(rng.standard_normal((21, 1)))
    want = sg.sig_gram_levels_ho_bwd_ref(M, w, 20, 20)
    plain = scaled(sg.sig_gram_levels_ho_bwd_ref(M.float(), w.float(), 20,
                                                 20).double(), want)
    got = OrderModel(M.float(), 20, 20, 32, 8, True).backward(w.float(), K)
    assert got.dtype == torch.float32
    assert scaled(got.double(), want) <= 5 * plain


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("nl,p,backward,slots", [
    # x, tsum, RA packed (1 + 2 + .. + 7), the scan slots, one grid
    (8, 8, False, 1 + 7 + 28 + 8 + 64),
    # x, mb, tsum/ec/rt, RA/CP/Rrow, the grids of levels 1..7 (1² + .. +
    # 7²), inj, two sets of [ptot, injc] and of prow
    (8, 8, True, 2 + 3 * 7 + 3 * 28 + 140 + 7 ** 2 + 2 * 8 + 2 * 7),
    # p < nl: levels 10.. keep 9 - 1 carries and 9² cells
    (10, 9, True, 2 + 3 * 9 + 3 * (36 + 8) + 285 + 8 ** 2 + 2 * 9 + 2 * 8),
    (127, 127, True, 2 + 3 * 126 + 3 * 8001 + 674751 + 126 ** 2 + 4 * 127
     - 2),
])
def test_order_slots_count_the_state(nl, p, backward, slots):
    """The packed slots a row keeps (``OrderLayout``): level m's carries
    min(p, m) - 1, its grid min(p, m)²; the count is the model's layout at
    every (nl, p) the instance takes a few of."""
    assert plan.order_slots(nl, p, backward) == slots
    for n, q in ((nl, p), (nl + 3, p), (max(nl, 12), 8)):
        q = min(q, n)
        assert plan.order_slots(n, q, backward) == Layout(n, q,
                                                          backward).total


@pytest.mark.parametrize("L1,L2,nl,itemsize,K,segments", [
    # every column's carries up to ORDER_CKPT_ALL_BYTES a matrix: 35 a row
    # at p = nl = 8 (the GPR's 49 x 49 in both dtypes), 209 at p = nl = 20
    (1, 49, 8, 4, 1, 1), (49, 49, 8, 4, 1, 49), (49, 49, 8, 8, 1, 49),
    (152, 49, 8, 4, 1, 152), (8, 150, 20, 4, 1, 8),
    # past it, segments of ceil(sqrt(L1))
    (153, 49, 8, 4, 13, 12), (77, 49, 8, 8, 9, 9), (9, 150, 20, 4, 3, 3),
    (20, 150, 20, 4, 5, 4), (149, 49, 20, 4, 13, 12),
])
def test_order_checkpoints_count_the_carry_sets(L1, L2, nl, itemsize, K,
                                                segments):
    """The backward's segments of K columns and its checkpoint region a
    row: a set of the carries over columns (T_m's nl - 1 and the RA
    carries: 35 at p = nl = 8, 209 at p = nl = 20) a segment and K - 1
    for a segment's columns past its first. K = 1 where the carries before
    every column take at most ORDER_CKPT_ALL_BYTES a matrix (no column
    recomputed), else ceil(sqrt(L1))."""
    nc = {8: 7 + 28, 20: 19 + 190}[nl]
    assert plan.order_carries(nl, nl) == nc
    assert plan.order_segments(L1, nl, nl, L2, itemsize) == (K, segments)
    assert (K == 1) == (L1 * nc * L2 * itemsize
                        <= plan.ORDER_CKPT_ALL_BYTES)
    assert plan.order_checkpoints(L1, nl, nl, L2, itemsize) == (
        segments + K - 1) * nc
    lay = Layout(12, 9, True)
    assert plan.order_carries(12, 9) == lay.ra0 + lay.rsum(13) - lay.ts


def test_order_constants_match_the_source():
    """plan.py's checkpoint budget is the kernel's."""
    src = (Path(plan.__file__).parents[2] / "csrc"
           / "sig_gram_order.cuh").read_text()
    shift = re.search(r"kOrderCkptAllBytes = 1 << (\d+);", src).group(1)
    assert 1 << int(shift) == plan.ORDER_CKPT_ALL_BYTES


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("backward", [False, True])
def test_order_plan_takes_one_warp_a_matrix(itemsize, backward):
    """p > 7: a block of ceil(L2 / 32) warps (at most 8) a matrix, one row a
    thread (one warp a matrix up to 32 rows). At p = 8 and a row a thread
    the register route, its carries (and the backward's E, CP and grids) in
    shared memory, where they fit; else every slot in shared memory after
    the small arrays where they fit; else the workspace, as many blocks as
    the 50 MB L2 holds regions, a block an SM where one region exceeds it.
    The forward's register and smem routes take a block a matrix. The
    backward keeps its checkpoints in a workspace region a block on every
    route (after the slots on the workspace route), its blocks at most
    what stays resident and what the workspace holds."""
    for B, L1, L2, nl, p in ((22500, 49, 49, 8, 8), (4, 20, 150, 10, 10),
                             (3, 7, 5, 127, 9), (1, 5, 40, 127, 127),
                             (300, 20, 150, 20, 20), (2, 3, 900, 8, 8),
                             (4, 20, 150, 8, 8), (2, 9, 240, 12, 8)):
        lp = plan.sig_gram_plan(B, L1, L2, nl, p, itemsize, backward)
        W = min(-(-L2 // 32), 8)
        assert (lp["S"], lp["R"], lp["bands"], lp["W"]) == (32, 1, 1, W)
        ckpt = (plan.order_checkpoints(L1, nl, p, L2, itemsize) * L2
                if backward else 0)
        assert lp["ckpt"] == ckpt
        reg = plan.order_slots(nl, p, backward, True) * L2
        reg_smem = itemsize * (plan.order_small(nl, p, W, True) + reg)
        area = plan.order_slots(nl, p, backward) * L2
        small = itemsize * plan.order_small(nl, p, W)
        if p == 8 and L2 <= 256 and reg_smem <= plan.SMEM_BYTES:
            route, smem, region, blocks = "register", reg_smem, ckpt, B
            assert (lp["area_smem"], lp["area"]) == (2, reg)
        elif small + area * itemsize <= plan.SMEM_BYTES:
            route, smem, region, blocks = ("smem", small + area * itemsize,
                                           ckpt, B)
            assert (lp["area_smem"], lp["area"]) == (True, area)
        else:
            route, smem, region = "workspace", small, area + ckpt
            blocks = min(B, plan.ORDER_L2_BYTES // (region * itemsize)
                         or 132)
            assert (lp["area_smem"], lp["area"]) == (False, area)
        if backward:
            blocks = min(blocks, plan.order_resident(W, smem),
                         plan.WORKSPACE_BYTES // (region * itemsize))
        assert (lp["route"], lp["smem"], lp["blocks"]) == (route, smem,
                                                           blocks)
        assert lp["work"] == blocks * region
        if route == "workspace":
            assert lp["work"] * itemsize <= max(
                plan.ORDER_L2_BYTES, 132 * region * itemsize)
    # the GPR's 150² pairs at L' = 49: the register route in both dtypes,
    # 35 slots a row forward (tsum, RA), 245 backward (also ec, the grids,
    # Rtot, Rrow); the backward's 49 sets of 35 carries a row (every
    # column's) in the workspace, on the blocks that stay resident: 4 an
    # SM in float32 (48 KB of shared memory a block), 2 in float64
    lp = plan.sig_gram_plan(11325, 49, 49, 8, 8, itemsize, backward)
    assert (lp["route"], lp["W"]) == ("register", 2)
    assert lp["area"] == (245 if backward else 35) * 49
    if backward:
        assert lp["blocks"] == 132 * (4 if itemsize == 4 else 2)
        assert lp["work"] == lp["blocks"] * 49 * 35 * 49
    else:
        assert (lp["blocks"], lp["work"]) == (11325, 0)
    # L2 = 150 at p = 10 leaves shared memory in the backward (both dtypes)
    # and in neither forward; p = nl = 20 there keeps 8 regions (slots and
    # checkpoints) in the L2 in float64; p = 8 in float64 leaves the
    # register route's shared memory in the backward
    lp = plan.sig_gram_plan(4, 20, 150, 10, 10, itemsize, backward)
    assert lp["route"] == ("workspace" if backward else "smem")
    lp = plan.sig_gram_plan(4, 20, 150, 8, 8, itemsize, backward)
    assert lp["route"] == ("workspace" if backward and itemsize == 8
                           else "register")
    if backward and itemsize == 8:
        lp = plan.sig_gram_plan(300, 20, 150, 20, 20, 8, True)
        assert (lp["route"], lp["blocks"]) == ("workspace", 8)


def test_order_plan_refuses_past_the_workspace():
    """One matrix whose rows' slots and checkpoints exceed WORKSPACE_BYTES
    has no plan (the wrapper raises ValueError naming the workspace): at p
    = nl = 127 and L1 = 5 the backward keeps 715,516 values a row and
    32,508 in its checkpoints (4 sets of 8,127 carries), so float32 takes
    358 rows and float64 179. The checkpoints grow as sqrt(L1): at 2^22
    columns 4,095 sets of 35 carries a row at p = 8, 18 MB a matrix of 32
    rows on the register route."""
    slots = plan.order_slots(127, 127, True)
    assert slots == 715516
    ckpt = plan.order_checkpoints(5, 127, 127, 358, 4)
    assert ckpt == 4 * 8127 == plan.order_checkpoints(5, 127, 127, 179, 8)
    assert [plan.WORKSPACE_BYTES // ((slots + ckpt) * i)
            for i in (4, 8)] == [358, 179]
    for itemsize in (4, 8):
        rows = plan.WORKSPACE_BYTES // ((slots + ckpt) * itemsize)
        assert plan.sig_gram_plan(1, 5, rows, 127, 127, itemsize, True)
        assert plan.sig_gram_plan(1, 5, rows + 1, 127, 127, itemsize,
                                  True) is None
    # the forward at the same shape keeps far less
    assert plan.sig_gram_plan(1, 5, 400, 127, 127, 4, False)
    assert plan.order_checkpoints(1 << 22, 8, 8, 32, 4) == 4095 * 35
    lp = plan.sig_gram_order_plan(1, 1 << 22, 32, 8, 8, 4, True)
    assert lp["route"] == "register" and lp["work"] == 4095 * 35 * 32


# -- the kernel layer against JAX ---------------------------------------------

NL, ORDER, C, M_IND = 8, 8, 3, 4


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-8, atol=1e-12)


def test_signature_rbf_order8_matches_jax():
    """SignatureRBF(2, 8, order=8): K(X), K(X, X2) and Kdiag(X) against the
    JAX package's XLA engine."""
    rng = np.random.default_rng(3)
    X = (0.3 * rng.standard_normal((3, 6, 2))).cumsum(1)
    X2 = (0.3 * rng.standard_normal((2, 5, 2))).cumsum(1)
    jk = jsk.SignatureRBF(2, NL, order=ORDER, lengthscales=[0.8, 1.2],
                          engine="xla")
    tk = tsk.SignatureRBF(2, NL, order=ORDER, lengthscales=[0.8, 1.2],
                          device="cpu")
    convert.load_jax_arrays(tk, leaves(jk))
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    want = jax.jit(lambda a, b: (jk.K(a), jk.K(a, b), jk.Kdiag(a)))(
        jnp.asarray(X), jnp.asarray(X2))
    for got, w in zip((tk.K(tX), tk.K(tX, tX2), tk.Kdiag(tX)), want):
        close(got, w)


def test_order8_elbo_gradient_matches_jax_grad():
    """The SVGP ELBO of SignatureRBF(2, 8, order=8) with inducing tensors
    and MultiClass(3): the value and every parameter's gradient against
    jax.grad."""
    rng = np.random.default_rng(8)
    F = NL * (NL + 1) // 2
    Z = 0.4 * rng.standard_normal((M_IND, F, 2, 2))
    X = (0.3 * rng.standard_normal((5, 6, 2))).cumsum(1)
    Y = rng.integers(0, C, 5)
    jk = jsk.SignatureRBF(2, NL, order=ORDER, lengthscales=[0.8, 1.2],
                          engine="xla")
    jm = jsvgp.SVGP.create(jk, jlik.MultiClass(C), jind.InducingTensors.create(
        jnp.asarray(Z), NL, True), C)
    jm = jm.replace(q_mu=jnp.asarray(rng.standard_normal((M_IND, C))),
                    q_sqrt=jnp.asarray(
                        np.tril(0.2 * rng.standard_normal((C, M_IND, M_IND)))
                        + 0.8 * np.eye(M_IND)))
    tk = tsk.SignatureRBF(2, NL, order=ORDER, lengthscales=[0.8, 1.2],
                          device="cpu")
    tm = tsvgp.SVGP.create(tk, tlik.MultiClass(C), tind.InducingTensors.create(
        torch.as_tensor(Z), NL, True), C, device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    elbo = tm.elbo(tX, tY, num_data=20)
    jelbo, jgrad = jax.jit(jax.value_and_grad(
        lambda m, x, y: m.elbo(x, y, num_data=20)))(
            jm, jnp.asarray(X), jnp.asarray(Y))
    close(elbo, jelbo)
    want = leaves(jgrad)
    elbo.backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        if name == "q_sqrt":  # only the lower triangle is used
            g, w = torch.tril(g), np.tril(w)
        close(g, w)
