"""sig_gram past order 7: the run-time-order instance
(``csrc/sig_gram_order.cuh``, ``plan.sig_gram_order_plan``).

- A float64 torch model of the kernels' loop order: a block of warps a
  matrix, a row a thread, the rows past the block in chunks; every scan
  the warps' scans, their totals added across the warps and carried from
  chunk to chunk; every value a row keeps in packed slots laid out as
  ``OrderLayout``; the forward's grid updated in place; the forward sweep,
  then the reverse sweep that rebuilds each column's grids by subtraction
  and walks the adjoint down the levels. Held at (num_levels, order) (8, 8) and (10, 9) against the
  JAX package's Pallas kernels (``sig_gram_levels_ho``, interpret mode)
  and ``jax.vjp`` (through their custom VJP, ``_bwd_kernel_ho``, at
  (8, 8); through the XLA ``signature_kern`` at (10, 9)), scaled error 1e-5
  (their in-kernel triangular products accumulate in float32 even on
  float64 inputs, as ``test_torch_sig_gram.py`` states), and against the
  port's plain version and autograd, scaled error 1e-10 (float64, other
  summation order only).
- The plan at p > 7: the packed slots, the warps a block, the register
  route at p = 8, the shared-memory route where a matrix's slots fit and
  the workspace route with its L2-bounded grid where they do not, and the
  workspace refusal. (The register route runs the same loop order with the
  grid and the adjoint's pieces in registers.)
- ``SignatureRBF(2, 8, order=8)``: K, Kdiag and the SVGP ELBO's gradients
  on the CPU against the JAX package, rtol 1e-8 (as ``test_torch_svgp.py``).
"""

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

    def sweep(self, g, backward, acc):
        ly = self.ly
        self.zero(ly.ts, ly.ra0 + ly.rsum(self.nl + 1))
        for i in range(self.L1):
            self.stage(i)
            for c in range(self.C):
                self.st(g, c, self.ld(X_SLOT, c))
            for m in range(2, self.nl + 1):
                self.forward_level(
                    m, g, ly.ec(m, 0) if backward else ly.buf0,
                    0 if m < self.nl else 2 if backward else 1, acc)

    def forward(self):
        acc = [0] * self.C
        self.sweep(self.ly.g0, False, acc)
        rows = self.mem[:, self.ly.ts:self.ly.ts + self.nl - 1].sum(-1)
        top = sum(a.sum(-1) for a in acc)
        return torch.cat([torch.ones(1, self.B, dtype=self.M.dtype), rows.T,
                          top[None]])

    def rebuild(self, m):
        p, ly, ld, st, inv = self.p, self.ly, self.ld, self.st, self.inv
        Rp, Rm = min(p, m - 1), min(p, m)
        write = m < self.nl
        gp, gc, e0 = ly.grid(m - 1), ly.grid(m) if write else 0, ly.ec(m, 0)
        for c in range(self.C):
            x = ld(X_SLOT, c)
            for q in range(Rm - 1):
                st(e0 + 1 + q, c, sum(ld(gp + a * Rp + q, c)
                                      for a in range(Rp)))
            tot = 0
            for a in range(Rp):
                moves = a + 1 < Rm
                xa = x * inv[a + 2]
                rs = 0
                for b in range(Rp):
                    v = ld(gp + a * Rp + b, c)
                    rs = rs + v
                    if write and moves and b + 1 < Rm:
                        st(gc + (a + 1) * Rm + b + 1, c, xa * inv[b + 2] * v)
                tot = tot + rs
                if moves:
                    r = ld(ly.ra(m, a), c) - rs
                    st(ly.ra(m, a), c, r)
                    if write:
                        st(gc + (a + 1) * Rm, c, xa * r)
            ts = ld(ly.tsum(m), c) - tot
            st(ly.tsum(m), c, ts)
            st(e0, c, ts)
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

    def backward(self, w):
        ly, nl = self.ly, self.nl
        self.sweep(ly.g0, True, [0] * self.C)
        self.zero(ly.rt0, ly.rt0 + nl - 1)
        self.zero(ly.rr0, ly.rr0 + ly.rsum(nl + 1))
        Mbar = torch.zeros_like(self.M)
        for i in reversed(range(self.L1)):
            self.stage(i)
            for c in range(self.C):
                self.st(ly.grid(1), c, self.ld(X_SLOT, c))
            for m in range(2, nl + 1):
                self.rebuild(m)
            for m in range(nl, 0, -1):
                self.adjoint(m, w[m], Mbar, i)
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
    ggrad = OrderModel(Mt, nl, order, lanes, max_warps, True).backward(
        torch.as_tensor(w))
    assert scaled(got, want) < 1e-5
    assert scaled(ggrad, wgrad) < 1e-5
    plain = sg.sig_gram_levels_ho_ref(Mt, nl, order)
    pgrad = sg.sig_gram_levels_ho_bwd_ref(Mt, torch.as_tensor(w), nl, order)
    assert scaled(got, plain) < 1e-10
    assert scaled(ggrad, pgrad) < 1e-10


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


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("backward", [False, True])
def test_order_plan_takes_one_warp_a_matrix(itemsize, backward):
    """p > 7: a block of ceil(L2 / 32) warps (at most 8) a matrix, one row a
    thread (one warp a matrix up to 32 rows). At p = 8 and a row a thread
    the register route, its carries (and the backward's E, CP and grids) in
    shared memory, where they fit; else every slot in shared memory after
    the small arrays where they fit, a block a matrix; else the workspace,
    as many blocks as the 50 MB L2 holds regions, a block an SM where one
    region exceeds it."""
    for B, L1, L2, nl, p in ((22500, 49, 49, 8, 8), (4, 20, 150, 10, 10),
                             (3, 7, 5, 127, 9), (1, 5, 40, 127, 127),
                             (300, 20, 150, 20, 20), (2, 3, 900, 8, 8),
                             (4, 20, 150, 8, 8), (2, 9, 240, 12, 8)):
        lp = plan.sig_gram_plan(B, L1, L2, nl, p, itemsize, backward)
        W = min(-(-L2 // 32), 8)
        assert (lp["S"], lp["R"], lp["bands"], lp["W"]) == (32, 1, 1, W)
        reg = plan.order_slots(nl, p, backward, True) * L2
        reg_smem = itemsize * (plan.order_small(nl, p, W, True) + reg)
        if p == 8 and L2 <= 256 and reg_smem <= plan.SMEM_BYTES:
            assert (lp["route"], lp["area_smem"], lp["area"], lp["smem"],
                    lp["blocks"], lp["work"]) == ("register", 2, reg,
                                                  reg_smem, B, 0)
            continue
        area = plan.order_slots(nl, p, backward) * L2
        small = itemsize * plan.order_small(nl, p, W)
        assert lp["area"] == area
        if small + area * itemsize <= plan.SMEM_BYTES:
            assert lp["route"] == "smem" and lp["area_smem"] is True
            assert (lp["smem"], lp["blocks"], lp["work"]) == (
                small + area * itemsize, B, 0)
            continue
        region = area * itemsize
        fit = plan.ORDER_L2_BYTES // region
        assert lp["route"] == "workspace" and not lp["area_smem"]
        assert lp["smem"] == small
        assert lp["blocks"] == min(B, fit or 132)
        assert lp["work"] == lp["blocks"] * area
        assert lp["work"] * itemsize <= max(plan.ORDER_L2_BYTES,
                                            132 * region)
    # the GPR's 150² pairs at L' = 49: the register route in both dtypes,
    # 35 slots a row forward (tsum, RA), 245 backward (also ec, the grids,
    # Rtot, Rrow)
    lp = plan.sig_gram_plan(11325, 49, 49, 8, 8, itemsize, backward)
    assert (lp["route"], lp["W"], lp["blocks"]) == ("register", 2, 11325)
    assert lp["area"] == (245 if backward else 35) * 49
    # L2 = 150 at p = 10 leaves shared memory in the backward (both dtypes)
    # and in neither forward; p = nl = 20 there keeps 12 regions in the L2
    # in float64; p = 8 in float64 leaves the register route's shared
    # memory in the backward
    lp = plan.sig_gram_plan(4, 20, 150, 10, 10, itemsize, backward)
    assert lp["route"] == ("workspace" if backward else "smem")
    lp = plan.sig_gram_plan(4, 20, 150, 8, 8, itemsize, backward)
    assert lp["route"] == ("workspace" if backward and itemsize == 8
                           else "register")
    if backward and itemsize == 8:
        lp = plan.sig_gram_plan(300, 20, 150, 20, 20, 8, True)
        assert (lp["route"], lp["blocks"]) == ("workspace", 12)


def test_order_plan_refuses_past_the_workspace():
    """One matrix whose rows' slots exceed WORKSPACE_BYTES has no plan (the
    wrapper raises ValueError naming the workspace): at p = nl = 127 the
    backward keeps 715,516 values a row, so float32 takes 375 rows and
    float64 187."""
    slots = plan.order_slots(127, 127, True)
    assert slots == 715516
    assert [plan.WORKSPACE_BYTES // (slots * i) for i in (4, 8)] == [375, 187]
    for itemsize in (4, 8):
        rows = plan.WORKSPACE_BYTES // (slots * itemsize)
        assert plan.sig_gram_plan(1, 5, rows, 127, 127, itemsize, True)
        assert plan.sig_gram_plan(1, 5, rows + 1, 127, 127, itemsize,
                                  True) is None
    # the forward at the same shape keeps far less
    assert plan.sig_gram_plan(1, 5, 400, 127, 127, 4, False)


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
