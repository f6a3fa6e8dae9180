"""Every sequence length and order: the sig_gram kernels' segments and
bands, orders 4-7 past 7 levels, the pairs route past the fused Grams'
1024 rows and between two lengths, and the Goursat grids past 2^15 refined
points a side.

- ``plan.sig_gram_plan`` at every L2 from 1 to 5000 and at each design's
  edges (8 R, 16 R, 32 R, each band boundary, 1024 / 1025), both itemsizes,
  forward and backward; the constants it shares with ``csrc/``.
- A float64 torch model of the band design (``csrc/sig_gram.cuh``'s
  BandGroup, ``csrc/sig_gram_bwd.cuh``): the run-length DP and its reverse
  sweep over one band's rows at a time, each row scan started from the
  carry its neighbour left at that column; the forward pass down the
  bands keeping every column's prefix carries, the reverse pass up them,
  rebuilding from those carries and taking its suffix carries from the
  band below. Held against ``signature_kern`` and autograd, scaled error
  1e-10 (float64, other summation order only).
- The pairs route (``SignatureKernel._pairs_levels``) in blocks under a
  byte budget, the triangle of a symmetric Gram, the shorter side on the
  rows; chunked against unchunked, values and gradients, 1e-12.
- Against the JAX package in float64 on the CPU (its XLA engine, its
  default CPU route): ``seq_covariances`` of inducing sequences of length
  8 against data of L = 1100 (the orientation), a Gram at L = 1100 (past
  1024 rows), orders 4-7 at num_levels = 8, each with its gradients; rtol
  1e-10.
- The Goursat forward's plans and the gradient's workspace past 2^15
  refined points a side, and the sweeps' position bound.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import inducing as jind
from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import goursat as tgs
from gpsig_tpu_torch.ops.cuda import plan

torch.set_num_threads(1)
RTOL = 1e-10
CSRC = Path(tsk.__file__).resolve().parents[1] / "csrc"


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def walks(rng, n, L, d=2):
    """Steps shrinking like 1/√L: the levels stay as large as at L = 50."""
    return (0.3 * np.sqrt(50 / L) * rng.standard_normal((n, L, d))).cumsum(1)


def scaled(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(1e-300, np.abs(want).max()))


# -- the plans ----------------------------------------------------------------

ORDERS = [(1, 4), (2, 5), (3, 4), (2, 10), (7, 7)]


@pytest.mark.parametrize("p,nl", ORDERS)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("backward", [False, True])
def test_sig_gram_plan_covers_every_length(p, nl, itemsize, backward):
    """Every L2 from 1 to 5000, at a batch that fills the card and one
    that does not: segments where 32 lanes cover the rows at the state's
    most rows a lane R (the fewest lanes; the register path's forward at
    fewer rows a lane where that launches more warps), else the fewest
    bands of 32 R rows on up to 8 warps; the area the layout needs, in
    shared memory where it fits, else a workspace within
    WORKSPACE_BYTES."""
    R = plan.sig_gram_rows_per_lane(p, nl, itemsize, backward)
    K = plan.sig_gram_carries(nl, p)
    choose = not backward and nl <= plan.REGISTER_LEVELS
    for B, L2 in ((B, L2) for B in (100, 10 ** 5)
                  for L2 in range(1, 5001)):
        lp = plan.sig_gram_plan(B, 50, L2, nl, p, itemsize, backward)
        fits = [S for S in plan.SEG_LANES if S * R >= L2]
        if fits and choose:
            assert (lp["bands"], lp["W"]) == (1, 1)
            assert lp["R"] <= R and lp["S"] * lp["R"] >= L2
            # a short batch: the most warps (32 lanes), the fewest rows
            # a lane that cover L2; a long one: the most rows a lane
            assert (lp["S"], lp["R"]) == (
                (32, next(r for r in (2, 4, 8) if 32 * r >= L2))
                if B == 100 else (fits[0], R))
        elif fits:
            assert (lp["S"], lp["R"], lp["bands"], lp["W"]) == \
                (fits[0], R, 1, 1)
        else:
            assert lp["R"] == R
            bands = -(-L2 // (32 * R))
            assert (lp["S"], lp["bands"]) == (32, bands)
            assert lp["W"] == min(bands, plan.SIG_GRAM_BAND_WARPS)
            if nl > plan.REGISTER_LEVELS:
                slots = plan.deep_slots(nl, p, backward)
            elif backward:
                nlm = plan.sig_gram_levels_bound(nl)
                slots = nlm + (nlm - 1) * max(p - 1, 1)
            else:
                slots = 0
            assert lp["area"] == ((2 if backward else 1) * (bands - 1) * 50
                                  * K + bands * slots * R * 32)
        assert lp["smem"] <= plan.SMEM_BYTES
        if lp["area_smem"]:
            assert lp["work"] == 0
        else:
            assert 0 < lp["work"] * itemsize <= plan.WORKSPACE_BYTES
            assert lp["blocks"] <= plan.SIG_GRAM_MAX_BLOCKS


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sig_gram_plan_edges(itemsize):
    """The design changes exactly at 8 R, 16 R, 32 R and at each band
    boundary k 32 R; the old 1024-row bound is no edge of its own."""
    for p, nl in ORDERS:
        for backward in (False, True):
            R = plan.sig_gram_rows_per_lane(p, nl, itemsize, backward)

            def at(L2):  # a batch that fills the card: R rows a lane
                lp = plan.sig_gram_plan(10 ** 5, 20, L2, nl, p, itemsize,
                                        backward)
                return lp["S"], lp["bands"]

            assert at(8 * R) == (8, 1) and at(8 * R + 1) == (16, 1)
            assert at(16 * R) == (16, 1) and at(16 * R + 1) == (32, 1)
            assert at(32 * R) == (32, 1) and at(32 * R + 1) == (32, 2)
            for k in range(2, 9):
                assert at(k * 32 * R) == (32, k)
                assert at(k * 32 * R + 1) == (32, k + 1)
            assert at(1024)[1] == -(-1024 // (32 * R))
            assert at(1025)[1] == -(-1025 // (32 * R))


def test_sig_gram_rows_per_lane():
    """R from the DP state at the level bound (4 up to 4 levels, else 7)
    within 160 registers: the flagship diagonal's order 2 at nl = 5 and
    orders 2 and 3 at nl = 4 take 8 rows a lane (one warp takes 256 rows:
    L' = 149 in one warp), the backward's larger state 2 at order 2; past 7
    levels 2."""
    rows = plan.sig_gram_rows_per_lane
    assert rows(2, 5, 4, False) == 8
    assert rows(2, 4, 4, False) == 8
    assert rows(3, 4, 4, False) == 8
    assert rows(3, 7, 4, False) == 4
    assert rows(1, 4, 4, True) == 8
    assert rows(1, 5, 4, True) == 4
    assert rows(2, 4, 4, True) == 2
    assert rows(2, 4, 8, False) == 4
    assert rows(1, 10, 4, False) == rows(7, 8, 8, True) == 2


@pytest.mark.parametrize("B,L1,L2,nl,p,S,R", [
    (2048, 49, 49, 5, 2, 32, 2),     # the flagship diagonal: 2048 warps
    (2048, 49, 49, 5, 1, 32, 2),
    (2000, 2999, 7, 4, 1, 32, 2),    # inducing sequences against L = 3000
    (22500, 49, 49, 4, 2, 8, 8),     # a GPR's 150² pairs fill the card
    (2048, 149, 149, 4, 3, 32, 8)])  # L' = 149 at order 3: one warp
def test_sig_gram_forward_takes_the_warps_it_needs(B, L1, L2, nl, p, S, R):
    """The forward's segments at the main path's shapes: a batch whose
    packed segments would launch fewer than SIG_GRAM_TARGET_WARPS warps
    takes one matrix a warp at the fewest rows a lane (latency-bound: more
    warps hide it); a batch that fills the card packs matrices at the most
    rows a lane."""
    lp = plan.sig_gram_plan(B, L1, L2, nl, p, 4, False)
    assert (lp["S"], lp["R"], lp["bands"]) == (S, R, 1)


def test_sig_gram_constants_match_the_source():
    """plan.py's sig_gram constants are the kernels': the band warps, the
    deep path's rows a lane, the register budget, the level bound, the
    templated paths' order bound, past which the run-time-order instance
    takes every order (its warps a block)."""
    sg = (CSRC / "sig_gram.cuh").read_text()
    common = (CSRC / "common.cuh").read_text()
    deep = (CSRC / "deep_levels.cuh").read_text()
    order = (CSRC / "sig_gram_order.cuh").read_text()
    entry = (CSRC / "sig_gram.cu").read_text()

    def const(src, name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert const(sg, "kSgBandWarps") == plan.SIG_GRAM_BAND_WARPS
    assert const(sg, "kSgDeepRows") == plan.SIG_GRAM_DEEP_ROWS
    assert const(common, "kSegStateRegs") == plan.SEG_STATE_REGS
    assert const(sg, "kSgStateRegs") == plan.SIG_GRAM_STATE_REGS
    assert const(common, "kRlLevels") == plan.REGISTER_LEVELS
    assert const(deep, "kDeepLevels") == plan.SIG_GRAM_MAX_LEVELS
    assert const(deep, "kDeepOrder") == plan.SIG_GRAM_MAX_ORDER
    assert const(order, "kOrderWarps") == plan.SIG_GRAM_ORDER_WARPS
    assert const(order, "kOrderRegP") == plan.ORDER_REGISTER_P
    assert "if (P > kDeepOrder)" in entry
    assert plan.sig_gram_plan(4, 20, 49, 8, plan.SIG_GRAM_MAX_ORDER + 1, 8,
                              True)["R"] == 1


# -- a float64 model of the band design ---------------------------------------

class BandScans:
    """One band's row scans (BandGroup): an exclusive prefix or suffix over
    the band's rows started from the carry the band above (pin) or below
    (sin) left at this column; the band's own carries, the carry plus its
    sum, kept by (column, scan)."""

    def __init__(self, pin=None, sin=None):
        self.pin, self.sin = pin, sin
        self.pout, self.sout = {}, {}

    def column(self, j):
        self.j, self.kp, self.ks = j, 0, 0

    def prefix(self, v):
        frm = self.pin[self.j, self.kp] if self.pin is not None else 0.0
        self.pout[self.j, self.kp] = frm + v.sum()
        self.kp += 1
        return frm + torch.cumsum(v, 0) - v

    def suffix(self, v):
        frm = self.sin[self.j, self.ks] if self.sin is not None else 0.0
        self.sout[self.j, self.ks] = frm + v.sum()
        self.ks += 1
        return frm + v.flip(0).cumsum(0).flip(0) - v


def _grid(z, P):
    return [[z] * P for _ in range(P)]


def band_forward(Mb, P, nl, g):
    """common.cuh's rl_forward over one band's entries Mb [L1, rows]
    (column j = Mb[j]): the end carries (tsum, ra)."""
    z = Mb.new_zeros(Mb.shape[1])
    grid, tsum = _grid(z, P), [z] * nl
    ra = [[z] * P for _ in range(nl)]
    for j in range(Mb.shape[0]):
        g.column(j)
        m = Mb[j]
        grid[0][0] = m
        for M in range(2, nl + 1):
            Rm, Rp = min(P, M), min(P, M - 1)
            tot = sum(grid[a][b] for a in range(Rp) for b in range(Rp))
            colpre, rowsum = [], []
            for q in range(Rm - 1):
                colpre.append(g.prefix(sum(grid[a][q] for a in range(Rp))))
                rowsum.append(sum(grid[q][a] for a in range(Rp)))
            pre = g.prefix(tsum[M - 2])
            new = _grid(z, P)
            for a in range(1, Rm):
                for b in range(1, Rm):
                    new[a][b] = m / ((a + 1) * (b + 1)) * grid[a - 1][b - 1]
                new[a][0] = m / (a + 1) * ra[M - 2][a - 1]
                new[0][a] = m / (a + 1) * colpre[a - 1]
            new[0][0] = m * pre
            tsum[M - 2] = tsum[M - 2] + tot
            for q in range(Rm - 1):
                ra[M - 2][q] = ra[M - 2][q] + rowsum[q]
            grid = new
        Rm = min(P, nl)
        tsum[nl - 1] = tsum[nl - 1] + sum(grid[a][b] for a in range(Rm)
                                          for b in range(Rm))
    return tsum, ra


def band_reverse(Mb, P, nl, w, tsum, ra, g):
    """common.cuh's rl_reverse over one band from its end carries: M̄ of
    the band's entries. w[m] is the cotangent of level m + 1."""
    z = Mb.new_zeros(Mb.shape[1])
    tsum, ra = list(tsum), [list(r) for r in ra]
    rtot, rrow = [z] * nl, [[z] * P for _ in range(nl)]
    st, pre, colpre = [None] * nl, [None] * nl, [[None] * P
                                                for _ in range(nl)]
    inj, ptot, prow = _grid(z, P), z, [z] * P
    Mbar = torch.zeros_like(Mb)
    for j in range(Mb.shape[0] - 1, -1, -1):
        g.column(j)
        m = Mb[j]
        mbar = z
        st[0] = _grid(z, P)
        st[0][0][0] = m
        for M in range(2, nl + 1):  # rebuild
            Rm, Rp = min(P, M), min(P, M - 1)
            prev = st[M - 2]
            tsum[M - 2] = tsum[M - 2] - sum(prev[a][b] for a in range(Rp)
                                            for b in range(Rp))
            for q in range(Rm - 1):
                ra[M - 2][q] = ra[M - 2][q] - sum(prev[q][a]
                                                  for a in range(Rp))
                colpre[M - 2][q] = g.prefix(sum(prev[a][q]
                                                for a in range(Rp)))
            pre[M - 2] = g.prefix(tsum[M - 2])
            if M < nl:
                cur = _grid(z, P)
                for a in range(1, Rm):
                    for b in range(1, Rm):
                        cur[a][b] = (m / ((a + 1) * (b + 1))
                                     * prev[a - 1][b - 1])
                    cur[a][0] = m / (a + 1) * ra[M - 2][a - 1]
                    cur[0][a] = m / (a + 1) * colpre[M - 2][a - 1]
                cur[0][0] = m * pre[M - 2]
                st[M - 1] = cur
        for M in range(nl, 0, -1):  # adjoint
            Rm = min(P, M)
            A = [[z + w[M - 1] for _ in range(Rm)] for _ in range(Rm)]
            if M < nl:
                Rn = min(P, M + 1)
                for a in range(Rm):
                    for b in range(Rm):
                        v = rtot[M - 1] + inj[a][b]
                        if a + 1 < Rn:
                            v = v + rrow[M - 1][a]
                        A[a][b] = A[a][b] + v
                rtot[M - 1] = rtot[M - 1] + g.suffix(ptot)
                for q in range(Rn - 1):
                    rrow[M - 1][q] = rrow[M - 1][q] + prow[q]
            if M >= 2:
                Rp = min(P, M - 1)
                for a in range(Rp):
                    for b in range(Rp):
                        inj[a][b] = z
                mbar = mbar + A[0][0] * pre[M - 2]
                for q in range(1, Rm):
                    c = 1.0 / (q + 1)
                    mbar = mbar + c * (A[q][0] * ra[M - 2][q - 1]
                                       + A[0][q] * colpre[M - 2][q - 1])
                    sfx = g.suffix(m * c * A[0][q])
                    for a in range(Rp):
                        inj[a][q - 1] = inj[a][q - 1] + sfx
                for a in range(1, Rm):
                    for b in range(1, Rm):
                        c = 1.0 / ((a + 1) * (b + 1))
                        mbar = mbar + c * A[a][b] * st[M - 2][a - 1][b - 1]
                        inj[a - 1][b - 1] = inj[a - 1][b - 1] + m * c * A[a][b]
                ptot = m * A[0][0]
                prow = [m / (q + 2) * A[q + 1][0] for q in range(Rm - 1)]
            else:
                mbar = mbar + A[0][0]
        Mbar[j] = mbar
    return Mbar


def banded(M, P, nl, band, w):
    """The band design on one matrix M [L1, L2]: levels [nl + 1] and M̄."""
    edges = list(range(0, M.shape[1], band))
    fwd, ends = [], []
    for k, b0 in enumerate(edges):
        g = BandScans(pin=fwd[k - 1].pout if k else None)
        ends.append(band_forward(M[:, b0:b0 + band], P, nl, g))
        fwd.append(g)
    levels = torch.stack([M.new_ones(())] + [
        sum(tsum[m].sum() for tsum, _ in ends) for m in range(nl)])
    Mbar, below = torch.zeros_like(M), None
    for k in range(len(edges) - 1, -1, -1):
        b0 = edges[k]
        g = BandScans(pin=fwd[k - 1].pout if k else None,
                      sin=below.sout if below is not None else None)
        Mbar[:, b0:b0 + band] = band_reverse(M[:, b0:b0 + band], P, nl, w,
                                             *ends[k], g)
        below = g
    return levels, Mbar


@pytest.mark.parametrize("L1,L2,band,P,nl", [
    (6, 11, 11, 1, 4), (6, 11, 4, 1, 4), (7, 13, 5, 2, 4), (5, 12, 3, 2, 5),
    (6, 10, 4, 3, 4), (5, 9, 2, 3, 7), (4, 17, 6, 4, 5), (5, 8, 3, 5, 6)])
def test_band_model_matches_the_plain_dp(L1, L2, band, P, nl):
    """The band design's recursion, one band at a time, against
    signature_kern (levels) and autograd (M̄); float64, scaled error
    1e-10."""
    rng = np.random.default_rng(L1 * 100 + L2)
    M = torch.as_tensor(0.4 * rng.standard_normal((L1, L2)))
    w = torch.as_tensor(rng.standard_normal(nl))
    levels, Mbar = banded(M, P, nl, band, w)
    Mg = M.clone().requires_grad_()
    want = sigops.signature_kern(Mg, nl, P)
    (wbar,) = torch.autograd.grad(want[1:], Mg, w)
    assert scaled(levels, want.detach()) < RTOL
    assert scaled(Mbar, wbar) < RTOL


# -- the pairs route ------------------------------------------------------------

def _spy(monkeypatch, kern):
    """Record the increment matrices' shapes the kernel layer reduces."""
    shapes = []
    reduce = kern._sig_gram

    def record(M):
        shapes.append(tuple(M.shape))
        return reduce(M)

    monkeypatch.setattr(kern, "_sig_gram", record)
    return shapes


@pytest.mark.parametrize("order", [1, 2])
def test_pairs_route_chunks_within_its_budget(monkeypatch, order):
    """Past the fused Grams' rows (MAX_ROWS lowered to 10 here) and between
    two lengths the pairs route builds its matrices in blocks of at most
    PAIRS_CHUNK_BYTES, the shorter side last (the rows), a symmetric Gram
    its triangle only; chunked equals unchunked, values and gradients."""
    rng = np.random.default_rng(3)
    X = torch.tensor(walks(rng, 7, 14), requires_grad=True)
    Z = torch.tensor(walks(rng, 3, 6), requires_grad=True)
    kern = tsk.SignatureRBF(2, 3, order=order, lengthscales=[0.8, 1.2],
                            device="cpu")

    def run(shapes=None):
        out = (kern.K(X), kern.K(Z, X), kern.K(X, Z))
        forward = list(shapes or ())  # the backward recomputes each chunk
        loss = sum((o * (1 + torch.arange(o.numel()).reshape(o.shape)))
                   .sum() for o in out)
        return out, torch.autograd.grad(loss, (X, Z,
                                               kern.raw_lengthscales)), forward

    monkeypatch.setattr(plan, "MAX_ROWS", 10)
    whole, gwhole, _ = run()
    budget = 4 * 13 * 13 * 8
    monkeypatch.setattr(tsk, "PAIRS_CHUNK_BYTES", budget)
    chunked, gchunked, shapes = run(_spy(monkeypatch, kern))
    for a, b in zip(chunked + gchunked, whole + gwhole):
        assert scaled(a.detach(), b.detach()) < 1e-12
    mats = [s for s in shapes if s[1:] == (13, 13)]
    # K(X)'s triangle, and at order 2 the sig_gram diagonal of X in each of
    # the three calls
    assert sum(s[0] for s in mats) == 7 * 8 // 2 + (3 * 7 if order > 1
                                                    else 0)
    assert all(s[0] * s[1] * s[2] * 8 <= budget for s in shapes)
    # the two-length Grams: [13, 5], the short side on the rows (and at
    # order 2 Z's own diagonal, [5, 5])
    assert {s[1:] for s in shapes} == ({(13, 13), (13, 5), (5, 5)}
                                       if order > 1 else {(13, 13), (13, 5)})


def test_pairs_route_keeps_its_matrices_when_unsplit(monkeypatch):
    """Within the budget the pairs route is one block and no checkpoint:
    the backward reuses the forward's matrices (one sig_gram launch a
    direction, as before chunking)."""
    calls = []
    reduce = tsk.checkpoint

    def spy(*args, **kw):
        calls.append(1)
        return reduce(*args, **kw)

    monkeypatch.setattr(tsk, "checkpoint", spy)
    rng = np.random.default_rng(4)
    X = torch.tensor(walks(rng, 4, 9), requires_grad=True)
    kern = tsk.SignatureRBF(2, 8, device="cpu")  # past 7 levels: pairs
    kern.K(X).sum().backward()
    assert calls == [] and torch.isfinite(X.grad).all()


# -- against the JAX package ----------------------------------------------------

def kernel_pair(ctor, nl, seed=0, **kw):
    jk = getattr(jsk, ctor)(2, nl, engine="xla", **kw)
    rng = np.random.default_rng(seed)
    jk = jk.replace(raw_sigma=jnp.asarray(rng.normal(0.5, 0.3)),
                    raw_variances=jnp.asarray(rng.normal(0.0, 0.5, nl + 1)))
    tk = getattr(tsk, ctor)(2, nl, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


def _grads(fn, *arrays):
    """fn's outputs and the gradient of Σ c·out (fixed weights c) in each
    array, by torch autograd."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    loss = sum((o * torch.linspace(0.5, 1.5, o.numel(), dtype=o.dtype)
                .reshape(o.shape)).sum() for o in out)
    return out, torch.autograd.grad(loss, ts)


def _jax_grads(fn, *arrays):
    def loss(*xs):
        out = fn(*xs)
        return sum((o * jnp.linspace(0.5, 1.5, o.size).reshape(o.shape))
                   .sum() for o in out)

    return fn(*arrays), jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *arrays)


@pytest.mark.parametrize("order", [1, 2])
def test_two_lengths_at_L1100_match_jax(order):
    """seq_covariances of 3 inducing sequences of length 8 against 2 data
    sequences of L = 1100: the two-length Gram's matrices lie [1099, 7]
    (the short side on the rows); values and the gradients in Z and X."""
    jk, tk = kernel_pair("SignatureRBF", 3, order=order,
                         lengthscales=[0.8, 1.2])
    rng = np.random.default_rng(11)
    Z, X = walks(rng, 3, 8), walks(rng, 2, 1100)
    got, gg = _grads(tk.seq_covariances, Z, X)
    want, wg = _jax_grads(jax.jit(jk.seq_covariances), jnp.asarray(Z),
                          jnp.asarray(X))
    for a, b in zip((*got, *gg), (*want, *wg)):
        assert scaled(a.detach(), b) < RTOL


@pytest.mark.parametrize("order", [1, 2])
def test_gram_past_1024_rows_matches_jax(order):
    """K(X) of 2 sequences of L = 1100 (1099 rows, past the fused Grams'
    1024: the pairs route), normalised, and its gradient in X."""
    jk, tk = kernel_pair("SignatureRBF", 3, order=order,
                         lengthscales=[0.8, 1.2])
    rng = np.random.default_rng(12)
    X = walks(rng, 2, 1100)
    got, gg = _grads(lambda x: (tk.K(x),), X)
    want, wg = _jax_grads(jax.jit(lambda x: (jk.K(x),)), jnp.asarray(X))
    assert scaled(got[0].detach(), want[0]) < RTOL
    assert scaled(gg[0], wg[0]) < RTOL


@pytest.mark.parametrize("order", [4, 5, 6, 7])
def test_orders_4_to_7_past_7_levels_match_jax(order):
    """num_levels = 8 at orders 4-7 (p > 3 past 7 levels, which the kernels
    refused before): K(X, X2), the normalised K(X) and the inducing
    sequences' Kuf, with the gradients in X and X2."""
    jk, tk = kernel_pair("SignatureRBF", 8, order=order,
                         lengthscales=[0.8, 1.2])
    rng = np.random.default_rng(13 + order)
    X, X2 = walks(rng, 3, 10), walks(rng, 2, 9)
    got, gg = _grads(lambda a, b: (tk.K(a, b), tk.K(a)), X, X2)
    want, wg = _jax_grads(jax.jit(lambda a, b: (jk.K(a, b), jk.K(a))),
                          jnp.asarray(X), jnp.asarray(X2))
    for a, b in zip((*got, *gg), (*want, *wg)):
        assert scaled(a.detach(), b) < RTOL
    Zs = walks(rng, 2, 5)
    jf = jind.InducingSequences.create(jnp.asarray(Zs))
    tf = tind.InducingSequences.create(torch.as_tensor(Zs))
    want = jax.jit(lambda x: jf.covariances(jk, x))(jnp.asarray(X))
    for a, b in zip(tf.covariances(tk, torch.as_tensor(X)), want):
        assert scaled(a.detach(), b) < RTOL


# -- Goursat past 2^15 refined points a side ----------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
def test_goursat_plans_past_2_15_refined_points(itemsize):
    """[2, 4100] at dyadic order 3 (16 x 32,800 refined) takes one segment
    a pair; [4100, 4100] at order 3 takes 129 bands of 256 rows on 8 warps,
    their bottom rows in a workspace; the gradient's block design keeps its
    u store in the workspace, (R + C + 1)(R + 1) values a pair."""
    small = plan.goursat_fwd_plan(2, 4100, 3, itemsize)
    assert (small["bands"], small["W"]) == (1, 1)
    assert small["S"] * small["RL"] >= 16
    big = plan.goursat_fwd_plan(4100, 4100, 3, itemsize)
    assert (big["bands"], big["W"], big["S"], big["RL"]) == (129, 8, 32, 8)
    assert not big["bnd_smem"] and big["smem"] <= plan.SMEM_BYTES
    assert tgs.warp_plan(2, 4100, 3, itemsize) is None
    assert tgs.grad_workspace_elems(2, 4100, 3, itemsize) == \
        (16 + 32800 + 1) * 17


def test_goursat_position_bound():
    """The sweeps take every grid whose refined sides sum below
    MAX_POSITIONS (2^28: 32-bit positions, a pair's offsets and a block's
    band rows), at any dyadic order up to MAX_ORDER; the bound is the
    kernels'."""
    src = (CSRC / "goursat.cuh").read_text()
    m = re.search(r"kMaxPositions = 1LL << (\d+);", src)
    assert 1 << int(m.group(1)) == tgs.MAX_POSITIONS
    assert re.search(r"o <= (\d+)", src).group(1) == str(tgs.MAX_ORDER)
    assert (2 + 4100) << 3 < tgs.MAX_POSITIONS
    assert (1 << 15) + 2 << 10 < tgs.MAX_POSITIONS
    assert (2 + 2) << 30 >= tgs.MAX_POSITIONS
    # 8 warps' bottom rows of C + 1 < MAX_POSITIONS values: 32-bit offsets
    assert 8 * (tgs.MAX_POSITIONS - 1) < 1 << 31
