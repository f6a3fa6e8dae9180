"""sig_gram past order 7: the run-time-order instance
(``csrc/sig_gram_order.cuh``, ``plan.sig_gram_order_plan``).

- A float64 torch model of the kernels' loop order: one warp a matrix, the
  rows in chunks of lanes, every row scan carried from chunk to chunk, one
  pass over the chunks a scan, every value a row keeps in slots laid out
  as ``OrderSlots``; the forward sweep, then the reverse sweep that
  rebuilds each column's grids by subtraction and walks the adjoint down
  the levels. Held at (num_levels, order) (8, 8) and (10, 9) against the
  JAX package's Pallas kernels (``sig_gram_levels_ho``, interpret mode)
  and ``jax.vjp`` (through their custom VJP, ``_bwd_kernel_ho``, at
  (8, 8); through the XLA ``signature_kern`` at (10, 9)), scaled error 1e-5
  (their in-kernel triangular products accumulate in float32 even on
  float64 inputs, as ``test_torch_sig_gram.py`` states), and against the
  port's plain version and autograd, scaled error 1e-10 (float64, other
  summation order only).
- The plan at p > 7: one warp a matrix, the slots a row, the grid bounded
  by the workspace, and the workspace refusal.
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

class Slots:
    """A row's slots (``csrc/sig_gram_order.cuh``'s OrderSlots)."""

    def __init__(self, nl, p):
        self.nl, self.p = nl, p
        self.f0 = nl + (nl - 1) * (p - 1)
        self.b0 = self.f0 + (nl - 1) * p * p
        self.b1 = self.b0 + 2 * (nl - 1) * p

    def tsum(self, m):
        return m

    def ra(self, m, q):
        return self.nl + m * (self.p - 1) + q

    def grid(self, k, a, b):
        return self.f0 + (k * self.p + a) * self.p + b

    def pre(self, m):
        return self.b0 + m

    def colpre(self, m, q):
        return self.b0 + self.nl - 1 + m * (self.p - 1) + q

    def rtot(self, m):
        return self.b0 + (self.nl - 1) * self.p + m

    def rrow(self, m, q):
        return self.b0 + (self.nl - 1) * (self.p + 1) + m * (self.p - 1) + q

    def inj(self, k, a, b):
        return self.b1 + (k * self.p + a) * self.p + b

    def injc(self, k, b):
        return self.b1 + 2 * self.p * self.p + k * self.p + b

    def ptot(self, k):
        return self.b1 + 2 * self.p * self.p + 2 * self.p + k

    def prow(self, k, q):
        return self.b1 + 2 * self.p * self.p + 2 * self.p + 2 + k * self.p + q


class OrderModel:
    """``OrderDP`` on every matrix of M [B, L1, L2] at once: slot s of row
    j is mem[:, s, j]; chunk c holds rows chunk·c .. chunk·(c+1) - 1."""

    def __init__(self, M, nl, order, chunk, backward):
        self.M, (self.B, self.L1, self.L2) = M, M.shape
        self.nl, self.p, self.chunk = nl, min(order, nl), chunk
        self.sl = Slots(nl, self.p)
        self.mem = torch.zeros(self.B, plan.order_slots(nl, self.p, backward),
                               self.L2, dtype=M.dtype)
        self.chunks = -(-self.L2 // chunk)

    def rows(self, c):
        return slice(c * self.chunk, min((c + 1) * self.chunk, self.L2))

    def ld(self, s, c):
        return self.mem[:, s, self.rows(c)].clone()

    def st(self, s, c, v):
        self.mem[:, s, self.rows(c)] = v

    def x(self, i, c):
        return self.M[:, i, self.rows(c)]

    @staticmethod
    def prefix(v, carry):
        incl = torch.cumsum(v, -1)
        return incl - v + carry[:, None], carry + incl[:, -1]

    @staticmethod
    def suffix(v, carry):
        incl = torch.flip(torch.cumsum(torch.flip(v, [-1]), -1), [-1])
        return incl - v + carry[:, None], carry + incl[:, 0]

    def level(self, i, m, rebuild):
        sl, p, nl, ld, st = self.sl, self.p, self.nl, self.ld, self.st
        Rp, Rm = min(p, m - 1), min(p, m)
        kp, kc = (m - 2, m - 1) if rebuild else ((m - 2) & 1, (m - 1) & 1)
        write, top = not rebuild or m < nl, not rebuild and m == nl
        carry = torch.zeros(self.B, dtype=self.M.dtype)
        for c in range(self.chunks):
            x = self.x(i, c)
            tot = sum(ld(sl.grid(kp, a, b), c) for a in range(Rp)
                      for b in range(Rp))
            ts = ld(sl.tsum(m - 2), c)
            if rebuild:
                ts = ts - tot
                st(sl.tsum(m - 2), c, ts)
            pre, carry = self.prefix(ts, carry)
            if rebuild:
                st(sl.pre(m - 2), c, pre)
            else:
                st(sl.tsum(m - 2), c, ts + tot)
            if write:
                s = x * pre
                st(sl.grid(kc, 0, 0), c, s)
                for a in range(1, Rm):
                    for b in range(1, Rm):
                        v = x / ((a + 1) * (b + 1)) * ld(
                            sl.grid(kp, a - 1, b - 1), c)
                        st(sl.grid(kc, a, b), c, v)
                        s = s + v
                if top:
                    st(sl.tsum(nl - 1), c, ld(sl.tsum(nl - 1), c) + s)
        for q in range(Rm - 1):
            carry = torch.zeros(self.B, dtype=self.M.dtype)
            for c in range(self.chunks):
                cs = sum(ld(sl.grid(kp, a, q), c) for a in range(Rp))
                rs = sum(ld(sl.grid(kp, q, a), c) for a in range(Rp))
                cp, carry = self.prefix(cs, carry)
                r = ld(sl.ra(m - 2, q), c)
                if rebuild:
                    r = r - rs
                    st(sl.ra(m - 2, q), c, r)
                    st(sl.colpre(m - 2, q), c, cp)
                else:
                    st(sl.ra(m - 2, q), c, r + rs)
                if write:
                    k = self.x(i, c) / (q + 2)
                    st(sl.grid(kc, q + 1, 0), c, k * r)
                    st(sl.grid(kc, 0, q + 1), c, k * cp)
                    if top:
                        st(sl.tsum(nl - 1), c,
                           ld(sl.tsum(nl - 1), c) + k * r + k * cp)

    def first(self, i):
        for c in range(self.chunks):
            self.st(self.sl.grid(0, 0, 0), c, self.x(i, c))

    def forward(self):
        for i in range(self.L1):
            self.first(i)
            for m in range(2, self.nl + 1):
                self.level(i, m, False)
        return torch.stack([torch.ones(self.B, dtype=self.M.dtype)]
                           + [self.mem[:, m].sum(-1) for m in range(self.nl)])

    def adjoint(self, i, m, w, Mbar):
        sl, p, nl, ld, st = self.sl, self.p, self.nl, self.ld, self.st
        Rm, Rn = min(p, m), min(p, m + 1)
        ki, ko, below = m & 1, (m - 1) & 1, m < nl
        for c in range(self.chunks):
            x = self.x(i, c)
            rt = ld(sl.rtot(m - 1), c) if below else 0

            def A(a, b):
                v = w[m][:, None]
                if below:
                    v = v + rt
                    if a + 1 < Rn:
                        v = v + ld(sl.rrow(m - 1, a), c)
                    if b + 1 < Rn:
                        v = v + ld(sl.injc(ki, b), c)
                        if a + 1 < Rn:
                            v = v + ld(sl.inj(ki, a, b), c)
                return v
            if m >= 2:
                a00 = A(0, 0)
                mb = a00 * ld(sl.pre(m - 2), c)
                for q in range(1, Rm):
                    k = 1.0 / (q + 1)
                    aq0, a0q = A(q, 0), A(0, q)
                    mb = mb + k * (aq0 * ld(sl.ra(m - 2, q - 1), c)
                                   + a0q * ld(sl.colpre(m - 2, q - 1), c))
                    st(sl.injc(ko, q - 1), c, x * k * a0q)
                    st(sl.prow(ko, q - 1), c, x * k * aq0)
                for a in range(1, Rm):
                    for b in range(1, Rm):
                        k = 1.0 / ((a + 1) * (b + 1))
                        ab = A(a, b)
                        mb = mb + k * ab * ld(sl.grid(m - 2, a - 1, b - 1), c)
                        st(sl.inj(ko, a - 1, b - 1), c, x * k * ab)
                st(sl.ptot(ko), c, x * a00)
            else:
                mb = A(0, 0)
            if below:
                for q in range(Rn - 1):
                    st(sl.rrow(m - 1, q), c, ld(sl.rrow(m - 1, q), c)
                       + ld(sl.prow(ki, q), c))
            Mbar[:, i, self.rows(c)] = mb if m == nl else (
                Mbar[:, i, self.rows(c)] + mb)
        if below:
            carry = torch.zeros(self.B, dtype=self.M.dtype)
            for c in reversed(range(self.chunks)):
                sfx, carry = self.suffix(ld(sl.ptot(ki), c), carry)
                st(sl.rtot(m - 1), c, ld(sl.rtot(m - 1), c) + sfx)
        if m >= 2:
            for q in range(1, Rm):
                carry = torch.zeros(self.B, dtype=self.M.dtype)
                for c in reversed(range(self.chunks)):
                    sfx, carry = self.suffix(ld(sl.injc(ko, q - 1), c), carry)
                    st(sl.injc(ko, q - 1), c, sfx)

    def backward(self, w):
        self.forward()
        Mbar = torch.zeros_like(self.M)
        for m in range(self.nl - 1):  # the reverse sweep's carries
            self.mem[:, self.sl.rtot(m)] = 0
            for q in range(self.p - 1):
                self.mem[:, self.sl.rrow(m, q)] = 0
        for i in reversed(range(self.L1)):
            self.first(i)
            for m in range(2, self.nl + 1):
                self.level(i, m, True)
            for m in range(self.nl, 0, -1):
                self.adjoint(i, m, w, Mbar)
        return Mbar


@pytest.mark.parametrize("nl,order,shape,chunk,pallas_vjp", [
    (8, 8, (2, 5, 7), 4, True),    # p = nl, the last chunk ragged
    (10, 9, (2, 4, 9), 4, False),  # p < nl: the grid stops growing at 9
])
def test_order_model_matches_jax_and_its_grad(nl, order, shape, chunk,
                                              pallas_vjp):
    """The loop order's forward against the JAX Pallas kernel
    ``_fwd_kernel_ho`` in interpret mode, and its backward against
    ``jax.vjp``: through the Pallas kernel's custom VJP
    (``_bwd_kernel_ho``, interpret mode) at (8, 8), through the JAX
    package's XLA ``signature_kern`` at (10, 9), where the interpreted
    backward would cost the file ~10 s more; both against the port's plain
    version and autograd through it."""
    rng = np.random.default_rng(nl + order)
    M = 0.5 * rng.standard_normal(shape)
    w = rng.standard_normal((nl + 1, shape[0]))
    ref = sig_gram_levels_ho if pallas_vjp else (
        lambda m, nl, order, _: signature_kern(m, nl, order, True))
    _, vjp = jax.vjp(lambda m: ref(m, nl, order, True), jnp.asarray(M))
    (wgrad,) = vjp(jnp.asarray(w))
    want = sig_gram_levels_ho(jnp.asarray(M), nl, order, True)
    Mt = torch.as_tensor(M)
    got = OrderModel(Mt, nl, order, chunk, False).forward()
    ggrad = OrderModel(Mt, nl, order, chunk, True).backward(
        torch.as_tensor(w))
    assert scaled(got, want) < 1e-5
    assert scaled(ggrad, wgrad) < 1e-5
    plain = sg.sig_gram_levels_ho_ref(Mt, nl, order)
    pgrad = sg.sig_gram_levels_ho_bwd_ref(Mt, torch.as_tensor(w), nl, order)
    assert scaled(got, plain) < 1e-10
    assert scaled(ggrad, pgrad) < 1e-10


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("nl,p,backward,slots", [
    (8, 8, False, 8 + 7 * 7 + 2 * 64),
    (8, 8, True, 8 + 7 * 87 + 2 * 64 + 32 + 2),
    (127, 127, True, 127 + 126 * (127 ** 2 + 3 * 127 - 1) + 2 * 127 ** 2
     + 4 * 127 + 2),
])
def test_order_slots_count_the_state(nl, p, backward, slots):
    """Forward: the deep path's carries and two grids; backward: also
    every level's grid below the top, E, CP, Rtot, Rrow and two sets of
    the adjoint's pieces (``OrderSlots::count``)."""
    assert plan.order_slots(nl, p, backward) == slots


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("backward", [False, True])
def test_order_plan_takes_one_warp_a_matrix(itemsize, backward):
    """p > 7 at every level count: one warp a matrix at one row a lane,
    the rows' slots in the workspace, the most warps of B, 528 blocks of
    four warps and what the workspace holds."""
    for B, L1, L2, nl, p in ((22500, 49, 49, 8, 8), (4, 20, 150, 10, 10),
                             (3, 7, 5, 127, 9), (1, 5, 40, 127, 127)):
        lp = plan.sig_gram_plan(B, L1, L2, nl, p, itemsize, backward)
        area = plan.order_slots(nl, p, backward) * L2
        warps = min(B, 4 * plan.SIG_GRAM_MAX_BLOCKS,
                    plan.WORKSPACE_BYTES // (area * itemsize))
        assert (lp["S"], lp["R"], lp["bands"], lp["area_smem"],
                lp["smem"]) == (32, 1, 1, False, 0)
        assert lp["area"] == area
        assert lp["W"] == min(4, warps)
        assert lp["blocks"] == warps // lp["W"] >= 1
        assert lp["blocks"] <= plan.SIG_GRAM_MAX_BLOCKS
        assert lp["work"] == lp["blocks"] * lp["W"] * area
        assert lp["work"] * itemsize <= plan.WORKSPACE_BYTES
    # the GPR's 150² pairs at L' = 49: every block of four warps
    lp = plan.sig_gram_plan(11325, 49, 49, 8, 8, 4, True)
    assert (lp["W"], lp["blocks"]) == (4, plan.SIG_GRAM_MAX_BLOCKS)


def test_order_plan_refuses_past_the_workspace():
    """One matrix whose rows' slots exceed WORKSPACE_BYTES has no plan (the
    wrapper raises ValueError naming the workspace): at p = nl = 127 the
    backward keeps 2,113,029 values a row, so float32 takes 127 rows and
    float64 63."""
    slots = plan.order_slots(127, 127, True)
    assert slots == 2113029
    assert [plan.WORKSPACE_BYTES // (slots * i) for i in (4, 8)] == [127, 63]
    for itemsize in (4, 8):
        rows = plan.WORKSPACE_BYTES // (slots * itemsize)
        assert plan.sig_gram_plan(1, 5, rows, 127, 127, itemsize, True)
        assert plan.sig_gram_plan(1, 5, rows + 1, 127, 127, itemsize,
                                  True) is None
    # the forward at the same shape keeps far less
    assert plan.sig_gram_plan(1, 5, 128, 127, 127, 4, False)


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
