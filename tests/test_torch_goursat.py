"""Parity of the port's Goursat solver (``gpsig_tpu_torch/ops/goursat.py``
and the plain versions in ``ops/cuda/goursat.py``) with
``gpsig_tpu.ops.goursat`` on the CPU.

- The plain grid, corner and adjoint gradient against the JAX scan and its
  custom VJP in float64, rtol 1e-10: the same recursion in the same order.
- A numpy model of the gradient kernel's warp design (``csrc/
  goursat_bwd.cu``: skewed lanes, checkpoints every K columns and the
  segment recompute, sums per unrefined cell in registers) against
  autograd through the plain sweep, float64, rtol 1e-10 at dyadic orders
  0-3, on square and rectangular grids.
- The refined corner and its gradient against the TPU's ``_fused_kernel``
  (``_corner_refined_impl`` / ``_corner_refined_bwd_impl`` in interpret
  mode), and the given-grid corner against ``_kernel``
  (``goursat_corner_pallas``), in float32 with scaled atol 1e-6 and 2e-6
  as in ``tests/test_goursat.py``: the Pallas kernels sum in another order
  (and expand the increments by a one-hot matmul).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import goursat as jg
from gpsig_tpu.ops.pallas import goursat_pallas as jgp
from gpsig_tpu_torch.ops import goursat as tg
from gpsig_tpu_torch.ops.cuda import goursat as tcg

torch.set_num_threads(1)
SHAPES = [(4, 4), (5, 3), (2, 7), (1, 1)]


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def scaled_close(got, want, atol):
    want = np.asarray(want)
    scale = max(1e-9, np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy() / scale, want / scale,
                               atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_matches_jax(shape):
    inc = 0.4 * np.random.default_rng(0).standard_normal(shape)
    close(tg.goursat_grid(torch.as_tensor(inc)),
          jg.goursat_grid(jnp.asarray(inc)))


@jax.jit
def _jax_corner_vjp(inc, w):
    out, vjp = jax.vjp(jg.goursat_corner, inc)
    return out, vjp(w)[0]


@pytest.mark.parametrize("shape", SHAPES + [(3, 6)])
def test_corner_and_adjoint_gradient_match_jax(shape):
    """Batched and weighted: the adjoint sweep seeded with ḡ."""
    rng = np.random.default_rng(1)
    inc = 0.4 * rng.standard_normal((2, 3) + shape)
    w = rng.standard_normal((2, 3))
    want, want_g = _jax_corner_vjp(jnp.asarray(inc), jnp.asarray(w))
    t = torch.as_tensor(inc).requires_grad_()
    got = tg.goursat_corner(t)
    close(got, want)
    (g,) = torch.autograd.grad(got, t, torch.as_tensor(w))
    close(g, want_g)


def test_refine_increments_matches_jax():
    inc = np.random.default_rng(2).standard_normal((2, 3, 4))
    for o in (0, 1, 2):
        got = tg.refine_increments(torch.as_tensor(inc), o)
        assert got.shape == (2, 3 << o, 4 << o)
        close(got, jg.refine_increments(jnp.asarray(inc), o), rtol=0)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_pde_vjp(inc, w, o, engine):
    out, vjp = jax.vjp(lambda a: jg.signature_kernel_pde(a, o, engine), inc)
    return out, vjp(w)[0]


@pytest.mark.parametrize("engine", ["auto", "pallas", "scan"])
def test_signature_kernel_pde_matches_jax(engine):
    """Values and gradients of every engine against the JAX function (its
    CPU path: refine, scan, custom adjoint)."""
    rng = np.random.default_rng(3)
    inc = 0.3 * rng.standard_normal((3, 6, 5))
    w = rng.standard_normal(3)
    for o in (0, 2):
        want, want_g = _jax_pde_vjp(jnp.asarray(inc), jnp.asarray(w), o,
                                    engine)
        t = torch.as_tensor(inc).requires_grad_()
        got = tg.signature_kernel_pde(t, o, engine)
        close(got, want)
        (g,) = torch.autograd.grad(got, t, torch.as_tensor(w))
        close(g, want_g)


def test_engine_is_validated():
    with pytest.raises(ValueError, match="unknown goursat engine"):
        tg.signature_kernel_pde(torch.zeros(2, 3, 3), 1, "pallsa")


@pytest.mark.parametrize("shape", [(0, 4), (3, 0), (0, 0)])
def test_length_one_sequence_gives_one(shape):
    """A sequence of length 1 has no increments: u(S, T) = 1 and no
    gradient (the JAX scan takes S, T >= 1 only)."""
    t = torch.zeros((2,) + shape, dtype=torch.float64, requires_grad=True)
    for o in (0, 2):
        out = tg.goursat_corner_refined(t, o)
        torch.testing.assert_close(out, torch.ones(2, dtype=torch.float64))
        (g,) = torch.autograd.grad(out.sum(), t)
        assert g.shape == t.shape and not g.any()
    assert tg.goursat_grid(t).shape == (2, shape[0] + 1, shape[1] + 1)


@pytest.mark.parametrize("shape,order", [((5, 5), 0), ((5, 3), 1),
                                         ((4, 6), 2), ((12, 9), 2)])
def test_refined_corner_matches_fused_pallas_kernel(shape, order):
    """The plain refined corner against ``_fused_kernel``'s forward."""
    inc = 0.4 * np.random.default_rng(7).standard_normal((3,) + shape)
    want = jg._corner_refined_impl(jnp.asarray(inc, jnp.float32), order,
                                   interpret=True)
    got = tcg.goursat_corner_refined_ref(
        torch.as_tensor(inc, dtype=torch.float32), order)
    scaled_close(got, want, 1e-6)
    scaled_close(tg.goursat_corner_refined(
        torch.as_tensor(inc, dtype=torch.float32), order), want, 1e-6)


@pytest.mark.parametrize("shape,order", [((5, 5), 0), ((5, 3), 1),
                                         ((4, 6), 2), ((12, 9), 2)])
def test_refined_gradient_matches_fused_pallas_kernel(shape, order):
    """The plain refined gradient (autograd through refine + the plain
    adjoint) against ``_fused_kernel`` with ``with_grad``, times ḡ."""
    rng = np.random.default_rng(8)
    inc = 0.4 * rng.standard_normal((2,) + shape)
    gbar = rng.standard_normal(2)
    (want,) = jg._corner_refined_bwd_impl(
        jnp.asarray(inc, jnp.float32), order, jnp.asarray(gbar, jnp.float32),
        interpret=True)
    got = tcg.goursat_grad_refined(torch.as_tensor(inc, dtype=torch.float32),
                                   order,
                                   torch.as_tensor(gbar, dtype=torch.float32))
    scaled_close(got, want, 2e-6)


@pytest.mark.parametrize("shape", [(5, 5), (7, 3), (1, 1)])
def test_given_grid_corner_matches_pallas_kernel(shape):
    """The plain corner on a given grid against ``_kernel``."""
    inc = 0.4 * np.random.default_rng(9).standard_normal((3,) + shape)
    S, T = shape
    want = jgp.goursat_corner_pallas(
        jg.skewpad_diag_major(jnp.asarray(inc, jnp.float32)), S, T,
        interpret=True)
    got = tg.goursat_corner_fast(torch.as_tensor(inc, dtype=torch.float32))
    scaled_close(got, want, 1e-6)


def test_plain_versions_agree():
    """The three plain versions the card is held against: the refined
    corner is the given-grid corner of the refined grid, and the refined
    gradient (the adjoint sweep) is autograd through the forward sweep,
    summed into unrefined cells."""
    rng = np.random.default_rng(10)
    inc = torch.as_tensor(0.3 * rng.standard_normal((4, 3, 5)))
    gbar = torch.as_tensor(rng.standard_normal(4))
    for o in (0, 1, 2):
        fine = tg.refine_increments(inc, o)
        torch.testing.assert_close(tcg.goursat_corner_refined_ref(inc, o),
                                   tcg.goursat_corner_ref(fine))
        t = inc.clone().requires_grad_()
        grid = tg.goursat_grid(tg.refine_increments(t, o))
        (want,) = torch.autograd.grad(grid[..., -1, -1], t, gbar)
        torch.testing.assert_close(tcg.goursat_grad_refined_ref(inc, o, gbar),
                                   want, rtol=1e-10, atol=1e-12)


def warp_adjoint_model(inc, o, gbar):
    """ḡ · ∂u(R, C)/∂inc for one unrefined grid inc [Su, Tu], computed as
    the warp design of ``csrc/goursat_bwd.cu`` schedules it (numpy, one
    Python loop body per lane and step). Returns the gradient and how many
    times each unrefined cell was written.

    The refined grid is swept with its shorter side R over the lanes, RL
    consecutive rows a lane. Forward, skewed: at step s lane l solves
    column s - l, taking u of the row above its rows from lane l - 1 (a
    shuffle up) and keeping that row (``bnd``) and, every K columns at
    columns of its own phase, its rows (``ck``). Reverse, skewed the other
    way: at step s lane l is at column Q_l - s, Q_l = C + lanes - 1 - l, so
    every lane starts a K-step segment at the same step; at a segment's
    start each lane recomputes its rows' u over the segment's columns from
    its checkpoint and ``bnd`` alone, then walks the adjoint μ down the
    segment, taking μ of the row below from lane l + 1 (a shuffle down),
    and adds each refined cell's term into its unrefined cell's sum, which
    the lane writes once when the unrefined column is done."""
    plan = tcg.warp_plan(*inc.shape, o, 4)  # float32 plan, as timed
    swap = inc.shape[0] > inc.shape[1]
    A = inc.T if swap else inc
    f = 1 << o
    R, C = A.shape[0] << o, A.shape[1] << o
    RL, K, nL, G = plan["RL"], plan["K"], plan["lanes"], plan["segments"]

    def a(i, j):  # refined cell (i, j), 0 past the last row
        return A[i >> o, j >> o] / (f * f) if i < R else 0.0

    # forward
    bnd = np.ones((C + 1, nL))
    ck = np.ones((G, nL, RL))
    u = np.ones((nL, RL))
    top_prev = np.ones(nL)
    last = np.ones(nL)
    for s in range(1, C + nL):
        sent = last.copy()
        for l in range(nL):
            j = s - l
            if not 1 <= j <= C:
                continue
            top = sent[l - 1] if l > 0 else 1.0
            bnd[j, l] = top
            up, upleft = top, top_prev[l]
            for r in range(RL):
                i = l * RL + r + 1
                left = u[l, r]
                v = left + up - upleft + a(i - 1, j - 1) * (left + up) * 0.5
                upleft, up, u[l, r] = left, v, v
            last[l], top_prev[l] = u[l, RL - 1], top
            g = (C + nL - 1 - l - j) // K - 1
            if (C + nL - 1 - l - j) % K == 0 and g >= 0:
                ck[g, l] = u[l]
    # reverse
    out = np.zeros(((R + f - 1) >> o, C >> o))
    writes = np.zeros(out.shape, dtype=int)
    mu_prev = np.zeros((nL, RL))
    below_prev = np.zeros(nL)
    first = np.zeros(nL)
    acc = np.zeros((nL, RL))
    for g in range(G):
        tiles = []
        for l in range(nL):
            c0 = C + nL - 1 - l - g * K - K
            uu = np.ones((K + 1, RL + 1))
            for k in range(K + 1):
                if 1 <= c0 + k <= C:
                    uu[k, 0] = bnd[c0 + k, l]
            if c0 >= 1:
                uu[0, 1:] = ck[g, l]
            for k in range(1, K + 1):
                if not 1 <= c0 + k <= C:
                    continue
                for r in range(1, RL + 1):
                    i = l * RL + r
                    left, up = uu[k - 1, r], uu[k, r - 1]
                    uu[k, r] = (left + up - uu[k - 1, r - 1]
                                + a(i - 1, c0 + k - 1) * (left + up) * 0.5)
            tiles.append(uu)
        for t in range(K):
            sent = first.copy()
            for l in range(nL):
                c = C + nL - 1 - l - (g * K + t)
                below = sent[l + 1] if l + 1 < nL else 0.0
                if 1 <= c <= C:
                    k, uu = K - t, tiles[l]
                    mb, mbp = below, below_prev[l]
                    for r in range(RL - 1, -1, -1):
                        i = l * RL + r + 1
                        mu = 0.0
                        if i == R and c == C:
                            mu = 1.0
                        elif i <= R:
                            if i < R and c < C:
                                mu -= mbp
                            if c < C:
                                mu += mu_prev[l, r] * (1 + 0.5 * a(i - 1, c))
                            if i < R:
                                mu += mb * (1 + 0.5 * a(i, c - 1))
                        acc[l, r] += mu * (uu[k - 1, r + 1] + uu[k, r]) * 0.5
                        mbp, mb, mu_prev[l, r] = mu_prev[l, r], mu, mu
                    first[l] = mu_prev[l, 0]
                    if (c - 1) % f == 0:
                        for r in range(0, RL, f):
                            if l * RL + r < R:
                                I, J = (l * RL + r) >> o, (c - 1) >> o
                                out[I, J] = acc[l, r:r + f].sum() * gbar / (
                                    f * f)
                                writes[I, J] += 1
                        acc[l] = 0.0
                below_prev[l] = below
    return (out.T, writes.T) if swap else (out, writes)


@pytest.mark.parametrize("shape,order", [
    ((4, 4), 0), ((5, 3), 0), ((3, 7), 1), ((1, 1), 0), ((13, 5), 1),
    ((7, 12), 2), ((6, 6), 2), ((35, 40), 1), ((3, 5), 3), ((40, 9), 0),
    ((35, 45), 2),
])
def test_warp_adjoint_model_matches_autograd(shape, order):
    """The warp design's schedule (lanes of 2, 4 or 8 refined rows, K = 16
    columns a segment, float32's plan) gives the plain gradient, and
    writes every unrefined cell exactly once (no atomics)."""
    rng = np.random.default_rng(11)
    inc = 0.3 * rng.standard_normal(shape)
    gbar = rng.standard_normal()
    assert tcg.warp_plan(*shape, order, 4) is not None
    got, writes = warp_adjoint_model(inc, order, gbar)
    want = tcg.goursat_grad_refined_ref(
        torch.as_tensor(inc[None]), order,
        torch.tensor([gbar], dtype=torch.float64))[0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-12)
    assert (writes == 1).all()


def test_warp_plan_covers_the_slice_grids():
    """One warp a pair at the SigGPDE grids up to 256 refined rows: the
    joint Gram (49 x 49) at dyadic orders 0-2, Kuf (7 x 49) at orders 0-2;
    the block design above, past a unrefined row of 8 refined rows, and
    where the boundary rows and checkpoints pass 48 KB (float64 at 196
    rows)."""
    joint = tcg.warp_plan(49, 49, 1, 4)
    assert (joint["RL"], joint["K"], joint["lanes"]) == (4, 16, 25)
    assert joint["segments"] == -(-(98 + 24) // 16)
    assert joint["smem"] == 4 * 25 * (99 + joint["segments"] * 4)
    assert tcg.warp_plan(49, 49, 1, 8)["K"] == 8
    assert tcg.warp_plan(49, 49, 0, 8)["RL"] == 2
    assert tcg.warp_plan(49, 49, 0, 8)["K"] == 16
    assert (tcg.warp_plan(49, 49, 2, 4)["RL"],
            tcg.warp_plan(49, 49, 2, 4)["lanes"]) == (8, 25)
    assert tcg.warp_plan(49, 49, 2, 8) is None
    for o in (0, 1, 2):
        assert tcg.warp_plan(7, 49, o, 4)["RL"] == max(2, 1 << o)
    assert tcg.warp_plan(199, 199, 2, 4) is None
    assert tcg.warp_plan(3, 5, 4, 4) is None
    assert tcg.warp_plan(0, 5, 0, 4) is None
