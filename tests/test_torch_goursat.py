"""Parity of the port's Goursat solver (``gpsig_tpu_torch/ops/goursat.py``
and the plain versions in ``ops/cuda/goursat.py``) with
``gpsig_tpu.ops.goursat`` on the CPU.

- The plain grid, corner and adjoint gradient against the JAX scan and its
  custom VJP in float64, rtol 1e-10: the same recursion in the same order.
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
