"""Parity of the port's run-length (order >= 2) recursions
(``gpsig_tpu_torch/ops/signature.py``: ``signature_kern`` and
``signature_kern_tens_vs_seq`` at any order) with
``gpsig_tpu/ops/signature.py``, float64 on the CPU, and with the
brute-force enumeration oracles of ``tests/oracles.py``.

Tolerance rtol 1e-10: both sides run the same float64 recursion, summed
in another order; the oracles sum the same terms one by one.
"""

import numpy as np
import pytest
import torch
from oracles import sig_kernel_levels, sig_tens_vs_seq_levels

from gpsig_tpu.ops import signature as jsig
from gpsig_tpu_torch.ops import signature as tsig

torch.set_num_threads(1)
RTOL, ATOL = 1e-10, 1e-14


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("nl,order", [(2, 2), (3, 2), (3, 3), (4, 2),
                                      (4, 3), (4, 4), (5, 2), (5, 9),
                                      (7, 3)])
def test_signature_kern_higher_order_matches_jax(nl, order):
    M = 0.5 * np.random.default_rng(nl + order).standard_normal((2, 3, 7, 9))
    want = jsig.signature_kern(M, nl, order=order)
    _close(tsig.signature_kern(torch.as_tensor(M), nl, order).numpy(), want)
    total = tsig.signature_kern(torch.as_tensor(M), nl, order,
                                return_levels=False)
    _close(total.numpy(), np.sum(np.asarray(want), axis=0))


@pytest.mark.parametrize("nl,order", [(2, 2), (3, 2), (4, 3), (4, 4),
                                      (5, 2), (5, 7), (7, 2)])
def test_signature_kern_tens_vs_seq_higher_order_matches_jax(nl, order):
    F = tsig.tensor_factor_count(nl)
    U = 0.5 * np.random.default_rng(nl * order).standard_normal((3, 4, F, 9))
    want = jsig.signature_kern_tens_vs_seq(U, nl, order=order)
    _close(tsig.signature_kern_tens_vs_seq(torch.as_tensor(U), nl,
                                           order).numpy(), want)


@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_signature_kern_matches_enumeration_oracle(order):
    """order >= num_levels is the exact signature of the piecewise-linear
    path; below it the run lengths are capped at ``order``."""
    nl = 3
    M = 0.5 * np.random.default_rng(order).standard_normal((5, 6))
    got = tsig.signature_kern(torch.as_tensor(M), nl, order).numpy()
    _close(got, sig_kernel_levels(M, nl, order))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_tens_vs_seq_matches_enumeration_oracle(order):
    nl = 3
    F = tsig.tensor_factor_count(nl)
    U = 0.5 * np.random.default_rng(10 + order).standard_normal((F, 6))
    got = tsig.signature_kern_tens_vs_seq(torch.as_tensor(U), nl,
                                          order).numpy()
    offs = [m * (m - 1) // 2 for m in range(1, nl + 1)]
    want = sig_tens_vs_seq_levels([U[o:o + m] for m, o in
                                   zip(range(1, nl + 1), offs)], order)
    _close(got, want)


def test_order_at_least_levels_is_the_exact_signature():
    """Every order >= num_levels gives the same kernel (p = min(order,
    nl)); the orders below it differ."""
    M = torch.as_tensor(0.5 * np.random.default_rng(3).standard_normal(
        (4, 8, 8)))
    exact = tsig.signature_kern(M, 4, 4)
    for order in (5, 8, 40):
        torch.testing.assert_close(tsig.signature_kern(M, 4, order), exact,
                                   rtol=0, atol=0)
    assert not torch.allclose(tsig.signature_kern(M, 4, 3), exact)


def test_higher_order_gradient_matches_jax():
    """Autograd through the run-length recursion against jax.grad."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    M = 0.5 * rng.standard_normal((3, 6, 7))
    w = rng.standard_normal((5, 3))
    want = jax.grad(lambda m: jnp.sum(w * jsig.signature_kern(m, 4, 2)))(
        jnp.asarray(M))
    Mt = torch.as_tensor(M).requires_grad_()
    torch.sum(torch.as_tensor(w) * tsig.signature_kern(Mt, 4, 2)).backward()
    _close(Mt.grad.numpy(), want)
