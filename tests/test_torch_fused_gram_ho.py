"""Parity of the port's general fused Gram (``ops/cuda/fused_gram_ho.py``)
with ``gpsig_tpu/ops/pallas/fused_gram_ho.py``, every base kind × both
``difference`` × order 1-3.

- The plain version against the JAX package's own plain reference
  (``_xla_reference_ho``) in float64: rtol 1e-10, since both compute the
  same unclamped formulas.
- Against the Pallas kernel (``_ho_kernel``) in interpret mode: its
  in-kernel matrix products accumulate in float32 even on float64 inputs,
  so the bound is float32's: scaled error 1e-5.

The CUDA kernel itself is checked on the card by
``test_torch_cuda_kernels.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops.pallas import fused_gram_ho as jfgho
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho

torch.set_num_threads(1)
KINDS = ["linear", "rbf", "poly2", "poly3", "cosine"]


def _inputs(rng, N1, N2, L, d, kind):
    """Random walks, with the Poly offset channel (x_extra = 1,
    y_extra = 0.7) that the kernel layer appends."""
    X = (0.3 * rng.standard_normal((N1, L, d))).cumsum(1)
    Y = (0.3 * rng.standard_normal((N2, L, d))).cumsum(1)
    if kind.startswith("poly"):
        X = np.concatenate([X, np.ones((N1, L, 1))], -1)
        Y = np.concatenate([Y, np.full((N2, L, 1), 0.7)], -1)
    return X, Y


def _scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_ref_matches_xla_reference(kind, order, difference):
    rng = np.random.default_rng(order)
    X, Y = _inputs(rng, 4, 5, 9, 2, kind)
    want = jfgho._xla_reference_ho(jnp.asarray(X), jnp.asarray(Y), 4, order,
                                   kind, difference)
    got = tfgho.fused_gram_ho_levels_ref(torch.as_tensor(X),
                                         torch.as_tensor(Y), 4, order, kind,
                                         difference)
    assert got.shape == (5, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly2", "cosine"])
def test_wrapper_matches_pallas_interpret(kind, order, difference):
    rng = np.random.default_rng(10 + order)
    X, Y = _inputs(rng, 3, 4, 7, 2, kind)
    want = jfgho.fused_gram_ho_levels(jnp.asarray(X), jnp.asarray(Y), 3,
                                      order, kind, difference,
                                      interpret=True)
    got = tfgho.fused_gram_ho_levels(torch.as_tensor(X), torch.as_tensor(Y),
                                     3, order, kind, difference)
    assert _scaled_err(got, want) < 1e-5


def test_wrapper_takes_plain_path_on_cpu_without_launching():
    X, Y = _inputs(np.random.default_rng(2), 3, 2, 8, 2, "poly2")
    X, Y = torch.as_tensor(X), torch.as_tensor(Y)
    before = tfgho.launches
    torch.testing.assert_close(
        tfgho.fused_gram_ho_levels(X, Y, 3, 2, "poly2", False),
        tfgho.fused_gram_ho_levels_ref(X, Y, 3, 2, "poly2", False),
        rtol=0, atol=0)
    assert tfgho.launches == before


def test_kind_parsing():
    assert tfgho.kind_params("rbf") == (True, None)
    assert tfgho.kind_params("cosine") == (True, None)
    assert tfgho.kind_params("linear") == (False, None)
    assert tfgho.kind_params("poly3") == (False, 3)
    assert tfgho._kind_code("poly3") == (3, 3)
    assert tfgho._kind_code("cosine") == (2, 0)
    for bad in ("poly", "poly0", "tanh"):
        with pytest.raises(ValueError, match="unknown base kind"):
            tfgho.kind_params(bad)


def test_kernel_shape_checks():
    """Lengths beyond one warp's 128 rows are taken with and without
    difference; num_levels, shapes, order and L >= 2 are checked."""
    for L in (150, 300):
        X = torch.zeros(2, L, 2)
        for difference in (True, False):
            tfgho._check_shapes("k", 3, 2, difference, X, X)
    X = torch.zeros(2, 150, 2)
    with pytest.raises(ValueError, match="length 1"):
        tfgho._check_shapes("k", 3, 2, False, X[:, :1], X[:, :1])
    with pytest.raises(ValueError, match="num_levels"):
        tfgho._check_shapes("k", 8, 2, True, X[:, :5], X[:, :5])
    with pytest.raises(ValueError, match=r"\[N, L, d\]"):
        tfgho._check_shapes("k", 3, 2, True, X[:, :5], X[:, :6])
    with pytest.raises(ValueError, match="order"):
        tfgho._check_shapes("k", 3, 0, True, X[:, :5], X[:, :5])


def test_backward_on_card_is_not_ported_yet():
    """The backward is ported: ``_GramHoLevels.backward`` hands the saved
    inputs and the cotangent to ``fused_gram_ho_levels_bwd`` (the kernel on
    the card, the plain VJP for these CPU tensors) and returns a gradient
    only for the inputs that need one."""
    X, Y = map(torch.as_tensor, _inputs(np.random.default_rng(7), 3, 2, 6,
                                        2, "cosine"))
    g = torch.as_tensor(np.random.default_rng(8).standard_normal((4, 3, 2)))
    args = (3, 2, "cosine", False)
    ctx = SimpleNamespace(saved_tensors=(X, Y), args=args,
                          needs_input_grad=(True, False) + (False,) * 4)
    gx, gy, *rest = tfgho._GramHoLevels.backward(ctx, g)
    want, _ = tfgho.fused_gram_ho_levels_bwd_ref(X, Y, g, *args)
    torch.testing.assert_close(gx, want, rtol=1e-12, atol=0)
    assert gy is None and rest == [None] * 4
