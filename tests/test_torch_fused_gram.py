"""Parity of the port's fused Gram / diagonal (``ops/cuda/fused_gram.py``)
with ``gpsig_tpu/ops/pallas/fused_gram.py``.

- Plain versions against the JAX package's own plain references
  (``_xla_reference``, ``_xla_reference_diag``) in float64: rtol 1e-10,
  since both compute the same unclamped formulas.
- One interpret-mode call of each Pallas kernel: its in-kernel matrix
  products accumulate in float32 (``preferred_element_type``) even on
  float64 inputs, so the bound is float32's: scaled error 1e-5.

The CUDA kernels themselves are checked on the card by
``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops.pallas import fused_gram as jfg
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg

torch.set_num_threads(1)


def _walks(rng, n, L, d):
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


def _scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 2, 4])
def test_gram_ref_matches_xla_reference(rbf, nl):
    rng = np.random.default_rng(nl)
    X, Y = _walks(rng, 5, 9, 2), _walks(rng, 7, 9, 2)
    want = np.asarray(jfg._xla_reference(jnp.asarray(X), jnp.asarray(Y),
                                         nl, rbf))
    got = tfg.fused_gram_levels_ref(torch.as_tensor(X), torch.as_tensor(Y),
                                    nl, rbf).numpy()
    assert got.shape == (nl + 1, 5, 7)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("rbf", [True, False])
def test_diag_ref_matches_xla_reference(rbf):
    X = _walks(np.random.default_rng(7), 6, 12, 2)
    want = np.asarray(jfg._xla_reference_diag(jnp.asarray(X), 4, rbf))
    got = tfg.fused_diag_levels_ref(torch.as_tensor(X), 4, rbf).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def test_wrappers_take_plain_path_on_cpu_without_launching():
    X = torch.as_tensor(_walks(np.random.default_rng(2), 3, 8, 2))
    before = (tfg.gram_launches, tfg.diag_launches)
    torch.testing.assert_close(tfg.fused_gram_levels(X, X, 3),
                               tfg.fused_gram_levels_ref(X, X, 3),
                               rtol=0, atol=0)
    torch.testing.assert_close(tfg.fused_diag_levels(X, 3, False),
                               tfg.fused_diag_levels_ref(X, 3, False),
                               rtol=0, atol=0)
    assert (tfg.gram_launches, tfg.diag_launches) == before


def test_gram_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    X, Y = _walks(rng, 4, 7, 2), _walks(rng, 5, 7, 2)
    want = jfg.fused_gram_levels(jnp.asarray(X), jnp.asarray(Y), 3, True,
                                 True)
    got = tfg.fused_gram_levels(torch.as_tensor(X), torch.as_tensor(Y), 3)
    assert _scaled_err(got, want) < 1e-5


def test_diag_matches_pallas_interpret():
    X = _walks(np.random.default_rng(12), 5, 8, 2)
    want = jfg.fused_diag_levels(jnp.asarray(X), 4, True, True)
    got = tfg.fused_diag_levels(torch.as_tensor(X), 4)
    assert _scaled_err(got, want) < 1e-5


def test_kernel_shape_checks():
    """Lengths beyond one warp's 128 rows are taken (the launch plan
    spreads them over warps); num_levels, shapes and L >= 2 are checked."""
    for L in (150, 300):
        X = torch.zeros(2, L, 2)
        tfg._check_shapes("k", 3, X)
        tfg._check_shapes("k", 3, X, X[:1])
    X = torch.zeros(2, 150, 2)
    with pytest.raises(ValueError, match="num_levels"):
        tfg._check_shapes("k", 8, X[:, :5])
    with pytest.raises(ValueError, match=r"\[N, L, d\]"):
        tfg._check_shapes("k", 3, X[:, :5], X[:, :6])
    with pytest.raises(ValueError, match="length 1"):
        tfg._check_shapes("k", 3, X[:, :1])
