"""Parity of the port's general Kuf (``ops/cuda/tens_seq_general.py``)
with ``gpsig_tpu/ops/pallas/tens_seq_general.py``, every base kind × both
``difference`` × both ``increments`` × order 1-3.

- The plain version against the JAX package's own plain reference
  (``_xla_reference_tens_seq_general``) in float64: rtol 1e-10.
- Against the Pallas kernel (``_tsg_kernel``) in interpret mode: its
  in-kernel matrix products accumulate in float32 even on float64 inputs:
  scaled error 1e-5.

The CUDA kernel itself is checked on the card by
``test_torch_cuda_kernels.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops.pallas import tens_seq_general as jtsg
from gpsig_tpu_torch.ops.cuda import tens_seq_general as ttsg

torch.set_num_threads(1)
KINDS = ["linear", "rbf", "poly2", "poly3", "cosine"]


def _inputs(rng, T, N, L, d, nl, kind, increments):
    """Factor stacks and random walks, with the Poly offset channel
    (x_extra = 1, z_extra = 0.7) that the kernel layer appends."""
    F = nl * (nl + 1) // 2
    Z = 0.4 * rng.standard_normal((T, F, 2, d) if increments else (T, F, d))
    X = (0.3 * rng.standard_normal((N, L, d))).cumsum(1)
    if kind.startswith("poly"):
        Z = np.concatenate([Z, np.full(Z.shape[:-1] + (1,), 0.7)], -1)
        X = np.concatenate([X, np.ones((N, L, 1))], -1)
    return Z, X


def _scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_ref_matches_xla_reference(kind, order, difference):
    rng = np.random.default_rng(order)
    for increments in (False, True):
        Z, X = _inputs(rng, 5, 4, 9, 2, 4, kind, increments)
        want = jtsg._xla_reference_tens_seq_general(
            jnp.asarray(Z), jnp.asarray(X), 4, order, kind, increments,
            difference)
        got = ttsg.fused_tens_seq_general_levels_ref(
            torch.as_tensor(Z), torch.as_tensor(X), 4, order, kind,
            increments, difference)
        assert got.shape == (5, 5, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly2", "cosine"])
def test_wrapper_matches_pallas_interpret(kind, order, difference):
    rng = np.random.default_rng(20 + order)
    increments = order != 2
    Z, X = _inputs(rng, 4, 3, 8, 2, 3, kind, increments)
    want = jtsg.fused_tens_seq_general_levels(
        jnp.asarray(Z), jnp.asarray(X), 3, order, kind, increments,
        difference, interpret=True)
    got = ttsg.fused_tens_seq_general_levels(
        torch.as_tensor(Z), torch.as_tensor(X), 3, order, kind, increments,
        difference)
    assert _scaled_err(got, want) < 1e-5


def test_wrapper_takes_plain_path_on_cpu_without_launching():
    Z, X = _inputs(np.random.default_rng(2), 3, 2, 8, 2, 3, "cosine", True)
    Z, X = torch.as_tensor(Z), torch.as_tensor(X)
    before = ttsg.launches
    torch.testing.assert_close(
        ttsg.fused_tens_seq_general_levels(Z, X, 3, 2, "cosine", True,
                                           False),
        ttsg.fused_tens_seq_general_levels_ref(Z, X, 3, 2, "cosine", True,
                                               False),
        rtol=0, atol=0)
    assert ttsg.launches == before


def test_backward_function_hands_off_to_bwd():
    """The backward is ported: ``_TensSeqGeneralLevels.backward`` hands the
    saved inputs and the cotangent to ``tens_seq_general_bwd`` (the kernel
    on the card, the plain VJP for these CPU tensors) and returns a
    gradient only for the inputs that need one."""
    Z, X = map(torch.as_tensor,
               _inputs(np.random.default_rng(7), 3, 2, 6, 2, 2, "rbf", True))
    g = torch.as_tensor(np.random.default_rng(8).standard_normal((3, 3, 2)))
    args = (2, 2, "rbf", True, True)
    ctx = SimpleNamespace(saved_tensors=(Z, X), args=args,
                          needs_input_grad=(False, True) + (False,) * 5)
    gz, gx, *rest = ttsg._TensSeqGeneralLevels.backward(ctx, g)
    _, want = ttsg.tens_seq_general_bwd_ref(Z, X, g, *args)
    torch.testing.assert_close(gx, want, rtol=1e-12, atol=0)
    assert gz is None and rest == [None] * 5
