"""Parity of the port's per-pair DP over increment matrices
(``ops/cuda/sig_gram.py``: ``sig_gram_levels``, order 1, and
``sig_gram_levels_ho``) with ``gpsig_tpu/ops/pallas/sig_gram.py``.

- The plain versions against ``gpsig_tpu.ops.signature.signature_kern`` in
  float64: rtol 1e-10.
- Against the Pallas kernels (``_fwd_kernel``, ``_fwd_kernel_ho``) in
  interpret mode: their in-kernel triangular products accumulate in
  float32 even on float64 inputs: scaled error 1e-5.
- The symmetry k_m(M) = k_m(Mᵀ) that the CUDA kernel relies on to stream
  M's rows.
- Past 7 levels (up to 127, the JAX kernels' bound): the plain versions
  against ``signature_kern`` (rtol 1e-10) and the launch plan of the deep
  path, whose state goes to shared memory or to a device workspace
  (``plan.sig_gram_plan``, ``csrc/deep_levels.cuh``).

The CUDA kernel itself is checked on the card by
``test_torch_cuda_kernels.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import signature as jsig
from gpsig_tpu.ops.pallas import sig_gram as jsg
from gpsig_tpu_torch.ops.cuda import plan
from gpsig_tpu_torch.ops.cuda import sig_gram as tsg

torch.set_num_threads(1)


def _scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("shape,nl", [((3, 9, 12), 4), ((2, 13, 5), 5),
                                      ((1, 1, 1), 2), ((2, 6, 6), 7)])
def test_refs_match_signature_kern(shape, nl, order):
    M = 0.4 * np.random.default_rng(nl + order).standard_normal(shape)
    want = jsig.signature_kern(M, nl, order=order)
    Mt = torch.as_tensor(M)
    got = (tsg.sig_gram_levels(Mt, nl) if order == 1
           else tsg.sig_gram_levels_ho(Mt, nl, order))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_wrappers_match_pallas_interpret(order):
    M = 0.4 * np.random.default_rng(30 + order).standard_normal((3, 9, 12))
    nl = 5
    if order == 1:
        want = jsg.sig_gram_levels(jnp.asarray(M), nl, True)
        got = tsg.sig_gram_levels(torch.as_tensor(M), nl)
    else:
        want = jsg.sig_gram_levels_ho(jnp.asarray(M), nl, order, True)
        got = tsg.sig_gram_levels_ho(torch.as_tensor(M), nl, order)
    assert _scaled_err(got, want) < 1e-5


@pytest.mark.parametrize("order", [1, 2, 4])
def test_levels_are_symmetric_under_transpose(order):
    M = torch.as_tensor(0.4 * np.random.default_rng(order).standard_normal(
        (3, 7, 11)))
    torch.testing.assert_close(
        tsg.sig_gram_levels_ho_ref(M, 4, order),
        tsg.sig_gram_levels_ho_ref(M.transpose(1, 2), 4, order),
        rtol=1e-12, atol=1e-14)


def test_wrappers_take_plain_path_on_cpu_without_launching():
    M = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 5, 6)))
    before = (tsg.launches, tsg.ho_launches)
    torch.testing.assert_close(tsg.sig_gram_levels(M, 3),
                               tsg.sig_gram_levels_ref(M, 3), rtol=0, atol=0)
    torch.testing.assert_close(tsg.sig_gram_levels_ho(M, 3, 2),
                               tsg.sig_gram_levels_ho_ref(M, 3, 2), rtol=0,
                               atol=0)
    assert (tsg.launches, tsg.ho_launches) == before
    with pytest.raises(ValueError, match="order >= 2"):
        tsg.sig_gram_levels_ho(M, 3, 1)


def test_backward_function_hands_off_to_bwd():
    """The backward is ported: ``_SigGramLevels.backward`` hands M and the
    cotangent to ``sig_gram_levels_bwd`` (order 1) or
    ``sig_gram_levels_ho_bwd`` (the kernels on the card, the plain VJP for
    these CPU tensors)."""
    rng = np.random.default_rng(9)
    M = torch.as_tensor(0.4 * rng.standard_normal((2, 5, 4)))
    g = torch.as_tensor(rng.standard_normal((4, 2)))
    for order in (1, 2):
        ctx = SimpleNamespace(saved_tensors=(M,), args=(3, order))
        gm, *rest = tsg._SigGramLevels.backward(ctx, g)
        torch.testing.assert_close(
            gm, tsg.sig_gram_levels_ho_bwd_ref(M, g, 3, order), rtol=1e-12,
            atol=0)
        assert rest == [None, None]


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("nl", [8, 12, 127])
def test_deep_refs_match_signature_kern(nl, order):
    M = np.random.default_rng(nl + order).standard_normal((2, 9, 12)) / 4
    want = np.asarray(jsig.signature_kern(M, nl, order=order))
    Mt = torch.as_tensor(M)
    got = (tsg.sig_gram_levels(Mt, nl) if order == 1
           else tsg.sig_gram_levels_ho(Mt, nl, order))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-300)
    g = np.random.default_rng(0).standard_normal((nl + 1, 2))
    gt = torch.as_tensor(g)
    jgrad = jax.grad(lambda m: jnp.sum(jnp.asarray(g) * jsig.signature_kern(
        m, nl, order=order)))(jnp.asarray(M))
    got = (tsg.sig_gram_levels_bwd(Mt, gt, nl) if order == 1
           else tsg.sig_gram_levels_ho_bwd(Mt, gt, nl, order))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgrad), rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("nl,p,backward,slots", [
    (8, 1, False, 8), (8, 1, True, 8 + 7 * 3), (10, 2, False, 19),
    (10, 2, True, 19 + 9 * 8), (127, 3, True, 127 + 126 * 17),
])
def test_deep_slots_count_the_state(nl, p, backward, slots):
    """Forward: T_m for every level and RA_m[q] below the top one;
    backward also the rebuilt states (p²), E_m, CP_m[q], Rtot_m and
    Rrow_m[q] below the top level (deep_levels.cuh's DeepSlots)."""
    assert plan.deep_slots(nl, p, backward) == slots


def test_deep_plan_takes_shared_memory_or_the_workspace():
    # order 1 at 10 levels, L2 = 49: a segment of 32 lanes a matrix at two
    # rows a lane, 10 slots of 64 rows in float32, four matrices a block
    small = plan.sig_gram_plan(2048, 49, 49, 10, 1, 4, False)
    assert (small["S"], small["R"], small["bands"], small["work"]) == \
        (32, 2, 1, 0)
    assert small["area"] == 10 * 64
    assert small["smem"] == 4 * 10 * 64 * 4
    assert small["blocks"] == 512
    # order 1 at 127 levels, L2 = 600, float64: ten bands of 64 rows on 8
    # warps, 127 slots a row and the carries of 126 scans a column at 9
    # boundaries, 723 KB a matrix, so the device workspace, the grid
    # bounded by it
    big = plan.sig_gram_plan(2048, 8, 600, 127, 1, 8, False)
    assert (big["S"], big["R"], big["bands"], big["W"]) == (32, 2, 10, 8)
    assert big["area"] == 9 * 8 * 126 + 10 * 127 * 64
    assert big["area"] * 8 > plan.SMEM_BYTES and not big["area_smem"]
    assert big["blocks"] == plan.SIG_GRAM_MAX_BLOCKS
    assert big["work"] == big["blocks"] * big["area"]
    assert big["smem"] == 16 * 5 + 8 * 8 * 127
    huge = plan.sig_gram_plan(10 ** 6, 1024, 1024, 127, 3, 8, True)
    assert huge["work"] * 8 <= plan.WORKSPACE_BYTES
    # past the old 1024-row bound the rows go in bands; only a matrix whose
    # band carries exceed the workspace has no plan
    past = plan.sig_gram_plan(4, 9, plan.MAX_ROWS + 1, 8, 1, 4, False)
    assert past["bands"] == 17 and past["W"] == 8
    assert plan.sig_gram_plan(1, 10 ** 6, 10 ** 5, 8, 1, 4, True) is None