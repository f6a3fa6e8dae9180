"""Parity of the port's fused tensor-vs-sequence levels
(``ops/cuda/tens_seq.py``) with ``gpsig_tpu/ops/pallas/tens_seq.py``.

- Plain version against ``_xla_reference_tens_seq`` in float64: rtol
  1e-10 (the same unclamped formulas).
- One interpret-mode call of the Pallas kernel: its in-kernel products
  accumulate in float32 even on float64 inputs, so scaled error 1e-5.

- The launch plans of both order-1 Kuf kernels at every d up to 2048 (the
  schedules themselves: ``test_torch_tens_seq_schedule.py``).

The CUDA kernel itself is checked on the card by
``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops.pallas import tens_seq as jts
from gpsig_tpu_torch.ops.cuda import plan
from gpsig_tpu_torch.ops.cuda import tens_seq as tts

torch.set_num_threads(1)


def _inputs(rng, T, N, L, d, nl, increments):
    F = nl * (nl + 1) // 2
    shape = (T, F, 2, d) if increments else (T, F, d)
    Z = 0.4 * rng.standard_normal(shape)
    X = (0.3 * rng.standard_normal((N, L, d))).cumsum(1)
    return Z, X


def _scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("increments", [False, True])
@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 3, 4])
def test_ref_matches_xla_reference(increments, rbf, nl):
    Z, X = _inputs(np.random.default_rng(nl), 5, 6, 10, 2, nl, increments)
    want = np.asarray(jts._xla_reference_tens_seq(
        jnp.asarray(Z), jnp.asarray(X), nl, rbf, increments))
    got = tts.fused_tens_seq_levels_ref(torch.as_tensor(Z),
                                        torch.as_tensor(X), nl, rbf,
                                        increments).numpy()
    assert got.shape == (nl + 1, 5, 6)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def test_wrapper_takes_plain_path_on_cpu_without_launching():
    Z, X = _inputs(np.random.default_rng(1), 3, 4, 8, 2, 3, True)
    Z, X = torch.as_tensor(Z), torch.as_tensor(X)
    before = tts.launches
    torch.testing.assert_close(
        tts.fused_tens_seq_levels(Z, X, 3, True, True),
        tts.fused_tens_seq_levels_ref(Z, X, 3, True, True), rtol=0, atol=0)
    assert tts.launches == before


@pytest.mark.parametrize("increments", [False, True])
def test_matches_pallas_interpret(increments):
    Z, X = _inputs(np.random.default_rng(9), 4, 3, 9, 2, 3, increments)
    want = jts.fused_tens_seq_levels(jnp.asarray(Z), jnp.asarray(X), 3,
                                     True, increments, True)
    got = tts.fused_tens_seq_levels(torch.as_tensor(Z), torch.as_tensor(X),
                                    3, True, increments)
    assert _scaled_err(got, want) < 1e-5


# -- launch plans (ops/cuda/plan.py): every d gets one ----------------------


@pytest.mark.parametrize("nl", range(1, 8))
def test_every_d_gets_a_plan(nl):
    """Both order-1 Kuf kernels get a launch plan at every d up to 2048, both
    ``increments`` and both dtypes: the order-1 forward wherever its 4-vector
    records fit the shared memory (one a factor point with its half norm up
    to d = 3, ceil(d / 4) and a half norm past it), a sequence a thread; the
    order-1 backward up to d = 3, blocks of two warps; past those the
    general kernel's plan (the same function at order 1), its backward's
    workspace in its bound."""
    for itemsize in (4, 8):
        for increments in (True, False):
            F2 = plan.factor_count(nl, increments)
            for d in range(1, 2049):
                fp = plan.kuf_fwd_plan(2048, F2, d, nl, itemsize, tuned=True)
                assert fp["smem"] <= plan.SMEM_BYTES
                smem = itemsize * F2 * (4 if d <= 3 else 4 * -(-d // 4) + 1)
                if smem <= plan.SMEM_BYTES:
                    assert fp == dict(route="tuned", threads=128, seqs=1,
                                      staged=True, smem=smem)
                else:
                    assert fp == plan.kuf_fwd_plan(2048, F2, d, nl, itemsize)
                for T, N in ((500, 50), (1, 1), (64, 2048)):
                    bp = plan.kuf_bwd_plan(T, N, F2, d, itemsize, tuned=True)
                    assert bp is not None and bp["smem"] <= plan.SMEM_BYTES
                    if d <= plan.KUF_TUNED_MAX_D:
                        assert (bp["route"], bp["threads"], bp["staged"]) == (
                            "tuned", 64, True)
                        assert bp["blocks"] == bp["items"] == T * -(
                            -N // (2 * bp["ppw"]))
                    else:
                        assert bp == plan.kuf_bwd_plan(T, N, F2, d, itemsize)
                        assert (bp["work"] * itemsize
                                <= plan.WORKSPACE_BYTES)


def test_backward_refuses_past_the_workspace_bound():
    """Past what one block's partial sums may take of the workspace the
    plan is None and the wrapper's check names the bound."""
    F2 = plan.factor_count(7, True)
    d = plan.WORKSPACE_BYTES // (8 * F2 * 32)
    assert plan.kuf_bwd_plan(2, 3, F2, d, 8, tuned=True) is None
    with pytest.raises(ValueError, match=str(plan.WORKSPACE_BYTES)):
        plan.check_kuf("tens_seq_bwd", None, f"d={d}")
