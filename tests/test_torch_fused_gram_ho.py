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
from gpsig_tpu_torch.ops.cuda import plan

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


def test_backward_function_hands_off_to_bwd():
    """The backward is ported: ``_GramHoLevels.backward`` hands the saved
    inputs and the cotangent to ``fused_gram_ho_levels_bwd`` (the kernel on
    the card, the plain VJP for these CPU tensors) and returns a gradient
    only for the inputs that need one."""
    X, Y = map(torch.as_tensor, _inputs(np.random.default_rng(7), 3, 2, 6,
                                        2, "cosine"))
    g = torch.as_tensor(np.random.default_rng(8).standard_normal((4, 3, 2)))
    args = (3, 2, "cosine", False)
    ctx = SimpleNamespace(saved_tensors=(X, Y), args=args,
                          needs_input_grad=(True, False) + (False,) * 5)
    gx, gy, *rest = tfgho._GramHoLevels.backward(ctx, g)
    want, _ = tfgho.fused_gram_ho_levels_bwd_ref(X, Y, g, *args)
    torch.testing.assert_close(gx, want, rtol=1e-12, atol=0)
    assert gy is None and rest == [None] * 5


# -- the segment plan --------------------------------------------------------

@pytest.mark.parametrize("order,nl,itemsize,R", [
    (1, 4, 4, 8), (1, 7, 8, 8), (2, 4, 4, 8), (2, 4, 8, 4), (2, 5, 4, 4),
    (2, 5, 8, 2), (3, 4, 4, 4), (3, 7, 8, 2), (4, 4, 4, 2), (7, 7, 4, 2)])
def test_gram_forward_plan_fits_the_state(order, nl, itemsize, R):
    """Rows a lane from the run-length state's size (p² + NLM +
    (NLM - 1)(p - 1) values a row, NLM = 4 for order 2 up to 4 levels):
    the most of 8, 4, 2 within 128 registers; one warp up to 32·R rows,
    lanes of 8, 16, 32 up to order 3 and 32 above; where R = 2, one warp
    of 32 lanes at 4 rows a lane up to 128 rows, as before segments; the
    block design past one warp, up to MAX_ROWS, within a block's shared
    memory."""
    p = min(order, nl)
    assert plan.gram_fwd_rows_per_lane(p, nl, itemsize) == R
    lanes = plan.SEG_LANES if p <= 3 else (32,)
    for rows in range(1, plan.MAX_ROWS + 1, 5):
        S, R_, W = plan.gram_fwd_plan(rows, rows, 8, p, nl, itemsize)
        if rows <= 32 * R:
            assert W == 1 and R_ == R and S in lanes and S * R >= rows
            assert S == lanes[0] or S // 2 * R < rows
        elif R == 2 and rows <= 128:
            assert (S, R_, W) == (32, 4, 1)
        else:
            assert (S, R_) == (32, 4) and 2 <= W <= plan.MAX_WARPS
            assert 32 * W * 4 >= rows
        assert plan.gram_fwd_smem(rows, 8, S, R_, W, itemsize) \
            <= plan.SMEM_BYTES
    assert plan.gram_fwd_plan(plan.MAX_ROWS + 1, plan.MAX_ROWS + 1, 8, p, nl,
                              itemsize) is None


def test_gram_forward_plan_takes_one_warp_to_256_rows():
    """Order 2 at 4 levels (float32): a warp a pair up to 256 rows (L = 257
    with difference, 256 without), four pairs a warp at L = 50; refused
    past MAX_ROWS."""
    X = torch.zeros(1, 257, 2)
    assert tfgho._plan("k", X, True, False, 4, 2) == (32, 8, 1)
    assert tfgho._plan("k", X[:, :256], False, False, 4, 2) == (32, 8, 1)
    assert tfgho._plan("k", X, False, False, 4, 2) == (32, 4, 3)
    assert tfgho._plan("k", X[:, :50], True, False, 4, 2) == (8, 8, 1)
    assert tfgho._plan("k", X[:, :50], True, False, 4, 3) == (16, 4, 1)
    with pytest.raises(ValueError, match="at most 1024"):
        tfgho._plan("k", torch.zeros(1, plan.MAX_ROWS + 1, 2), False, False,
                    4, 2)
    # the backward keeps its plan: one warp a pair at 2 rows a lane, staged
    bp = tfgho._plan("k", X[:, :50], True, True)
    assert (bp["W"], bp["R"], bp["staged"]) == (1, 2, True)


@pytest.mark.parametrize("order,nl,dtype", [
    (3, 4, torch.float64), (2, 6, torch.float64), (4, 4, torch.float32),
    (7, 7, torch.float32)])
def test_gram_forward_plan_keeps_one_warp_where_two_rows_a_lane_fit(
        order, nl, dtype):
    """Where the state takes only 2 rows a lane, 65-128 rows still take
    one warp (32 lanes at 4 rows a lane, as before segments), not the
    block design; up to 64 rows 2 rows a lane; past 128 the block."""
    X = torch.zeros(1, 130, 2, dtype=dtype)
    assert tfgho._plan("k", X[:, :65], True, False, nl, order)[1:] == (2, 1)
    assert tfgho._plan("k", X[:, :66], True, False, nl, order) == (32, 4, 1)
    assert tfgho._plan("k", X[:, :129], True, False, nl, order) == (32, 4, 1)
    assert tfgho._plan("k", X, True, False, nl, order) == (32, 4, 2)


@pytest.mark.parametrize("L,d,dtype", [
    (50, 231, torch.float32), (50, 115, torch.float64),
    (150, 192, torch.float32), (150, 95, torch.float64)])
def test_gram_forward_plan_takes_the_widest_sequences_it_took(L, d, dtype):
    """The widest d that the design before segments took at L = 50 and 150
    (lag-augmented or wide UEA data) keeps one warp a pair wherever a
    segment covers the rows (its y read from global memory), the block
    design elsewhere; past every design's shared memory (d = the block's
    shared memory in values) the block design takes the shape with x and
    y read from global memory."""
    X = torch.zeros(1, L, d, dtype=dtype)
    item = X.element_size()
    for order in (1, 2, 3):
        S, R, W = tfgho._plan("k", X, True, False, 4, order)
        R_lane = plan.gram_fwd_rows_per_lane(min(order, 4), 4, item)
        assert (W == 1) == (32 * max(R_lane, 4) >= L - 1)
        assert plan.gram_fwd_smem(L, d, S, R, W, item) <= plan.SMEM_BYTES
    over = plan.SMEM_BYTES // item
    S, R, W = tfgho._plan("k", torch.zeros(1, L, over, dtype=dtype), True,
                          False, 4, 2)
    assert (S, R) == (32, 4) and W == max(2, -(-(L - 1) // 128))
    assert plan.gram_fwd_smem(L, over, S, R, W, item) \
        == item * 2 * L + plan.exchange_bytes(W, item)


def run_length_model(X, Ys, nl, order, kind, difference, S, R):
    """fused_gram_ho.cuh's gram_ho_seg_kernel on one warp: common.cuh's
    rl_level column by column on the segment columns and scans of
    ``test_torch_fused_gram``'s model; [nl + 1, pairs]."""
    from tests.test_torch_fused_gram import seg_columns, seg_prefix, seg_sum

    P = min(order, nl)
    pairs = 32 // S
    Ys = torch.cat([Ys, Ys[-1:].expand(pairs - len(Ys), -1, -1)])
    z = torch.zeros(32, R, dtype=X.dtype)
    grid = [[z.clone() for _ in range(P)] for _ in range(P)]
    tsum = [z.clone() for _ in range(nl)]
    ra = [[z.clone() for _ in range(max(P - 1, 1))] for _ in range(nl)]
    for mcol in seg_columns(X, Ys, S, R, kind, difference):
        grid[0][0] = mcol
        for M in range(2, nl + 1):
            Rm, Rp = min(P, M), min(P, M - 1)
            tot = sum(grid[a][b] for a in range(Rp) for b in range(Rp))
            colpre = [seg_prefix(sum(grid[a][q] for a in range(Rp)), S)
                      for q in range(Rm - 1)]
            rowsum = [sum(grid[q][a] for a in range(Rp))
                      for q in range(Rm - 1)]
            pre = seg_prefix(tsum[M - 2], S)
            old = [row[:] for row in grid]
            for a in range(1, Rm):
                for b in range(1, Rm):
                    grid[a][b] = mcol / ((a + 1) * (b + 1)) * old[a - 1][b - 1]
                grid[a][0] = mcol / (a + 1) * ra[M - 2][a - 1]
                grid[0][a] = mcol / (a + 1) * colpre[a - 1]
            grid[0][0] = mcol * pre
            tsum[M - 2] = tsum[M - 2] + tot
            for q in range(Rm - 1):
                ra[M - 2][q] = ra[M - 2][q] + rowsum[q]
        Rm = min(P, nl)
        tsum[nl - 1] = tsum[nl - 1] + sum(grid[a][b] for a in range(Rm)
                                          for b in range(Rm))
    lv = [seg_sum(tsum[m].sum(1), S)[::S] for m in range(nl)]
    return torch.stack([torch.ones(pairs, dtype=X.dtype)] + lv)


@pytest.mark.parametrize("rows", [19, 49, 149, 256])
@pytest.mark.parametrize("order,kind,difference", [
    (2, "rbf", True), (1, "poly2", True), (2, "cosine", False)])
def test_segment_model_matches_plain_and_xla_reference(rows, order, kind,
                                                       difference):
    """The general Gram's segment plan (float32's (S, R): one warp up to
    256 rows at order 2), lane by lane in float64: several pairs a warp,
    rows past the matrix zero, the segmented scans of the run-length DP;
    against the plain version and ``_xla_reference_ho``, scaled error
    1e-12 (other summation order only)."""
    L, nl = rows + difference, 4
    S, R, W = plan.gram_fwd_plan(rows, L, 2, min(order, nl), nl, 4)
    assert W == 1
    rng = np.random.default_rng(rows + order)
    X, Y = _inputs(rng, 1, max(1, 32 // S - 1), L, 2, kind)
    X *= np.sqrt(50 / L)
    Y *= np.sqrt(50 / L)
    if kind.startswith("poly"):
        X[..., -1], Y[..., -1] = 1.0, 0.7
    got = run_length_model(torch.as_tensor(X[0]), torch.as_tensor(Y), nl,
                           order, kind, difference, S, R)[:, :len(Y)]
    want = tfgho.fused_gram_ho_levels_ref(
        torch.as_tensor(X), torch.as_tensor(Y), nl, order, kind,
        difference)[:, 0]
    assert _scaled_err(got, want) < 1e-12
    xla = np.asarray(jfgho._xla_reference_ho(
        jnp.asarray(X), jnp.asarray(Y), nl, order, kind, difference))[:, 0]
    assert _scaled_err(got, xla) < 1e-12
