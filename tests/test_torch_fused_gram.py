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
from gpsig_tpu_torch.ops.cuda import plan

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


# -- the Gram forwards' segment plan ------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("nl", [1, 4, 5, 7])
def test_gram_forward_plan_covers_the_rows(nl, itemsize):
    """The order-1 Gram's plan: one warp up to 256 rows at R = 8 (the
    level bound's carries fit the registers), the fewest lanes S of 8, 16,
    32 with S·R >= rows; the block design above, up to MAX_ROWS; None past
    it; its shared memory within a block's up to L = 257 at d = 8."""
    R = plan.gram_fwd_rows_per_lane(1, nl, itemsize, tuned=True)
    assert R == 8
    for rows in range(1, plan.MAX_ROWS + 1, 7):
        S, R_, W = plan.gram_fwd_plan(rows, rows + 1, 8, 1, nl, itemsize,
                                      tuned=True)
        if rows <= 256:
            assert (W, R_) == (1, 8) and S * R_ >= rows
            assert S == 8 or S // 2 * R_ < rows
        else:
            assert (S, R_) == (32, 4) and 2 <= W <= plan.MAX_WARPS
            assert 32 * W * 4 >= rows
        assert plan.gram_fwd_smem(rows + 1, 8, S, R_, W, itemsize) \
            <= plan.SMEM_BYTES
    assert plan.gram_fwd_plan(plan.MAX_ROWS + 1, plan.MAX_ROWS + 2, 8, 1,
                              nl, itemsize, tuned=True) is None


def parent_widest_d(L, itemsize):
    """The widest d whose Gram forward the one-warp design before segments
    took at L: x and four pairs' y with their half norms in one block's
    shared memory up to 128 rows, x and y and the W warps' exchange past
    that."""
    W = -(-(L - 1) // 128)
    pairs, ex = (4, 0) if W == 1 else (1, 2 * W * itemsize)
    return (plan.SMEM_BYTES - ex) // (itemsize * L * (1 + pairs)) - 1


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("L", [50, 150])
@pytest.mark.parametrize("P,tuned", [(1, True), (2, False), (3, False)])
def test_gram_forward_plan_takes_every_width_it_took_before(L, itemsize, P,
                                                            tuned):
    """Every d up to the widest that the design before segments took
    (231 / 115 at L = 50 in float32 / float64, 192 / 95 at L = 150) gets a
    plan within a block's shared memory: one warp wherever a segment
    covers the rows, its pairs' y staged while they fit and read from
    global memory past that (only their half norms staged); the block
    design where no segment covers the rows."""
    rows = L - 1
    widest = parent_widest_d(L, itemsize)
    assert widest == {(50, 4): 231, (50, 8): 115, (150, 4): 192,
                      (150, 8): 95}[L, itemsize]
    R = plan.gram_fwd_rows_per_lane(P, 4, itemsize, tuned)
    one_warp = 32 * max(R, 4) >= rows
    layouts = set()
    for d in range(1, widest + 1):
        S, R_, W = plan.gram_fwd_plan(rows, L, d, P, 4, itemsize, tuned)
        smem = plan.gram_fwd_smem(L, d, S, R_, W, itemsize)
        assert smem <= plan.SMEM_BYTES
        assert (W == 1) == one_warp and S * R_ * W >= rows
        if W == 1:
            # y staged, or only the half norms
            staged = itemsize * ((R_ + 1) * d * S
                                 + 128 // S * ((L * (d + 1)) | 1))
            layouts.add(smem == staged)
    assert layouts == ({True, False} if one_warp else set())
    X = torch.zeros(1, L, widest, dtype=torch.float32 if itemsize == 4
                    else torch.float64)
    if tuned:
        assert tfg._forward_plan("k", X, False, 4) == ((8, 8, 1) if L == 50
                                                       else (32, 8, 1))


def test_gram_forward_plan_raises_above_what_it_takes():
    """The one bound that remains is 1024 rows; a shape whose x and y do
    not fit a block's shared memory (L = 150, d = 300, float64, where no
    segment's x fits either) takes the block design with x and y read
    from global memory: only the half norms and the exchange staged."""
    X = torch.zeros(1, plan.MAX_ROWS + 2, 2)
    with pytest.raises(ValueError, match="at most 1024"):
        tfg._forward_plan("k", X, diag=False, num_levels=4)
    wide = tfg._forward_plan("k", torch.zeros(1, 150, 300,
                                              dtype=torch.float64),
                             diag=False, num_levels=4)
    assert wide == (32, 4, 2)
    assert plan.gram_fwd_smem(150, 300, *wide, 8) \
        == 8 * 2 * 150 + plan.exchange_bytes(2, 8) <= plan.SMEM_BYTES
    assert tfg._forward_plan("k", torch.zeros(1, 50, 2), False, 4) \
        == (8, 8, 1)
    assert tfg._forward_plan("k", torch.zeros(1, 150, 2), False, 4) \
        == (32, 8, 1)
    assert tfg._forward_plan("k", torch.zeros(1, 257, 2), False, 4) \
        == (32, 8, 1)
    assert tfg._forward_plan("k", torch.zeros(1, 258, 2), False, 4) \
        == (32, 4, 3)
    # the diagonal's plan: one sequence (one warp to fill) at 2 rows a
    # lane over 32 lanes, everything staged
    p = tfg._forward_plan("k", torch.zeros(1, 50, 2), diag=True,
                          num_levels=4)
    assert (p["S"], p["R"], p["bands"], p["stage"]) == (32, 2, 1,
                                                        plan.DIAG_STAGE_ALL)


def seg_prefix(v, S):
    """csrc/common.cuh's WarpGroup<T, S>::prefix on v [32, R] (one warp,
    lane-major rows): the in-lane exclusive prefix, then log2(S)
    shuffle-up steps of the lanes' totals within S-lane segments (a lane
    whose source lies before its segment keeps its own value and adds
    nothing), and one more shuffle up that hands each lane its
    predecessor's inclusive total (0 at a segment's first lane)."""
    within = torch.cumsum(v, 1) - v
    own = v.sum(1)
    lane = torch.arange(32) % S
    incl = own.clone()
    off = 1
    while off < S:
        src = torch.arange(32) - off
        shifted = torch.where(lane >= off, incl[src.clamp(min=0)], incl)
        incl = torch.where(lane >= off, incl + shifted, incl)
        off *= 2
    excl = torch.where(lane >= 1, incl[(torch.arange(32) - 1).clamp(min=0)],
                       torch.zeros_like(incl))
    return within + excl[:, None]


def seg_sum(v, S):
    """The segment's butterfly sum (WarpGroup::sum), one value a lane."""
    off = S // 2
    while off:
        v = v + v[torch.arange(32) ^ off]
        off //= 2
    return v


def seg_columns(X, Ys, S, R, kind="rbf", difference=True):
    """common.cuh's SegBlock and SegColumns for one warp: lane l takes pair
    l // S (y = Ys[l // S]), rows (l % S)·R + r; its R + 1 points clamped
    to the sequence; a generator of the columns of M [32, R], rows past
    the matrix exactly 0."""
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho

    L = X.shape[0]
    rows = L - 1 if difference else L
    t = torch.arange(32) % S
    pts = torch.clamp(t[:, None] * R + torch.arange(R + 1)[None, :],
                      max=L - 1)
    first = t[:, None] * R + torch.arange(R)[None, :]
    valid = first < rows
    ys = Ys[torch.arange(32) // S]  # [32, L, d]
    xs = X[pts]  # [32, R + 1, d]

    def values(j):
        y = ys[:, j]  # [32, d]
        return torch.stack([tfgho.base_gram(xs[l], y[l:l + 1], kind)[:, 0]
                            for l in range(32)])

    kprev = values(0) if difference else None
    for j in range(rows):
        if difference:
            knew = values(j + 1)
            v = (knew[:, 1:] - kprev[:, 1:]) - (knew[:, :-1] - kprev[:, :-1])
            kprev = knew
        else:
            v = values(j)[:, :R]
        yield torch.where(valid, v, torch.zeros_like(v))


def seg_order1_levels(X, Ys, nl, S, R, rbf=True):
    """fused_gram.cu's gram_seg_kernel on one warp of 32 / S pairs (x, Ys[p])
    (pairs past Ys stage its last): every level below the bound NLM
    updated, descending, per column; [nl + 1, pairs]."""
    nlm = plan.gram_fwd_levels(1, nl, tuned=True)
    pairs = 32 // S
    Ys = torch.cat([Ys, Ys[-1:].expand(pairs - len(Ys), -1, -1)])
    C = torch.zeros(nlm, 32, R, dtype=X.dtype)
    for mcol in seg_columns(X, Ys, S, R, "rbf" if rbf else "linear"):
        for m in range(nlm - 1, 0, -1):
            C[m] += mcol * seg_prefix(C[m - 1], S)
        C[0] += mcol
    lv = [seg_sum(C[m].sum(1), S)[::S] for m in range(nl)]
    return torch.stack([torch.ones(pairs, dtype=X.dtype)] + lv)


@pytest.mark.parametrize("rows", [19, 49, 149, 256])
def test_segment_model_matches_plain_and_xla_reference(rows):
    """The segment plan's design, lane by lane, at the plan's (S, R) for
    float32 (one warp up to 256 rows), in float64: several pairs a warp
    (the last segments' pairs past Y), lane-major points, rows past the
    matrix zero, the segmented scan; against the plain version and the
    JAX package's reference, scaled error 1e-12 (other summation order
    only)."""
    L, nl = rows + 1, 4
    S, R, W = plan.gram_fwd_plan(rows, rows + 1, 2, 1, nl, 4, tuned=True)
    assert W == 1
    rng = np.random.default_rng(rows)
    steps = 0.3 * np.sqrt(50 / L)
    X = (steps * rng.standard_normal((1, L, 2))).cumsum(1)
    Y = (steps * rng.standard_normal((max(1, 32 // S - 1), L, 2))).cumsum(1)
    for rbf in (True, False):
        got = seg_order1_levels(torch.as_tensor(X[0]), torch.as_tensor(Y),
                                nl, S, R, rbf)[:, :len(Y)]
        want = tfg.fused_gram_levels_ref(torch.as_tensor(X),
                                         torch.as_tensor(Y), nl, rbf)[:, 0]
        assert _scaled_err(got, want) < 1e-12
        xla = np.asarray(jfg._xla_reference(jnp.asarray(X), jnp.asarray(Y),
                                            nl, rbf))[:, 0]
        assert _scaled_err(got, xla) < 1e-12
