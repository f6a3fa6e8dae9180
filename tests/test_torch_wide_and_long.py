"""The order-1 main path at every d and L: the launch plans of the
Gram-side kernels past their shared memory, float64 models of the two
redesigned schedules, and the wide-d SVGP against ``gpsig_tpu``, on the
CPU.

- Plans (``ops/cuda/plan.py``, ``ops/cuda/goursat.py``): every d from 1 to
  2048 at L = 2 .. 1025, float32 and float64, gets a plan within a block's
  shared memory for the diagonal, both Gram backwards and both Gram
  forwards; the diagonal also past 1024 rows; the one bound left is 1024
  rows on the Gram kernels.
- The diagonal's schedule (``csrc/fused_gram.cu``'s diag_kernel): a
  segment of S lanes at R rows a lane, the rows in bands of S·R, each
  column's level prefixes started from the carry of the rows above the
  band, the carry the band leaves for the next.
- The Goursat forward's schedule (``csrc/goursat.cu``): lanes of RL
  refined rows, a skewed wavefront (lane t at column s - t, the row above
  from lane t - 1), bands of S·RL rows whose bottom rows feed the next.

Each model is held against the plain versions and the JAX package on
numpy-seeded inputs: the diagonal against ``_xla_reference_diag`` and the
plain version (rtol 1e-12: one recursion, another summation order), the
Goursat forward bitwise against the plain sweep (each cell is its
expression in its order) and against ``gpsig_tpu.ops.goursat`` (1e-12).
The wide-d SVGP's ELBO and gradient (the JAX package's XLA engine, which
clamps the RBF squared distance: the diagonal's coincident points differ
by rounding) to 1e-10. The CUDA kernels themselves are checked on the
card by ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import inducing as jind
from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu.ops import goursat as jgoursat
from gpsig_tpu.ops.pallas import fused_gram as jfg
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.models import svgp as tsvgp
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho
from gpsig_tpu_torch.ops.cuda import goursat as tgs
from gpsig_tpu_torch.ops.cuda import plan

torch.set_num_threads(1)
PLAN_LENGTHS = [2, 50, 65, 129, 150, 300, 1025]


# -- the launch plans ---------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("L", PLAN_LENGTHS)
def test_every_d_gets_a_gram_side_plan(L, itemsize):
    """d = 1 .. 2048 at L: the diagonal (nl 4 and 7), the order-1 and the
    general Gram backward, the order-1 Gram forward and the general one at
    orders 2 and 3 each get a plan within SMEM_BYTES; where it does not
    stage, the diagonal and the backwards read from global memory (their
    workspaces within their bounds)."""
    rows = L - 1
    for d in range(1, 2049):
        for nl in (4, 7):
            p = plan.diag_plan(2048, L, d, nl, itemsize)
            assert p["smem"] <= plan.SMEM_BYTES and p["S"] * p["R"] * \
                p["bands"] >= rows
            assert p["work"] * itemsize <= plan.WORKSPACE_BYTES
        b1 = plan.gram_bwd_launch(150, 150, L, d, itemsize)
        bho = plan.gram_ho_bwd_launch(150, 150, rows, L, d, itemsize)
        for b in (b1, bho):
            assert b["smem"] <= plan.SMEM_BYTES and b["blocks"] >= 1
            assert b["work"] * itemsize <= max(
                plan.WORKSPACE_BYTES, L * (d + 1) * 4 * itemsize)
        for P, tuned in ((1, True), (2, False), (3, False)):
            wr = plan.gram_fwd_plan(rows, L, d, P, 4, itemsize, tuned)
            assert plan.gram_fwd_smem(L, d, *wr, itemsize) <= plan.SMEM_BYTES


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("L", [1026, 3000, 8193])
def test_diagonal_takes_every_length(L, itemsize):
    """Past 1024 rows the diagonal still gets a plan (32 lanes, bands of
    256 rows) at every d, its carries in shared memory where they fit,
    while the Gram kernels refuse the length with the row bound."""
    for d in (1, 3, 64, 400, 963, 1345, 2048):
        for nl in (1, 4, 5, 7):
            p = plan.diag_plan(100, L, d, nl, itemsize)
            assert (p["S"], p["R"]) == (32, 8)
            assert p["bands"] == -(-(L - 1) // 256)
            assert p["smem"] <= plan.SMEM_BYTES
            assert p["carry_smem"] or p["work"] > 0 or nl == 1
    X = torch.zeros(1, L, 3, dtype=torch.float32 if itemsize == 4
                    else torch.float64)
    assert tfg._forward_plan("k", X, diag=True, num_levels=5)["bands"] > 4
    for call in (lambda: tfg._forward_plan("k", X, False, 4),
                 lambda: tfg._backward_plan("k", X),
                 lambda: tfgho._plan("k", X, True, False, 4, 2),
                 lambda: tfgho._plan("k", X, True, True)):
        with pytest.raises(ValueError, match="at most 1024"):
            call()


def test_plans_at_the_shapes_that_were_refused():
    """The shapes the plan arithmetic refused before: PEMS-SF's diagonal
    (d = 963, L = 144), MotorImagery's (d = 64, L = 3000) and the order-1
    Gram backward at d = 64, L = 50 in both dtypes."""
    pems = plan.diag_plan(173, 144, 963, 5, 4)
    assert (pems["S"], pems["bands"], pems["stage"]) == (
        32, 1, plan.DIAG_STAGE_NONE)
    mi = plan.diag_plan(100, 3000, 64, 4, 4)
    assert (mi["bands"], mi["stage"], mi["carry_smem"]) == (
        12, plan.DIAG_STAGE_OWN, True)
    # the flagship's 2048 sequences fill the card at 2 rows a lane
    flagship = plan.diag_plan(2048, 50, 3, 5, 4)
    assert (flagship["S"], flagship["R"], flagship["stage"],
            flagship["blocks"]) == (32, 2, plan.DIAG_STAGE_ALL, 2048)
    assert (plan.diag_plan(2048, 50, 3, 5, 8)["S"],
            plan.diag_plan(2048, 50, 3, 5, 8)["R"]) == (8, 8)
    for item in (4, 8):
        b = plan.gram_bwd_launch(150, 150, 50, 64, item)
        assert not b["staged"] and b["smem"] <= plan.SMEM_BYTES
        assert b["work"] == b["blocks"] * 8 * 50 * 65


def test_goursat_forward_plan_covers_every_grid():
    """One segment a pair up to 256 refined rows (the fewest RL, then the
    fewest lanes), bands of 256 past it; the slice's grids."""
    keys = ("RL", "S", "bands")
    assert {k: plan.goursat_fwd_plan(7, 49, 1, 4)[k] for k in keys} \
        == {"RL": 2, "S": 8, "bands": 1}
    assert {k: plan.goursat_fwd_plan(49, 49, 1, 4)[k] for k in keys} \
        == {"RL": 4, "S": 32, "bands": 1}
    assert plan.goursat_fwd_plan(14, 98, 0, 4)["stage"]
    big = plan.goursat_fwd_plan(199, 199, 3, 4)
    assert (big["RL"], big["S"], big["bands"], big["W"]) == (8, 32, 7, 7)
    assert big["bnd_smem"] and big["stage"]
    for Su in (1, 5, 49, 199, 1000, 4096, 4100, 8200):
        for o in range(0, 4):
            for item in (4, 8):
                p = plan.goursat_fwd_plan(Su, 49, o, item)
                R = min(Su, 49) << o
                assert p["RL"] >= min(8, 1 << o)
                assert p["S"] * p["RL"] * p["bands"] >= R
                assert p["smem"] <= plan.SMEM_BYTES
                assert p["W"] == (1 if p["bands"] == 1
                                  else min(p["bands"], 8))


def test_goursat_plan_constants_match_the_source():
    """plan.py's Goursat forward constants are the kernel's: the warps a
    banded pair and the steps a column tile spans (csrc/goursat.cu), and
    the tiles' shared memory the plan states is what the launch takes."""
    import re
    from pathlib import Path

    src = (Path(tgs.__file__).resolve().parents[2] / "csrc" /
           "goursat.cu").read_text()
    assert int(re.search(r"kFwdBandWarps = (\d+);", src).group(1)) \
        == plan.GOURSAT_BAND_WARPS
    assert 1 << int(re.search(r"kColStepsLog2 = (\d+);", src).group(1)) \
        == plan.GOURSAT_COL_STEPS
    p = plan.goursat_fwd_plan(196, 196, 0, 4)
    assert p["cols"] and p["smem"] == 2 * 32 * (
        p["RL"] * plan.GOURSAT_COL_STEPS + 1) * 16

# -- the diagonal's schedule ---------------------------------------------------

def _lane_prefix(C, S, R, start):
    """WarpGroup::prefix_from over the band's S lanes of R rows: the
    exclusive prefix of C [S·R] plus ``start`` (lane 0's carry), and the
    inclusive total the band's last lane leaves."""
    lanes = C.reshape(S, R)
    run = torch.cumsum(lanes, 1) - lanes  # within a lane
    tot = lanes.sum(1)
    tot = torch.cat([tot[:1] + start, tot[1:]])
    incl = torch.cumsum(tot, 0)
    excl = torch.cat([incl.new_zeros(1), incl[:-1]])
    pre = run + excl[:, None]
    pre[0] += start
    return pre.reshape(-1), incl[-1]


def diag_schedule_model(X, nl, S, R, rbf=True):
    """The diagonal kernel's schedule on one sequence X [L, d]: bands of S·R
    rows swept one after another over all columns, lane t of band b holding
    rows b·S·R + t·R .. + R - 1; at column j the levels in descending order,
    level m's prefix started from carry[m][j] (the rows above the band) and
    the band leaving carry[m][j] + its sum for the next; [nl + 1]."""
    L = X.shape[0]
    rows = L - 1
    K = tfg._rbf_gram(X, X) if rbf else X @ X.T
    bands = -(-rows // (S * R))
    carry = X.new_zeros(max(nl - 1, 1), rows)
    lv = X.new_zeros(nl)
    for b in range(bands):
        i = b * S * R + torch.arange(S * R)
        live = i < rows
        lo, hi = i.clamp(max=L - 1), (i + 1).clamp(max=L - 1)
        C = X.new_zeros(nl, S * R)
        for j in range(rows):
            mcol = (K[hi, j + 1] - K[hi, j]) - (K[lo, j + 1] - K[lo, j])
            mcol = torch.where(live, mcol, torch.zeros_like(mcol))
            for m in range(nl - 1, 0, -1):
                start = carry[m - 1, j] if b > 0 else X.new_zeros(())
                pre, incl = _lane_prefix(C[m - 1], S, R, start)
                if b + 1 < bands:
                    carry[m - 1, j] = incl
                C[m] += mcol * pre
            C[0] += mcol
        lv += C.sum(1)
    return torch.cat([X.new_ones(1), lv])


def _walks(rng, n, L, d):
    return (0.3 * np.sqrt(50 / L) * rng.standard_normal((n, L, d))
            * np.sqrt(2 / d)).cumsum(1)


@pytest.mark.parametrize("L,d,nl,SR", [
    (50, 3, 5, None), (257, 2, 4, None), (258, 2, 4, None),
    (300, 3, 7, None), (530, 2, 3, None), (23, 4, 5, (4, 2)),
    (41, 2, 7, (8, 2)), (40, 3, 1, (4, 2))])
def test_diagonal_band_model_matches_plain_and_jax(L, d, nl, SR):
    """The schedule at the plan's S and R (one band to L = 257, two from
    258, three at 530) and at small bands (S·R = 8, 16: up to five band
    edges), RBF and Linear, against the plain version and
    ``_xla_reference_diag``."""
    rng = np.random.default_rng(40 + L)
    Xn = _walks(rng, 2, L, d)
    X = torch.as_tensor(Xn)
    p = plan.diag_plan(2, L, d, nl, 8)
    S, R = SR or (p["S"], p["R"])
    for rbf in (True, False):
        want = tfg.fused_diag_levels_ref(X, nl, rbf)
        jwant = np.asarray(jfg._xla_reference_diag(jnp.asarray(Xn), nl, rbf))
        got = torch.stack([diag_schedule_model(x, nl, S, R, rbf) for x in X],
                          1)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-12,
                                   atol=1e-14)


# -- the Goursat forward's schedule ---------------------------------------------

def goursat_schedule_model(inc, o, RL, band_rows):
    """The forward kernel's schedule on one pair inc [Su, Tu]: the shorter
    refined side R over lanes of RL rows, bands of ``band_rows`` rows; at
    step s lane t solves column j = s - t from the row above (lane t - 1's
    last row at the previous step, or the band above's bottom row) and its
    own rows' previous column; the corner u(R, C)."""
    Su, Tu = inc.shape
    if Su > Tu:
        inc = inc.T
    R, C = min(Su, Tu) << o, max(Su, Tu) << o
    if R == 0:
        return inc.new_ones(())
    scale = 1.0 / (1 << 2 * o)
    one = inc.new_ones(())
    bottom = None
    for b0 in range(0, R, band_rows):
        lanes = -(-min(band_rows, R - b0) // RL)
        t = torch.arange(lanes)
        rows = b0 + t[:, None] * RL + torch.arange(RL)  # [lanes, RL]
        u = inc.new_ones(lanes, RL)
        top_prev = inc.new_ones(lanes)
        last = inc.new_ones(lanes)
        new_bottom = inc.new_ones(C + 1)
        corner = None
        for s in range(1, C + lanes):
            sent = torch.cat([one[None], last[:-1]])
            j = s - t
            act = (j >= 1) & (j <= C)
            jc = j.clamp(1, C)
            top = sent.clone()
            top[0] = one if bottom is None else bottom[jc[0]]
            up, upleft = top, top_prev
            for r in range(RL):
                I = rows[:, r]
                a = torch.where(I < R, inc[(I.clamp(max=R - 1) >> o),
                                           (jc - 1) >> o] * scale,
                                torch.zeros_like(top))
                left = u[:, r].clone()
                v = left + up - upleft + a * (left + up) * 0.5
                v = torch.where(act, v, left)
                upleft, up = left, v
                u[:, r] = v
            last = torch.where(act, u[:, RL - 1], last)
            top_prev = torch.where(act, top, top_prev)
            if act[-1]:
                new_bottom[jc[-1]] = u[-1, RL - 1]
            if act.any() and bool((jc == C)[act].any()):
                k = R - 1 - b0
                if 0 <= k < lanes * RL and j[k // RL] == C:
                    corner = u[k // RL, k % RL]
        bottom = new_bottom
    return corner


@pytest.mark.parametrize("Su,Tu,o,band_rows", [
    (7, 49, 1, None), (49, 49, 1, None), (13, 5, 2, None), (1, 1, 0, None),
    (49, 7, 0, None), (40, 45, 3, None), (9, 11, 1, 8), (12, 7, 2, 16),
    (0, 4, 1, None)])
def test_goursat_wavefront_model_matches_the_sweep(Su, Tu, o, band_rows):
    """The schedule at the plan's RL and lanes (one segment; bands of 256
    rows at (40, 45) order 3) and at small bands (8, 16 rows: up to six
    band edges), float64, bitwise against the plain sweep and to 1e-12
    against ``gpsig_tpu.ops.goursat``."""
    rng = np.random.default_rng(50 + Su + Tu)
    incn = 0.1 * rng.standard_normal((3, Su, Tu))
    inc = torch.as_tensor(incn)
    p = plan.goursat_fwd_plan(Su, Tu, o, 8)
    rows = band_rows or (p["S"] if p["bands"] == 1 else 32) * p["RL"]
    RL = p["RL"] if band_rows is None else 2
    want = tgs.goursat_corner_refined_ref(inc, o)
    got = torch.stack([goursat_schedule_model(x, o, RL, rows) for x in inc])
    assert torch.equal(got, want)
    if Su * Tu:  # the JAX scan takes no empty grid (u = 1 there)
        jwant = np.asarray(jgoursat.goursat_corner(
            jgoursat.refine_increments(jnp.asarray(incn), o)))
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-12,
                                   atol=1e-14)


def goursat_cols_model(inc, RL, V):
    """The forward kernel's schedule of column tiles on a given grid
    (goursat_cols): one segment of lanes of RL rows, the columns in blocks
    of V (the last block those up to C); at step s lane t solves the
    columns of block s - t, the row above's V values from lane t - 1's
    last row at the previous step; the corner u(R, C)."""
    R, C = inc.shape
    lanes = -(-R // RL)
    nb = -(-C // V)
    t = torch.arange(lanes)
    rows = (t[:, None] * RL + torch.arange(RL)).clamp(max=R - 1)
    one = inc.new_ones(())
    u = inc.new_ones(lanes, RL)
    last = inc.new_ones(lanes, V)
    top_prev = inc.new_ones(lanes)
    corner = None
    for s in range(nb + lanes - 1):
        sent = torch.cat([inc.new_ones(1, V), last[:-1]])
        jb = s - t
        live = (jb >= 0) & (jb < nb)
        cols = (jb.clamp(0, nb - 1)[:, None] * V
                + torch.arange(V)).clamp(max=C - 1)
        a = inc[rows[:, :, None], cols[:, None, :]]  # [lanes, RL, V]
        for v in range(V):
            act = live & (jb * V + v < C)
            top = torch.where(t == 0, one, sent[:, v])
            up, upleft = top, top_prev
            for r in range(RL):
                left = u[:, r].clone()
                val = left + up - upleft + a[:, r, v] * (left + up) * 0.5
                val = torch.where(act, val, left)
                upleft, up = left, val
                u[:, r] = val
            last[:, v] = torch.where(act, u[:, RL - 1], last[:, v])
            top_prev = torch.where(act, top, top_prev)
        k = (R - 1) // RL
        if bool(live[k]) and int(jb[k]) == nb - 1:
            corner = u[k, (R - 1) % RL]
    return corner


@pytest.mark.parametrize("Su,Tu,V", [
    (196, 196, 4), (196, 196, 2), (98, 100, 4), (14, 98, 2), (5, 8, 4),
    (33, 36, 4), (196, 198, 4), (14, 98, 4), (33, 35, 4), (3, 5, 2)])
def test_goursat_cols_model_matches_the_sweep(Su, Tu, V):
    """The given-grid schedule of column tiles (a block of V columns a
    step: V = 4 in float32, 2 in float64; a last block of fewer where C is
    not a multiple of V) at the plan's RL, float64, bitwise against the
    plain sweep; the plan takes it where staging would not leave room for
    GOURSAT_STAGE_BLOCKS blocks an SM."""
    rng = np.random.default_rng(70 + Su + Tu)
    inc = torch.as_tensor(0.05 * rng.standard_normal((2, Su, Tu)))
    p = plan.goursat_fwd_plan(Su, Tu, 0, 16 // V)
    got = torch.stack([goursat_cols_model(x, p["RL"], V) for x in inc])
    assert torch.equal(got, tgs.goursat_corner_ref(inc))
    block = 32 // p["S"] * Su * Tu * 16 // V
    width = plan.goursat_copy_width(Tu, 16 // V)
    assert width == (16 if Tu % V == 0 else 8 if (Tu * 16 // V) % 8 == 0
                     else 4)
    cols = plan.GOURSAT_STAGE_BLOCKS[width] * block > plan.SMEM_BYTES
    assert p["cols"] == cols
    assert p["stage"] == (not cols and block <= plan.SMEM_BYTES)


# -- the wide-d order-1 SVGP against the JAX package ---------------------------

def test_wide_d_order1_svgp_elbo_and_gradient_match_jax():
    """The main path's model, the order-1 normalised SignatureRBF SVGP with
    inducing tensors (increments), at PEMS-SF's d = 963 (T = 4 tensors,
    N = 6 sequences of L = 8, nl = 3, MultiClass(3)): its ELBO and every
    parameter's gradient on the CPU against ``jax.grad`` of the JAX
    package's, tolerance 1e-10."""
    rng = np.random.default_rng(60)
    d, nl, T, C, N, L = 963, 3, 4, 3, 6, 8
    F = nl * (nl + 1) // 2
    Z = 0.4 * rng.standard_normal((T, F, 2, d)) / np.sqrt(d)
    X = _walks(rng, N, L, d)
    Y = rng.integers(0, C, N)
    jk = jsk.SignatureRBF(d, nl, engine="xla")
    jm = jsvgp.SVGP.create(jk, jlik.MultiClass(C),
                           jind.InducingTensors.create(jnp.asarray(Z), nl,
                                                       True), C)
    jm = jm.replace(q_mu=jnp.asarray(rng.standard_normal((T, C))),
                    q_sqrt=jnp.asarray(np.tril(0.2 * rng.standard_normal(
                        (C, T, T))) + 0.8 * np.eye(T)))
    tm = tsvgp.SVGP.create(tsk.SignatureRBF(d, nl, device="cpu"),
                           tlik.MultiClass(C),
                           tind.InducingTensors.create(torch.as_tensor(Z),
                                                       nl, True), C,
                           device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(jm)
    leaves = {".".join(k.name for k in path): np.asarray(v)
              for path, v in flat}
    convert.load_jax_arrays(tm, leaves)
    want = jm.elbo(X, Y, num_data=40)
    got = tm.elbo(torch.as_tensor(X), torch.as_tensor(Y), num_data=40)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
    grads = jax.grad(lambda m: m.elbo(X, Y, num_data=40))(jm)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    jgrad = {".".join(k.name for k in path): np.asarray(v)
             for path, v in flat}
    got.backward()
    tgrad = {n: p.grad for n, p in tm.named_parameters()}
    assert set(tgrad) == set(jgrad)
    for name, w in jgrad.items():
        g = tgrad[name].numpy()
        if name == "q_sqrt":  # only the lower triangle is used
            g, w = np.tril(g), np.tril(w)
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-13)


# -- the inducing tensors' Gram at wide d ----------------------------------------

@pytest.mark.parametrize("ctor,kw", [
    (tsk.SignatureRBF, {}), (tsk.SignatureLinear, {}),
    (tsk.SignaturePoly, {"offset": 0.7}), (tsk.SignatureCosine, {})])
@pytest.mark.parametrize("increments", [True, False])
def test_factor_gram_in_blocks_matches_paired_evaluation(
        ctor, kw, increments, monkeypatch):
    """The matched-position factor Grams of K_tens, [T1, T2, F], built in
    blocks of T1 rows (the whole [T1, T2, F, (2, 2,) d] array is 58 GB at
    T = 500, d = 963) and recomputed in the backward, against the paired
    evaluation of every position pair in one broadcast, as the JAX package
    writes it, float64, at a budget of one row a block: the values bitwise,
    the gradients to Z1, Z2 and the Poly offset to 1e-12 (Z2's and the
    offset's sum the blocks in another order)."""
    rng = np.random.default_rng(61)
    d, nl = 5, 3
    F = nl * (nl + 1) // 2
    shape = (F, 2, d) if increments else (F, d)
    Z1 = torch.as_tensor(0.4 * rng.standard_normal((4,) + shape))
    Z2 = torch.as_tensor(0.4 * rng.standard_normal((3,) + shape))
    kern = ctor(d, nl, device="cpu", **kw)
    base = kern.base
    g = torch.as_tensor(rng.standard_normal((4, 3, F)))

    def run(fn):
        a, b = Z1.clone().requires_grad_(), Z2.clone().requires_grad_()
        out = fn(a, b)
        leaves = [a, b] + [p for p in kern.parameters() if p.requires_grad]
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return out.detach(), grads

    def paired(a, b):
        if increments:
            G = base.matched(a[:, None, :, :, None, :],
                             b[None, :, :, None, :, :])
            return G[..., 1, 1] - G[..., 1, 0] - G[..., 0, 1] + G[..., 0, 0]
        return base.matched(a[:, None], b[None, :])

    want, wgrads = run(paired)
    row = Z2.numel() * (2 if increments else 1) * 8
    monkeypatch.setattr(tsk, "FACTOR_GRAM_CHUNK_BYTES", row)
    got, grads = run(
        lambda a, b: kern._factor_gram_matched(a, b, increments))
    assert got.shape == (4, 3, F)
    assert torch.equal(got, want)
    for gw, gg in zip(wgrads, grads):
        assert (gw is None and gg is None) or torch.allclose(
            gg, gw, rtol=1e-12, atol=1e-12)
    with torch.no_grad():
        assert torch.equal(kern._factor_gram_matched(Z1, Z2, increments),
                           want)
