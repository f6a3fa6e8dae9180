"""Sequences longer than one warp's 128 rows: the port against
``gpsig_tpu`` at L = 130, 150 and 300, and a numpy model of the kernels'
row partition.

- The launch plans (``ops/cuda/plan.py``): which (warps, rows per lane) a
  row count takes, and where the wrappers' bound lies.
- A numpy model of ``csrc/fused_gram_bwd.cu``'s design, thread by thread:
  rows t*R .. t*R+R-1 per group thread, scans composed from the lanes'
  and the warps' totals, the next thread's first row of M̄ across warps,
  point ownership, and the u tile contracted every ``chunk`` columns in
  descending order. Held against autograd of the plain Gram at 130, 149
  and 299 rows (and the 16-lane plan at L = 50), so that index mistakes
  surface before the card. Scaled error 1e-10: float64, other summation
  order only.
- The kernel layer (``K``, ``Kdiag``, ``K_tens_vs_seq``; orders 1-3,
  ``difference=False``, Poly, inducing sequences of length 8 against
  length-150 data) and the SynthGunPoint window model's ELBO and
  gradient, float64 on the CPU, against the JAX package's XLA engine
  (its default CPU route), rtol 1e-8 as in ``test_torch_signature_kernel``:
  the XLA engine clamps the RBF squared distance at 0 and the port's plain
  versions do not, which differs only at coincident points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import inducing as jind
from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.data import preprocessing as jprep
from gpsig_tpu.data import uea_like as juea
from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.data import preprocessing as tprep
from gpsig_tpu_torch.data import uea_like as tuea
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.models import svgp as tsvgp
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import plan

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-12


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def walks(rng, n, L, d=2):
    """Steps shrinking like 1/√L: the levels stay as large as at L = 50."""
    return (0.3 * np.sqrt(50 / L) * rng.standard_normal((n, L, d))).cumsum(1)


# -- the launch plans ---------------------------------------------------------

@pytest.mark.parametrize("rows,want", [
    (49, (1, 2)), (128, (1, 4)), (129, (2, 4)), (149, (2, 4)),
    (299, (3, 4)), (511, (4, 4)), (600, (5, 4)), (1024, (8, 4)),
    (1025, None)])
def test_row_plan_takes_the_fewest_warps(rows, want):
    assert plan.row_plan(rows) == want
    if want is not None:
        W, R = want
        assert 32 * W * R >= rows and W <= plan.MAX_WARPS


def test_gram_backward_plan_and_the_stated_bound():
    """Two pairs a warp up to 64 rows; the bound is 1024 rows, and the
    backward's shared memory at d = 8 in float64 still takes L = 512. Past
    its shared memory (L = 900, d = 8, float64) the backward reads x and y
    from global memory and sums X̄ in a workspace; the diagonal takes
    L = 1025 in one segment's bands (no row bound)."""
    assert plan.gram_bwd_plan(50) == (16, 1)
    assert plan.gram_bwd_plan(20) == (16, 1)
    assert plan.gram_bwd_plan(129) == (32, 1)
    assert plan.gram_bwd_plan(150) == (32, 2)
    assert plan.gram_bwd_plan(1026) is None
    for item in (4, 8):
        S, W = plan.gram_bwd_plan(512)
        chunk = plan.gram_bwd_chunk(512, 8, S, W, item)
        assert plan.gram_bwd_smem(512, 8, S, W, chunk, item) \
            <= plan.SMEM_BYTES
    X = torch.zeros(1, 1026, 2)
    with pytest.raises(ValueError, match="at most 1024"):
        tfg._backward_plan("k", X)
    wide = tfg._backward_plan("k", torch.zeros(1, 900, 8,
                                               dtype=torch.float64))
    assert not wide["staged"] and wide["smem"] <= plan.SMEM_BYTES
    assert (wide["S"], wide["W"], wide["work"]) == (32, 8, 900 * 9)
    d1025 = tfg._forward_plan("k", torch.zeros(1, 1025, 8), diag=True,
                              num_levels=4)
    assert (d1025["S"], d1025["R"], d1025["bands"]) == (32, 8, 4)


# -- a numpy model of the backward kernel's row partition ---------------------

def group_scan(v, S, W, suffix=False):
    """common.cuh's group prefix and suffix (WarpGroup, BlockGroup) on
    v [GT, R]: within the thread, then the lanes of a segment (the shuffle
    scan), then the warps' totals (the shared-memory exchange)."""
    if suffix:
        return group_scan(v[::-1, ::-1], S, W)[::-1, ::-1]
    within = np.cumsum(v, 1) - v
    tot = v.sum(1).reshape(W, S)
    lanes = np.cumsum(tot, 1) - tot
    warps = np.cumsum(tot.sum(1)) - tot.sum(1)
    return within + (lanes + warps[:, None]).reshape(-1, 1)


def model_gram_bwd(x, y, w, S, W, R, chunk):
    """X̄, Ȳ of one pair as fused_gram_bwd.cu computes them (RBF)."""
    L, d = x.shape
    rows, nl, GT = L - 1, len(w), S * W
    t, r = np.arange(GT)[:, None], np.arange(R + 1)[None, :]
    pts = t * R + r
    xi = np.minimum(pts, L - 1)
    own = (pts <= L - 1) & ((r > 0) | (t == 0))
    row_ok = (t * R + r[:, :R]) < rows

    def k(j):
        a = x[xi]
        return np.exp(-0.5 * (a * a).sum(-1) - 0.5 * y[j] @ y[j] + a @ y[j])

    def incr(hi, lo):
        v = (hi[:, 1:] - lo[:, 1:]) - (hi[:, :-1] - lo[:, :-1])
        return np.where(row_ok, v, 0.0)

    C = np.zeros((nl - 1, GT, R))
    khi = k(0)
    for j in range(rows):
        knew = k(j + 1)
        mcol = incr(knew, khi)
        khi = knew
        pre = [group_scan(C[m], S, W) for m in range(nl - 2)]
        C[0] += mcol
        for m in range(1, nl - 1):
            C[m] += mcol * pre[m - 1]

    xacc, ybar = np.zeros((L, d + 1)), np.zeros((L, d))
    tile = np.zeros((chunk, L | 1))
    state = dict(filled=0, c0=L - 1)

    def contract():
        n, c0 = state["filled"], state["c0"]
        cols = c0 - np.arange(n)
        u = tile[:n, :L]
        xacc[:, :d] += u.T @ y[cols]
        xacc[:, d] += u.sum(0)
        ybar[cols] += u @ x - y[cols] * u.sum(1)[:, None]
        state["c0"] -= n
        state["filled"] = 0

    def store(kbar, kv):
        tile[state["filled"], xi[own]] = (kbar * kv)[own]
        state["filled"] += 1
        if state["filled"] == chunk:
            contract()

    Rs = np.zeros((nl - 1, GT, R))
    dprev = np.zeros((GT, R + 1))
    for j in range(rows - 1, -1, -1):
        klo = k(j)
        mcol = incr(khi, klo)
        a, P = mcol, []
        for m in range(nl - 1):
            C[m] -= a
            P.append(group_scan(C[m], S, W))
            a = mcol * P[m]
        Mbar = w[0] + (Rs[0] if nl > 1 else 0.0)
        for m in range(1, nl):
            Mbar = Mbar + (w[m] + (Rs[m] if m + 1 < nl else 0.0)) * P[m - 1]
        v = [mcol * (w[m + 1] + (Rs[m + 1] if m + 2 < nl else 0.0))
             for m in range(nl - 1)]
        for m in range(nl - 1):
            Rs[m] += group_scan(v[m], S, W, suffix=True)
        Mbar = np.where(row_ok, Mbar, 0.0)
        mnext = np.append(Mbar[1:, 0], 0.0)[:, None]
        dcol = (np.hstack([np.zeros((GT, 1)), Mbar])
                - np.hstack([Mbar, mnext]))
        store(dcol - dprev, khi)
        dprev = dcol
        khi = klo
    store(-dprev, khi)
    if state["filled"]:
        contract()
    return xacc[:, :d] - x * xacc[:, d:], ybar


@pytest.mark.parametrize("L", [50, 130, 150, 300])
def test_backward_row_partition_model_matches_autograd(L):
    rng = np.random.default_rng(L)
    x, y = walks(rng, 2, L)
    w = rng.standard_normal(4)
    S, W = plan.gram_bwd_plan(L)
    chunk = plan.gram_bwd_chunk(L, 2, S, W, 8)
    got = model_gram_bwd(x, y, w, S, W, 4, chunk)
    g = torch.as_tensor(np.concatenate([[0.0], w])).reshape(5, 1, 1)
    want = tfg.fused_gram_levels_bwd_ref(torch.as_tensor(x[None]),
                                         torch.as_tensor(y[None]), g, 4)
    for a, b in zip(got, want):
        b = b[0].numpy()
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-10
    if L > 129:  # the tile flushes mid-sweep and at a ragged end
        assert W > 1 and L % chunk != 0
    else:
        assert L % chunk != 0


# -- the kernel layer against the JAX package ---------------------------------

def kernel_pair(ctor, nl, seed=0, **kw):
    jk = getattr(jsk, ctor)(2, nl, engine="xla", **kw)
    rng = np.random.default_rng(seed)
    jk = jk.replace(raw_sigma=jnp.asarray(rng.normal(0.5, 0.3)),
                    raw_variances=jnp.asarray(rng.normal(0.0, 0.5, nl + 1)))
    tk = getattr(tsk, ctor)(2, nl, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


@pytest.mark.parametrize("L", [130, 150, 300])
@pytest.mark.parametrize("ctor", ["SignatureRBF", "SignatureLinear"])
def test_long_order1_kernel_matches_jax(L, ctor):
    jk, tk = kernel_pair(ctor, 3, lengthscales=[0.8, 1.2])
    _, traw = kernel_pair(ctor, 3, normalization=False)
    jraw = jsk.__dict__[ctor](2, 3, engine="xla", normalization=False)
    jraw = jraw.replace(**{k: getattr(jk, k) for k in ("raw_sigma",
                                                       "raw_variances")})
    convert.load_jax_arrays(traw, leaves(jraw))
    rng = np.random.default_rng(L)
    X, Y = walks(rng, 3, L), walks(rng, 2, L)
    Z = 0.4 * rng.standard_normal((4, 6, 2, 2))
    tX, tY, tZ = map(torch.as_tensor, (X, Y, Z))
    want = jax.jit(lambda X, Y, Z: (
        jk.K(X, Y), jk.K(X), jraw.Kdiag(X),
        jk.K_tens_vs_seq(Z, X, True)))(X, Y, Z)
    got = (tk.K(tX, tY), tk.K(tX), traw.Kdiag(tX),
           tk.K_tens_vs_seq(tZ, tX, True))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("ctor,kw", [
    ("SignatureRBF", dict(order=2)),
    ("SignatureRBF", dict(order=3, difference=False)),
    ("SignaturePoly", dict(order=1)),
    ("SignaturePoly", dict(order=2, difference=False)),
])
def test_long_general_kernel_matches_jax(ctor, kw):
    """Order 2 and 3, difference=False and Poly at L = 150 (the general
    engines' plain versions and, for the diagonal, sig_gram's)."""
    jk, tk = kernel_pair(ctor, 3, lengthscales=[0.8, 1.2], **kw)
    rng = np.random.default_rng(5)
    X, Y = walks(rng, 3, 150), walks(rng, 2, 150)
    Z = 0.4 * rng.standard_normal((3, 6, 2, 2))
    tX, tY, tZ = map(torch.as_tensor, (X, Y, Z))
    want = jax.jit(lambda X, Y, Z: (
        jk.K(X, Y), jk.K_tens_vs_seq(Z, X, True)))(X, Y, Z)
    close(tk.K(tX, tY), want[0])
    close(tk.K_tens_vs_seq(tZ, tX, True), want[1])


@pytest.mark.parametrize("order", [1, 2])
def test_inducing_sequences_against_long_data_match_jax(order):
    """Kuu and Kuf of 4 inducing sequences of length 8 against data of
    length 150 (increment matrices [8-1, 150-1], the sig_gram route)."""
    jk, tk = kernel_pair("SignatureRBF", 3, order=order,
                         lengthscales=[0.8, 1.2])
    rng = np.random.default_rng(7)
    Zs, X = walks(rng, 4, 8), walks(rng, 3, 150)
    jf = jind.InducingSequences.create(jnp.asarray(Zs))
    tf = tind.InducingSequences.create(torch.as_tensor(Zs))
    want = jax.jit(lambda X: jf.covariances(jk, X))(X)
    for g, w in zip(tf.covariances(tk, torch.as_tensor(X)), want):
        close(g, w)


def gunpoint_batch(n=6):
    """SynthGunPoint as the window protocol prepares it: scaled on train,
    time added, tabulated to L = 150 (d = 2); the first n sequences."""
    Xtr_l, ytr, _, _ = tuea.load_dataset("SynthGunPoint")
    scaler = tprep.SequenceScaler().fit(Xtr_l)
    X = tprep.tabulate_list_of_sequences(
        tprep.add_time_to_list(scaler.transform(Xtr_l)), 150)
    return X[:n], ytr[:n]


def test_gunpoint_window_model_elbo_and_gradient_match_jax():
    """The SynthGunPoint window's model (order 1, nl=4, lengthscales √d,
    normalised, inducing tensors with increments, MultiClass(2)) at small
    N: 8 inducing tensors drawn from the data's increments, 6 sequences of
    L = 150; the ELBO and its gradient (jax.grad) for every parameter."""
    X, y = gunpoint_batch()
    assert X.shape == (6, 150, 2)
    rng = np.random.default_rng(0)
    nl, T, C = 4, 8, 2
    F = nl * (nl + 1) // 2
    incs = np.diff(X, axis=1).reshape(-1, 2)
    Z = incs[rng.integers(0, len(incs), T * F * 2)].reshape(T, F, 2, 2)
    ell = [np.sqrt(2.0)] * 2
    jk = jsk.SignatureRBF(2, nl, lengthscales=ell, engine="xla")
    jf = jind.InducingTensors.create(jnp.asarray(Z), nl, True)
    jm = jsvgp.SVGP.create(jk, jlik.MultiClass(C), jf, C)
    jm = jm.replace(q_mu=jnp.asarray(rng.standard_normal((T, C))),
                    q_sqrt=jnp.asarray(np.tril(0.2 * rng.standard_normal(
                        (C, T, T))) + 0.8 * np.eye(T)))
    tk = tsk.SignatureRBF(2, nl, lengthscales=ell, device="cpu")
    tf = tind.InducingTensors.create(torch.as_tensor(Z), nl, True)
    tm = tsvgp.SVGP.create(tk, tlik.MultiClass(C), tf, C, device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    elbo = jax.jit(jax.value_and_grad(lambda m: m.elbo(X, y, num_data=50)))
    want, wgrad = elbo(jm)
    got = tm.elbo(torch.as_tensor(X), torch.as_tensor(y), num_data=50)
    close(got, want)
    got.backward()
    wgrad = leaves(wgrad)
    tgrad = {n: p.grad for n, p in tm.named_parameters()}
    assert set(tgrad) == set(wgrad)
    for name in wgrad:
        g, w = tgrad[name], wgrad[name]
        if name == "q_sqrt":  # only the lower triangle is used
            g, w = torch.tril(g), np.tril(w)
        close(g, w)


def test_gunpoint_preprocessing_matches_jax():
    """The window's data pipeline gives bitwise the JAX package's arrays."""
    Xtr_l, _, Xte_l, _ = juea.load_dataset("SynthGunPoint")
    scaler = jprep.SequenceScaler().fit(Xtr_l)
    want = jprep.tabulate_list_of_sequences(
        jprep.add_time_to_list(scaler.transform(Xte_l)), 150)
    Xtr_t, _, Xte_t, _ = tuea.load_dataset("SynthGunPoint")
    tscaler = tprep.SequenceScaler().fit(Xtr_t)
    got = tprep.tabulate_list_of_sequences(
        tprep.add_time_to_list(tscaler.transform(Xte_t)), 150)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (150, 150, 2)
