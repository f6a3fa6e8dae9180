"""Parity of the port's GP layer (``gauss.py``, ``likelihoods.py``,
``models/svgp.py``, ``models/gpr.py``) with ``gpsig_tpu``, float64 on the
CPU, with every parameter loaded through ``convert.load_jax_arrays``: the
order-1 models, and the order-2 SVGP and GPR that run through the general
engines' plain versions (with the ELBO's gradient against ``jax.grad``).

Tolerance rtol 1e-8, for the same reason as in
``test_torch_signature_kernel.py``: the JAX XLA engine clamps the RBF
squared distance and the port's kernel path does not, which differs only
at coincident points; Cholesky, solves and quadrature then agree to
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import gauss as jgauss
from gpsig_tpu import inducing as jind
from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu.models import gpr as jgpr
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import gauss as tgauss
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.models import gpr as tgpr
from gpsig_tpu_torch.models import svgp as tsvgp

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-12
D, NL, M, C, N = 2, 3, 6, 3, 7


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=ATOL)


def walks(rng, n, L=8):
    return (0.3 * rng.standard_normal((n, L, D))).cumsum(1)


def svgp_pair(whiten=True, q_diag=False, increments=True, seed=0, order=1):
    """The same SVGP in both packages: RBF signature kernel with ARD at
    ``order``, inducing tensors, MultiClass(3), non-trivial q_mu /
    q_sqrt."""
    rng = np.random.default_rng(seed)
    F = NL * (NL + 1) // 2
    Z = 0.4 * rng.standard_normal((M, F, 2, D) if increments else (M, F, D))
    jk = jsk.SignatureRBF(D, NL, lengthscales=[0.8, 1.2], engine="xla",
                          order=order)
    jf = jind.InducingTensors.create(jnp.asarray(Z), NL, increments)
    jm = jsvgp.SVGP.create(jk, jlik.MultiClass(C), jf, C, whiten=whiten,
                           q_diag=q_diag)
    q_sqrt = (rng.uniform(0.3, 1.0, (M, C)) if q_diag else
              np.tril(0.2 * rng.standard_normal((C, M, M)))
              + 0.8 * np.eye(M))
    jm = jm.replace(q_mu=jnp.asarray(rng.standard_normal((M, C))),
                    q_sqrt=jnp.asarray(q_sqrt))
    tk = tsk.SignatureRBF(D, NL, lengthscales=[0.8, 1.2], order=order,
                          device="cpu")
    tf = tind.InducingTensors.create(torch.as_tensor(Z), NL, increments)
    tm = tsvgp.SVGP.create(tk, tlik.MultiClass(C), tf, C, whiten=whiten,
                           q_diag=q_diag, device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    X = walks(rng, N)
    Y = rng.integers(0, C, N)
    return jm, tm, X, Y


def test_stable_cholesky_picks_the_jax_jitter_level():
    rng = np.random.default_rng(0)
    B = rng.standard_normal((8, 3))
    K = B @ B.T - 1e-7 * np.eye(8)  # indefinite: needs extra jitter
    want = np.asarray(jgauss.stable_cholesky(jnp.asarray(K)))
    got = tgauss.stable_cholesky(torch.as_tensor(K)).numpy()
    assert np.all(np.isfinite(want)) and np.all(np.isfinite(got))

    def added_jitter(L):
        R = L @ L.T - K
        np.testing.assert_allclose(R - np.diag(np.diag(R)), 0, atol=1e-12)
        return np.diag(R)

    # both factor K + e·I with the same escalation level e = 10 · 1e-6
    # (the factors themselves differ in the last digits, as the matrix is
    # ill-conditioned: the solvers round differently)
    np.testing.assert_allclose(added_jitter(want), 1e-5, rtol=1e-6)
    np.testing.assert_allclose(added_jitter(got), 1e-5, rtol=1e-6)
    healthy = K + np.eye(8)
    close(tgauss.stable_cholesky(torch.as_tensor(healthy)),
          jgauss.stable_cholesky(jnp.asarray(healthy)), rtol=1e-10)


@pytest.mark.parametrize("whiten_kl,q_diag", [(True, False), (True, True),
                                              (False, False), (False, True)])
def test_gauss_kl_matches_jax(whiten_kl, q_diag):
    rng = np.random.default_rng(1)
    q_mu = rng.standard_normal((M, C))
    q_sqrt = (rng.uniform(0.3, 1.0, (M, C)) if q_diag
              else np.tril(rng.standard_normal((C, M, M))) + 2 * np.eye(M))
    B = rng.standard_normal((M, M))
    K = None if whiten_kl else B @ B.T + M * np.eye(M)
    want = jgauss.gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt),
                           K=None if K is None else jnp.asarray(K))
    got = tgauss.gauss_kl(torch.as_tensor(q_mu), torch.as_tensor(q_sqrt),
                          K=None if K is None else torch.as_tensor(K))
    close(got, want)


@pytest.mark.parametrize("white,full_cov,q_diag", [
    (True, False, False), (False, False, False), (True, True, False),
    (True, False, True)])
def test_conditional_matches_jax(white, full_cov, q_diag):
    rng = np.random.default_rng(2)
    B = rng.standard_normal((M + N, M + N))
    Kall = B @ B.T + 0.5 * np.eye(M + N)
    Kmm, Kmn = Kall[:M, :M], Kall[:M, M:]
    Knn = Kall[M:, M:] if full_cov else np.diag(Kall)[M:]
    q_mu = rng.standard_normal((M, C))
    q_sqrt = (rng.uniform(0.3, 1.0, (M, C)) if q_diag
              else np.tril(0.3 * rng.standard_normal((C, M, M))))
    args = (Kmn, Kmm, Knn, q_mu, q_sqrt)
    jm, jv = jgauss.conditional(*map(jnp.asarray, args), white=white,
                                full_cov=full_cov)
    tm, tv = tgauss.conditional(*map(torch.tensor, args), white=white,
                                full_cov=full_cov)
    close(tm, jm)
    close(tv, jv)


def test_floor_marginal_variance_matches_jax():
    var = np.array([[-1.0, 1e-20, 0.5], [2.0, -3e-9, 1e-15]])
    scale = np.array([3.0, 0.5, 1.0])
    for s in (None, scale):
        want = jgauss.floor_marginal_variance(
            jnp.asarray(var), None if s is None else jnp.asarray(s))
        got = tgauss.floor_marginal_variance(
            torch.as_tensor(var), None if s is None else torch.as_tensor(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tgauss._conditional_var_floor(torch.float32) == 1e-8


@pytest.mark.parametrize("name", ["Gaussian", "Bernoulli", "MultiClass"])
def test_likelihoods_match_jax(name):
    rng = np.random.default_rng(3)
    Fmu = rng.standard_normal((N, C))
    Fvar = rng.uniform(0.1, 2.0, (N, C))
    if name == "Gaussian":
        jl = jlik.Gaussian.create(0.7)
        tl = tlik.Gaussian.create(0.7, device="cpu")
        convert.load_jax_arrays(tl, leaves(jl))
        Y = rng.standard_normal((N, C))
    elif name == "Bernoulli":
        jl, tl = jlik.Bernoulli(), tlik.Bernoulli()
        Y = rng.integers(0, 2, (N, C)).astype(float)
    else:
        jl, tl = jlik.MultiClass(C), tlik.MultiClass(C)
        Y = rng.integers(0, C, N)
    jargs = tuple(map(jnp.asarray, (Y, Fmu, Fvar)))
    targs = tuple(map(torch.as_tensor, (Y, Fmu, Fvar)))
    close(tl.variational_expectations(*targs),
          jl.variational_expectations(*jargs))
    for got, want in zip(tl.predict_mean_and_var(*targs[1:]),
                         jl.predict_mean_and_var(*jargs[1:])):
        close(got, want)
    close(tl.predict_log_density(*targs), jl.predict_log_density(*jargs))


@pytest.mark.parametrize("whiten,q_diag,increments", [
    (True, False, True), (True, True, False), (False, False, True)])
def test_svgp_elbo_and_prediction_match_jax(whiten, q_diag, increments):
    jm, tm, X, Y = svgp_pair(whiten, q_diag, increments)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    close(tm.elbo(tX, tY, num_data=40), jm.elbo(X, Y, num_data=40))
    for got, want in zip(tm.predict_f(tX), jm.predict_f(X)):
        close(got, want)
    for got, want in zip(tm.predict_f(tX, full_cov=True),
                         jm.predict_f(X, full_cov=True)):
        close(got, want)
    for got, want in zip(tm.predict_y(tX), jm.predict_y(X)):
        close(got, want)
    close(tm.predict_log_density(tX, tY), jm.predict_log_density(X, Y))


@pytest.mark.parametrize("whiten", [True, False])
def test_posterior_prediction_matches_jax(whiten):
    jm, tm, X, Y = svgp_pair(whiten=whiten, seed=4)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    jp, tp = jm.posterior(), tm.posterior()
    close(tp.proj_mean, jp.proj_mean)
    for got, want in zip(tp.predict_y(tX), jp.predict_y(X)):
        close(got, want)
    for got, want in zip(tp.predict_f(tX, full_cov=True),
                         jp.predict_f(X, full_cov=True)):
        close(got, want)
    close(tp.predict_log_density(tX, tY), jp.predict_log_density(X, Y))
    # the cached posterior and the direct route agree within the port
    p_cached, _ = tp.predict_y(tX)
    p_direct, _ = tm.predict_y(tX)
    torch.testing.assert_close(p_cached, p_direct, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(p_cached.sum(-1),
                               torch.ones(N, dtype=torch.float64))


def test_svgp_parameter_names_mirror_jax():
    jm, tm, _, _ = svgp_pair()
    assert set(tm.state_dict()) == set(leaves(jm)) == {
        "q_mu", "q_sqrt", "kernel.raw_sigma", "kernel.raw_variances",
        "kernel.raw_lengthscales", "inducing.raw_Z"}


def test_identity_features_are_not_ported_yet():
    """Inducing features with ``kuu_is_identity`` take the Kuu = I path:
    no Kuu is formed, and predict_f and the ELBO equal the whitened
    conditional and KL at Kmm = I."""
    rng = np.random.default_rng(4)
    kern = tsk.SignatureRBF(D, NL, device="cpu")
    X = torch.as_tensor(walks(rng, N))
    Kuf = torch.as_tensor(0.3 * rng.standard_normal((3, N)))

    class Identity(torch.nn.Module):
        kuu_is_identity = True
        num_inducing = 3

        def Kuu(self, kernel, jitter=None):
            raise AssertionError("Kuu = I is never formed")

        def Kuf(self, kernel, X):
            return Kuf

    for q_diag in (True, False):
        m = tsvgp.SVGP.create(kern, tlik.MultiClass(C), Identity(), C,
                              q_diag=q_diag, device="cpu")
        q_sqrt = (rng.uniform(0.3, 1.0, (3, C)) if q_diag else
                  np.tril(0.3 * rng.standard_normal((C, 3, 3))))
        with torch.no_grad():
            m.q_mu.copy_(torch.as_tensor(rng.standard_normal((3, C))))
            m.q_sqrt.copy_(torch.as_tensor(q_sqrt))
        want = tgauss.conditional(Kuf, torch.eye(3, dtype=torch.float64),
                                  kern.Kdiag(X), m.q_mu, m._tril_q_sqrt())
        for got, w in zip(m.predict_f(X), want):
            close(got, w.detach(), rtol=1e-12)
        Y = torch.as_tensor(rng.integers(0, C, N))
        elbo = (torch.sum(m.likelihood.variational_expectations(Y, *want))
                - tgauss.gauss_kl(m.q_mu, m._tril_q_sqrt()))
        close(m.elbo(X, Y), elbo.detach(), rtol=1e-12)


def test_gpr_matches_jax():
    _gpr_parity("SignatureRBF", {})


@pytest.mark.parametrize("ctor,kw", [
    ("SignatureRBF", dict(order=2)),
    ("SignaturePoly", dict(order=2, offset=0.8)),
    ("SignatureCosine", dict(order=1, difference=False)),
])
def test_general_gpr_matches_jax(ctor, kw):
    """GPR through the general Gram and sig_gram's plain versions."""
    _gpr_parity(ctor, kw)


def _gpr_parity(ctor, kw):
    kw = dict(kw, lengthscales=[0.9, 1.1])
    rng = np.random.default_rng(5)
    X, Xnew = walks(rng, N), walks(rng, 4)
    Y = rng.standard_normal((N, 2))
    jk = getattr(jsk, ctor)(D, NL, engine="xla", **kw)
    jg = jgpr.GPR.create(jk, noise_variance=0.3)
    tg = tgpr.GPR.create(getattr(tsk, ctor)(D, NL, device="cpu", **kw),
                         noise_variance=0.3, device="cpu")
    convert.load_jax_arrays(tg, leaves(jg))
    tX, tY, tXn = map(torch.as_tensor, (X, Y, Xnew))
    close(tg.log_marginal_likelihood(tX, tY),
          jg.log_marginal_likelihood(X, Y))
    for full_cov in (False, True):
        for got, want in zip(tg.predict_f(tX, tY, tXn, full_cov=full_cov),
                             jg.predict_f(X, Y, Xnew, full_cov=full_cov)):
            close(got, want)
    for got, want in zip(tg.predict_y(tX, tY, tXn),
                         jg.predict_y(X, Y, Xnew)):
        close(got, want)


@pytest.mark.parametrize("whiten,increments", [(True, True), (False, False)])
def test_order2_svgp_matches_jax(whiten, increments):
    """The order-2 SVGP: Kuf through the general Kuf's plain version, the
    normalisation diagonal through sig_gram's."""
    jm, tm, X, Y = svgp_pair(whiten, increments=increments, seed=6, order=2)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    close(tm.elbo(tX, tY, num_data=40), jm.elbo(X, Y, num_data=40))
    for got, want in zip(tm.predict_f(tX), jm.predict_f(X)):
        close(got, want)
    for got, want in zip(tm.posterior().predict_y(tX),
                         jm.posterior().predict_y(X)):
        close(got, want)


def test_order2_elbo_gradient_matches_jax_grad():
    """CPU autograd through the order-2 plain path against jax.grad, every
    parameter."""
    jm, tm, X, Y = svgp_pair(seed=7, order=2)
    want = leaves(jax.grad(lambda m: m.elbo(X, Y, num_data=40))(jm))
    tm.elbo(torch.as_tensor(X), torch.as_tensor(Y), num_data=40).backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        if name == "q_sqrt":  # only the lower triangle is used
            g, w = torch.tril(g), np.tril(w)
        close(g, w)
