"""Parity of the port's VOSF family with ``gpsig_tpu``, float64 on the CPU:
the explicit truncated signature (``ops/explicit.py``), the explicit
signature kernel and the orthogonal features (``kernels/vosf.py``), the
Kuu = I SVGP (ELBO, its gradient against ``jax.grad``, ``predict_f``,
``posterior()``, ``prior_kl``, a natgrad + Adam step) and the untruncated
kernel's features (``UntruncatedSignatureKernel.feature``), every parameter
loaded through ``convert.load_jax_arrays``.

Tolerances, scaled by the largest magnitude compared: values 1e-10 (the
same arithmetic in another summation order; the finite-difference solves
agree to rounding), gradients and one step's parameters 1e-8 (a gradient
carries each value's rounding, amplified at most mildly by one Adam step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_svgp import leaves, svgp_pair

from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.kernels import pde as jpde
from gpsig_tpu.kernels import static_kernels as jst
from gpsig_tpu.kernels import vosf as jvosf
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu.ops import explicit as jex
from gpsig_tpu.training import loop as jloop
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.kernels import pde as tpde
from gpsig_tpu_torch.kernels import static_kernels as tst
from gpsig_tpu_torch.kernels import vosf as tvosf
from gpsig_tpu_torch.models import svgp as tsvgp
from gpsig_tpu_torch.ops import explicit as tex
from gpsig_tpu_torch.training import loop as tloop

torch.set_num_threads(1)
VALUE_TOL, GRAD_TOL = 1e-10, 1e-8
D, NL, C, N = 2, 3, 3, 9
KEY = jax.random.PRNGKey(0)


def close(got, want, tol=VALUE_TOL, scale=None):
    """max|got − want| / scale <= tol, scale max|want| unless given."""
    got = torch.as_tensor(got).detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if scale is None:
        scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= tol, err


def close_grads(got, want):
    """Every gradient against JAX's, scaled by the largest of them all: a
    parameter the ELBO is invariant to has a gradient of rounding size
    (σ under RobustMax, which depends on f only through its argmax)."""
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for n, g in got.items():
        close(g, want[n], GRAD_TOL, scale)


def walks(rng, n, L=7, d=D):
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


@pytest.mark.parametrize("nl", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_truncated_signature_matches_jax(nl, d):
    X = walks(np.random.default_rng(10 * nl + d), 4, L=6, d=d)
    want = jex.truncated_signature(jnp.asarray(X), nl)
    got = tex.truncated_signature(torch.as_tensor(X), nl)
    assert len(got) == len(want) == nl
    for g, w in zip(got, want):
        close(g, w)
    for inc in (True, False):
        assert tex.signature_dim(d, nl, inc) == jex.signature_dim(d, nl, inc)


def kern_pair(lengthscales=(0.8, 1.3), normalization=True, nl=NL):
    kw = dict(lengthscales=None if lengthscales is None else
              list(lengthscales), sigma=1.3, variances=[0.5, 1.2, 0.9, 0.7],
              normalization=normalization)
    jk = jvosf.ExplicitSignatureKernel.create(D, nl, **kw)
    tk = tvosf.ExplicitSignatureKernel.create(D, nl, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


@pytest.mark.parametrize("lengthscales,normalization", [
    ((0.8, 1.3), True), (None, True), ((0.8, 1.3), False)])
def test_explicit_kernel_matches_jax(lengthscales, normalization):
    jk, tk = kern_pair(lengthscales, normalization)
    assert (tk.raw_lengthscales is None) == (lengthscales is None)
    rng = np.random.default_rng(1)
    X, X2 = walks(rng, 5), walks(rng, 3)
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    want = jax.jit(lambda k: (k.feature(X), k.K(X), k.K(X, X2), k.Kdiag(X),
                              k.feature(X.reshape(5, -1))))(jk)
    # the last: flattened [N, L·d] input, as the JAX kernel takes it
    got = (tk.feature(tX), tk.K(tX), tk.K(tX, tX2), tk.Kdiag(tX),
           tk.feature(tX.reshape(5, -1)))
    for g, w in zip(got, want):
        close(g, w)
    assert tk.num_features_total == jk.num_features_total


def test_for_kernel_branches_and_errors():
    _, tk = kern_pair()
    feat = tvosf.OrthogonalSignatureFeatures.for_kernel(tk)
    assert feat.kuu_is_identity and feat.feature_levels is None
    assert feat.num_inducing == 1 + 2 + 4 + 8
    assert tvosf.OrthogonalSignatureFeatures.for_kernel(
        tk, num_levels=NL).num_inducing == feat.num_inducing
    with pytest.raises(ValueError, match="own truncation level"):
        tvosf.OrthogonalSignatureFeatures.for_kernel(tk, num_levels=NL + 1)
    pk = tpde.UntruncatedSignatureKernel.create(D, device="cpu")
    with pytest.raises(ValueError, match="num_levels is required"):
        tvosf.OrthogonalSignatureFeatures.for_kernel(pk)
    pf = tvosf.OrthogonalSignatureFeatures.for_kernel(pk, num_levels=4)
    jpf = jvosf.OrthogonalSignatureFeatures.for_kernel(
        jpde.UntruncatedSignatureKernel.create(D), num_levels=4)
    assert (pf.num_inducing, pf.feature_levels) == (jpf.num_inducing,
                                                    jpf.feature_levels)
    eye = feat.Kuu(tk.to(torch.float32))
    assert eye.dtype == torch.float32 and eye.device == tk.raw_sigma.device
    torch.testing.assert_close(eye, torch.eye(feat.num_inducing), rtol=0,
                               atol=0)


def vosf_pair(q_diag, seed=0, prior="explicit", whiten=True):
    """The same Kuu = I SVGP in both packages, MultiClass(3), q_mu and
    q_sqrt drawn: under the explicit kernel, or (``prior="pde"``) under the
    untruncated kernel (Linear base, ARD, normalised, dyadic order 1) with
    features of 3 levels."""
    rng = np.random.default_rng(seed)
    if prior == "explicit":
        jk, tk = kern_pair()
        jf = jvosf.OrthogonalSignatureFeatures.for_kernel(jk)
        tf = tvosf.OrthogonalSignatureFeatures.for_kernel(tk)
    else:
        kw = dict(lengthscales=[0.8, 1.3], sigma=1.3, normalization=True,
                  dyadic_order=1)
        jk = jpde.UntruncatedSignatureKernel.create(D, **kw)
        tk = tpde.UntruncatedSignatureKernel.create(D, device="cpu", **kw)
        jf = jvosf.OrthogonalSignatureFeatures.for_kernel(jk, num_levels=NL)
        tf = tvosf.OrthogonalSignatureFeatures.for_kernel(tk, num_levels=NL)
    M = jf.num_inducing
    jm = jsvgp.SVGP.create(jk, jlik.MultiClass(C), jf, C, q_diag=q_diag,
                           whiten=whiten)
    q_sqrt = (rng.uniform(0.3, 1.0, (M, C)) if q_diag else
              np.tril(0.1 * rng.standard_normal((C, M, M))) + 0.8 * np.eye(M))
    jm = jm.replace(q_mu=jnp.asarray(0.5 * rng.standard_normal((M, C))),
                    q_sqrt=jnp.asarray(q_sqrt))
    tm = tsvgp.SVGP.create(tk, tlik.MultiClass(C), tf, C, q_diag=q_diag,
                           whiten=whiten, device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    X = walks(rng, N)
    Y = rng.integers(0, C, N)
    return jm, tm, X, Y


def check_serving(jm, tm, X):
    """predict_f, the cached posterior's quad, predict_f (marginal and
    full_cov) and predict_y, and prior_kl."""
    tX = torch.as_tensor(X)

    def serve(m):
        post = m.posterior()
        return (m.predict_f(X), post.quad, post.predict_f(X),
                post.predict_f(X, full_cov=True), post.predict_y(X),
                m.prior_kl())

    assert tm.posterior().quad_is_diag == jm.posterior().quad_is_diag
    tpost = tm.posterior()
    got = (tm.predict_f(tX), tpost.quad, tpost.predict_f(tX),
           tpost.predict_f(tX, full_cov=True), tpost.predict_y(tX),
           tm.prior_kl())
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.jit(serve)(jm))):
        close(g, w)


def check_elbo_and_grads(jm, tm, X, Y):
    jelbo, jgrad = jax.jit(jax.value_and_grad(
        lambda m: m.elbo(X, Y, num_data=40)))(jm)
    telbo = tm.elbo(torch.as_tensor(X), torch.as_tensor(Y), num_data=40)
    close(telbo, jelbo)
    telbo.backward()
    close_grads({n: p.grad for n, p in tm.named_parameters()},
                leaves(jgrad))


@pytest.mark.parametrize("q_diag", [True, False])
def test_identity_svgp_matches_jax(q_diag):
    jm, tm, X, Y = vosf_pair(q_diag)
    check_serving(jm, tm, X)
    check_elbo_and_grads(jm, tm, X, Y)


@pytest.mark.parametrize("whiten,identity", [(True, False), (False, False),
                                             (False, True)])
def test_prior_kl_matches_jax(whiten, identity):
    """Whitened: against N(0, I); not whitened: against N(0, Kuu), the
    inducing tensors' Gram or, under VOSF, the identity."""
    if identity:
        jm, tm, _, _ = vosf_pair(True, seed=3, whiten=False)
    else:
        jm, tm, _, _ = svgp_pair(whiten=whiten, seed=3)
    want = jax.jit(lambda m: m.prior_kl())(jm)
    close(tm.prior_kl(), want)
    close(tm.prior_kl(Kuu=tm.inducing.Kuu(tm.kernel, None)), want)


@pytest.mark.parametrize("prior", ["explicit", "pde"])
def test_identity_step_matches_jax(prior):
    """One natgrad + Adam step (γ 0.1, Adam 1e-2) from JAX's make_step_fn."""
    jm, tm, X, Y = vosf_pair(True, seed=4, prior=prior)
    opt = optax.adam(1e-2)
    jstate, jelbo = jloop.make_step_fn(opt, num_data=40, gamma=0.1)(
        jloop.init_state(jm, opt), X, Y, KEY)
    tstep = tloop.make_step_fn(1e-2, num_data=40, gamma=0.1)
    tstate, telbo = tstep(tstep.init(tm), torch.as_tensor(X),
                          torch.as_tensor(Y))
    close(telbo, jelbo, GRAD_TOL)
    want = leaves(jstate.model)
    for n, p in tstate.model.named_parameters():
        close(p, want[n], GRAD_TOL)


@pytest.mark.parametrize("normalization", [True, False])
def test_untruncated_feature_matches_jax(normalization):
    kw = dict(lengthscales=[0.8, 1.3], sigma=1.3, dyadic_order=1,
              normalization=normalization)
    jk = jpde.UntruncatedSignatureKernel.create(D, **kw)
    tk = tpde.UntruncatedSignatureKernel.create(D, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    X = walks(np.random.default_rng(5), 5)
    tX = torch.as_tensor(X, dtype=torch.float64).requires_grad_()
    got = tk.feature(tX, NL)
    close(got, jk.feature(X, NL))
    # the gradient through the normalisation's solve (the Goursat adjoint)
    w = np.random.default_rng(6).standard_normal(got.shape)
    jgrad = jax.jit(jax.grad(lambda k, x: jnp.sum(k.feature(x, NL) * w),
                             argnums=(0, 1)))(jk, jnp.asarray(X))
    (got * torch.as_tensor(w)).sum().backward()
    close_grads({"x": tX.grad, **{n: p.grad for n, p in
                                  tk.named_parameters()}},
                {"x": np.asarray(jgrad[1]), **leaves(jgrad[0])})


def test_untruncated_pde_vosf_svgp_matches_jax():
    jm, tm, X, Y = vosf_pair(True, seed=7, prior="pde")
    check_serving(jm, tm, X)
    check_elbo_and_grads(jm, tm, X, Y)


@pytest.mark.parametrize("base", ["rbf", "poly"])
def test_untruncated_feature_refuses_nonlinear_base(base):
    tbase = (tst.RBFBase() if base == "rbf"
             else tst.PolyBase.create(0.7, 2, device="cpu"))
    tk = tpde.UntruncatedSignatureKernel.create(D, base=tbase, device="cpu")
    jbase = (jst.RBFBase() if base == "rbf"
             else jst.PolyBase.create(0.7, 2, dtype=jnp.float64))
    jk = jpde.UntruncatedSignatureKernel.create(D, base=jbase)
    X = walks(np.random.default_rng(8), 2)
    with pytest.raises(NotImplementedError, match="linear base"):
        jk.feature(X, NL)
    with pytest.raises(NotImplementedError, match="linear base"):
        tk.feature(torch.as_tensor(X), NL)
