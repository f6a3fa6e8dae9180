"""Parity of the port's PDE slice with ``gpsig_tpu``, float64 on the CPU:
``UntruncatedSignatureKernel`` (``kernels/pde.py``), ``InducingSequences``
(``inducing.py``), the SigGPDE SVGP (ELBO, its gradient, a natgrad + Adam
step, prediction) and a PDE GPR, every parameter loaded through
``convert.load_jax_arrays``; and the numpy data generators the slice runs
on (``data/synthetic.py``).

Tolerance rtol 1e-8 (as ``test_torch_svgp.py``): the Goursat solves agree
to rounding (rtol 1e-10 in ``test_torch_goursat.py``), and the eigh of the
PSD projections, the Cholesky factors, solves and quadratures round
differently in the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_svgp import leaves

from gpsig_tpu import inducing as jind
from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.data import synthetic as jdata
from gpsig_tpu.kernels import pde as jpde
from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu.kernels import static_kernels as jst
from gpsig_tpu.models import gpr as jgpr
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu.training import loop as jloop
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.data import synthetic as tdata
from gpsig_tpu_torch.kernels import pde as tpde
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.kernels import static_kernels as tst
from gpsig_tpu_torch.models import gpr as tgpr
from gpsig_tpu_torch.models import svgp as tsvgp
from gpsig_tpu_torch.training import loop as tloop

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-12
D, M, C = 2, 5, 2
KEY = jax.random.PRNGKey(0)


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=rtol, atol=ATOL)


def walks(rng, n, L):
    return (0.3 * rng.standard_normal((n, L, D))).cumsum(1)


def kern_pair(base="linear", **kw):
    """The same untruncated kernel in both packages (ARD lengthscales,
    σ = 1.3, normalised, dyadic order 1 unless ``kw`` says otherwise)."""
    kw = dict(dict(lengthscales=[0.8, 1.3], sigma=1.3, normalization=True,
                   dyadic_order=1), **kw)
    jbase, tbase = {
        "linear": (jst.LinearBase(), tst.LinearBase()),
        "rbf": (jst.RBFBase(), tst.RBFBase()),
        "poly": (jst.PolyBase.create(0.7, 2, dtype=jnp.float64),
                 tst.PolyBase.create(0.7, 2, device="cpu")),
    }[base]
    jk = jpde.UntruncatedSignatureKernel.create(D, base=jbase, **kw)
    tk = tpde.UntruncatedSignatureKernel.create(D, base=tbase, device="cpu",
                                                **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


@pytest.mark.parametrize("base", ["linear", "rbf", "poly"])
@pytest.mark.parametrize("normalization", [True, False])
def test_kernel_matches_jax(base, normalization):
    rng = np.random.default_rng(0)
    X, X2 = walks(rng, 4, 7), walks(rng, 3, 5)
    jk, tk = kern_pair(base, normalization=normalization)
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    want = jax.jit(lambda k: (k.K(X), k.K(X, X2), k.Kdiag(X)))(jk)
    close(tk.K(tX), want[0])
    close(tk.K(tX, tX2), want[1])
    close(tk.Kdiag(tX), want[2])
    close(tk.K(tX.reshape(4, -1)), want[0])


@pytest.mark.parametrize("psd_floor", [None, 0.0, 0.05])
def test_psd_projection_matches_jax(psd_floor):
    """K_sym_psd and K under each psd_floor setting, at dyadic order 0 on
    rough paths (where the finite-difference Gram is indefinite), and the
    straight-through gradient of a loss on them."""
    rng = np.random.default_rng(1)
    X = 1.5 * walks(rng, 6, 4)
    jk, tk = kern_pair(dyadic_order=0, normalization=False,
                       psd_floor=psd_floor)
    tX = torch.as_tensor(X)
    jK, jKpsd = jax.jit(lambda k: (k.K(X), k.K_sym_psd(X)))(jk)
    close(tk.K(tX), jK)
    close(tk.K_sym_psd(tX), jKpsd)

    def jloss(k):
        return jnp.sum(k.K_sym_psd(X) ** 2) + jnp.sum(k.K(X))

    want = leaves(jax.jit(jax.grad(jloss))(jk))
    loss = (tk.K_sym_psd(tX) ** 2).sum() + tk.K(tX).sum()
    got = dict(zip([n for n, _ in tk.named_parameters()],
                   torch.autograd.grad(loss, list(tk.parameters()))))
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name])


def test_kernel_hyper_and_input_gradients_match_jax():
    rng = np.random.default_rng(2)
    X, X2 = walks(rng, 4, 6), walks(rng, 3, 8)
    jk, tk = kern_pair("poly", dyadic_order=2)

    def jloss(k, X, X2):
        return jnp.sum(k.K(X, X2) ** 2) + jnp.sum(jnp.sin(k.K(X)))

    jg, jgx, jgx2 = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jk, X, X2)
    tX = torch.tensor(X, requires_grad=True)
    tX2 = torch.tensor(X2, requires_grad=True)
    loss = (tk.K(tX, tX2) ** 2).sum() + torch.sin(tk.K(tX)).sum()
    names = [n for n, _ in tk.named_parameters()]
    grads = torch.autograd.grad(loss, [tX, tX2, *tk.parameters()])
    close(grads[0], jgx)
    close(grads[1], jgx2)
    want = leaves(jg)
    assert set(names) == set(want) == {"raw_sigma", "raw_lengthscales",
                                       "base.raw_offset"}
    for name, g in zip(names, grads[2:]):
        close(g, want[name])


def test_normalisation_floor_splits_the_gradient_at_a_tie():
    """A sequence with zero increments has k(x, x) = 1, exactly the floor:
    torch.maximum, like jnp.maximum, passes half the gradient there."""
    X = np.zeros((2, 5, D))
    X[1] = walks(np.random.default_rng(3), 1, 5)[0]
    jk, tk = kern_pair()
    want = leaves(jax.jit(jax.grad(lambda k: jnp.sum(k.K(X))))(jk))
    tk.K(torch.as_tensor(X)).sum().backward()
    for name, p in tk.named_parameters():
        close(p.grad, want[name])


def test_feature_is_not_ported_yet():
    _, tk = kern_pair()
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tk.feature(torch.zeros(2, 4, D), 3)


def test_engine_typo_raises_at_the_first_solve():
    _, tk = kern_pair(engine="pallsa")
    with pytest.raises(ValueError, match="unknown goursat engine"):
        tk.K(torch.zeros(2, 4, D, dtype=torch.float64))


def features(rng, joint_psd, kernel="pde", Lz=4):
    Z = 0.5 * rng.standard_normal((M, Lz, D)).cumsum(1)
    if kernel == "pde":
        jk, tk = kern_pair()
    else:
        jk = jsk.SignatureRBF(D, 3, lengthscales=[0.9, 1.1], engine="xla")
        tk = tsk.SignatureRBF(D, 3, lengthscales=[0.9, 1.1], device="cpu")
    jf = jind.InducingSequences.create(jnp.asarray(Z), joint_psd=joint_psd)
    tf = tind.InducingSequences.create(torch.as_tensor(Z),
                                       joint_psd=joint_psd)
    return jk, tk, jf, tf


@pytest.mark.parametrize("kernel", ["pde", "signature"])
@pytest.mark.parametrize("joint_psd", [False, True])
def test_inducing_sequences_match_jax(kernel, joint_psd):
    """Kuu, Kuf, covariances (the truncated kernel through its
    seq_covariances) and covariances_full (the joint projection where the
    kernel has K_sym_psd; X longer than Z, so Z is padded)."""
    rng = np.random.default_rng(4)
    jk, tk, jf, tf = features(rng, joint_psd, kernel)
    X, Xs = walks(rng, 6, 7), walks(rng, 3, 3)
    want = jax.jit(lambda f, k: (
        f.Kuu(k), f.Kuf(k, X), *f.covariances(k, X),
        *f.covariances_full(k, X),
        # X shorter than Z, so X is padded
        *f.covariances_full(k, Xs)))(jf, jk)
    tX = torch.as_tensor(X)
    got = (tf.Kuu(tk), tf.Kuf(tk, tX), *tf.covariances(tk, tX),
           *tf.covariances_full(tk, tX),
           *tf.covariances_full(tk, torch.as_tensor(Xs)))
    for g, w in zip(got, want, strict=True):
        close(g, w)


def test_make_inducing_sequences_from_data():
    rng = np.random.default_rng(5)
    X = torch.as_tensor(walks(rng, 9, 12))
    feat = tind.make_inducing_sequences_from_data(
        torch.Generator().manual_seed(0), X, 7, 4, D)
    assert isinstance(feat, tind.InducingSequences) and not feat.joint_psd
    assert feat.raw_Z.shape == (7, 4, D) and feat.num_inducing == 7
    for z in feat.raw_Z:  # each a window of one data sequence
        assert any(torch.equal(z, x[s:s + 4]) for x in X for s in range(9))
    long = tind.make_inducing_sequences_from_data(None, X, 3, 15, D)
    assert torch.equal(long.raw_Z[:, 12:], long.raw_Z[:, 11:12].expand(
        3, 3, D))  # past the end: the last observation, as JAX clamps


def svgp_pair(joint_psd=True, seed=6, N=6):
    """The same SigGPDE SVGP in both packages: the untruncated kernel,
    inducing sequences, MultiClass(2), non-trivial q_mu / q_sqrt."""
    rng = np.random.default_rng(seed)
    jk, tk, jf, tf = features(rng, joint_psd)
    jm = jsvgp.SVGP.create(jk, jlik.MultiClass(C), jf, C)
    jm = jm.replace(q_mu=jnp.asarray(rng.standard_normal((M, C))),
                    q_sqrt=jnp.asarray(np.tril(0.2 * rng.standard_normal(
                        (C, M, M))) + 0.8 * np.eye(M)))
    tm = tsvgp.SVGP.create(tk, tlik.MultiClass(C), tf, C, device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    return jm, tm, walks(rng, N, 7), rng.integers(0, C, N)


@pytest.mark.parametrize("joint_psd", [True, False])
def test_svgp_elbo_and_gradient_match_jax(joint_psd):
    jm, tm, X, Y = svgp_pair(joint_psd)
    assert set(dict(tm.named_parameters())) == set(leaves(jm)) == {
        "q_mu", "q_sqrt", "kernel.raw_sigma", "kernel.raw_lengthscales",
        "inducing.raw_Z"}
    value, grad = jax.jit(jax.value_and_grad(
        lambda m: m.elbo(X, Y, num_data=40)))(jm)
    elbo = tm.elbo(torch.as_tensor(X), torch.as_tensor(Y), num_data=40)
    close(elbo, value)
    elbo.backward()
    want = leaves(grad)
    for name, p in tm.named_parameters():
        g, w = p.grad, want[name]
        if name == "q_sqrt":  # only the lower triangle is used
            g, w = torch.tril(g), np.tril(w)
        close(g, w)


def test_svgp_prediction_matches_jax():
    jm, tm, X, _ = svgp_pair(seed=7)
    tX = torch.as_tensor(X)
    want = jax.jit(lambda m: (*m.predict_f(X),
                              *m.posterior().predict_y(X)))(jm)
    got = (*tm.predict_f(tX), *tm.posterior().predict_y(tX))
    for g, w in zip(got, want, strict=True):
        close(g, w)


def test_natgrad_adam_steps_match_jax():
    """Three natgrad + Adam steps of the SigGPDE SVGP, joint_psd on: the
    loss's backward runs the adjoint through every kernel parameter and
    the inducing sequences."""
    jm, tm, X, Y = svgp_pair(seed=8)
    opt = optax.adam(2e-3)
    jstep = jloop.make_step_fn(opt, num_data=40, gamma=0.05)
    jstate = jloop.init_state(jm, opt)
    tstep = tloop.make_step_fn(2e-3, num_data=40, gamma=0.05)
    tstate = tstep.init(tm)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    for _ in range(3):
        jstate, jelbo = jstep(jstate, X, Y, KEY)
        tstate, telbo = tstep(tstate, tX, tY)
        close(telbo, jelbo)
    want = leaves(jstate.model)
    for name, p in tm.named_parameters():
        w = want[name]
        if name == "q_sqrt":
            p, w = torch.tril(p), np.tril(w)
        close(p, w)


def test_pde_gpr_matches_jax():
    rng = np.random.default_rng(9)
    X, Xnew = walks(rng, 6, 6), walks(rng, 3, 6)
    Y = rng.standard_normal((6, 1))
    jk, tk = kern_pair("rbf")
    jg = jgpr.GPR.create(jk, noise_variance=0.2)
    tg = tgpr.GPR.create(tk, noise_variance=0.2, device="cpu")
    convert.load_jax_arrays(tg, leaves(jg))
    tX, tY, tXn = map(torch.as_tensor, (X, Y, Xnew))
    want = jax.jit(lambda g: (g.log_marginal_likelihood(X, Y),
                              *g.predict_y(X, Y, Xnew)))(jg)
    got = (tg.log_marginal_likelihood(tX, tY), *tg.predict_y(tX, tY, tXn))
    for g, w in zip(got, want, strict=True):
        close(g, w)


def test_pde_training_stays_finite_in_float32():
    """The port of tests/test_training.py's float32 stability test: at
    dyadic order 1 on rough paths the finite-difference Gram is only
    approximately PSD across (Z, X); four natgrad + Adam steps must stay
    finite and the predictive variances positive."""
    X, y = tdata.classification_sequences(seed=0, N=24, L=10, d=2,
                                          num_classes=2)
    X = torch.as_tensor(X, dtype=torch.float32)
    y = torch.as_tensor(y)
    kern = tpde.UntruncatedSignatureKernel.create(
        2, lengthscales=1.5, normalization=True, dyadic_order=1,
        dtype=torch.float32, device="cpu")
    feat = tind.make_inducing_sequences_from_data(
        torch.Generator().manual_seed(0), X, 6, 4, 2)
    model = tsvgp.SVGP.create(kern, tlik.MultiClass(2), feat, 2,
                              dtype=torch.float32, device="cpu")
    step = tloop.make_step_fn(2e-3, num_data=24, gamma=0.05)
    state = step.init(model)
    elbos = []
    for _ in range(4):
        state, e = step(state, X, y)
        elbos.append(float(e))
    assert np.all(np.isfinite(elbos)), elbos
    with torch.no_grad():
        fm, fv = model.predict_f(X)
        assert torch.isfinite(fm).all() and (fv > 0).all()
        post = model.posterior()
        pm, pv = post.predict_y(X)
        assert torch.isfinite(pm).all() and torch.isfinite(pv).all()
        assert (post.predict_f(X)[1] > 0).all()


def test_synthetic_data_matches_jax():
    for got, want in zip(tdata.classification_sequences(3, 7, 9, 2, 3),
                         jdata.classification_sequences(3, 7, 9, 2, 3)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(tdata.regression_sequences(4, 5, 8),
                         jdata.regression_sequences(4, 5, 8)):
        np.testing.assert_array_equal(got, want)
