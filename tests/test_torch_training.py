"""Parity of the port's training (``gpsig_tpu_torch.training``) with
``gpsig_tpu.training``, and of a GPR type-II maximum-likelihood Adam loop
with the same loop in JAX: float64 on the CPU, every parameter loaded
through ``convert.load_jax_arrays``.

The SVGP is ``test_torch_svgp.svgp_pair``'s (inducing tensors with
increments, MultiClass), so the Adam half of each step differentiates Kuf.
Tolerance rtol 1e-8 (as in ``test_torch_svgp.py``): the two packages'
Cholesky factorisations, solves and quadratures agree to rounding, and a
few Adam steps amplify that only mildly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_svgp import leaves, svgp_pair, walks

from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu.models import gpr as jgpr
from gpsig_tpu.training import loop as jloop
from gpsig_tpu.training import natgrad as jnat
from gpsig_tpu_torch import convert
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.models import gpr as tgpr
from gpsig_tpu_torch.training import loop as tloop
from gpsig_tpu_torch.training import natgrad as tnat

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-12
KEY = jax.random.PRNGKey(0)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.asarray(want), rtol=rtol, atol=atol)


def close_models(tm, jm, rtol=RTOL):
    want = leaves(jm)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, value in want.items():
        if name == "q_sqrt" and value.ndim == 3:  # only the tril is used
            value, got[name] = np.tril(value), torch.tril(got[name])
        close(got[name], value, rtol=rtol)


def fresh(pair):
    """q_mu = 0, q_sqrt = I in both models: a freshly created SVGP."""
    jm, tm, X, Y = pair
    jm = jm.replace(q_mu=jnp.zeros_like(jm.q_mu),
                    q_sqrt=jnp.broadcast_to(jnp.eye(jm.q_mu.shape[0]),
                                            jm.q_sqrt.shape))
    convert.load_jax_arrays(tm, leaves(jm))
    return jm, tm, X, Y


@pytest.mark.parametrize("diag", [False, True])
def test_gaussian_natgrad_update_matches_jax(diag):
    """Latent 0 passes at γ, latent 1 only after backing off to γ/4,
    latent 2 at no factor (it keeps its (μ, S))."""
    rng = np.random.default_rng(0)
    M, C = 5, 3
    mu = rng.standard_normal((M, C))
    g_mu = rng.standard_normal((M, C))
    gamma = 1.0
    if diag:
        S = rng.uniform(0.5, 1.0, (M, C))
        g_S = np.stack([0.1 / S[:, 0], 0.8 / S[:, 1], 100.0 / S[:, 2]], 1)
    else:
        B = rng.standard_normal((C, M, M))
        S = np.eye(M) + 0.05 * B @ np.swapaxes(B, -1, -2)
        Sinv = np.linalg.inv(S)
        A = rng.standard_normal((C, M, M))  # asymmetric: symmetrised inside
        g_S = np.stack([0.05 * Sinv[0], 0.8 * Sinv[1], 100.0 * Sinv[2]]) \
            + 1e-3 * (A - np.swapaxes(A, -1, -2))
    args = (mu, S, g_mu, g_S)
    want = jnat.gaussian_natgrad_update(*map(jnp.asarray, args), gamma,
                                        diag=diag)
    got = tnat.gaussian_natgrad_update(*map(torch.as_tensor, args), gamma,
                                       diag=diag)
    for g, w in zip(got, want):
        close(g, w)
    # the third latent kept its mean: no step passed
    close(got[0][:, 2], mu[:, 2], rtol=0, atol=0)
    assert not np.allclose(got[0][:, 1], mu[:, 1])


@pytest.mark.parametrize("whiten,q_diag", [(True, False), (True, True),
                                           (False, False)])
def test_natgrad_step_matches_jax(whiten, q_diag):
    jm, tm, X, Y = svgp_pair(whiten=whiten, q_diag=q_diag)
    jm = jnat.natgrad_step(jm, 0.1, X, Y, num_data=40)
    out = tnat.natgrad_step(tm, 0.1, torch.as_tensor(X), torch.as_tensor(Y),
                            num_data=40)
    assert out is tm
    close_models(tm, jm)


def test_natgrad_backoff_at_large_gamma_matches_jax():
    """γ = 1 on a fresh MultiClass model (as tests/test_training.py): the
    step must back off, stay finite, and match JAX."""
    jm, tm, X, Y = fresh(svgp_pair(seed=2))
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    for _ in range(2):
        jm = jnat.natgrad_step(jm, 1.0, X, Y, num_data=X.shape[0])
        tnat.natgrad_step(tm, 1.0, tX, tY, num_data=X.shape[0])
        close_models(tm, jm)
    assert np.isfinite(float(tm.elbo(tX, tY).detach()))


@pytest.mark.parametrize("use_natgrad", [True, False])
def test_step_fn_matches_jax(use_natgrad):
    jm, tm, X, Y = svgp_pair()
    opt = optax.adam(1e-2)
    jstep = jloop.make_step_fn(opt, num_data=40, gamma=0.1,
                               use_natgrad=use_natgrad)
    jstate = jloop.init_state(jm, opt)
    tstep = tloop.make_step_fn(1e-2, num_data=40, gamma=0.1,
                               use_natgrad=use_natgrad)
    tstate = tstep.init(tm)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    for _ in range(3):
        jstate, jelbo = jstep(jstate, X, Y, KEY)
        tstate, telbo = tstep(tstate, tX, tY)
        close(telbo, jelbo)
        close_models(tstate.model, jstate.model)
    assert tstate.step == 3


def test_multi_step_matches_single_steps():
    _, tm, X, Y = svgp_pair(seed=5)
    tm2 = svgp_pair(seed=5)[1]
    rng = np.random.default_rng(1)
    idx = [rng.choice(len(X), 4, replace=False) for _ in range(3)]
    Xb = torch.as_tensor(np.stack([X[i] for i in idx]))
    Yb = torch.as_tensor(np.stack([Y[i] for i in idx]))
    single = tloop.make_step_fn(1e-2, num_data=len(X), gamma=0.1)
    multi = tloop.make_multi_step_fn(1e-2, num_data=len(X), gamma=0.1)
    state = single.init(tm)
    elbos = []
    for X1, Y1 in zip(Xb, Yb):
        state, e = single(state, X1, Y1)
        elbos.append(e)
    mstate, melbos = multi(multi.init(tm2), Xb, Yb)
    torch.testing.assert_close(melbos, torch.stack(elbos), rtol=1e-12,
                               atol=0)
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              tm2.named_parameters()):
        torch.testing.assert_close(q, p, rtol=1e-12, atol=0, msg=n)


def test_fit_with_minibatches_matches_jax():
    jm, tm, X, Y = svgp_pair(seed=6)
    kw = dict(num_iters=5, batch_size=4, learning_rate=1e-2, gamma=0.05,
              seed=3, log_every=1)
    jtrained, jhist = jloop.fit(jm, jnp.asarray(X), jnp.asarray(Y), **kw)
    ttrained, thist = tloop.fit(tm, torch.as_tensor(X), torch.as_tensor(Y),
                                **kw)
    assert [i for i, _ in thist] == [i for i, _ in jhist] == list(range(5))
    close(np.array([e for _, e in thist]), [e for _, e in jhist])
    close_models(ttrained, jtrained)


def test_map_prior_matches_jax_and_regularises():
    jm, tm, X, Y = svgp_pair(seed=7)
    tm_mle = svgp_pair(seed=7)[1]

    def jprior(m):
        return -50.0 * jnp.sum(jnp.log(m.kernel.lengthscales) ** 2)

    def tprior(m):
        return -50.0 * torch.sum(torch.log(m.kernel.lengthscales) ** 2)

    opt = optax.adam(5e-2)
    jstep = jloop.make_step_fn(opt, num_data=len(X), use_natgrad=False,
                               log_prior_fn=jprior)
    jstate = jloop.init_state(jm, opt)
    tstep = tloop.make_step_fn(5e-2, num_data=len(X), use_natgrad=False,
                               log_prior_fn=tprior)
    tstep_mle = tloop.make_step_fn(5e-2, num_data=len(X), use_natgrad=False)
    tstate, tstate_mle = tstep.init(tm), tstep_mle.init(tm_mle)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    for _ in range(5):
        jstate, jval = jstep(jstate, X, Y, KEY)
        tstate, tval = tstep(tstate, tX, tY)
        tstate_mle, _ = tstep_mle(tstate_mle, tX, tY)
        close(tval, jval)  # ELBO + log-prior, as JAX returns it
    close_models(tstate.model, jstate.model)
    # the prior pins log-lengthscales to 0: MAP ends nearer to it than MLE
    map_dist = tm.kernel.lengthscales.detach().log().abs().max()
    mle_dist = tm_mle.kernel.lengthscales.detach().log().abs().max()
    assert map_dist < mle_dist


def test_fit_early_stopping_returns_the_best_model():
    _, tm, X, Y = svgp_pair(seed=8)
    scores = iter([0.1, 0.5, 0.3, 0.2, 0.9, 0.9])
    snapshots = []

    def metric(model, Xv, yv):
        snapshots.append(model.q_mu.detach().clone())
        return next(scores)

    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    best, hist = tloop.fit(tm, tX, tY, num_iters=6, learning_rate=1e-2,
                           gamma=0.05, log_every=1, val_data=(tX, tY),
                           val_every=1, patience=2, val_metric=metric)
    assert len(snapshots) == 4  # stopped after two evaluations without gain
    assert len(hist) == 4
    assert best is not tm
    torch.testing.assert_close(best.q_mu, snapshots[1], rtol=0, atol=0)
    assert not torch.equal(best.q_mu, tm.q_mu)
    # the default metric is accuracy
    acc = tloop.default_val_metric(best, tX, tY)
    assert 0.0 <= acc <= 1.0


def test_gpr_adam_steps_match_jax():
    """Type-II ML as benchmarks/config1_gram_gpr.py writes it: Adam on
    −log_marginal_likelihood over every parameter, here 5 steps."""
    _gpr_adam_parity("SignatureRBF", {})


@pytest.mark.parametrize("ctor,kw", [
    ("SignatureRBF", dict(order=2)),
    ("SignaturePoly", dict(order=1, offset=0.6)),
])
def test_general_gpr_adam_steps_match_jax(ctor, kw):
    """The same through the general Gram's and sig_gram's plain versions:
    an order-2 RBF kernel, and a Poly base whose offset
    (``base.raw_offset``) trains too."""
    _gpr_adam_parity(ctor, kw)


def _gpr_adam_parity(ctor, kw):
    rng = np.random.default_rng(9)
    X = walks(rng, 7)
    Y = np.sin(rng.standard_normal((7, 1)))
    kw = dict(kw, lengthscales=[0.9, 1.1])
    jg = jgpr.GPR.create(getattr(jsk, ctor)(2, 3, engine="xla", **kw),
                         noise_variance=0.3)
    tg = tgpr.GPR.create(getattr(tsk, ctor)(2, 3, device="cpu", **kw),
                         noise_variance=0.3, device="cpu")
    convert.load_jax_arrays(tg, leaves(jg))
    opt = optax.adam(5e-2)

    @jax.jit
    def jstep(m, s):
        loss, g = jax.value_and_grad(
            lambda mm: -mm.log_marginal_likelihood(X, Y))(m)
        up, s = opt.update(g, s, m)
        return optax.apply_updates(m, up), s, -loss

    js = opt.init(jg)
    topt = torch.optim.Adam(tg.parameters(), lr=5e-2)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    for _ in range(5):
        jg, js, jlml = jstep(jg, js)
        topt.zero_grad()
        loss = -tg.log_marginal_likelihood(tX, tY)
        loss.backward()
        topt.step()
        close(-loss, jlml)
    want = leaves(jg)
    assert set(want) == {n for n, _ in tg.named_parameters()}
    for name, p in tg.named_parameters():
        close(p, want[name])


def test_order2_step_fn_matches_jax():
    """Natgrad + Adam steps of the order-2 SVGP (Kuf and the normalisation
    diagonal through the general engines' plain versions), as
    ``job_flagship_o2`` trains it."""
    jm, tm, X, Y = svgp_pair(seed=4, order=2)
    opt = optax.adam(1e-2)
    jstep = jloop.make_step_fn(opt, num_data=40, gamma=0.05)
    jstate = jloop.init_state(jm, opt)
    tstep = tloop.make_step_fn(1e-2, num_data=40, gamma=0.05)
    tstate = tstep.init(tm)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    for _ in range(3):
        jstate, jelbo = jstep(jstate, X, Y, KEY)
        tstate, telbo = tstep(tstate, tX, tY)
        close(telbo, jelbo)
        close_models(tstate.model, jstate.model)
