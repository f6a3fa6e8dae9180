"""Parity of the port's Monte-Carlo ``Softmax`` likelihood and its
generator threading with ``gpsig_tpu``, float64 on the CPU.

JAX's draws come from ``jax.random`` and cannot be reproduced by a
``torch.Generator``, so parity feeds JAX's own ε into the port: the
functions of (Y, Fmu, Fvar, ε) directly, and the SVGP's ELBO, gradient
and training step with ``Softmax.draw`` replaced by JAX's draw under the
same key. The port's own draws are held to their shape, their
distribution and their determinism under a seeded generator, and one
training step is shown to hand its natgrad ELBO and its loss the same
draws, as JAX's step hands both the same key.

Tolerances: the functions of ε 1e-12 (the same arithmetic), the ELBO
1e-10 and gradients and one step's parameters 1e-8 scaled (as
``test_torch_vosf.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_svgp import leaves
from test_torch_vosf import GRAD_TOL, close, close_grads, kern_pair, walks

from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.kernels import vosf as jvosf
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu.training import loop as jloop
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.kernels import vosf as tvosf
from gpsig_tpu_torch.models import svgp as tsvgp
from gpsig_tpu_torch.training import loop as tloop

torch.set_num_threads(1)
EPS_TOL = 1e-12
C, S, N = 4, 6, 9
KEY = jax.random.PRNGKey(3)


def moments(rng, n=N):
    Fmu = rng.standard_normal((n, C))
    Fvar = rng.uniform(0.05, 2.0, (n, C))
    Y = rng.integers(0, C, n)
    return Y, Fmu, Fvar


def jax_eps(key, num_samples, shape):
    return np.array(jax.random.normal(key, (num_samples,) + tuple(shape),
                                        jnp.float64))


def test_softmax_functions_of_eps_match_jax():
    Y, Fmu, Fvar = moments(np.random.default_rng(0))
    j, t = jlik.Softmax(C, num_samples=S), tlik.Softmax(C, num_samples=S)
    tFmu, tFvar = torch.as_tensor(Fmu), torch.as_tensor(Fvar)
    eps = torch.as_tensor(jax_eps(KEY, S, Fmu.shape))
    close(t.expected_log_prob(torch.as_tensor(Y), tFmu, tFvar, eps),
          j.variational_expectations(Y, Fmu, Fvar, key=KEY), EPS_TOL)
    eps = torch.as_tensor(jax_eps(KEY, 50, Fmu.shape))
    for got, want in zip(t.moments(tFmu, tFvar, eps),
                         j.predict_mean_and_var(Fmu, Fvar, KEY, 50)):
        close(got, want, EPS_TOL)


def test_softmax_entry_points_match_jax_with_its_draws(monkeypatch):
    """variational_expectations, predict_mean_and_var (JAX's default
    PRNGKey(0)) and predict_log_density, ``draw`` giving JAX's ε."""
    Y, Fmu, Fvar = moments(np.random.default_rng(1))
    j, t = jlik.Softmax(C, num_samples=S), tlik.Softmax(C, num_samples=S)
    args = (torch.as_tensor(Fmu), torch.as_tensor(Fvar))
    key = {"value": KEY}
    monkeypatch.setattr(t, "draw", lambda num_samples, F, generator=None:
                        torch.as_tensor(jax_eps(key["value"], num_samples,
                                                F.shape)))
    close(t.variational_expectations(torch.as_tensor(Y), *args),
          j.variational_expectations(Y, Fmu, Fvar, key=KEY), EPS_TOL)
    key["value"] = jax.random.PRNGKey(0)
    for got, want in zip(t.predict_mean_and_var(*args),
                         j.predict_mean_and_var(Fmu, Fvar)):
        close(got, want, EPS_TOL)
    close(t.predict_log_density(torch.as_tensor(Y), *args, num_samples=30),
          j.predict_log_density(Y, Fmu, Fvar, num_samples=30), EPS_TOL)


def test_softmax_own_draws():
    """Shape, dtype and device of ε; determinism under a seeded generator
    (and different draws under another seed); mean 0 and variance 1; the
    prediction's default generator is one seeded 0."""
    t = tlik.Softmax(C)
    Fmu = torch.zeros((2000, C), dtype=torch.float64)
    eps = t.draw(25, Fmu, torch.Generator().manual_seed(7))
    assert eps.shape == (25, 2000, C) and eps.dtype == torch.float64
    torch.testing.assert_close(
        eps, t.draw(25, Fmu, torch.Generator().manual_seed(7)), rtol=0,
        atol=0)
    assert not torch.equal(eps, t.draw(25, Fmu,
                                       torch.Generator().manual_seed(8)))
    # 200,000 standard normals: the mean's standard error is 0.0022, the
    # variance's 0.0032; 5 standard errors
    assert abs(eps.mean().item()) < 0.011
    assert abs(eps.var().item() - 1.0) < 0.016
    Fmu, Fvar = torch.zeros((5, C), dtype=torch.float64), torch.ones(5, C)
    default = t.predict_mean_and_var(Fmu, Fvar.double())
    seeded = t.predict_mean_and_var(Fmu, Fvar.double(),
                                    torch.Generator().manual_seed(0))
    for a, b in zip(default, seeded):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def softmax_pair(seed=0):
    """The VOSF SVGP of ``test_torch_vosf.py`` with Softmax(4, 6) in both
    packages, q_mu and a diagonal q_sqrt drawn."""
    rng = np.random.default_rng(seed)
    jk, tk = kern_pair()
    jf = jvosf.OrthogonalSignatureFeatures.for_kernel(jk)
    tf = tvosf.OrthogonalSignatureFeatures.for_kernel(tk)
    M = jf.num_inducing
    jm = jsvgp.SVGP.create(jk, jlik.Softmax(C, S), jf, C, q_diag=True)
    jm = jm.replace(q_mu=jnp.asarray(0.5 * rng.standard_normal((M, C))),
                    q_sqrt=jnp.asarray(rng.uniform(0.3, 1.0, (M, C))))
    tm = tsvgp.SVGP.create(tk, tlik.Softmax(C, S), tf, C, q_diag=True,
                           device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    return jm, tm, walks(rng, N), rng.integers(0, C, N)


def feed_jax_draws(monkeypatch, tm, key, record=None):
    """Make the port's Softmax draw JAX's ε under ``key``; ``record``
    collects what it was given."""
    def draw(num_samples, Fmu, generator=None):
        if record is not None:
            record.append(generator)
        return torch.as_tensor(jax_eps(key, num_samples, Fmu.shape))

    monkeypatch.setattr(tm.likelihood, "draw", draw)


def test_softmax_svgp_elbo_and_gradients_match_jax(monkeypatch):
    jm, tm, X, Y = softmax_pair()
    feed_jax_draws(monkeypatch, tm, KEY)
    jelbo, jgrad = jax.jit(jax.value_and_grad(
        lambda m: m.elbo(X, Y, num_data=40, key=KEY)))(jm)
    telbo = tm.elbo(torch.as_tensor(X), torch.as_tensor(Y), num_data=40,
                    generator=torch.Generator())
    close(telbo, jelbo)
    telbo.backward()
    close_grads({n: p.grad for n, p in tm.named_parameters()},
                leaves(jgrad))


def test_step_gives_natgrad_and_loss_the_same_draws(monkeypatch):
    """The port's own draws: the natgrad ELBO and the loss of one step
    draw the same ε, from the step's generator, and a second step draws
    others. Then, with JAX's draws fed in, a natgrad + Adam step matches
    JAX's ``make_step_fn`` under the same key."""
    _, tm, X, Y = softmax_pair(seed=1)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    seen = []
    real_draw = tm.likelihood.draw

    def recording_draw(num_samples, Fmu, generator=None):
        eps = real_draw(num_samples, Fmu, generator)
        seen.append(eps)
        return eps

    monkeypatch.setattr(tm.likelihood, "draw", recording_draw)
    step = tloop.make_step_fn(1e-2, num_data=40, gamma=0.1)
    state = step.init(tm)
    gen = torch.Generator().manual_seed(11)
    state, _ = step(state, tX, tY, gen)
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    state, _ = step(state, tX, tY, gen)
    assert len(seen) == 4 and torch.equal(seen[2], seen[3])
    assert not torch.equal(seen[0], seen[2])

    jm, tm, X, Y = softmax_pair(seed=2)
    given = []
    feed_jax_draws(monkeypatch, tm, KEY, record=given)
    opt = optax.adam(1e-2)
    jstate, jelbo = jloop.make_step_fn(opt, num_data=40, gamma=0.1)(
        jloop.init_state(jm, opt), X, Y, KEY)
    step = tloop.make_step_fn(1e-2, num_data=40, gamma=0.1)
    tstate, telbo = step(step.init(tm), torch.as_tensor(X),
                         torch.as_tensor(Y), torch.Generator().manual_seed(0))
    assert len(given) == 2 and all(g is not None for g in given)
    close(telbo, jelbo, GRAD_TOL)
    want = leaves(jstate.model)
    for n, p in tstate.model.named_parameters():
        close(p, want[n], GRAD_TOL)


@pytest.mark.parametrize("entry", ["fit", "multi"])
def test_seeded_runs_repeat_bitwise(entry):
    """Two runs from generators seeded alike are bitwise equal, a third
    from another seed is not: ``fit(seed=…)`` and ``make_multi_step_fn``
    with a generator."""
    def run(seed):
        _, tm, X, Y = softmax_pair(seed=3)
        tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
        if entry == "fit":
            tm, hist = tloop.fit(tm, tX, tY, num_iters=2, batch_size=5,
                                 learning_rate=1e-2, seed=seed, log_every=1)
            elbos = torch.tensor([e for _, e in hist])
        else:
            multi = tloop.make_multi_step_fn(1e-2, num_data=40)
            _, elbos = multi(multi.init(tm), tX[None].repeat(2, 1, 1, 1),
                             tY[None].repeat(2, 1),
                             torch.Generator().manual_seed(seed))
        return [elbos] + [p.detach() for p in tm.parameters()]

    a, b, c = run(5), run(5), run(6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_predict_y_passes_generator_and_samples():
    """``SVGP.predict_y`` / ``predict_log_density`` and the cached
    posterior's ``predict_y`` hand ``generator`` and ``num_samples`` to the
    likelihood."""
    _, tm, X, Y = softmax_pair(seed=4)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    with torch.no_grad():
        m, v = tm.predict_f(tX)
        want = tm.likelihood.moments(m, v, tm.likelihood.draw(
            7, m, torch.Generator().manual_seed(9)))
        for got in (tm.predict_y(tX, generator=torch.Generator().manual_seed(
                        9), num_samples=7),
                    tm.posterior().predict_y(
                        tX, generator=torch.Generator().manual_seed(9),
                        num_samples=7)):
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-14)
        p = tm.predict_y(tX)[0]
        torch.testing.assert_close(p.sum(-1), torch.ones(N,
                                                         dtype=p.dtype))
        lpd = tm.predict_log_density(tX, tY, num_samples=7)
        assert lpd.shape == (N,) and bool(torch.all(lpd <= 0))


def test_softmax_natgrad_steps_match_jax(monkeypatch):
    """Three natgrad steps at γ = 0.1 of config 6's model cut to a small
    size: the VOSF SVGP (explicit signature kernel, lengthscale 1,
    normalised, nl = 3: M = 15 features at d = 2, the family's size
    nearest 16), q_diag, Softmax(10, 20), a batch of B = 64 sequences
    standing for config 6's 120,000, JAX's ε under each step's key fed
    across. q_mu, q_sqrt and the ELBO after every step match JAX (1e-8
    scaled), so a divergence of these steps on the card is the reference's
    behaviour, not the port's."""
    from gpsig_tpu.training import natgrad as jnat
    from gpsig_tpu_torch.training import natgrad as tnat

    rng = np.random.default_rng(31)
    C10, S20, B, num_data = 10, 20, 64, 120_000
    kw = dict(lengthscales=1.0, normalization=True)
    jk = jvosf.ExplicitSignatureKernel.create(2, 3, **kw)
    tk = tvosf.ExplicitSignatureKernel.create(2, 3, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    jf = jvosf.OrthogonalSignatureFeatures.for_kernel(jk)
    tf = tvosf.OrthogonalSignatureFeatures.for_kernel(tk)
    M = jf.num_inducing
    assert M == 15
    jm = jsvgp.SVGP.create(jk, jlik.Softmax(C10, S20), jf, C10, q_diag=True)
    jm = jm.replace(q_mu=jnp.asarray(0.3 * rng.standard_normal((M, C10))),
                    q_sqrt=jnp.asarray(rng.uniform(0.3, 1.0, (M, C10))))
    tm = tsvgp.SVGP.create(tk, tlik.Softmax(C10, S20), tf, C10, q_diag=True,
                           device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    X, Y = walks(rng, B), rng.integers(0, C10, B)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    key = {"value": None}
    monkeypatch.setattr(tm.likelihood, "draw",
                        lambda num_samples, F, generator=None: torch.as_tensor(
                            jax_eps(key["value"], num_samples, F.shape)))
    jstep = jax.jit(lambda m, k: jnat.natgrad_step(m, 0.1, X, Y,
                                                   num_data=num_data, key=k))
    jelbo = jax.jit(lambda m, k: m.elbo(X, Y, num_data=num_data, key=k))
    for k_step, k_eval in jax.random.split(jax.random.PRNGKey(32), (3, 2)):
        jm = jstep(jm, k_step)
        key["value"] = k_step
        tnat.natgrad_step(tm, 0.1, tX, tY, num_data=num_data,
                          generator=torch.Generator())
        close(tm.q_mu, jm.q_mu, GRAD_TOL)
        close(tm.q_sqrt, jm.q_sqrt, GRAD_TOL)
        key["value"] = k_eval
        with torch.no_grad():
            close(tm.elbo(tX, tY, num_data=num_data,
                          generator=torch.Generator()),
                  jelbo(jm, k_eval), GRAD_TOL)
