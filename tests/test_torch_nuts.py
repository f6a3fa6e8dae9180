"""Parity of the port's NUTS (``gpsig_tpu_torch/mcmc``, ``parallel/chains.py``,
``utils/``) with ``gpsig_tpu``, float64 on the CPU.

JAX's draws come from ``jax.random`` and cannot be reproduced by a
``torch.Generator``, so parity runs the port on a draw source whose
streams replay JAX's own keys (:class:`JaxKeyStream`), split in the JAX
sampler's order: ``key, kw = split(key)`` for a run, ``key, sub =
split(key)`` a transition, ``k_mom, k_dir, _ = split(sub, 3)``, per
doubling ``key, k_dir, k_sub, k_merge = split(key, 4)``, per leaf ``key,
k_prop = split(key)``. The port's own draws (one generator a chain) are
held to the moment tests of ``tests/test_nuts.py`` with fewer draws, and
to bitwise determinism: chunked equals monolithic, a resumed run equals
an uninterrupted one, chain blocks do not change a chain's draws.

Tolerances: the deterministic parts (leapfrog, U-turn test, dual
averaging, Welford) 1e-12 scaled, the same arithmetic; one transition
1e-12 and whole runs 1e-10 scaled (rounding through up to 50 transitions
of 15 leapfrogs); discrete outputs (leaves, divergences) exactly; ESS and
split-R̂ bitwise (the same numpy code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.mcmc import nuts as jnuts
from gpsig_tpu.mcmc import sample as jsample
from gpsig_tpu.utils import metrics as jmetrics
from gpsig_tpu_torch import convert
from gpsig_tpu_torch.mcmc import nuts as tnuts
from gpsig_tpu_torch.mcmc import sample as tsample
from gpsig_tpu_torch.mcmc.draws import DrawSource
from gpsig_tpu_torch.parallel.chains import make_chunked_sampler
from gpsig_tpu_torch.utils import checkpoint as tckpt
from gpsig_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)
DET_TOL, STEP_TOL, RUN_TOL = 1e-12, 1e-12, 1e-10
COV = np.array([[2.0, 1.2], [1.2, 1.5]])
PREC = np.linalg.inv(COV)
SCALES = np.array([0.1, 10.0])


def close(got, want, tol, what=""):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


# -- targets: JAX's per chain, the port's over [C, D] ------------------------
# The port's targets avoid matrix products of θ: BLAS picks its kernel by
# the row count, so a product's last bits depend on how many chains share
# the batch, which the block-grouping test must not see.

def jax_targets():
    prec = jnp.asarray(PREC)
    return {
        "correlated": lambda x: -0.5 * x @ prec @ x,
        "scaled": lambda x: -0.5 * jnp.sum((x / jnp.asarray(SCALES)) ** 2),
        "funnel": lambda x: (-x[0] ** 2 / 18.0
                             - 0.5 * jnp.sum(x[1:] ** 2) * jnp.exp(-x[0])
                             - 0.5 * (x.shape[0] - 1) * x[0]),
    }


def torch_targets():
    prec = torch.as_tensor(PREC)
    scales = torch.as_tensor(SCALES)
    return {
        "correlated": lambda x: -0.5 * torch.sum(
            x[..., :, None] * prec * x[..., None, :], dim=(-2, -1)),
        "scaled": lambda x: -0.5 * torch.sum((x / scales) ** 2, dim=-1),
        "funnel": lambda x: (-x[:, 0] ** 2 / 18.0
                             - 0.5 * torch.sum(x[:, 1:] ** 2, dim=-1)
                             * torch.exp(-x[:, 0])
                             - 0.5 * (x.shape[1] - 1) * x[:, 0]),
    }


DIMS = {"correlated": 2, "scaled": 2, "funnel": 3}


# -- JAX's keys replayed ------------------------------------------------------

_split2 = jax.jit(lambda k: jax.random.split(k))
_split3 = jax.jit(lambda k: jax.random.split(k, 3))
_split4 = jax.jit(lambda k: jax.random.split(k, 4))
_normal = jax.jit(lambda k, dim: jax.random.normal(k, (dim,)),
                  static_argnums=1)
_uniform = jax.jit(lambda k: jax.random.uniform(k))
_bernoulli = jax.jit(lambda k: jax.random.bernoulli(k))


class JaxKeyStream:
    """One chain's draws from JAX's keys, split as ``gpsig_tpu.mcmc``
    splits them: a run's (``run_key``: warmup from ``kw``, sampling from
    the other half of ``split(run_key)``), explicit per-phase keys, or one
    transition's key (``transition``)."""

    def __init__(self, run_key=None, warm=None, samp=None, transition=None):
        if run_key is not None:
            samp, warm = _split2(run_key)
        self.keys = {"warmup": warm, "sampling": samp}
        self.transition = transition
        self.loop_key = self.leaf_key = None

    def momentum(self, phase, dim):
        if self.transition is not None:
            sub = self.transition
        else:
            self.keys[phase], sub = _split2(self.keys[phase])
        k_mom, k_dir, _ = _split3(sub)
        self.loop_key = k_dir
        return np.asarray(_normal(k_mom, dim))

    def doubling(self):
        self.loop_key, k_dir, k_sub, k_merge = _split4(self.loop_key)
        self.leaf_key = k_sub
        return bool(_bernoulli(k_dir)), float(_uniform(k_merge))

    def leaf(self):
        self.leaf_key, k_prop = _split2(self.leaf_key)
        return float(_uniform(k_prop))

    def state(self):
        return {}

    def load_state(self, state):
        pass


def jax_run_draws(key, C):
    """A draw source replaying ``gpsig_tpu.mcmc.sample.run_chains``'s keys."""
    return DrawSource(JaxKeyStream(run_key=k) for k in jax.random.split(key, C))


def theta0s(C, dim, seed=3):
    return np.random.default_rng(seed).normal(0.0, 0.5, (C, dim))


# -- the deterministic parts --------------------------------------------------

@pytest.mark.parametrize("target", ["correlated", "funnel"])
def test_leapfrog_matches_jax(target):
    rng = np.random.default_rng(0)
    C, dim = 5, DIMS[target]
    theta, r = rng.normal(size=(C, dim)), rng.normal(size=(C, dim))
    inv_mass, eps = rng.uniform(0.5, 2.0, (C, dim)), rng.uniform(0.1, 0.4, C)
    jf = jax.value_and_grad(jax_targets()[target])
    _, grad = jax.vmap(jf)(jnp.asarray(theta))
    want = jax.vmap(lambda t, rr, g, e, m: jnuts._leapfrog(jf, t, rr, g, e, m))(
        jnp.asarray(theta), jnp.asarray(r), grad, jnp.asarray(eps),
        jnp.asarray(inv_mass))
    tf = tnuts.value_and_grad(torch_targets()[target])
    got = tnuts._leapfrog(tf, torch.as_tensor(theta), torch.as_tensor(r),
                          torch.as_tensor(np.asarray(grad)),
                          torch.as_tensor(eps)[:, None],
                          torch.as_tensor(inv_mass))
    for g, w, what in zip(got, want, ("theta", "r", "logp", "grad")):
        close(g, w, DET_TOL, what)


def test_is_turning_and_kinetic_match_jax():
    rng = np.random.default_rng(1)
    C, dim = 64, 3
    args = [rng.normal(size=(C, dim)) for _ in range(3)]
    inv_mass = rng.uniform(0.5, 2.0, (C, dim))
    want = jax.vmap(jnuts._is_turning)(*map(jnp.asarray, args + [inv_mass]))
    got = tnuts._is_turning(*map(torch.as_tensor, args + [inv_mass]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < C  # both outcomes occur
    close(tnuts._kinetic(torch.as_tensor(args[0]), torch.as_tensor(inv_mass)),
          jax.vmap(jnuts._kinetic)(jnp.asarray(args[0]),
                                   jnp.asarray(inv_mass)), DET_TOL)


def test_ctz_matches_jax():
    n = np.arange(1, 300)
    for maxbits in (3, 7, 9):
        want = jax.jit(jax.vmap(lambda k: jnuts._ctz(k, maxbits)))(
            jnp.asarray(n, jnp.int32))
        assert [tnuts._ctz(k, maxbits) for k in n] == np.asarray(
            want).tolist(), maxbits


def test_dual_averaging_and_welford_match_jax():
    rng = np.random.default_rng(2)
    C, dim, steps = 4, 3, 25
    accs = rng.uniform(0.0, 1.0, (steps, C))
    xs = rng.normal(size=(steps, C, dim))
    eps0 = rng.uniform(0.05, 0.5, C)
    jda = jax.vmap(jsample.da_init)(jnp.asarray(eps0))
    tda = tsample.da_init(torch.as_tensor(eps0))
    jwf = jax.vmap(lambda _: jsample.welford_init(dim, jnp.float64))(
        jnp.arange(C))
    twf = tsample.welford_init(dim, torch.float64, C)
    for a, x in zip(accs, xs):
        jda = jax.vmap(jsample.da_update)(jda, jnp.asarray(a))
        tda = tsample.da_update(tda, torch.as_tensor(a))
        jwf = jax.vmap(jsample.welford_update)(jwf, jnp.asarray(x))
        twf = tsample.welford_update(twf, torch.as_tensor(x))
    for name in jsample.DAState._fields:
        close(getattr(tda, name), getattr(jda, name), DET_TOL, name)
    for name in jsample.WelfordState._fields:
        close(getattr(twf, name), getattr(jwf, name), DET_TOL, name)
    for reg in (True, False):
        close(tsample.welford_variance(twf, reg),
              jax.vmap(lambda w: jsample.welford_variance(w, reg))(jwf),
              DET_TOL, f"variance regularize={reg}")


def test_ess_and_split_rhat_bitwise():
    rng = np.random.default_rng(3)
    for shape in ((4, 200, 3), (1, 51, 2), (8, 3, 1)):
        x = rng.normal(size=shape).cumsum(1)
        np.testing.assert_array_equal(tmetrics.effective_sample_size(x),
                                      jmetrics.effective_sample_size(x))
        np.testing.assert_array_equal(tmetrics.split_rhat(x),
                                      jmetrics.split_rhat(x))


# -- one transition with JAX's keys ---------------------------------------------

@pytest.mark.parametrize("max_depth", [1, 2, 3, 4])
@pytest.mark.parametrize("target", ["correlated", "scaled", "funnel"])
def test_transition_matches_jax(target, max_depth):
    """One transition of 6 chains from JAX's keys: θ, log p, gradient,
    accept_prob, num_leaves and diverging. The funnel's large steps at its
    neck diverge on some chains (asserted at depth 4)."""
    C, dim = 6, DIMS[target]
    rng = np.random.default_rng(10 * max_depth + dim)
    theta = rng.normal(0.0, 1.0, (C, dim))
    if target == "funnel":
        theta[:, 0] = np.linspace(-3.0, 2.0, C)
    eps = rng.uniform(0.2, 0.6, C) * (3.0 if target == "funnel" else 1.0)
    inv_mass = rng.uniform(0.5, 2.0, (C, dim))
    keys = jax.random.split(jax.random.PRNGKey(max_depth), C)
    jf = jax_targets()[target]
    jlogp, jgrad = jax.vmap(jax.value_and_grad(jf))(jnp.asarray(theta))
    jstep = jnuts.nuts_kernel(jf, max_depth=max_depth)
    jstate, jinfo = jax.vmap(jstep)(
        keys, jnuts.NutsState(jnp.asarray(theta), jlogp, jgrad),
        jnp.asarray(eps), jnp.asarray(inv_mass))

    tstep = tnuts.nuts_kernel(torch_targets()[target], max_depth=max_depth)
    state = tnuts.NutsState(*(torch.as_tensor(np.asarray(a))
                              for a in (theta, jlogp, jgrad)))
    draws = DrawSource(JaxKeyStream(transition=k) for k in keys)
    tstate, tinfo = tstep(draws, state, torch.as_tensor(eps),
                          torch.as_tensor(inv_mass))
    np.testing.assert_array_equal(tinfo["num_leaves"].numpy(),
                                  np.asarray(jinfo["num_leaves"]))
    np.testing.assert_array_equal(tinfo["diverging"].numpy(),
                                  np.asarray(jinfo["diverging"]))
    for name in ("theta", "logp", "grad"):
        close(getattr(tstate, name), getattr(jstate, name), STEP_TOL, name)
    for name in ("accept_prob", "energy"):
        close(tinfo[name], jinfo[name], STEP_TOL, name)
    if target == "funnel" and max_depth == 4:
        assert 0 < int(tinfo["diverging"].sum()) < C


def test_run_chains_matches_jax():
    """A whole run_chains (4 chains, 30 warmup, 20 samples, max_depth 4):
    samples, adaptation and diagnostics."""
    C, dim = 4, 2
    key = jax.random.PRNGKey(21)
    th0 = theta0s(C, dim)
    kw = dict(num_warmup=30, num_samples=20, max_depth=4)
    jtheta, jinfo = jsample.run_chains(key, jax_targets()["correlated"],
                                       jnp.asarray(th0), **kw)
    ttheta, tinfo = tsample.run_chains(jax_run_draws(key, C),
                                       torch_targets()["correlated"],
                                       torch.as_tensor(th0), **kw)
    close(ttheta, jtheta, RUN_TOL, "theta")
    for k in ("num_leaves", "diverging"):
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=k)
    for k in ("step_size", "inv_mass", "warmup_accept", "accept_prob",
              "logp"):
        close(tinfo[k], jinfo[k], RUN_TOL, k)


def test_start_from_jax_mid_warmup_state():
    """``convert.sampler_state_from_arrays`` takes JAX's warmup carry after
    12 steps; 8 more port steps (across the mass window's end at 14) from
    the carry's key match JAX's continuation."""
    C, dim = 3, 2
    jf = jax_targets()["correlated"]
    kernel = jnuts.nuts_kernel(jf, max_depth=4)
    warm = jsample.make_warm_step(kernel, 0.8, 2, 14)
    th0 = jnp.asarray(theta0s(C, dim, seed=5))

    def init(t, k):
        logp, grad = jax.value_and_grad(jf)(t)
        return (jnuts.NutsState(t, logp, grad),
                jsample.da_init(jnp.asarray(0.1)),
                jsample.welford_init(dim, jnp.float64), jnp.ones(dim), k)

    def scan(carry, t0, n):
        return jax.lax.scan(warm, carry, t0 + jnp.arange(n))

    carry = jax.vmap(init)(th0, jax.random.split(jax.random.PRNGKey(8), C))
    carry, _ = jax.vmap(lambda c: scan(c, 0, 12))(carry)
    jend, jacc = jax.vmap(lambda c: scan(c, 12, 8))(carry)

    st, da, wf, im, keys = carry
    tcarry = convert.sampler_state_from_arrays(
        {"state": {k: np.asarray(v) for k, v in st._asdict().items()},
         "da": {k: np.asarray(v) for k, v in da._asdict().items()},
         "wf": {k: np.asarray(v) for k, v in wf._asdict().items()},
         "inv_mass": np.asarray(im)}, device="cpu")
    tstep = tsample.make_warm_step(tnuts.nuts_kernel(
        torch_targets()["correlated"], max_depth=4), 0.8, 2, 14)
    draws = DrawSource(JaxKeyStream(warm=k) for k in keys)
    accs = []
    for t in range(12, 20):
        tcarry, acc = tstep(tcarry, t, draws)
        accs.append(acc)
    close(torch.stack(accs, 1), jacc, RUN_TOL, "accept")
    close(tcarry[0].theta, jend[0].theta, RUN_TOL, "theta")
    close(tcarry[1].log_eps, jend[1].log_eps, RUN_TOL, "log_eps")
    close(tcarry[3], jend[3], RUN_TOL, "inv_mass")


# -- the port's own draws: moments (tests/test_nuts.py:25-66, shorter) -------

def test_nuts_correlated_gaussian_moments():
    theta, info = tsample.run_nuts(0, torch_targets()["correlated"],
                                   torch.zeros(2, dtype=torch.float64),
                                   num_warmup=100, num_samples=300,
                                   max_depth=6)
    s = theta.numpy()
    assert not info["diverging"].any()
    assert 0.6 < float(info["accept_prob"].mean()) <= 1.0
    np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.25)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.45)


def test_nuts_mass_matrix_adapts_to_scales():
    theta, info = tsample.run_nuts(
        1, torch_targets()["scaled"], torch.as_tensor([0.05, 1.0],
                                                      dtype=torch.float64),
        num_warmup=60, num_samples=400, max_depth=8)
    inv_mass = info["inv_mass"].numpy()
    # inverse mass ≈ marginal variances: the ratio reflects the 1e4 spread
    assert inv_mass[1] / inv_mass[0] > 100
    np.testing.assert_allclose(theta.numpy().std(0), SCALES, rtol=0.35)


def test_nuts_batched_chains():
    th0 = torch.as_tensor(0.1 * np.random.default_rng(3).normal(size=(4, 2)))
    theta, info = tsample.run_chains(2, torch_targets()["correlated"], th0,
                                     num_warmup=100, num_samples=200,
                                     max_depth=6)
    assert theta.shape == (4, 200, 2)
    s = theta.numpy().reshape(-1, 2)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.4)


# -- the chunked sampler ------------------------------------------------------

KEYS = ("step_size", "inv_mass", "warmup_accept", "accept_prob",
        "num_leaves", "diverging", "logp")


def assert_same(got, want):
    (gt, gi), (wt, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gt), np.asarray(wt))
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(gi[k]), np.asarray(wi[k]),
                                      err_msg=k)


def chunked(**kw):
    return make_chunked_sampler(torch_targets()["correlated"], **kw)


def test_chunked_dispatch_matches_monolithic():
    """draws_per_dispatch does not change the draws: chunks of 13 (one
    splitting the mass window [4, 36), ragged last chunks) equal one chunk
    a phase with a shared step size, and equal ``run_chains`` without
    one."""
    th0 = torch.as_tensor(theta0s(8, 2, seed=6))
    kw = dict(num_warmup=40, num_samples=30, max_depth=5)
    assert_same(chunked(draws_per_dispatch=13, **kw)(7, th0),
                chunked(draws_per_dispatch=40, **kw)(7, th0))
    t, i = tsample.run_chains(7, torch_targets()["correlated"], th0, **kw)
    assert_same(chunked(draws_per_dispatch=13, shared_step_size=False,
                        **kw)(7, th0),
                (t.numpy(), {k: v.numpy() for k, v in i.items()}))


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """A run saving every chunk equals the plain chunked run, and so does
    one stopped after every chunk (a fresh sampler each slice, the state
    only on disk)."""
    th0 = torch.as_tensor(theta0s(8, 2, seed=8))
    kw = dict(num_warmup=40, num_samples=30, max_depth=5,
              draws_per_dispatch=13)
    ref = chunked(**kw)(9, th0)
    assert_same(chunked(**kw)(9, th0, checkpoint_dir=str(tmp_path / "a")),
                ref)
    out, slices = None, 0
    while out is None:
        out = chunked(**kw)(9, th0, checkpoint_dir=str(tmp_path / "b"),
                            max_chunks=1)
        slices += 1
        assert slices < 30
        assert len([d for d in (tmp_path / "b").iterdir()
                    if d.name.startswith("chunk_")]) == 1  # the newest only
    assert slices > 3
    assert_same(out, ref)


def test_chunked_guards_and_empty_sampling(tmp_path):
    """max_chunks without checkpoint_dir raises; num_samples = 0 returns
    empty buffers of the right shapes; a checkpoint of other settings is
    refused, and so is a directory whose saves none restores."""
    th0 = torch.as_tensor(theta0s(8, 2, seed=10))
    s = chunked(num_warmup=10, num_samples=5, max_depth=4,
                draws_per_dispatch=4)
    with pytest.raises(ValueError, match="max_chunks"):
        s(11, th0, max_chunks=1)
    theta, info = chunked(num_warmup=8, num_samples=0, max_depth=4,
                          draws_per_dispatch=4)(11, th0)
    assert theta.shape == (8, 0, 2)
    assert info["accept_prob"].shape == (8, 0)
    assert info["warmup_accept"].shape == (8, 8)
    cdir = tmp_path / "cfg"
    assert s(11, th0, checkpoint_dir=str(cdir), max_chunks=1) is None
    other = chunked(num_warmup=20, num_samples=5, max_depth=4,
                    draws_per_dispatch=4)
    with pytest.raises(ValueError, match="different sampler config"):
        other(11, th0, checkpoint_dir=str(cdir))
    (save,) = cdir.iterdir()
    save.write_bytes(b"not a checkpoint")
    with pytest.raises(RuntimeError, match="none could be restored"):
        s(11, th0, checkpoint_dir=str(cdir))
    with pytest.raises(ValueError, match="chain_blocks"):
        chunked(num_warmup=4, num_samples=4, draws_per_dispatch=4,
                chain_blocks=3)(0, th0)


def test_chain_blocks_grouping_invariance():
    """Chain blocks change only which chains share a batch: with
    independent chains every grouping equals one block, bitwise."""
    th0 = torch.as_tensor(theta0s(8, 2, seed=14))
    kw = dict(num_warmup=24, num_samples=16, max_depth=5,
              draws_per_dispatch=10, shared_step_size=False)
    ref = chunked(**kw)(15, th0)
    for g in (2, 4):
        assert_same(chunked(chain_blocks=g, **kw)(15, th0), ref)


def test_on_chunk_progress_callback():
    th0 = torch.as_tensor(theta0s(8, 2, seed=12))
    events = []
    chunked(num_warmup=10, num_samples=5, max_depth=4, draws_per_dispatch=4)(
        13, th0, on_chunk=lambda ph, pos, tot: events.append((ph, pos, tot)))
    assert events == [("warmup", 4, 10), ("warmup", 8, 10),
                      ("warmup", 10, 10), ("sampling", 4, 5),
                      ("sampling", 5, 5)]


def test_legacy_checkpoint_without_chain_blocks_resumes(tmp_path):
    """A checkpoint written before the chain_blocks setting existed resumes
    under the default of one block."""
    th0 = torch.as_tensor(theta0s(8, 2, seed=12))
    kw = dict(num_warmup=12, num_samples=8, max_depth=4,
              draws_per_dispatch=5)
    ref = chunked(**kw)(13, th0)
    cdir = tmp_path / "legacy"
    assert chunked(**kw)(13, th0, checkpoint_dir=str(cdir),
                         max_chunks=1) is None
    (path,) = cdir.iterdir()
    tree = tckpt.restore_checkpoint(str(path))
    assert "chain_blocks" in tree["config"]
    del tree["config"]["chain_blocks"]
    tckpt.save_checkpoint(str(path), tree)
    out = None
    while out is None:
        out = chunked(**kw)(13, th0, checkpoint_dir=str(cdir), max_chunks=2)
    assert_same(out, ref)


def test_split_rhat_detects_mixing_and_failure():
    rng = np.random.default_rng(0)
    good = rng.standard_normal((8, 400, 3))
    assert np.all(tmetrics.split_rhat(good) < 1.01)
    assert np.all(tmetrics.split_rhat(
        good + 3.0 * rng.standard_normal((8, 1, 3))) > 1.2)
    assert np.all(tmetrics.split_rhat(
        good + np.linspace(0, 2, 400)[None, :, None]) > 1.05)


def test_metric_writer_and_step_timer(tmp_path):
    path = tmp_path / "m.jsonl"
    w = tmetrics.MetricWriter(log_every=2, jsonl_path=str(path),
                              verbose=False)
    for step in range(3):
        w.write(step, loss=float(step) / 2)
    assert [r["loss"] for r in w.history] == [0.0, 0.5, 1.0]
    assert len(path.read_text().splitlines()) == 3
    timer = tmetrics.StepTimer(warmup=1)
    for _ in range(4):
        timer.tick()
    assert len(timer.times) == 3 and timer.mean >= 0.0
    with tmetrics.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(3).sum()
    assert prof.key_averages() and (tmp_path / "trace" / "trace.json").exists()


def test_draw_state_taken_before_a_transition_replays_it():
    """The card-vs-CPU check's draws: a source of another seed, loaded with
    the generator states taken before a transition, repeats that
    transition bitwise from the same carry."""
    th0 = torch.as_tensor(theta0s(4, 2, seed=20))
    f = torch_targets()["correlated"]
    samp = tsample.make_samp_step(tnuts.nuts_kernel(f, max_depth=4))
    state, _, _, inv_mass = tsample.init_carry(f, th0, 0.3)
    carry = (state, torch.full((4,), 0.3, dtype=th0.dtype), inv_mass)
    draws = DrawSource.from_seed(5, 4)
    history = []
    for _ in range(6):
        states = draws.state_dict()
        after, out = samp(carry, draws)
        history.append((carry, states, out))
        carry = after
    for before, states, out in history:
        again = DrawSource.from_seed(7, 4)
        again.load_state_dict(states)
        _, got = samp(before, again)
        for k in out:
            assert torch.equal(got[k], out[k]), k


def test_counters_count_reads_and_evaluations():
    """Each leaf is one evaluation; each doubling and each later leaf of a
    subtree one host read of the chains' mask."""
    th0 = torch.as_tensor(theta0s(4, 2, seed=22))
    n0, r0 = tnuts.evaluations, tnuts.host_reads
    _, info = tsample.run_chains(3, torch_targets()["correlated"], th0,
                                 num_warmup=0, num_samples=5, max_depth=4)
    # lockstep: a leaf evaluates all chains at once, so a transition takes
    # at least its longest chain's leaves and at most 2^4 - 1; the first
    # evaluation is the sampler's start
    most = info["num_leaves"].max(0).values
    evals = tnuts.evaluations - n0 - 1
    assert int(most.sum()) <= evals <= 5 * 15
    assert tnuts.host_reads - r0 >= evals
