"""The NUTS sampler loops: warmup (dual averaging and a Welford mass
estimate) and sampling, C chains as one batch.

Counterpart of ``gpsig_tpu/mcmc/sample.py``. Every state here carries the
chain axis first: ``DAState``'s fields are [C], ``WelfordState``'s count
[C] and mean and M2 [C, D], the inverse mass [C, D]. The reference has a
single adaptation window: the mass matrix is estimated over warmup
iterations [0.1 W, 0.9 W) and frozen at 0.9 W, where dual averaging
restarts (``gpsig_tpu/mcmc/nuts.py:11-13``); the port keeps it so. The
window keys on the absolute warmup index, so a run cut into chunks
(``parallel/chains.py``) adapts exactly as one that is not.

``run_chains`` takes an int seed (each chain its own generator, seeded
from (seed, chain)) or a draw source (``mcmc/draws.py``) where JAX takes a
key. It has no ``share_step_size``: the JAX package's changes nothing
there (it cannot express a mean over its ``vmap`` axis), and shares a
step size only in ``parallel/chains.py``, as the port's chunked sampler
does by pooling the accept statistic over a block of chains.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gpsig_tpu_torch.mcmc.draws import as_draw_source
from gpsig_tpu_torch.mcmc.nuts import NutsState, nuts_kernel, value_and_grad


class DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def da_init(eps0):
    log_eps = torch.log(eps0)
    return DAState(
        log_eps=log_eps,
        log_eps_bar=torch.zeros_like(log_eps),
        h_bar=torch.zeros_like(log_eps),
        mu=math.log(10.0) + log_eps,
        t=torch.zeros_like(log_eps),
    )


def da_update(state: DAState, accept_prob, target=0.8, gamma=0.05,
              t0=10.0, kappa=0.75):
    t = state.t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * state.h_bar + (
        target - accept_prob
    ) / (t + t0)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return DAState(log_eps, log_eps_bar, h_bar, state.mu, t)


class WelfordState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dim, dtype, num_chains, device=None):
    """Zero state for ``num_chains`` vectors of ``dim``."""
    z = torch.zeros((num_chains, dim), dtype=dtype, device=device)
    return WelfordState(torch.zeros(num_chains, dtype=dtype, device=device),
                        z, z)


def welford_update(state: WelfordState, x):
    n = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / n[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(n, mean, m2)


def welford_variance(state: WelfordState, regularize=True):
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)[..., None]
    if regularize:  # Stan's shrinkage towards unit
        n = state.count[..., None]
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def make_warm_step(kernel, target_accept, mass_start, mass_end,
                   cross_chain_mean=None):
    """One warmup iteration: NUTS transition + dual-averaging step-size
    update + Welford mass accumulation in [mass_start, mass_end).

    warm_step(carry, t, draws) with carry = (state, da, wf, inv_mass) and
    t the absolute warmup index (so chunked runs keep the window); returns
    (carry, accept_prob [C]). ``cross_chain_mean`` maps the accept
    statistic [C] to the value dual averaging uses (a shared step size)."""

    def warm_step(carry, t, draws):
        state, da, wf, inv_mass = carry
        eps = torch.exp(da.log_eps)
        state, info = kernel(draws, state, eps, inv_mass, phase="warmup")
        acc = info["accept_prob"]
        if cross_chain_mean is not None:
            acc = cross_chain_mean(acc)
        da = da_update(da, acc, target=target_accept)
        if mass_start <= t < mass_end:
            wf = welford_update(wf, state.theta)
        # at window end: freeze mass matrix, restart dual averaging
        if t == mass_end:
            inv_mass = welford_variance(wf)
            da = da_init(torch.exp(da.log_eps))
        return (state, da, wf, inv_mass), info["accept_prob"]

    return warm_step


def make_samp_step(kernel):
    """One sampling iteration: samp_step(carry, draws) with carry =
    (state, eps, inv_mass); returns (carry, the transition's outputs)."""

    def samp_step(carry, draws):
        state, eps, inv_mass = carry
        state, info = kernel(draws, state, eps, inv_mass, phase="sampling")
        out = {
            "theta": state.theta,
            "logp": state.logp,
            "accept_prob": info["accept_prob"],
            "diverging": info["diverging"],
            "num_leaves": info["num_leaves"],
        }
        return (state, eps, inv_mass), out

    return samp_step


def init_carry(logp_fn, theta0s, init_step_size):
    """The warmup carry of chains θ0 [C, D]: their log p and gradient (one
    evaluation), dual averaging at ``init_step_size``, an empty Welford
    state and a unit inverse mass."""
    C, dim = theta0s.shape
    logp0, grad0 = value_and_grad(logp_fn)(theta0s)
    eps0 = torch.full((C,), init_step_size, dtype=theta0s.dtype,
                      device=theta0s.device)
    return (NutsState(theta0s, logp0, grad0), da_init(eps0),
            welford_init(dim, theta0s.dtype, C, theta0s.device),
            torch.ones_like(theta0s))


def _stack(outs):
    return {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}


def run_nuts(
    key,
    logp_fn: Callable,
    theta0,
    num_warmup=500,
    num_samples=500,
    max_depth=8,
    target_accept=0.8,
    init_step_size=0.1,
):
    """Adaptive NUTS. θ0 [D] (one chain; ``logp_fn`` still maps [C, D] →
    [C]) or [C, D] (a batch of chains). Returns (samples [num_samples, D],
    or [C, num_samples, D], and the info dict, shaped alike).

    key: an int seed or a draw source."""
    one = theta0.ndim == 1
    theta0s = theta0[None] if one else theta0
    C = theta0s.shape[0]
    draws = as_draw_source(key, C)
    kernel = nuts_kernel(logp_fn, max_depth=max_depth)
    mass_start = int(0.1 * num_warmup)
    mass_end = int(0.9 * num_warmup)
    warm_step = make_warm_step(kernel, target_accept, mass_start, mass_end)
    carry = init_carry(logp_fn, theta0s, init_step_size)
    warm_acc = []
    for t in range(num_warmup):
        carry, acc = warm_step(carry, t, draws)
        warm_acc.append(acc)
    state, da, _, inv_mass = carry
    eps = torch.exp(da.log_eps_bar)
    samp_step = make_samp_step(kernel)
    scarry, outs = (state, eps, inv_mass), []
    for _ in range(num_samples):
        scarry, out = samp_step(scarry, draws)
        outs.append(out)
    kw = dict(dtype=theta0s.dtype, device=theta0s.device)
    draws_out = _stack(outs) if outs else {
        "theta": torch.zeros((C, 0) + theta0s.shape[1:], **kw),
        "logp": torch.zeros((C, 0), **kw),
        "accept_prob": torch.zeros((C, 0), **kw),
        "diverging": torch.zeros((C, 0), dtype=torch.bool,
                                 device=theta0s.device),
        "num_leaves": torch.zeros((C, 0), **kw)}
    info = {
        "step_size": eps,
        "inv_mass": inv_mass,
        "warmup_accept": (torch.stack(warm_acc, dim=1) if warm_acc
                          else torch.zeros((C, 0), **kw)),
        "accept_prob": draws_out["accept_prob"],
        "diverging": draws_out["diverging"],
        "num_leaves": draws_out["num_leaves"],
        "logp": draws_out["logp"],
    }
    if one:
        info = {k: v[0] for k, v in info.items()}
        return draws_out["theta"][0], info
    return draws_out["theta"], info


def run_chains(key, logp_fn, theta0s, **kw):
    """C chains θ0s [C, D] as one batch on one device; returns (samples
    [C, num_samples, D], info with a leading chain axis). ``key``: an int
    seed (chain c's generator seeded from (seed, c)) or a draw source."""
    if theta0s.ndim != 2:
        raise ValueError(f"run_chains takes θ0s [C, D], not "
                         f"{tuple(theta0s.shape)}")
    return run_nuts(key, logp_fn, theta0s, **kw)
