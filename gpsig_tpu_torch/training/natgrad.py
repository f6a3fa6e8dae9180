"""Natural-gradient steps on the Gaussian variational parameters.

Counterpart of ``gpsig_tpu/training/natgrad.py`` (GPflow 1.x's
``NatGradOptimizer`` with the ``XiSqrtMeanVar`` transform); see its
docstring for the mathematics. For q(u) = N(μ, S), a step of length γ is

    S'⁻¹ = S⁻¹ − 2γ g_S,    μ' = S' (S⁻¹μ + γ(g_μ − 2 g_S μ)),

with g_μ = ∂ELBO/∂μ and g_S = ∂ELBO/∂S symmetrised. The same formulas
hold elementwise for a diagonal q. Where S'⁻¹ is not positive-definite,
γ backs off through ``_BACKOFF`` per latent.

Unlike the JAX package, whose models are immutable, :func:`natgrad_step`
writes the new (q_mu, q_sqrt) into the model in place.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.config import precise_linalg

#: backoff factors tried when S'⁻¹ = S⁻¹ − 2γ g_S is not positive-definite
_BACKOFF = (1.0, 0.25, 0.0625, 0.015625)


def _cho_inverse(L):
    """A⁻¹ from its lower Cholesky factor L, by two triangular solves (as
    ``jax.scipy.linalg.cho_solve`` against the identity). At
    [10, 500, 500] in float32 on an H100 80GB HBM3 (700 W),
    ``torch.cholesky_solve`` against the identity took 6.0–6.3 ms by CUDA
    events, these two solves 0.78–0.81 ms (PERF.md, Findings)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Linv,
                                         upper=True)


def _factor(A):
    """Cholesky factor of A and, per batch entry, whether it exists:
    ``cholesky_ex`` reports failure in ``info`` (where JAX returns NaNs),
    and on CUDA a failed factor is not reliably NaN, so both are read."""
    L, info = torch.linalg.cholesky_ex(A)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    return L, info.eq(0) & torch.isfinite(diag).all(-1)


@precise_linalg()
def gaussian_natgrad_update(mu, S, g_mu, g_S, gamma, jitter=1e-8,
                            diag=False):
    """Apply the natural-gradient step in (μ, S); returns (μ', q_sqrt').

    mu [M, C]; S [C, M, M] (or [M, C] variances with ``diag``). Tries
    γ·{1, ¼, 1/16, 1/64} and keeps, per latent, the first step whose new
    precision stays positive-definite; a latent for which all fail keeps
    its (μ, S). Stops once every latent has a step, which gives the same
    result as trying all four."""
    C = mu.shape[1]
    done = torch.zeros(C, dtype=torch.bool, device=mu.device)
    if diag:
        prec = 1.0 / S
        mu_out, s_out = mu, S
        for scale in _BACKOFF:
            g = gamma * scale
            prec_new = prec - 2.0 * g * g_S
            ok = torch.all(prec_new > jitter, dim=0)  # [C]
            S_new = 1.0 / torch.clamp(prec_new, min=jitter)
            mu_new = S_new * (prec * mu + g * (g_mu - 2.0 * g_S * mu))
            take = ok & ~done
            mu_out = torch.where(take[None, :], mu_new, mu_out)
            s_out = torch.where(take[None, :], S_new, s_out)
            done = done | ok
            if bool(done.all()):
                break
        return mu_out, torch.sqrt(s_out)

    g_S = 0.5 * (g_S + g_S.transpose(-1, -2))
    M = mu.shape[0]
    eye = torch.eye(M, dtype=mu.dtype, device=mu.device)
    Ls = torch.linalg.cholesky(S)
    Sinv = _cho_inverse(Ls)
    theta1 = torch.einsum("cij,jc->ic", Sinv, mu)  # S⁻¹μ, [M, C]
    step_mu = g_mu - 2.0 * torch.einsum("cij,jc->ic", g_S, mu)

    mu_out, q_out = mu, Ls
    for scale in _BACKOFF:
        g = gamma * scale
        Lp, ok = _factor(Sinv - 2.0 * g * g_S + jitter * eye)
        S_new = _cho_inverse(torch.where(ok[:, None, None], Lp, eye))
        mu_new = torch.einsum("cij,jc->ic", S_new, theta1 + g * step_mu)
        q_new, ok_q = _factor(0.5 * (S_new + S_new.transpose(-1, -2))
                              + jitter * eye)
        ok = ok & ok_q & torch.isfinite(mu_new).all(0)
        take = ok & ~done
        mu_out = torch.where(take[None, :], mu_new, mu_out)
        q_out = torch.where(take[:, None, None], q_new, q_out)
        done = done | ok
        if bool(done.all()):
            break
    return mu_out, q_out


def natgrad_step(model, gamma, X, Y, num_data=None, jitter=1e-8,
                 generator=None, reduce=None):
    """One natural-gradient ascent step on (q_mu, q_sqrt) of an SVGP,
    written into the model in place; returns the model. Hyperparameters
    are untouched. ∂ELBO/∂S flows through cholesky(S), as in JAX.
    ``generator`` goes to the ELBO (a Monte-Carlo likelihood draws from
    it). ``reduce(g_mu, g_S) -> (g_mu, g_S)`` maps the gradients before the
    update (the sharded step sums its ranks' shares there)."""
    diag = model.q_diag
    mu = model.q_mu.detach().clone().requires_grad_()
    if diag:
        S = (model.q_sqrt.detach() ** 2).requires_grad_()  # [M, C]
    else:
        Lq = torch.tril(model.q_sqrt.detach())  # [C, M, M]
        S = (Lq @ Lq.transpose(-1, -2)).requires_grad_()
    with torch.enable_grad(), precise_linalg():
        q_sqrt = torch.sqrt(S) if diag else torch.linalg.cholesky(S)
        elbo = model.elbo_at(mu, q_sqrt, X, Y, num_data=num_data,
                             generator=generator)
        g_mu, g_S = torch.autograd.grad(elbo, (mu, S))
    if reduce is not None:
        g_mu, g_S = reduce(g_mu, g_S)
    mu_new, q_sqrt_new = gaussian_natgrad_update(
        mu.detach(), S.detach(), g_mu, g_S, gamma, jitter, diag)
    with torch.no_grad():
        model.q_mu.copy_(mu_new)
        model.q_sqrt.copy_(q_sqrt_new)
    return model
