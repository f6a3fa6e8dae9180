"""Multivariate-Gaussian machinery: KL divergence and sparse conditionals.

Counterpart of ``gpsig_tpu/gauss.py`` (GPflow 1.x's ``gauss_kl`` and
``conditional``). ``q_mu`` is [M, C]; ``q_sqrt`` is [C, M, M]
lower-triangular or [M, C] diagonal; ``white=True`` means u = L v with
q(v) = N(q_mu, q_sqrt q_sqrtᵀ) and p(v) = N(0, I).
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.config import default_jitter, precise_linalg


def _is_diag(q_sqrt):
    return q_sqrt.ndim == 2


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def stable_cholesky(K, extra_levels=None):
    """Cholesky with jitter escalation.

    Trial factorisations (outside autograd) pick the smallest extra jitter
    in ``extra_levels`` whose factor exists, then one differentiable
    Cholesky runs at that level; see ``gpsig_tpu.gauss.stable_cholesky``.
    ``torch.linalg.cholesky`` raises where JAX's returns NaNs, so the trials
    read ``cholesky_ex``'s ``info`` instead. K must already include the
    caller's base jitter.

    A batch K [C, M, M] (one matrix a chain, as the JAX package's ``vmap``
    gives it) chooses each matrix's jitter on its own, as ``vmap`` turns
    the JAX code's ``lax.cond`` into a per-matrix select, and a matrix that
    no level factors gets JAX's factor of such a matrix (NaN on and below
    the diagonal) where ``torch.linalg.cholesky`` would raise for the whole
    batch: the other matrices' factors do not change. The healthy batch
    reads the card once, as an unbatched K does."""
    dtype = K.dtype
    if extra_levels is None:
        base = default_jitter(dtype)
        extra_levels = (0.0, 10.0 * base, 100.0 * base, 1000.0 * base)
    eye = torch.eye(K.shape[-1], dtype=dtype, device=K.device)
    if K.ndim > 2:
        return _stable_cholesky_batch(K, extra_levels, eye)

    def factors(e):
        L, info = torch.linalg.cholesky_ex(Ks + e * eye)
        return bool(info.eq(0).all() and torch.isfinite(L).all())

    with torch.no_grad():
        Ks = K.detach()
        chosen = extra_levels[0]
        if not factors(chosen):
            chosen = next((e for e in extra_levels[1:] if factors(e)),
                          extra_levels[-1])
    return torch.linalg.cholesky(K + chosen * eye)


def _stable_cholesky_batch(K, extra_levels, eye):
    """:func:`stable_cholesky` of a batch [..., M, M], per matrix."""

    def factors(e):
        L, info = torch.linalg.cholesky_ex(Ks + e * eye)
        return info.eq(0) & torch.isfinite(L).all(dim=(-2, -1))

    with torch.no_grad():
        Ks = K.detach()
        ok = factors(extra_levels[0])
        chosen = torch.full(ok.shape, extra_levels[0], dtype=K.dtype,
                            device=K.device)
        if not bool(ok.all()):
            # as the JAX escalation: the smallest later level that factors,
            # else the last
            pick = torch.full_like(chosen, extra_levels[-1])
            for e in reversed(extra_levels[1:]):
                pick = torch.where(factors(e), e, pick)
            chosen = torch.where(ok, chosen, pick)
    L, info = torch.linalg.cholesky_ex(K + chosen[..., None, None] * eye)
    # a failed factor as JAX's: NaN on and below the diagonal, 0 above
    return torch.where(info.eq(0)[..., None, None], L,
                       torch.full_like(L, float("nan")).tril())


@precise_linalg()
def gauss_kl(q_mu, q_sqrt, K=None, K_chol=None):
    """KL[q || p] summed over latents; p = N(0, I) when K and K_chol are
    None (whitened), else N(0, K) with K [M, M] or [C, M, M]."""
    M, C = q_mu.shape
    if K is None and K_chol is None:
        mahal = torch.sum(q_mu**2)
        if _is_diag(q_sqrt):
            s2 = q_sqrt**2
            trace = torch.sum(s2)
            logdet_q = torch.sum(torch.log(s2))
        else:
            trace = torch.sum(q_sqrt**2)
            diag = torch.diagonal(q_sqrt, dim1=-2, dim2=-1)
            logdet_q = 2.0 * torch.sum(torch.log(torch.abs(diag)))
        return 0.5 * (mahal + trace - M * C - logdet_q)

    L = K_chol if K_chol is not None else stable_cholesky(K)
    if L.ndim == 2:
        L = L.expand((C,) + L.shape)
    alpha = _solve_lower(L, q_mu.T[:, :, None])  # [C, M, 1]
    mahal = torch.sum(alpha**2)
    logdet_p = 2.0 * C_logdiag_sum(L)
    if _is_diag(q_sqrt):
        s2 = q_sqrt**2  # [M, C]
        eye = torch.eye(M, dtype=L.dtype, device=L.device).expand(L.shape)
        Kinv_diag = torch.sum(_solve_lower(L, eye) ** 2, dim=-2)  # [C, M]
        trace = torch.sum(Kinv_diag * s2.T)
        logdet_q = torch.sum(torch.log(s2))
    else:
        trace = torch.sum(_solve_lower(L, q_sqrt) ** 2)
        diag = torch.diagonal(q_sqrt, dim1=-2, dim2=-1)
        logdet_q = 2.0 * torch.sum(torch.log(torch.abs(diag)))
    return 0.5 * (mahal + trace - M * C + logdet_p - logdet_q)


def C_logdiag_sum(L):
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.sum(torch.log(torch.abs(d)))


def _conditional_var_floor(dtype):
    """Positive floor for marginal conditional variances: far below any
    exact-kernel variance, high enough that sqrt/log stay finite."""
    return 1e-14 if dtype == torch.float64 else 1e-8


def floor_marginal_variance(var, scale=None):
    """Clamp marginal predictive variances at a dtype-tiny positive floor,
    relative to max|scale| when ``scale`` (the prior marginals) is given;
    see ``gpsig_tpu.gauss.floor_marginal_variance`` for the policy."""
    floor = torch.as_tensor(_conditional_var_floor(var.dtype),
                            dtype=var.dtype, device=var.device)
    if scale is not None:
        amp = torch.max(torch.abs(scale)).to(var.dtype)
        tiny = 8.0 * torch.finfo(var.dtype).tiny
        floor = torch.clamp(floor * amp, min=tiny)
    return torch.maximum(var, floor)


@precise_linalg()
def conditional(Kmn, Kmm, Knn, q_mu, q_sqrt, white=True, full_cov=False,
                Kmm_chol=None):
    """Sparse GP predictive q(f) = ∫ p(f | u) q(u) du.

    Kmn [M, N]; Kmm [M, M]; Knn [N] (full_cov=False) or [N, N].
    Returns (mean [N, C], var [N, C] or [C, N, N])."""
    L = Kmm_chol if Kmm_chol is not None else stable_cholesky(Kmm)
    Aw = _solve_lower(L, Kmn)  # L⁻¹Kmn, [M, N]
    A = Aw if white else torch.linalg.solve_triangular(L.T, Aw, upper=True)
    mean = A.T @ q_mu  # [N, C]
    if _is_diag(q_sqrt):
        SA = q_sqrt.T[:, :, None] * A[None]  # [C, M, N]
    else:
        SA = torch.einsum("cmk,kn->cmn", torch.swapaxes(q_sqrt, -1, -2), A)
    if full_cov:
        ext = torch.einsum("cmn,cmk->cnk", SA, SA)
        return mean, Knn[None] - (Aw.T @ Aw)[None] + ext  # [C, N, N]
    var = Knn[None, :] - torch.sum(Aw**2, dim=0)[None, :] \
        + torch.sum(SA**2, dim=1)  # [C, N]
    return mean, floor_marginal_variance(var, scale=Knn).T  # [N, C]
