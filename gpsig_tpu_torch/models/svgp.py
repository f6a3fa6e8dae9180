"""Sparse variational GP (SVGP) with whitened parameterisation.

Counterpart of ``gpsig_tpu/models/svgp.py``:
ELBO = (N/B) Σ_batch E_q[log p(y_i | f_i)] − KL[q(u) ‖ p(u)], prediction,
and the cached :class:`Posterior`. Inducing features with
``kuu_is_identity`` (VOSF, ``kernels/vosf.py``) take the Kuu = I path: no
Cholesky, no solves, an O(M) KL and an elementwise conditional. Training
(natural gradients + Adam) is ``gpsig_tpu_torch.training``.

A Monte-Carlo likelihood (``likelihoods.Softmax``) draws from the
``generator`` that ``elbo``, ``predict_y`` and ``predict_log_density``
take, where the JAX package takes a PRNG key.
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch import config, gauss
from gpsig_tpu_torch.config import precise_linalg


class SVGP(nn.Module):
    def __init__(self, kernel, likelihood, inducing, q_mu, q_sqrt,
                 whiten=True, q_diag=False):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.inducing = inducing
        self.q_mu = nn.Parameter(q_mu)  # [M, C]
        self.q_sqrt = nn.Parameter(q_sqrt)  # [C, M, M] (tril used) or [M, C]
        self.whiten = whiten
        self.q_diag = q_diag

    @classmethod
    def create(cls, kernel, likelihood, inducing, num_latent, whiten=True,
               q_diag=False, dtype=torch.float64, device=None):
        M = inducing.num_inducing
        kw = dict(dtype=dtype, device=config.resolve_device(device))
        q_mu = torch.zeros((M, num_latent), **kw)
        if q_diag:
            q_sqrt = torch.ones((M, num_latent), **kw)
        else:
            q_sqrt = torch.eye(M, **kw).repeat(num_latent, 1, 1)
        return cls(kernel, likelihood, inducing, q_mu, q_sqrt, whiten, q_diag)

    @property
    def num_latent(self):
        return self.q_mu.shape[1]

    def _tril_q_sqrt(self):
        return self.q_sqrt if self.q_diag else torch.tril(self.q_sqrt)

    def _covariances(self, X):
        # jitter=None → the inducing object resolves a dtype-aware default
        if hasattr(self.inducing, "covariances"):
            return self.inducing.covariances(self.kernel, X, None)
        return self.inducing.Kuu(self.kernel, None), \
            self.inducing.Kuf(self.kernel, X)

    @property
    def _kuu_identity(self):
        """VOSF: Kuu = I needs no Cholesky and no solves."""
        return getattr(self.inducing, "kuu_is_identity", False)

    @precise_linalg()
    def _identity_conditional(self, Kuf, Knn):
        """q(f) marginals under Kuu = I: mean Kufᵀ q_mu, variance
        Knn − Σ_m Kuf² + Σ_m (Sᵀ Kuf)². On the self-consistent VOSF path
        Knn equals Σ Kuf² analytically (the difference is rounding noise);
        under the untruncated prior it is the finite-difference PDE
        kernel: both take the marginal floor."""
        q_sqrt = self._tril_q_sqrt()
        mean = Kuf.T @ self.q_mu
        if self.q_diag:
            extra = (q_sqrt**2).T @ Kuf**2  # [C, N]
        else:
            SA = torch.einsum("cmk,kn->cmn", q_sqrt.transpose(-1, -2), Kuf)
            extra = torch.sum(SA**2, dim=1)
        var = Knn[None, :] - torch.sum(Kuf**2, dim=0)[None, :] + extra
        return mean, gauss.floor_marginal_variance(var, scale=Knn).T

    @precise_linalg()
    def predict_f(self, X, full_cov=False):
        if self._kuu_identity and not full_cov:
            Kuf = self.inducing.Kuf(self.kernel, X)
            return self._identity_conditional(Kuf, self.kernel.Kdiag(X))
        Kuu, Kuf = self._covariances(X)
        Knn = self.kernel.K(X) if full_cov else self.kernel.Kdiag(X)
        return gauss.conditional(Kuf, Kuu, Knn, self.q_mu,
                                 self._tril_q_sqrt(), white=self.whiten,
                                 full_cov=full_cov)

    def prior_kl(self, Kuu=None):
        """KL[q(u) ‖ p(u)]: against N(0, I) when whitened, else against
        N(0, Kuu) (``Kuu`` computed when not given)."""
        q_sqrt = self._tril_q_sqrt()
        if self.whiten:
            return gauss.gauss_kl(self.q_mu, q_sqrt)
        if Kuu is None:
            Kuu = self.inducing.Kuu(self.kernel, None)
        return gauss.gauss_kl(self.q_mu, q_sqrt, K=Kuu)

    @precise_linalg()
    def elbo(self, X, Y, num_data=None, generator=None):
        """Evidence lower bound on a (mini)batch; ``num_data`` is the total
        dataset size for minibatch scaling (default: the batch size),
        ``generator`` the ``torch.Generator`` a Monte-Carlo likelihood
        draws from."""
        q_sqrt = self._tril_q_sqrt()
        if self._kuu_identity:
            Knn = self.kernel.Kdiag(X)
            Kuf = self.inducing.Kuf(self.kernel, X)
            fmean, fvar = self._identity_conditional(Kuf, Knn)
            kl = gauss.gauss_kl(self.q_mu, q_sqrt)
            return self._scaled_elbo(Y, fmean, fvar, kl, num_data, generator)
        if hasattr(self.inducing, "covariances_full"):
            # a joint (Kuu, Kuf, Knn) batch covariance: the joint-PSD
            # guarantee for finite-difference kernels
            # (InducingSequences.covariances_full)
            Kuu, Kuf, Knn = self.inducing.covariances_full(self.kernel, X,
                                                           None)
        else:
            Knn = self.kernel.Kdiag(X)
            Kuu, Kuf = self._covariances(X)
        L = gauss.stable_cholesky(Kuu)
        fmean, fvar = gauss.conditional(Kuf, Kuu, Knn, self.q_mu, q_sqrt,
                                        white=self.whiten, Kmm_chol=L)
        if self.whiten:
            kl = gauss.gauss_kl(self.q_mu, q_sqrt)
        else:
            kl = gauss.gauss_kl(self.q_mu, q_sqrt, K_chol=L)
        return self._scaled_elbo(Y, fmean, fvar, kl, num_data, generator)

    def _scaled_elbo(self, Y, fmean, fvar, kl, num_data, generator):
        var_exp = self.likelihood.variational_expectations(
            Y, fmean, fvar, generator=generator)
        batch = fmean.shape[0]
        total = batch if num_data is None else num_data
        return (total / batch) * torch.sum(var_exp) - kl

    def forward(self, X, Y, num_data=None, generator=None):
        """The ELBO (so that ``torch.func.functional_call`` reaches it)."""
        return self.elbo(X, Y, num_data, generator)

    def elbo_at(self, q_mu, q_sqrt, X, Y, num_data=None, generator=None):
        """The ELBO with (q_mu, q_sqrt) in place of the model's own, without
        copying the model (the counterpart of ``model.replace(q_mu=…,
        q_sqrt=…).elbo(…)``); gradients flow to the given tensors."""
        return torch.func.functional_call(
            self, {"q_mu": q_mu, "q_sqrt": q_sqrt}, (X, Y),
            {"num_data": num_data, "generator": generator})

    def predict_y(self, X, **kw):
        """Predictive class probabilities or means and variances; ``kw``
        goes to the likelihood (``generator``, ``num_samples`` for the
        Monte-Carlo Softmax)."""
        m, v = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(m, v, **kw)

    def predict_log_density(self, X, Y, **kw):
        m, v = self.predict_f(X)
        return self.likelihood.predict_log_density(Y, m, v, **kw)

    @precise_linalg()
    def posterior(self):
        """Fold everything batch-independent into cached projections:

            mean  = Kufᵀ a,           a   = L⁻ᵀ q_mu (white), Kuu⁻¹ q_mu
            var_c = Knn − kufᵀ Q_c kuf,
            Q_c   = L⁻ᵀ (I − S_c S_cᵀ) L⁻¹  (white),
                    Kuu⁻¹ − Kuu⁻¹ S_c S_cᵀ Kuu⁻¹  (unwhitened)

        so a prediction batch costs one Kuf build and C matrix products.
        Under Kuu = I with a diagonal q, Q_c is diagonal (1 − s_c²) and is
        kept as [M, C] (``quad_is_diag``): O(M) a point."""
        q_sqrt = self._tril_q_sqrt()
        if self._kuu_identity:
            if self.q_diag:
                return Posterior(self.kernel, self.likelihood, self.inducing,
                                 self.q_mu, 1.0 - q_sqrt**2,
                                 quad_is_diag=True)
            M = self.q_mu.shape[0]
            eye = torch.eye(M, dtype=self.q_mu.dtype, device=self.q_mu.device)
            quad = eye[None] - torch.einsum("cmk,cnk->cmn", q_sqrt, q_sqrt)
            return Posterior(self.kernel, self.likelihood, self.inducing,
                             self.q_mu, quad)
        Kuu = self.inducing.Kuu(self.kernel, None)
        L = gauss.stable_cholesky(Kuu)
        M = L.shape[0]
        eye = torch.eye(M, dtype=L.dtype, device=L.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        if self.q_diag:
            SSt = torch.einsum("mc,mn->cmn", q_sqrt**2, eye)
        else:
            SSt = torch.einsum("cmk,cnk->cmn", q_sqrt, q_sqrt)
        if self.whiten:
            proj_mean = Linv.T @ self.q_mu
            quad = torch.einsum("nm,cnk,kp->cmp", Linv, eye[None] - SSt, Linv)
        else:
            Kinv = Linv.T @ Linv
            proj_mean = Kinv @ self.q_mu
            quad = Kinv[None] - torch.einsum("mn,cnk,kp->cmp", Kinv, SSt,
                                             Kinv)
        return Posterior(self.kernel, self.likelihood, self.inducing,
                         proj_mean, quad)


class Posterior:
    """Batch-independent SVGP posterior projections (see
    :meth:`SVGP.posterior`)."""

    def __init__(self, kernel, likelihood, inducing, proj_mean, quad,
                 quad_is_diag=False):
        self.kernel = kernel
        self.likelihood = likelihood
        self.inducing = inducing
        self.proj_mean = proj_mean  # [M, C]
        self.quad = quad  # [C, M, M], or [M, C] diagonal (VOSF, diagonal q)
        self.quad_is_diag = quad_is_diag

    @precise_linalg()
    def predict_f(self, X, full_cov=False):
        Kuf = self.inducing.Kuf(self.kernel, X)  # [M, N]
        mean = Kuf.T @ self.proj_mean  # [N, C]
        if full_cov:
            if self.quad_is_diag:
                red = torch.einsum("mn,mc,mk->cnk", Kuf, self.quad, Kuf)
            else:
                red = torch.einsum("mn,cmp,pk->cnk", Kuf, self.quad, Kuf)
            return mean, self.kernel.K(X)[None] - red
        Knn = self.kernel.Kdiag(X)
        if self.quad_is_diag:
            red = torch.einsum("mn,mc->cn", Kuf**2, self.quad)
        else:
            QK = torch.einsum("cmp,pn->cmn", self.quad, Kuf)
            red = torch.sum(Kuf[None] * QK, dim=1)  # [C, N]
        var = gauss.floor_marginal_variance(Knn[None, :] - red, scale=Knn)
        return mean, var.T

    def predict_y(self, X, **kw):
        m, v = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(m, v, **kw)

    def predict_log_density(self, X, Y, **kw):
        m, v = self.predict_f(X)
        return self.likelihood.predict_log_density(Y, m, v, **kw)
