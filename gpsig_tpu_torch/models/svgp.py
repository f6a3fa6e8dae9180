"""Sparse variational GP (SVGP) with whitened parameterisation, forward.

Counterpart of ``gpsig_tpu/models/svgp.py``:
ELBO = (N/B) Σ_batch E_q[log p(y_i | f_i)] − KL[q(u) ‖ p(u)], prediction,
and the cached :class:`Posterior`. Training (natural gradients + Adam) is
``gpsig_tpu_torch.training``; the Kuu = I (VOSF) fast path is ROADMAP
Queue 1 item 13.
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch import config, gauss
from gpsig_tpu_torch.config import precise_linalg

_IDENTITY = ("Kuu = I inducing features (VOSF) are not ported yet: ROADMAP "
             "Queue 1 item 13")


class SVGP(nn.Module):
    def __init__(self, kernel, likelihood, inducing, q_mu, q_sqrt,
                 whiten=True, q_diag=False):
        super().__init__()
        if getattr(inducing, "kuu_is_identity", False):
            raise NotImplementedError(_IDENTITY)
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

    @precise_linalg()
    def predict_f(self, X, full_cov=False):
        Kuu, Kuf = self._covariances(X)
        Knn = self.kernel.K(X) if full_cov else self.kernel.Kdiag(X)
        return gauss.conditional(Kuf, Kuu, Knn, self.q_mu,
                                 self._tril_q_sqrt(), white=self.whiten,
                                 full_cov=full_cov)

    @precise_linalg()
    def elbo(self, X, Y, num_data=None):
        """Evidence lower bound on a (mini)batch; ``num_data`` is the total
        dataset size for minibatch scaling (default: the batch size)."""
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
        q_sqrt = self._tril_q_sqrt()
        fmean, fvar = gauss.conditional(Kuf, Kuu, Knn, self.q_mu, q_sqrt,
                                        white=self.whiten, Kmm_chol=L)
        if self.whiten:
            kl = gauss.gauss_kl(self.q_mu, q_sqrt)
        else:
            kl = gauss.gauss_kl(self.q_mu, q_sqrt, K_chol=L)
        var_exp = self.likelihood.variational_expectations(Y, fmean, fvar)
        batch = fmean.shape[0]
        total = batch if num_data is None else num_data
        return (total / batch) * torch.sum(var_exp) - kl

    def forward(self, X, Y, num_data=None):
        """The ELBO (so that ``torch.func.functional_call`` reaches it)."""
        return self.elbo(X, Y, num_data)

    def elbo_at(self, q_mu, q_sqrt, X, Y, num_data=None):
        """The ELBO with (q_mu, q_sqrt) in place of the model's own, without
        copying the model (the counterpart of ``model.replace(q_mu=…,
        q_sqrt=…).elbo(…)``); gradients flow to the given tensors."""
        return torch.func.functional_call(
            self, {"q_mu": q_mu, "q_sqrt": q_sqrt}, (X, Y),
            {"num_data": num_data})

    def predict_y(self, X):
        m, v = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(m, v)

    def predict_log_density(self, X, Y):
        m, v = self.predict_f(X)
        return self.likelihood.predict_log_density(Y, m, v)

    @precise_linalg()
    def posterior(self):
        """Fold everything batch-independent into cached projections:

            mean  = Kufᵀ a,           a   = L⁻ᵀ q_mu (white), Kuu⁻¹ q_mu
            var_c = Knn − kufᵀ Q_c kuf,
            Q_c   = L⁻ᵀ (I − S_c S_cᵀ) L⁻¹  (white),
                    Kuu⁻¹ − Kuu⁻¹ S_c S_cᵀ Kuu⁻¹  (unwhitened)

        so a prediction batch costs one Kuf build and C matrix products."""
        q_sqrt = self._tril_q_sqrt()
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

    def __init__(self, kernel, likelihood, inducing, proj_mean, quad):
        self.kernel = kernel
        self.likelihood = likelihood
        self.inducing = inducing
        self.proj_mean = proj_mean  # [M, C]
        self.quad = quad  # [C, M, M]

    @precise_linalg()
    def predict_f(self, X, full_cov=False):
        Kuf = self.inducing.Kuf(self.kernel, X)  # [M, N]
        mean = Kuf.T @ self.proj_mean  # [N, C]
        if full_cov:
            red = torch.einsum("mn,cmp,pk->cnk", Kuf, self.quad, Kuf)
            return mean, self.kernel.K(X)[None] - red
        Knn = self.kernel.Kdiag(X)
        QK = torch.einsum("cmp,pn->cmn", self.quad, Kuf)
        red = torch.sum(Kuf[None] * QK, dim=1)  # [C, N]
        var = gauss.floor_marginal_variance(Knn[None, :] - red, scale=Knn)
        return mean, var.T

    def predict_y(self, X):
        m, v = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(m, v)

    def predict_log_density(self, X, Y):
        m, v = self.predict_f(X)
        return self.likelihood.predict_log_density(Y, m, v)
