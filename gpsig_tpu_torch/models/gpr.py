"""Exact GP regression (the conjugate baseline).

Counterpart of ``gpsig_tpu/models/gpr.py`` (GPflow's ``GPR``).

A chain axis: where the kernel's hyperparameters carry one (see
``kernels/signature.py``) and the likelihood's ``raw_variance`` is [C],
``log_marginal_likelihood`` returns [C], one value a chain, from one
batch of Grams [C, N, N] and Cholesky factors; a chain whose matrix no
jitter factors gets NaN and leaves the others unchanged
(``gauss.stable_cholesky``). This is how a sampler's chains evaluate the
model as one batch (``mcmc/``, BASELINE config 5).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gpsig_tpu_torch import config, gauss
from gpsig_tpu_torch import params as pr
from gpsig_tpu_torch.config import default_jitter, precise_linalg
from gpsig_tpu_torch.likelihoods import Gaussian


class GPR(nn.Module):
    def __init__(self, kernel, likelihood):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood

    @classmethod
    def create(cls, kernel, noise_variance=1.0, dtype=torch.float64,
               device=None):
        return cls(kernel, Gaussian.create(noise_variance, dtype,
                                           config.resolve_device(device)))

    def _chol(self, X):
        K = self.kernel.K(X)
        N = K.shape[-1]
        noise = self.likelihood.variance + default_jitter(K.dtype)
        eye = torch.eye(N, dtype=K.dtype, device=K.device)
        return gauss.stable_cholesky(K + noise[..., None, None] * eye)

    @precise_linalg()
    def log_marginal_likelihood(self, X, Y):
        """log N(Y | 0, K + σ²I), summed over output columns; [C] with a
        chain axis on the hyperparameters."""
        L = self._chol(X)
        N = L.shape[-1]
        Y = Y.reshape(N, -1)
        C = Y.shape[1]
        alpha = torch.linalg.solve_triangular(L, Y.expand(L.shape[:-2]
                                                          + Y.shape),
                                              upper=False)
        return (-0.5 * torch.sum(alpha**2, dim=(-2, -1))
                - C * torch.sum(torch.log(torch.diagonal(L, dim1=-2,
                                                         dim2=-1)), dim=-1)
                - 0.5 * N * C * math.log(2.0 * math.pi))

    @precise_linalg()
    def predict_f(self, X, Y, Xnew, full_cov=False):
        pr.refuse_chains(self.likelihood, "predict_f")
        pr.refuse_chains(self.kernel, "predict_f")
        L = self._chol(X)
        N = L.shape[0]
        A = torch.linalg.solve_triangular(L, self.kernel.K(X, Xnew),
                                          upper=False)  # [N, N*]
        V = torch.linalg.solve_triangular(L, Y.reshape(N, -1), upper=False)
        mean = A.T @ V
        if full_cov:
            return mean, self.kernel.K(Xnew) - A.T @ A
        var = self.kernel.Kdiag(Xnew) - torch.sum(A**2, dim=0)
        return mean, var[:, None] * torch.ones_like(mean)

    def predict_y(self, X, Y, Xnew):
        m, v = self.predict_f(X, Y, Xnew)
        return self.likelihood.predict_mean_and_var(m, v)
