"""Posterior targets for the sampler: log densities over θ [C, D].

:func:`signature_gpr_logp` is BASELINE config 5's target
(``benchmarks/config5_nuts.py``): full-Bayes GP regression over the
hyperparameters of an order-1 ``SignatureRBF`` with normalisation,
θ = (log-lengthscales [d], log level variances [nl+1], log noise
variance), log p(θ | y) = log N(y | 0, K_θ + σ²I) + log N(θ | 0, 2² I) up to
a constant. The model is built once; each call puts the C chains'
hyperparameters into it with ``params.substituted`` as [C, ...] tensors,
so the Gram, its diagonal and the Gram's backward launch once for all C
chains (``kernels/signature.py``'s chain axis).
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch import params as pr
from gpsig_tpu_torch.kernels.signature import SignatureRBF
from gpsig_tpu_torch.models.gpr import GPR


def signature_gpr_logp(X, Y, num_levels):
    """θ [C, d + num_levels + 2] → log p(θ | Y) [C] for sequences X [N, L,
    d] and targets Y [N] or [N, 1] (on X's device, in X's dtype)."""
    d = X.shape[-1]
    kw = dict(dtype=X.dtype, device=X.device)
    model = GPR.create(SignatureRBF(d, num_levels, lengthscales=1.0,
                                    order=1, normalization=True, **kw),
                       noise_variance=1.0, **kw)

    def logp(theta):
        ell = torch.exp(theta[:, :d])
        var = torch.exp(theta[:, d:d + num_levels + 1])
        noise = torch.exp(theta[:, -1])
        with pr.substituted(model, {
                "kernel.raw_lengthscales": pr.inv_positive(ell),
                "kernel.raw_variances": pr.inv_positive(var),
                "likelihood.raw_variance": pr.inv_positive(noise)}):
            lml = model.log_marginal_likelihood(X, Y)
        prior = -0.5 * torch.sum(theta**2, dim=-1) / 4.0  # N(0, 2²)
        return lml + prior

    return logp
