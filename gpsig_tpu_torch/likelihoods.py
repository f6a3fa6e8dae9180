"""Likelihoods with variational expectations (GPflow-1.x parity surface).

Counterpart of ``gpsig_tpu/likelihoods.py``: Gaussian (closed form),
Bernoulli (probit) and MultiClass (RobustMax), the last two by 30-point
Gauss–Hermite quadrature, and the Monte-Carlo Softmax. Every
``variational_expectations`` takes marginal means/variances [N, C] and a
``generator`` (a ``torch.Generator``, where the JAX package takes a PRNG
key; only a likelihood with ``needs_generator``, the Softmax, draws from
it) and returns per-datapoint expectations [N].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from gpsig_tpu_torch import config
from gpsig_tpu_torch import params as pr

_GH_POINTS = 30


def _gh(like):
    """Gauss–Hermite nodes and weights in ``like``'s dtype and device."""
    x, w = np.polynomial.hermite.hermgauss(_GH_POINTS)
    kw = dict(dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, **kw), torch.as_tensor(w, **kw)


def _normal_cdf(x):
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


class Gaussian(nn.Module):
    """y = f + ε, ε ~ N(0, σ²)."""

    def __init__(self, raw_variance):
        super().__init__()
        self.raw_variance = nn.Parameter(raw_variance)

    @classmethod
    def create(cls, variance=1.0, dtype=torch.float64, device=None):
        return cls(pr.inv_positive(torch.as_tensor(
            variance, dtype=dtype, device=config.resolve_device(device))))

    @property
    def variance(self):
        return pr.positive(self.raw_variance)

    def variational_expectations(self, Y, Fmu, Fvar, generator=None):
        s2 = self.variance
        out = (-0.5 * torch.log(2.0 * math.pi * s2)
               - 0.5 * ((Y - Fmu) ** 2 + Fvar) / s2)
        return torch.sum(out, dim=-1)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance

    def predict_log_density(self, Y, Fmu, Fvar):
        s2 = self.variance + Fvar
        out = -0.5 * torch.log(2.0 * math.pi * s2) - 0.5 * (Y - Fmu) ** 2 / s2
        return torch.sum(out, dim=-1)


class Bernoulli(nn.Module):
    """p(y=1|f) = Φ(f) (probit link), y ∈ {0, 1}."""

    def variational_expectations(self, Y, Fmu, Fvar, generator=None):
        x, w = _gh(Fmu)
        f = Fmu[..., None] + torch.sqrt(2.0 * Fvar[..., None]) * x
        sign = 2.0 * Y[..., None] - 1.0
        logp = torch.log(torch.clamp(_normal_cdf(sign * f), 1e-12, 1.0))
        out = torch.sum(logp * w, dim=-1) / math.sqrt(math.pi)
        return torch.sum(out, dim=-1)

    def predict_mean_and_var(self, Fmu, Fvar):
        p = _normal_cdf(Fmu / torch.sqrt(1.0 + Fvar))
        return p, p - p**2

    def predict_log_density(self, Y, Fmu, Fvar):
        p = _normal_cdf(Fmu / torch.sqrt(1.0 + Fvar))
        out = torch.where(Y > 0.5, torch.log(p + 1e-12),
                          torch.log(1 - p + 1e-12))
        return torch.sum(out, dim=-1)


class MultiClass(nn.Module):
    """RobustMax multiclass: p(y=c | f) = 1-ε if c = argmax f, else
    ε/(C-1). The variational expectation needs P(f_y = max f), by 1-D
    Gauss–Hermite quadrature over f_y (GPflow's ``prob_is_largest``)."""

    def __init__(self, num_classes, epsilon=1e-3):
        super().__init__()
        self.num_classes = num_classes
        self.epsilon = epsilon

    def _prob_is_largest(self, Y, Fmu, Fvar):
        x, w = _gh(Fmu)
        y = Y.reshape(-1).to(device=Fmu.device, dtype=torch.int64)
        mu_y = torch.gather(Fmu, -1, y[:, None])  # [N, 1]
        var_y = torch.gather(Fvar, -1, y[:, None])
        f = mu_y + torch.sqrt(2.0 * var_y) * x[None, :]  # [N, Q]
        # Π_{j≠y} Φ((f - μ_j)/σ_j)
        z = (f[:, None, :] - Fmu[:, :, None]) / torch.sqrt(
            torch.clamp(Fvar, min=1e-30))[:, :, None]  # [N, C, Q]
        mask = nn.functional.one_hot(y, self.num_classes).to(Fmu.dtype)
        cdfs = _normal_cdf(z) * (1 - mask[:, :, None]) + mask[:, :, None]
        prod = torch.prod(cdfs, dim=1)  # [N, Q]
        return torch.sum(prod * w[None, :], dim=-1) / math.sqrt(math.pi)

    def variational_expectations(self, Y, Fmu, Fvar, generator=None):
        p = self._prob_is_largest(Y, Fmu, Fvar)
        C = self.num_classes
        return (p * math.log(1.0 - self.epsilon)
                + (1.0 - p) * math.log(self.epsilon / (C - 1)))

    def predict_mean_and_var(self, Fmu, Fvar):
        C = self.num_classes
        N = Fmu.shape[0]
        p = torch.stack([
            self._prob_is_largest(
                torch.full((N,), c, dtype=torch.int64, device=Fmu.device),
                Fmu, Fvar)
            for c in range(C)
        ], dim=-1)
        p = p / torch.sum(p, dim=-1, keepdim=True)
        p = p * (1.0 - self.epsilon) + (1.0 - p) * self.epsilon / (C - 1)
        return p, p - p**2

    def predict_log_density(self, Y, Fmu, Fvar):
        p, _ = self.predict_mean_and_var(Fmu, Fvar)
        y = Y.reshape(-1).to(device=Fmu.device, dtype=torch.int64)
        return torch.log(torch.gather(p, -1, y[:, None])[:, 0] + 1e-12)


def _labels(Y, like):
    return Y.reshape(-1).to(device=like.device, dtype=torch.int64)


class Softmax(nn.Module):
    """p(y=c|f) = softmax(f)_c, with Monte-Carlo expectations by the
    reparameterisation f = Fmu + √Fvar·ε, ε ~ N(0, I).

    A draw (:meth:`draw`) and the function of (Fmu, Fvar, ε) are separate
    steps, so that any ε can be fed in (:meth:`expected_log_prob`,
    :meth:`moments`). Draws come from the ``generator`` passed, made on its
    device and moved to Fmu's (the default generator on Fmu's device when
    it is None). They are not the JAX package's draws: ``jax.random`` and
    ``torch.Generator`` are different generators. Where JAX's
    ``predict_mean_and_var`` defaults to ``PRNGKey(0)``, the port defaults
    to a generator seeded 0 on Fmu's device: equally deterministic, with
    other values."""

    needs_generator = True

    def __init__(self, num_classes, num_samples=20):
        super().__init__()
        self.num_classes = num_classes
        self.num_samples = num_samples

    @staticmethod
    def draw(num_samples, Fmu, generator=None):
        """ε ~ N(0, I) of shape [num_samples, *Fmu.shape], in Fmu's dtype
        and on its device."""
        device = Fmu.device if generator is None else generator.device
        eps = torch.randn((num_samples,) + tuple(Fmu.shape),
                          generator=generator, dtype=Fmu.dtype, device=device)
        return eps.to(Fmu.device)

    @staticmethod
    def _samples(Fmu, Fvar, eps):
        return Fmu[None] + torch.sqrt(torch.clamp(Fvar, min=1e-30))[None] * eps

    def expected_log_prob(self, Y, Fmu, Fvar, eps):
        """E[log softmax(f)_y] over the draws ε [S, N, C]: [N]."""
        logp = torch.log_softmax(self._samples(Fmu, Fvar, eps), dim=-1)
        y = _labels(Y, Fmu)
        picked = torch.gather(
            logp, -1, y[None, :, None].expand(logp.shape[0], -1, 1))[..., 0]
        return torch.mean(picked, dim=0)

    def moments(self, Fmu, Fvar, eps):
        """Mean and variance of softmax(f) over the draws ε: [N, C] each."""
        p = torch.softmax(self._samples(Fmu, Fvar, eps), dim=-1)
        pm = torch.mean(p, dim=0)
        return pm, torch.mean(p**2, dim=0) - pm**2

    def variational_expectations(self, Y, Fmu, Fvar, generator=None):
        eps = self.draw(self.num_samples, Fmu, generator)
        return self.expected_log_prob(Y, Fmu, Fvar, eps)

    def predict_mean_and_var(self, Fmu, Fvar, generator=None,
                             num_samples=100):
        if generator is None:
            generator = torch.Generator(device=Fmu.device).manual_seed(0)
        return self.moments(Fmu, Fvar, self.draw(num_samples, Fmu, generator))

    def predict_log_density(self, Y, Fmu, Fvar, generator=None,
                            num_samples=100):
        p, _ = self.predict_mean_and_var(Fmu, Fvar, generator, num_samples)
        y = _labels(Y, Fmu)
        return torch.log(torch.gather(p, -1, y[:, None])[:, 0] + 1e-12)
