"""Explicit-signature feature kernel and orthogonal inducing features
(VOSF: variational orthogonal signature features, ``Kuu = I``).

Counterpart of ``gpsig_tpu/kernels/vosf.py``. The prior is
f(x) = Σ_I w_I ψ_I(x), w ~ N(0, I), where ψ stacks the level-m signature
coordinates scaled by √(σ·σ_m) (each level optionally normalised). Then
k(x, y) = Ψ(x)ᵀΨ(y) is the truncated signature kernel with a linear lift,
u_I = w_I gives exactly Kuu = I and Kuf = Ψ(X)ᵀ, and a diagonal q is the
natural variational family: the KL and the natural-gradient step cost O(M).

Parameters are the unconstrained leaves, named as the JAX fields:
``raw_sigma``, ``raw_variances`` and ``raw_lengthscales`` (absent when
``lengthscales=None``). The JAX package has no Pallas kernel on this path;
the explicit signature (``ops/explicit.py``) is plain PyTorch on both
devices.
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch import config
from gpsig_tpu_torch import params as pr
from gpsig_tpu_torch.ops import explicit as ex


class ExplicitSignatureKernel(nn.Module):
    """Truncated signature kernel by explicit coordinates (linear lift)."""

    def __init__(self, raw_sigma, raw_variances, raw_lengthscales,
                 num_features, num_levels, normalization=True):
        super().__init__()
        self.raw_sigma = nn.Parameter(raw_sigma)
        self.raw_variances = nn.Parameter(raw_variances)  # [num_levels+1]
        self.register_parameter(
            "raw_lengthscales",
            None if raw_lengthscales is None else nn.Parameter(
                raw_lengthscales))
        self.num_features = num_features
        self.num_levels = num_levels
        self.normalization = normalization

    @classmethod
    def create(cls, num_features, num_levels, lengthscales=1.0, sigma=1.0,
               variances=None, normalization=True, dtype=torch.float64,
               device=None):
        kw = dict(dtype=dtype, device=config.resolve_device(device))
        nl1 = num_levels + 1
        variances = (torch.ones((nl1,), **kw) if variances is None
                     else torch.broadcast_to(torch.as_tensor(variances, **kw),
                                             (nl1,)))
        raw_ell = None
        if lengthscales is not None:
            ell = torch.broadcast_to(torch.as_tensor(lengthscales, **kw),
                                     (num_features,))
            raw_ell = pr.inv_positive(ell).clone()
        return cls(pr.inv_positive(torch.as_tensor(sigma, **kw)),
                   pr.inv_positive(variances).clone(), raw_ell, num_features,
                   num_levels, normalization)

    @property
    def sigma(self):
        return pr.positive(self.raw_sigma)

    @property
    def variances(self):
        return pr.positive(self.raw_variances)

    @property
    def lengthscales(self):
        if self.raw_lengthscales is None:
            return None
        return pr.positive(self.raw_lengthscales)

    @property
    def num_features_total(self):
        return ex.signature_dim(self.num_features, self.num_levels)

    def _as_sequences(self, X):
        if X.ndim == 2:
            N, Ld = X.shape
            return X.reshape(N, Ld // self.num_features, self.num_features)
        return X

    def feature(self, X):
        """Ψ(X): [N, 1 + Σ_m d^m]; k(x, y) = ⟨Ψ(x), Ψ(y)⟩."""
        pr.refuse_chains(self, "feature")
        Xs = self._as_sequences(X)
        ell = self.lengthscales
        if ell is not None:
            Xs = Xs / ell
        levels = ex.truncated_signature(Xs, self.num_levels)
        if self.normalization:
            levels = [f / torch.sqrt(torch.clamp(
                torch.sum(f * f, -1, keepdim=True), min=1e-30))
                for f in levels]
        w = torch.sqrt(self.sigma * self.variances)
        N = Xs.shape[0]
        cols = [w[0].expand(N, 1)]
        for m, f in enumerate(levels, start=1):
            cols.append(w[m] * f)
        return torch.cat(cols, dim=-1)

    def K(self, X, X2=None):
        F1 = self.feature(X)
        F2 = F1 if X2 is None else self.feature(X2)
        return F1 @ F2.T

    def Kdiag(self, X):
        F = self.feature(X)
        return torch.sum(F * F, dim=-1)


class OrthogonalSignatureFeatures(nn.Module):
    """VOSF inducing family: Kuu = I exactly, Kuf = Ψ(X)ᵀ.

    Use with ``SVGP(..., q_diag=True)``: whitened and unwhitened coincide,
    the KL is a diagonal Gaussian's against N(0, I) and the natural-gradient
    step is elementwise. Two priors (``for_kernel`` chooses by the kernel):

    * :class:`ExplicitSignatureKernel`: the prior is k = ΨᵀΨ itself, so the
      conditional's ``Knn − Σ Kuf²`` cancels exactly (rounding noise around
      zero, floored);
    * :class:`~gpsig_tpu_torch.kernels.pde.UntruncatedSignatureKernel` (the
      SigGPDE model): the prior is the untruncated PDE kernel, ``Kuf`` the
      first ``feature_levels`` levels of its Mercer expansion, and the gap
      ``Knn − Σ Kuf² ≥ 0`` is prior variance outside the inducing span.

    It holds no parameters.
    """

    kuu_is_identity = True

    def __init__(self, num_inducing, feature_levels=None):
        super().__init__()
        self.num_inducing = num_inducing
        #: truncation level of the features under the untruncated prior;
        #: None: the kernel computes its own (ExplicitSignatureKernel)
        self.feature_levels = feature_levels

    @classmethod
    def for_kernel(cls, kernel, num_levels=None):
        """Features for ``kernel``. Under the untruncated (PDE) kernel pass
        ``num_levels``, the truncation level of the inducing set
        (M = 1 + Σ_{m ≤ num_levels} d^m)."""
        if isinstance(kernel, ExplicitSignatureKernel):
            if num_levels is not None and num_levels != kernel.num_levels:
                raise ValueError(
                    "ExplicitSignatureKernel carries its own truncation "
                    f"level ({kernel.num_levels}); num_levels must be "
                    "omitted or equal")
            return cls(kernel.num_features_total)
        if num_levels is None:
            raise ValueError(
                "num_levels is required under the untruncated prior (it "
                "sets the inducing truncation level)")
        return cls(ex.signature_dim(kernel.num_features, num_levels),
                   num_levels)

    def Kuu(self, kernel, jitter=None):
        """The identity, in the kernel's dtype and on its device."""
        del jitter
        ref = kernel.raw_sigma
        return torch.eye(self.num_inducing, dtype=ref.dtype,
                         device=ref.device)

    def Kuf(self, kernel, X):
        if self.feature_levels is not None:
            return kernel.feature(X, self.feature_levels).T
        return kernel.feature(X).T
