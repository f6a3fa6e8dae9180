"""Low-rank signature kernel: explicit feature maps, O(N·L·c) Grams.

Counterpart of ``gpsig_tpu/kernels/low_rank.py`` (the reference's
``low_rank=True`` signature kernel with ``num_components``, ``rank_bound``
and ``sparsity``): K ≈ Σ_m σσ_m F_m(X) F_m(Y)ᵀ with the per-level features
of ``ops/low_rank.py``.

State, named as the JAX fields: the parameters ``raw_sigma``,
``raw_variances``, ``raw_lengthscales`` (absent when None) and
``landmarks``, which the JAX package's training loop differentiates and
Adam updates like any float leaf, so here they are an ``nn.Parameter``;
and the sketch's integer index sets, buffers under ``pair_indices.<k>``
(k = level − 2, the JAX tuple's index), absent for a level kept exact.
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch import config
from gpsig_tpu_torch import params as pr
from gpsig_tpu_torch.kernels import static_kernels as sk
from gpsig_tpu_torch.ops import low_rank as lr


class PairIndices(nn.Module):
    """The sketch's [2, r] index sets for levels 2..num_levels as integer
    buffers ``"0"``, ``"1"``, …; a level without a sketch has none."""

    def __init__(self, pair_indices):
        super().__init__()
        self.num = len(pair_indices)
        for k, idx in enumerate(pair_indices):
            self.register_buffer(str(k), idx)

    def __getitem__(self, k):
        return self._buffers[str(k)]

    def as_tuple(self):
        return tuple(self[k] for k in range(self.num))


class LowRankSignatureKernel(nn.Module):
    def __init__(self, base, raw_sigma, raw_variances, raw_lengthscales,
                 landmarks, pair_indices, num_features, num_levels,
                 num_components, normalization=True, difference=True):
        super().__init__()
        self.base = base
        self.raw_sigma = nn.Parameter(raw_sigma)
        self.raw_variances = nn.Parameter(raw_variances)  # [num_levels+1]
        self.register_parameter(
            "raw_lengthscales",
            None if raw_lengthscales is None else nn.Parameter(
                raw_lengthscales))
        self.landmarks = nn.Parameter(landmarks)  # [n_landmarks, d]
        #: None: every level's product exact
        self.pair_indices = (None if pair_indices is None
                             else PairIndices(pair_indices))
        self.num_features = num_features
        self.num_levels = num_levels
        self.num_components = num_components
        self.normalization = normalization
        self.difference = difference

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
    def level_variances(self):
        return self.sigma * self.variances

    def _as_sequences(self, X):
        if X.ndim == 2:
            N, Ld = X.shape
            return X.reshape(N, Ld // self.num_features, self.num_features)
        return X

    def feature_levels(self, X):
        """Per-level sequence features, a list of [N, c_m] for m = 1..nl
        (each normalised when ``normalization``)."""
        pr.refuse_chains(self, "feature_levels")
        Xs = self._as_sequences(X)
        ell = self.lengthscales
        Zl = self.landmarks
        if ell is not None:
            Xs, Zl = Xs / ell, Zl / ell
        phi = lr.nystrom_map(Xs, Zl, self.base, self.num_components)
        dphi = torch.diff(phi, dim=-2) if self.difference else phi
        idx = (None if self.pair_indices is None
               else self.pair_indices.as_tuple())
        feats = lr.signature_features(dphi, self.num_levels, idx)
        if self.normalization:
            feats = [f / torch.sqrt(torch.clamp(
                torch.sum(f * f, -1, keepdim=True), min=1e-30))
                for f in feats]
        return feats

    def feature(self, X):
        """Stacked weighted features Φ(X): [N, 1 + Σ c_m], with
        K(X, Y) = Φ(X) Φ(Y)ᵀ exactly (constant level included)."""
        feats = self.feature_levels(X)
        w = torch.sqrt(self.level_variances)
        N = feats[0].shape[0]
        cols = [w[0].expand(N, 1)]
        for m, f in enumerate(feats, start=1):
            cols.append(w[m] * f)
        return torch.cat(cols, dim=-1)

    def K(self, X, X2=None):
        F1 = self.feature(X)
        F2 = F1 if X2 is None else self.feature(X2)
        return F1 @ F2.T

    def Kdiag(self, X):
        F = self.feature(X)
        return torch.sum(F * F, dim=-1)


def LowRankSignatureRBF(generator, X_example, num_features, num_levels,
                        num_components=64, rank_bound=None, sparsity="sqrt",
                        n_landmarks=None, lengthscales=1.0, sigma=1.0,
                        variances=None, normalization=True, difference=True,
                        dtype=torch.float64, device=None):
    """A low-rank RBF signature kernel with landmarks drawn from the data.

    ``generator`` (a ``torch.Generator``, or None for the default one)
    draws the landmarks, ``n_landmarks`` distinct steps of ``X_example``
    (default min(2·num_components, steps)), without replacement by
    ``torch.randperm``, then each sketched level's pairs. These are not the
    JAX package's draws (``jax.random.choice`` and ``randint`` under a
    PRNG key); ``convert`` carries a JAX kernel's landmarks and pairs
    across. ``sparsity='sqrt'`` (the reference default) makes rank_bound
    default to ``num_components``, so each level keeps c of its c² pair
    columns; a level whose full product has at most rank_bound columns
    stays exact."""
    device = config.resolve_device(device)
    X = X_example
    if X.ndim == 2:
        X = X.reshape(X.shape[0], -1, num_features)
    steps = X.reshape(-1, num_features)
    n_landmarks = n_landmarks or min(2 * num_components, steps.shape[0])
    gen_device = "cpu" if generator is None else generator.device
    sel = torch.randperm(steps.shape[0], generator=generator,
                         device=gen_device)[:n_landmarks]
    landmarks = steps[sel.to(steps.device)].to(dtype=dtype, device=device)
    if rank_bound is None:
        rank_bound = (num_components if sparsity == "sqrt"
                      else num_components**2)
    pair_indices = []
    c_prev = num_components
    for _ in range(2, num_levels + 1):
        full = c_prev * num_components
        if rank_bound < full:
            pair_indices.append(lr.draw_pair_indices(
                generator, num_components, c_prev, rank_bound, device))
            c_prev = rank_bound
        else:
            pair_indices.append(None)
            c_prev = full
    kw = dict(dtype=dtype, device=device)
    nl1 = num_levels + 1
    variances = (torch.ones((nl1,), **kw) if variances is None
                 else torch.broadcast_to(torch.as_tensor(variances, **kw),
                                         (nl1,)))
    ell = torch.broadcast_to(torch.as_tensor(lengthscales, **kw),
                             (num_features,))
    return LowRankSignatureKernel(
        sk.RBFBase(), pr.inv_positive(torch.as_tensor(sigma, **kw)),
        pr.inv_positive(variances).clone(), pr.inv_positive(ell).clone(),
        landmarks.detach().clone(), pair_indices, num_features, num_levels,
        num_components, normalization, difference)
