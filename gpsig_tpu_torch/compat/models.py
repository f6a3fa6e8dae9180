"""GPSig-style data-holding models (reference: ``gpsig/models.py`` and
GPflow's ``models.SVGP``).

Counterpart of ``gpsig_tpu/compat/models.py``. The model owns its data and
its minibatches: ``SVGP(X, Y, kern, likelihood, feat=..., num_latent=C,
whiten=True, minibatch_size=B)``, with ``compute_log_likelihood()`` (the
minibatch ELBO), ``predict_f``, ``predict_y`` and ``predict_density``
returning numpy. The optimizers of ``compat.training`` train the wrapped
module in place.

- ``X`` and ``Y`` are put on the model's device once, in the kernel's
  dtype (integer labels stay integers); a minibatch indexes them there.
  Its indices come from ``np.random.default_rng(seed).choice(...,
  replace=False)``, the JAX facade's stream, so both see the same batches.
- A ``torch.Generator`` seeded ``seed`` on the model's device feeds a
  Monte-Carlo likelihood's draws, where the JAX facade splits
  ``PRNGKey(seed)``.
- The kernel, the features and the likelihood are the same module objects
  inside the core ``SVGP``: ``kern.lengthscales`` follows training.
- Predictions go through a cached ``Posterior``, rebuilt when any
  parameter has changed since it was made: the cache is keyed on the
  parameters and their in-place version counters, so a step taken on
  ``model.to_functional()`` directly invalidates it too (the JAX facade
  keys on the identity of its immutable model).
"""

from __future__ import annotations

import numpy as np
import torch

from gpsig_tpu_torch.models import svgp as core_svgp


def _numpy(t):
    return t.detach().cpu().numpy()


class SVGP:
    def __init__(
        self,
        X,
        Y,
        kern,
        likelihood,
        feat=None,
        num_latent=None,
        whiten=True,
        q_diag=False,
        minibatch_size=None,
        seed=0,
    ):
        if feat is None:
            raise ValueError("feat (inducing variables) is required")
        self._kern_wrapper = kern
        self._feat_wrapper = feat
        if getattr(kern, "_low_rank", False) and kern._kern is None:
            # Low-rank kernels build their Nyström landmarks from data: the
            # training set (the reference's fit-on-train semantics) rather
            # than whatever data touches the kernel first.
            kern._ensure_low_rank(kern._check(X))
        kfun = kern.to_functional() if hasattr(kern, "to_functional") else kern
        ffun = feat.to_functional() if hasattr(feat, "to_functional") else feat
        ref = next(kfun.parameters())
        self.X = torch.as_tensor(X, dtype=ref.dtype, device=ref.device)
        Y = torch.as_tensor(Y, device=ref.device)
        self.Y = Y.to(ref.dtype) if Y.is_floating_point() else Y
        self.num_data = self.X.shape[0]
        self.minibatch_size = minibatch_size
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator(device=ref.device).manual_seed(seed)
        if num_latent is None:
            C = getattr(likelihood, "num_classes", None)
            num_latent = C if C is not None else (
                self.Y.shape[1] if self.Y.ndim > 1 else 1
            )
        self._model = core_svgp.SVGP.create(
            kfun, likelihood, ffun, num_latent, whiten=whiten, q_diag=q_diag,
            dtype=ref.dtype, device=ref.device,
        )
        self._post_cache = None  # (key, Posterior): see _posterior

    # -- functional-core handoff -------------------------------------------
    def to_functional(self):
        return self._model

    def update_functional(self, model):
        self._model = model
        self._post_cache = None
        # keep the user's kernel and feature wrappers on the same modules
        if hasattr(self._kern_wrapper, "update_functional"):
            self._kern_wrapper.update_functional(model.kernel)
        if hasattr(self._feat_wrapper, "update_functional"):
            self._feat_wrapper.update_functional(model.inducing)

    def _cache_key(self):
        return [(p, p._version) for p in self._model.parameters()]

    def _posterior(self):
        """The cached :class:`~gpsig_tpu_torch.models.svgp.Posterior` (the
        reference wrapper's prediction-time caching of the Kuu factors),
        rebuilt when the model or any parameter's value has changed."""
        key = self._cache_key()
        cache = self._post_cache
        if cache is None or len(cache[0]) != len(key) or any(
            p is not q or v != w for (p, v), (q, w) in zip(cache[0], key)
        ):
            with torch.no_grad():
                self._post_cache = (key, self._model.posterior())
        return self._post_cache[1]

    @property
    def kern(self):
        return self._kern_wrapper

    @property
    def feat(self):
        return self._feat_wrapper

    @property
    def likelihood(self):
        return self._model.likelihood

    @property
    def q_mu(self):
        return _numpy(self._model.q_mu)

    @property
    def q_sqrt(self):
        return _numpy(self._model.q_sqrt)

    # -- data / minibatching --------------------------------------------------
    def _draws(self):
        """The generator a Monte-Carlo likelihood draws from; None for a
        likelihood that draws nothing."""
        if getattr(self._model.likelihood, "needs_generator", False):
            return self._generator
        return None

    def next_batch(self):
        """(X_batch, Y_batch) on the model's device: the reference's
        minibatch feed."""
        if (
            self.minibatch_size is None
            or self.minibatch_size >= self.num_data
        ):
            return self.X, self.Y
        idx = self._rng.choice(self.num_data, self.minibatch_size,
                               replace=False)
        idx = torch.as_tensor(idx, device=self.X.device)
        return self.X[idx], self.Y[idx]

    def _inputs(self, Xnew):
        return torch.as_tensor(Xnew, dtype=self.X.dtype, device=self.X.device)

    def _labels(self, Ynew):
        Ynew = torch.as_tensor(Ynew, device=self.Y.device)
        return Ynew.to(self.X.dtype) if Ynew.is_floating_point() else Ynew

    # -- GPflow-session-style entry points ------------------------------------
    def compute_log_likelihood(self):
        """Minibatch ELBO estimate (the reference's training objective)."""
        xb, yb = self.next_batch()
        with torch.no_grad():
            return float(self._model.elbo(xb, yb, num_data=self.num_data,
                                          generator=self._draws()))

    def compute_log_likelihood_full(self):
        """Full-data ELBO (no minibatch subsampling noise)."""
        with torch.no_grad():
            return float(self._model.elbo(self.X, self.Y,
                                          num_data=self.num_data,
                                          generator=self._draws()))

    def predict_f(self, Xnew, full_cov=False):
        with torch.no_grad():
            m, v = self._posterior().predict_f(self._inputs(Xnew),
                                               full_cov=full_cov)
        return _numpy(m), _numpy(v)

    def predict_y(self, Xnew, **kw):
        if self._draws() is not None:
            kw.setdefault("generator", self._generator)
        with torch.no_grad():
            m, v = self._posterior().predict_y(self._inputs(Xnew), **kw)
        return _numpy(m), _numpy(v)

    def predict_density(self, Xnew, Ynew, **kw):
        if self._draws() is not None:
            kw.setdefault("generator", self._generator)
        with torch.no_grad():
            return _numpy(self._posterior().predict_log_density(
                self._inputs(Xnew), self._labels(Ynew), **kw))
