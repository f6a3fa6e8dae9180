"""The flagship forward as one callable: the port's counterpart of
``__graft_entry__.py``'s ``_build`` and ``entry``.

:func:`build` makes the same data from ``np.random.default_rng(0)`` and the
same model: an order-1 normalised ``SignatureRBF``, inducing tensors drawn
from the data's increments, and an ``SVGP`` with ``MultiClass(2)`` and two
latent functions. :func:`entry` returns ``(fn, (model, X, Y))`` with
``fn(model, X, Y) = (elbo, fmean, fvar)``, in float32 on the card.

The inducing tensors are drawn with a ``torch.Generator`` seeded 0, whose
draws differ from ``jax.random``'s: to compare with the JAX package, carry
its model's parameters across with :mod:`gpsig_tpu_torch.convert`.

    python -c "from gpsig_tpu_torch import entry; fn, args = entry.entry(); print(fn(*args))"
"""

from __future__ import annotations

import numpy as np
import torch

from gpsig_tpu_torch import config
from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
from gpsig_tpu_torch.kernels.signature import SignatureRBF
from gpsig_tpu_torch.likelihoods import MultiClass
from gpsig_tpu_torch.models.svgp import SVGP


def build(dtype, N=16, L=10, d=2, num_tensors=8, num_levels=3, device=None):
    """(model, X [N, L, d], Y [N]) on ``device`` (default: the card)."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(0)
    X = torch.as_tensor((0.3 * rng.standard_normal((N, L, d))).cumsum(1),
                        dtype=dtype, device=device)
    Y = torch.as_tensor(rng.integers(0, 2, N), device=device)
    kern = SignatureRBF(d, num_levels, lengthscales=1.0, order=1,
                        normalization=True, dtype=dtype, device=device)
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(0), X, num_tensors=num_tensors,
        num_levels=num_levels, num_features=d)
    model = SVGP.create(kern, MultiClass(num_classes=2), feat, num_latent=2,
                        dtype=dtype, device=device)
    return model, X, Y


def forward(model, X, Y):
    """The SVGP ELBO and the posterior predictive of the batch."""
    elbo = model.elbo(X, Y, num_data=X.shape[0])
    fmean, fvar = model.predict_f(X)
    return elbo, fmean, fvar


def entry(device=None):
    """(fn, example_args): the flagship forward, SVGP ELBO + posterior
    predictive on a batch of sequences, in float32."""
    return forward, build(torch.float32, device=device)
