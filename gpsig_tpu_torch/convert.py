"""Load a ``gpsig_tpu`` model's parameters into the port's modules.

The JAX models are pytrees whose leaves are the unconstrained parameters;
the port's modules hold the same leaves as ``nn.Parameter``s under the same
names. A caller flattens the JAX model (for instance with
``jax.tree_util.tree_flatten_with_path``), keys each leaf by its dotted
field path (``kernel.raw_sigma``, ``inducing.raw_Z``, ``q_sqrt``,
``likelihood.raw_variance``; an element of a tuple field by its index, as
the low-rank kernel's ``kernel.pair_indices.0``) and passes numpy arrays
here; this module never sees JAX itself. Integer leaves (the low-rank
sketch's pair indices, buffers in the port) keep an integer dtype.

:func:`sampler_state_from_arrays` carries a NUTS sampler's state across
the same way (the chains' positions, log densities and gradients, dual
averaging, the Welford mass estimate and the inverse mass), so a port run
can start from a JAX run's mid-warmup state.
"""

from __future__ import annotations

import numpy as np
import torch

from gpsig_tpu_torch import config


def from_jax_arrays(tree, dtype=None, device=None):
    """{dotted path: array} → a ``state_dict`` of tensors on ``device``
    (default: the card, :func:`config.default_device`), floating-point
    leaves cast to ``dtype`` when given. A ``None`` leaf (no lengthscales,
    no lags, no mixing weights, a low-rank level without a sketch) stays
    absent, as the port's module then has no such parameter or buffer. A
    Poly base's offset travels as ``kernel.base.raw_offset``, its JAX
    path."""
    device = config.resolve_device(device)
    out = {}
    for key, value in tree.items():
        if value is None:
            continue
        arr = np.array(value)
        cast = dtype if np.issubdtype(arr.dtype, np.floating) else None
        out[key] = torch.as_tensor(arr, dtype=cast, device=device)
    return out


def load_jax_arrays(module, tree):
    """Copy the leaves into ``module``'s parameters (cast to their dtype
    and device; staged on the CPU). Strict: a missing or unexpected key,
    or a shape that differs, raises, so the two models must share their
    configuration (base kind included: only a Poly base has an offset)."""
    module.load_state_dict(from_jax_arrays(tree, device="cpu"), strict=True)
    return module


def sampler_state_from_arrays(tree, dtype=None, device=None):
    """A NUTS sampler's state from numpy arrays, as the JAX package's
    warmup carry holds it (for instance ``jax.vmap``'d chains' leaves
    passed through ``np.asarray``): ``tree`` maps ``"state"`` to {theta,
    logp, grad}, ``"da"`` to the ``DAState`` fields, ``"wf"`` to the
    ``WelfordState`` fields and ``"inv_mass"`` to an array; every array has
    the chain axis first. Returns the port's warmup carry (NutsState,
    DAState, WelfordState, inv_mass) on ``device`` (default: the card),
    cast to ``dtype`` when given, for ``mcmc/sample.py``'s
    ``make_warm_step`` (drop DAState and WelfordState for a sampling
    carry, whose step size is ``exp(log_eps_bar)``)."""
    from gpsig_tpu_torch.mcmc.nuts import NutsState
    from gpsig_tpu_torch.mcmc.sample import DAState, WelfordState

    device = config.resolve_device(device)

    def tensors(d):
        return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
                for k, v in d.items()}

    return (NutsState(**tensors(tree["state"])), DAState(**tensors(tree["da"])),
            WelfordState(**tensors(tree["wf"])),
            tensors({"m": tree["inv_mass"]})["m"])
