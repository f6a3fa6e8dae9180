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
