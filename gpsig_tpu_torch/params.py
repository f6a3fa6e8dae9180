"""Parameter transforms (bijectors) for constrained optimisation.

PyTorch counterpart of ``gpsig_tpu/params.py``. Modules of this package
store *unconstrained* ``nn.Parameter`` leaves (named as the JAX fields) and
expose constrained values through properties that apply the forward
transforms below, as GPflow 1.x's ``Parameter`` does with its transforms.
"""

from __future__ import annotations

import contextlib

import torch


def _as_tensor(y):
    return y if torch.is_tensor(y) else torch.as_tensor(y)


def softplus(x):
    # log(1 + e^x) without torch's threshold cut-over, as jax.nn.softplus
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    """Inverse of softplus, numerically stable for large and small y."""
    y = _as_tensor(y)
    safe = torch.clamp(y, min=1e-10)
    return torch.where(safe > 20.0, safe, torch.log(torch.expm1(safe)))


def positive(x):
    """Unconstrained -> positive (softplus, as in gpflow's default)."""
    return softplus(x)


def inv_positive(y):
    return inv_softplus(y)


def logistic(x, lo=0.0, hi=1.0):
    """Unconstrained -> (lo, hi) via a scaled sigmoid (gpflow ``Logistic``)."""
    return lo + (hi - lo) * torch.sigmoid(x)


def inv_logistic(y, lo=0.0, hi=1.0):
    t = (_as_tensor(y) - lo) / (hi - lo)
    t = torch.clamp(t, 1e-12, 1.0 - 1e-12)
    return torch.log(t) - torch.log1p(-t)


def vec_to_tril(v, n):
    """Pack a vector of length n(n+1)/2 into a lower-triangular [n, n]
    matrix, row-major over the lower triangle."""
    idx = torch.tril_indices(n, n, device=v.device)
    out = torch.zeros((n, n), dtype=v.dtype, device=v.device)
    out[idx[0], idx[1]] = v
    return out



# ---------------------------------------------------------------------------
# Chains of hyperparameters: a sampler's C chains evaluate one model at C
# settings at once, each hyperparameter with a leading chain axis.
# ---------------------------------------------------------------------------

#: the rank of each kernel hyperparameter without a chain axis
HYPER_NDIM = {"raw_sigma": 0, "raw_variances": 1, "raw_lengthscales": 1,
              "raw_lags": 1, "raw_gamma": 1, "raw_variance": 0}


def chain_count(module):
    """C where ``module``'s own hyperparameters carry a leading chain axis
    of C (rank one above :data:`HYPER_NDIM`), else None. Raises where two
    disagree on C."""
    counts = {name: getattr(module, name).shape[0]
              for name, ndim in HYPER_NDIM.items()
              if getattr(module, name, None) is not None
              and getattr(module, name).ndim > ndim}
    if len(set(counts.values())) > 1:
        raise ValueError(f"{type(module).__name__}: hyperparameters with "
                         f"different chain counts {counts}")
    return next(iter(counts.values()), None)


def refuse_chains(module, what):
    """Raise ``ValueError`` where ``module``'s hyperparameters carry a
    chain axis: ``what`` (an entry point) evaluates one setting only."""
    C = chain_count(module)
    if C is not None:
        raise ValueError(
            f"{type(module).__name__}.{what}: the hyperparameters carry a "
            f"chain axis (C = {C}), which only SignatureKernel's tuned "
            "order-1 route takes (K and Kdiag: order 1, difference=True, "
            "RBF or Linear base, num_levels <= 7, no lags, one sequence "
            "length); evaluate one chain at a time here")


@contextlib.contextmanager
def substituted(module, values):
    """Within the block, ``module``'s parameters named in ``values``
    (dotted paths, as ``named_parameters`` gives them) are the given
    tensors, which need not be leaves: gradients flow to whatever they
    were computed from. The parameters are restored on exit. This is how
    a target puts C chains' hyperparameters ([C, ...] tensors, functions
    of the sampler's θ) into a model built once."""
    saved = []
    try:
        for path, value in values.items():
            *parents, name = path.split(".")
            owner = module.get_submodule(".".join(parents))
            if name not in owner._parameters:
                raise KeyError(f"{path}: not a parameter of "
                               f"{type(module).__name__}")
            saved.append((owner, name, owner._parameters[name]))
            owner._parameters[name] = value
        yield module
    finally:
        for owner, name, param in reversed(saved):
            owner._parameters[name] = param
