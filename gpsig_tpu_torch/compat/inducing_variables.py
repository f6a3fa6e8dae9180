"""GPSig-style inducing-variable classes (reference:
``gpsig/inducing_variables.py``).

Counterpart of ``gpsig_tpu/compat/inducing_variables.py``:
``InducingTensors(Z, num_levels, increments=..., learn_weights=...)``,
``InducingSequences(Z)`` and the fork's ``OrthogonalFeatures``, with
``len(feat)`` the number of inducing variables. ``Kuu`` / ``Kuf`` take the
compat kernel and unwrap it, as the reference's ``features.Kuu(feat,
kern)`` dispatch pairs do; they return tensors. ``Z`` is copied to
``dtype`` (default ``torch.float64``) on ``device`` (default: the card).
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch import config
from gpsig_tpu_torch import inducing as core
from gpsig_tpu_torch.kernels.vosf import OrthogonalSignatureFeatures


def _unwrap(kern):
    return kern.to_functional() if hasattr(kern, "to_functional") else kern


def _inputs(kern, X):
    """``X`` cast by the compat kernel (a core kernel takes tensors)."""
    return kern._check(X) if hasattr(kern, "_check") else X


def _parameter(Z, dtype, device):
    """A copy of ``Z``: training updates it in place, never the caller's
    array."""
    return torch.as_tensor(Z, dtype=dtype or torch.float64,
                           device=config.resolve_device(device)).clone()


class _Wrapper:
    def __len__(self):
        return self._feat.num_inducing

    @property
    def Z(self):
        return self._feat.raw_Z.detach().cpu().numpy()

    def to_functional(self):
        return self._feat

    def update_functional(self, feat):
        self._feat = feat

    def Kuu(self, kern, jitter=None):
        return self._feat.Kuu(_unwrap(kern), jitter)

    def Kuf(self, kern, X):
        return self._feat.Kuf(_unwrap(kern), _inputs(kern, X))


class InducingTensors(_Wrapper):
    def __init__(self, Z, num_levels, increments=False, learn_weights=False,
                 dtype=None, device=None):
        self._feat = core.InducingTensors.create(
            _parameter(Z, dtype, device), num_levels, increments=increments,
            learn_weights=learn_weights)


class InducingSequences(_Wrapper):
    def __init__(self, Z, num_levels=None, joint_psd=False, dtype=None,
                 device=None):
        # num_levels accepted for signature parity: the sequence family
        # uses the kernel's own truncation level. joint_psd: see
        # gpsig_tpu_torch.inducing.InducingSequences.covariances_full.
        del num_levels
        self._feat = core.InducingSequences.create(
            _parameter(Z, dtype, device), joint_psd=joint_psd)


class OrthogonalFeatures(_Wrapper):
    """VOSF inter-domain features (the fork's, ``Kuu = I``).

    Takes the explicit signature kernel
    (``gpsig_tpu_torch.kernels.vosf.ExplicitSignatureKernel``) or, with
    ``num_levels``, the untruncated PDE kernel
    (``compat.kernels.UntruncSignatureKernel``): the reference SigGPDE
    model, ``Kuf`` the rescaled signature coordinates of the untruncated
    prior's Mercer expansion and ``Knn`` the PDE kernel. It holds no
    parameters, so it has no ``Z``."""

    def __init__(self, kern, num_levels=None):
        self._feat = OrthogonalSignatureFeatures.for_kernel(
            _unwrap(kern), num_levels=num_levels
        )
