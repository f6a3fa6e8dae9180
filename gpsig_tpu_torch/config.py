"""Global numeric policy for gpsig_tpu_torch.

Counterpart of ``gpsig_tpu/config.py``. Library code is dtype-polymorphic:
it computes in the dtype of its inputs (float64 for parity on the CPU,
float32 on the card) and only consults this module for constants.

Device policy: the entry points that create parameters (the kernels'
constructors, ``SVGP.create``, ``GPR.create``, the likelihoods' ``create``,
``convert.from_jax_arrays``) put them on :func:`default_device`, the CUDA
card, unless the caller names a device (the CPU tests pass
``device="cpu"``). Without a card such a call fails with PyTorch's own
error; it never carries on on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class Settings:
    #: jitter added to Kuu / Cholesky factorisations (gpflow default: 1e-6)
    jitter: float = 1e-6
    #: jitter floor for float32 factorisations: inducing-tensor Grams are
    #: structurally rank-deficient, so the f64 default sits below f32
    #: rounding error and the Cholesky fails
    jitter_f32: float = 1e-4


settings = Settings()


def default_device():
    """Where the entry points put what they create: the CUDA card."""
    return torch.device("cuda")


def resolve_device(device):
    """``device``, or :func:`default_device` when it is None."""
    return default_device() if device is None else torch.device(device)


def default_jitter(dtype=None):
    """Jitter for Cholesky factorisations; dtype-aware when dtype is given
    (float32 needs a larger floor than GPflow's f64 default)."""
    if dtype is not None and dtype == torch.float32:
        return max(settings.jitter, settings.jitter_f32)
    return settings.jitter


@contextlib.contextmanager
def precise_linalg():
    """Run the GP layer (Cholesky, triangular solves, KL, conditionals)
    with TF32 off, so float32 matrix products on the card keep full
    float32 mantissas. Those ops difference nearly-equal quantities
    through the solves; TF32's ~3 decimal digits would turn predictive
    variances negative. Usable as ``with precise_linalg():`` and as the
    decorator ``@precise_linalg()``. The previous flags are restored on
    exit."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    prev = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = prev
