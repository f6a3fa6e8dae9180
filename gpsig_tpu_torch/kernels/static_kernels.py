"""Static base kernels lifted into the signature machinery.

Counterpart of ``gpsig_tpu/kernels/static_kernels.py``: Linear, RBF, Poly
and Cosine. ARD lengthscales belong to
:class:`~gpsig_tpu_torch.kernels.signature.SignatureKernel`, which
pre-scales the inputs. Only Poly holds a parameter, its trainable offset
``raw_offset``; it is an ``nn.Module`` so that the kernel's state dict
names it ``base.raw_offset``, as the JAX pytree path does.

- ``gram(A, B)``: [..., n, d] × [..., m, d] → [..., n, m]
- ``matched(A, B)``: [..., d] × [..., d] → [...] (paired evaluation)
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch import config
from gpsig_tpu_torch import params as pr


def _dot(A, B):
    return torch.matmul(A, torch.swapaxes(B, -1, -2))


def _sqdist(A, B):
    na = torch.sum(A * A, dim=-1)
    nb = torch.sum(B * B, dim=-1)
    d2 = na[..., :, None] + nb[..., None, :] - 2.0 * _dot(A, B)
    return torch.clamp(d2, min=0.0)


class LinearBase:
    """k(a, b) = ⟨a, b⟩."""

    def gram(self, A, B):
        return _dot(A, B)

    def matched(self, A, B):
        return torch.sum(A * B, dim=-1)


class RBFBase:
    """k(a, b) = exp(-||a - b||² / 2) on pre-scaled inputs."""

    def gram(self, A, B):
        return torch.exp(-0.5 * _sqdist(A, B))

    def matched(self, A, B):
        d = A - B
        return torch.exp(-0.5 * torch.sum(d * d, dim=-1))


class PolyBase(nn.Module):
    """k(a, b) = (⟨a, b⟩ + c)^degree with a trainable offset c > 0."""

    def __init__(self, raw_offset, degree=2):
        super().__init__()
        self.raw_offset = nn.Parameter(raw_offset)
        self.degree = degree

    @classmethod
    def create(cls, offset=1.0, degree=2, dtype=torch.float64, device=None):
        c = torch.as_tensor(offset, dtype=dtype,
                            device=config.resolve_device(device))
        return cls(pr.inv_positive(c), degree)

    @property
    def offset(self):
        return pr.positive(self.raw_offset)

    def gram(self, A, B):
        return (_dot(A, B) + self.offset) ** self.degree

    def matched(self, A, B):
        return (torch.sum(A * B, dim=-1) + self.offset) ** self.degree


class CosineBase:
    """k(a, b) = cos(||a - b||) on pre-scaled inputs (GPflow 1.x's
    stationary ``Cosine``)."""

    def gram(self, A, B):
        return torch.cos(torch.sqrt(_sqdist(A, B) + 1e-36))

    def matched(self, A, B):
        d = A - B
        return torch.cos(torch.sqrt(torch.sum(d * d, dim=-1) + 1e-36))
