"""Likelihood constructors under the GPflow 1.x names the reference uses
(``Gaussian``, ``Bernoulli``, ``MultiClass``, ``SoftMax``). They return the
port's likelihood modules (``gpsig_tpu_torch/likelihoods.py``)."""

from __future__ import annotations

import torch

from gpsig_tpu_torch import likelihoods as core


def Gaussian(variance=1.0, dtype=torch.float64, device=None):
    """Its variance is a parameter, on ``device`` (default: the card)."""
    return core.Gaussian.create(variance=variance, dtype=dtype, device=device)


def Bernoulli():
    return core.Bernoulli()


def MultiClass(num_classes, epsilon=1e-3):
    """RobustMax multiclass (GPflow 1.x ``MultiClass`` default)."""
    return core.MultiClass(num_classes=num_classes, epsilon=epsilon)


def SoftMax(num_classes, num_samples=100):
    """Monte-Carlo softmax with the reference's 100 draws (the core
    ``Softmax`` defaults to 20)."""
    return core.Softmax(num_classes=num_classes, num_samples=num_samples)


Softmax = SoftMax
