"""Synthetic sequence datasets, numpy only.

A copy of ``gpsig_tpu/data/synthetic.py``'s ``regression_sequences`` and
``classification_sequences``, kept here because importing the JAX package's
module runs ``gpsig_tpu/__init__.py``, which imports JAX. The same seed
gives the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np


def regression_sequences(seed=0, N=200, L=50, d=2, noise=0.1):
    """BASELINE config 1: synthetic 2-D random walks with a smooth path
    functional (final value + signed-area proxy) as target. Returns
    (X [N, L, d], y [N, 1]), float64."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(0.3 * rng.standard_normal((N, L, d)), axis=1)
    area = np.sum(X[:, :-1, 0] * np.diff(X[:, :, 1], axis=1), axis=1)
    y = np.tanh(X[:, -1, 0]) + 0.5 * np.tanh(area)
    y = y + noise * rng.standard_normal(N)
    return X.astype(np.float64), y[:, None].astype(np.float64)


def classification_sequences(seed=0, N=300, L=40, d=3, num_classes=3,
                             difficulty=1.0):
    """Class-dependent frequency + drift on a random walk; a higher
    ``difficulty`` shrinks the separation. Returns (X [N, L, d] float64,
    y [N] int32)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, N)
    t = np.linspace(0, 1, L)
    X = np.empty((N, L, d))
    for n in range(N):
        c = y[n]
        freq = 1.0 + c
        drift = (c - (num_classes - 1) / 2.0) * 1.5 / difficulty
        base = 0.25 * rng.standard_normal((L, d)).cumsum(axis=0)
        phase = 2 * np.pi * rng.random(d)
        osc = np.sin(2 * np.pi * freq * t[:, None] + phase[None, :])
        X[n] = base + osc + drift * t[:, None]
    return X.astype(np.float64), y.astype(np.int32)
