"""Synthetic sequence datasets, numpy only.

A copy of ``gpsig_tpu/data/synthetic.py`` (``regression_sequences``,
``classification_sequences``, ``sits_sequences``,
``ragged_classification_sequences`` and ``train_test_split``), kept here
because importing the JAX package's module runs ``gpsig_tpu/__init__.py``,
which imports JAX. The same seed gives the same arrays in both packages,
bitwise.
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


def sits_sequences(seed=0, N=100_000, L=40, num_classes=10):
    """SITS-like crop-classification stand-in: univariate NDVI-style
    seasonal profiles, double-logistic phenology with class-dependent
    green-up/senescence timing and amplitude, plus cloud-like dropouts and
    noise. Returns (X [N, L, 1] float64, y [N] int32); vectorised, so
    N ≈ 1e5+ stays cheap."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, N).astype(np.int32)
    t = np.linspace(0.0, 1.0, L)[None, :]
    base = np.linspace(0.25, 0.55, num_classes)  # green-up midpoint
    width = np.linspace(0.08, 0.2, num_classes)  # season half-length
    amp = np.linspace(0.5, 0.9, num_classes)  # NDVI amplitude
    g = base[y][:, None] + 0.03 * rng.standard_normal((N, 1))
    w = width[y][:, None] * np.exp(0.1 * rng.standard_normal((N, 1)))
    a = amp[y][:, None] * np.exp(0.1 * rng.standard_normal((N, 1)))
    k = 25.0
    ndvi = a * (
        1.0 / (1.0 + np.exp(-k * (t - g)))
        - 1.0 / (1.0 + np.exp(-k * (t - g - 2 * w)))
    ) + 0.15
    # cloud dropouts: random dips toward zero
    clouds = rng.random((N, L)) < 0.05
    ndvi = np.where(clouds, ndvi * rng.random((N, L)) * 0.3, ndvi)
    ndvi = ndvi + 0.03 * rng.standard_normal((N, L))
    return ndvi[:, :, None].astype(np.float64), y


def ragged_classification_sequences(seed=0, N=100, Lmin=20, Lmax=50, d=2,
                                    num_classes=2):
    """Variable-length variant of :func:`classification_sequences` (each
    sequence cut to a length in [Lmin, Lmax]). Returns (list of [L_n, d]
    arrays, y [N])."""
    rng = np.random.default_rng(seed)
    Xf, y = classification_sequences(seed, N, Lmax, d, num_classes)
    seqs = []
    for n in range(N):
        L = int(rng.integers(Lmin, Lmax + 1))
        seqs.append(Xf[n, :L])
    return seqs, y


def train_test_split(X, y, test_frac=0.3, seed=0):
    """A seeded random split of an array [N, ...] or a list of N sequences
    and y [N]: (X_train, y_train, X_test, y_test), round(test_frac N) of
    them in the test part."""
    rng = np.random.default_rng(seed)
    N = len(X) if isinstance(X, list) else X.shape[0]
    perm = rng.permutation(N)
    n_test = int(round(test_frac * N))
    te, tr = perm[:n_test], perm[n_test:]
    take = (lambda Z, idx: [Z[i] for i in idx]) if isinstance(X, list) else (
        lambda Z, idx: Z[idx]
    )
    return take(X, tr), y[tr], take(X, te), y[te]
