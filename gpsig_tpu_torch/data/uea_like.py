"""Deterministic synthetic UEA-like classification suite, numpy only.

A copy of ``gpsig_tpu/data/uea_like.py``, kept here because importing the
JAX package's module runs ``gpsig_tpu/__init__.py``, which imports JAX.
The same name gives bitwise the same arrays in both packages.

Five frozen datasets whose shapes mirror real UEA archives (train/test
split sizes, channel counts, class counts, ragged lengths), generated from
committed seeds; their expected accuracy/NLPP windows are recorded in
``benchmarks/expected_windows.json``. Interface: lists of ``[L_i, d]``
float arrays and int label vectors, so ``data/preprocessing.py`` (scaling,
time augmentation, repeat-last-observation padding) applies unchanged.

Generation model: per class, a smooth prototype path built from a
class-seeded random Fourier series; per sample, the prototype is
time-warped, amplitude-jittered per channel, and observed with additive
noise. Class information lives in the path's *shape* (harmonic content
and cross-channel phases), which is what signature features measure.
"""

from __future__ import annotations

import numpy as np

# Name → (seed, C, d, L or (Lmin, Lmax), Ntr, Nte, n_harm, sep, warp,
# noise, drift). Shapes mirror the named UEA archives; seeds are frozen —
# do NOT change any entry without recalibrating
# benchmarks/expected_windows.json.
_SPECS = {
    "SynthGunPoint": dict(seed=101, C=2, d=1, L=150, Ntr=50, Nte=150,
                          n_harm=4, sep=0.25, warp=0.2, noise=0.52,
                          drift=0.75),
    "SynthBasicMotions": dict(seed=202, C=4, d=6, L=100, Ntr=40, Nte=40,
                              n_harm=3, sep=0.35, warp=0.25, noise=0.75,
                              drift=0.9),
    "SynthLibras": dict(seed=303, C=15, d=2, L=45, Ntr=180, Nte=180,
                        n_harm=4, sep=0.5, warp=0.15, noise=0.6,
                        drift=0.75),
    "SynthERing": dict(seed=404, C=6, d=4, L=65, Ntr=30, Nte=270,
                       n_harm=3, sep=0.42, warp=0.2, noise=0.68,
                       drift=0.9),
    "SynthCharTraj": dict(seed=505, C=10, d=3, L=(60, 140), Ntr=200,
                          Nte=150, n_harm=5, sep=0.42, warp=0.3, noise=0.6,
                          drift=0.75),
}


def available_datasets():
    return sorted(_SPECS)


def load_dataset(name):
    """(train_seqs, y_train, test_seqs, y_test) — same contract as
    ``uea.load_dataset``; fully deterministic per name."""
    if name not in _SPECS:
        raise KeyError(f"unknown synthetic dataset {name!r}; "
                       f"available: {available_datasets()}")
    s = _SPECS[name]
    rng = np.random.default_rng(s["seed"])
    protos = _prototypes(rng, s["C"], s["d"], s["n_harm"], s["sep"])
    Xtr, ytr = _sample_split(rng, protos, s, s["Ntr"])
    Xte, yte = _sample_split(rng, protos, s, s["Nte"])
    return Xtr, ytr, Xte, yte


def _prototypes(rng, C, d, n_harm, sep):
    """Per-class Fourier coefficients: [C, n_harm, d] each for cos/sin.

    A shared backbone keeps classes overlapping (so the task is not
    trivially linearly separable); ``sep`` scales the class-specific part.
    """
    backbone_c = rng.standard_normal((1, n_harm, d))
    backbone_s = rng.standard_normal((1, n_harm, d))
    cls_c = rng.standard_normal((C, n_harm, d))
    cls_s = rng.standard_normal((C, n_harm, d))
    decay = (1.0 / np.arange(1, n_harm + 1))[None, :, None]
    return (
        (backbone_c + sep * cls_c) * decay,
        (backbone_s + sep * cls_s) * decay,
    )


def _sample_split(rng, protos, s, N):
    co, si = protos
    C, n_harm, d = co.shape
    y = rng.integers(0, C, N).astype(np.int32)
    seqs = []
    k = np.arange(1, n_harm + 1)
    for n in range(N):
        L = s["L"]
        if isinstance(L, tuple):
            L = int(rng.integers(L[0], L[1] + 1))
        t = np.linspace(0.0, 1.0, L)
        # smooth random time warp (monotone, endpoints fixed): cumulative
        # softplus-ish positive speed profile from two random harmonics
        w1, w2 = s["warp"] * rng.standard_normal(2)
        ph1, ph2 = 2 * np.pi * rng.random(2)
        speed = 1.0 + w1 * np.sin(2 * np.pi * t + ph1) + w2 * np.sin(
            4 * np.pi * t + ph2
        )
        speed = np.maximum(speed, 0.05)
        tw = np.concatenate([[0.0], np.cumsum(speed[:-1])])
        tw = tw / tw[-1]
        arg = 2.0 * np.pi * np.outer(tw, k)  # [L, n_harm]
        c = y[n]
        amp = 1.0 + 0.25 * rng.standard_normal(d)
        path = (np.cos(arg) @ co[c] + np.sin(arg) @ si[c]) * amp
        # class-independent nuisance: a smooth random drift (hurts any
        # classifier keying on absolute level rather than shape)
        drift = s["drift"] * np.cumsum(
            rng.standard_normal((L, d)), axis=0
        ) / np.sqrt(L)
        path = path + drift + s["noise"] * rng.standard_normal((L, d))
        seqs.append(path.astype(np.float64))
    return seqs, y


def dataset_fingerprint(name):
    """Stable checksum of the generated data (regression guard for the
    generator itself — windows in expected_windows.json are only valid
    against these exact arrays)."""
    Xtr, ytr, Xte, yte = load_dataset(name)
    h = 0.0
    for seqs in (Xtr, Xte):
        for a in seqs:
            h += float(np.sum(a) + np.sum(a * a) * 1e-3)
    return round(h + float(ytr.sum()) * 1e-2 + float(yte.sum()) * 1e-4, 6)
