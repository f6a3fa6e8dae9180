"""Metrics, logging and profiling.

Counterpart of ``gpsig_tpu/utils/metrics.py``: a metric writer that
accumulates scalar series, prints periodically and optionally appends
JSONL; a step timer; a ``torch.profiler`` trace around a block (where the
JAX package wraps ``jax.profiler``); and the MCMC diagnostics
:func:`effective_sample_size` and :func:`split_rhat`, numpy functions
copied unchanged, so they agree with the JAX package's bitwise on the
same array.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class MetricWriter:
    def __init__(self, log_every=100, jsonl_path=None, verbose=True):
        self.log_every = log_every
        self.jsonl_path = jsonl_path
        self.verbose = verbose
        self.history = []
        self._t0 = time.time()

    def write(self, step, **scalars):
        rec = {"step": int(step), "wall": time.time() - self._t0}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.history.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.verbose and step % self.log_every == 0:
            parts = " ".join(f"{k}={v:.5g}" for k, v in rec.items()
                             if k not in ("step", "wall"))
            print(f"[{rec['wall']:8.1f}s] step {step:6d} {parts}",
                  flush=True)


@contextlib.contextmanager
def profile_trace(logdir):
    """Profile a block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write a Chrome trace to ``logdir/trace.json``. Yields
    the profiler, whose ``key_averages()`` the caller may read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Per-step wall-clock timing with warmup discard."""

    def __init__(self, warmup=2):
        self.warmup = warmup
        self.times = []
        self._last = None

    def tick(self):
        now = time.time()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def mean(self):
        ts = self.times[self.warmup:]
        return sum(ts) / max(len(ts), 1)


def effective_sample_size(chains):
    """Cross-chain ESS per coordinate (Geyer initial monotone sequence).

    chains: [C, S, D] numpy array of post-warmup draws. Returns [D] ESS
    following the Stan/Vehtari multi-chain estimator: autocovariances
    averaged over chains, combined with between-chain variance, summed over
    lag pairs until the first negative pair, with the monotone adjustment.
    """
    import numpy as np

    x = np.asarray(chains, np.float64)
    C, S, D = x.shape
    mean_c = x.mean(axis=1)  # [C, D]
    var_c = x.var(axis=1, ddof=1)  # [C, D]
    W = var_c.mean(0)  # within-chain variance
    B = S * mean_c.var(axis=0, ddof=1) if C > 1 else np.zeros(D)
    var_plus = W * (S - 1) / S + (B / S if C > 1 else 0.0)

    # FFT autocovariance per chain/coordinate
    xc = x - x.mean(axis=1, keepdims=True)
    n_fft = 1 << (2 * S - 1).bit_length()
    f = np.fft.rfft(xc, n=n_fft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=1)[:, :S].real
    acov = acov / S  # biased (Geyer convention)
    rho_hat = 1.0 - (W - acov.mean(axis=0)) / np.maximum(var_plus, 1e-300)

    ess = np.empty(D)
    for dd in range(D):
        r = rho_hat[:, dd]
        # pairwise sums Γ_k = ρ_{2k} + ρ_{2k+1}, truncate at first negative,
        # then enforce monotone decrease
        tmax = (S - 1) // 2
        gam = r[0 : 2 * tmax : 2] + r[1 : 2 * tmax + 1 : 2]
        pos = gam > 0
        k_end = int(np.argmin(pos)) if not pos.all() else len(gam)
        gam = np.minimum.accumulate(gam[:k_end]) if k_end else gam[:0]
        tau = -1.0 + 2.0 * gam.sum()
        # cap at the draw count (conservative vs Stan's CS·log10(CS) cap)
        ess[dd] = min(C * S / max(tau, 1e-12), C * S)
    return ess


def split_rhat(chains):
    """Split-R̂ per coordinate (Gelman/Vehtari potential scale reduction).

    chains: [C, S, D] post-warmup draws. Each chain is split in half
    (dropping the middle draw when S is odd), giving 2C sequences of
    length S//2; R̂ = sqrt(var̂⁺ / W) with the standard between/within
    decomposition. Values near 1 indicate mixing; Vehtari et al. (2021)
    recommend requiring R̂ < 1.01.
    """
    import numpy as np

    x = np.asarray(chains, np.float64)
    C, S, D = x.shape
    half = S // 2
    if half < 2:
        return np.full(D, np.nan)
    halves = np.concatenate([x[:, :half], x[:, S - half :]], axis=0)
    m = 2 * C
    mean_c = halves.mean(axis=1)  # [m, D]
    var_c = halves.var(axis=1, ddof=1)  # [m, D]
    W = var_c.mean(0)
    B = half * mean_c.var(axis=0, ddof=1)
    var_plus = W * (half - 1) / half + B / half
    return np.sqrt(var_plus / np.maximum(W, 1e-300))
