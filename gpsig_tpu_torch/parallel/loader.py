"""Sharded minibatch loader.

Counterpart of ``gpsig_tpu/parallel/loader.py``. Every rank draws the same
global indices, ``np.random.default_rng(seed).choice(N, batch,
replace=False)`` a batch, so the stream is the JAX loader's bitwise; the
batch is rounded down to a multiple of the data axis's size, and the rank
keeps its contiguous block of it (``mesh.shard_batch``). One batch ahead,
the next block is copied from pinned host memory to the rank's device with
``non_blocking=True`` while the current step computes.
"""

from __future__ import annotations

import numpy as np
import torch

from gpsig_tpu_torch import config
from gpsig_tpu_torch.parallel.mesh import shard_batch


class ShardedLoader:
    """Infinite uniform-without-replacement minibatch stream.

    Yields this rank's (X_block, y_block) on ``device`` (default: the
    card), X cast to ``dtype`` (default: X's own); ``indices`` holds the
    global indices of the batch last yielded."""

    def __init__(self, mesh, X, y, batch_size, seed=0, prefetch=True,
                 device=None, dtype=None):
        self.mesh = mesh
        n_dev = mesh.data
        self.batch = max(n_dev, batch_size - batch_size % n_dev)
        self.X = np.asarray(X)
        self.y = np.asarray(y)
        self.N = self.X.shape[0]
        self.rng = np.random.default_rng(seed)
        self.device = config.resolve_device(device)
        self.dtype = dtype
        self.prefetch = prefetch
        self.indices = None
        self._next = None

    def _to_device(self, a, dtype=None):
        t = torch.as_tensor(a, dtype=dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _sample(self):
        if self.batch >= self.N:
            idx = np.arange(self.N)
        else:
            idx = self.rng.choice(self.N, self.batch, replace=False)
        mine = shard_batch(self.mesh, idx)
        return idx, (self._to_device(self.X[mine], self.dtype),
                     self._to_device(self.y[mine]))

    def __iter__(self):
        return self

    def __next__(self):
        if not self.prefetch:
            self.indices, out = self._sample()
            return out
        if self._next is None:
            self._next = self._sample()
        self.indices, out = self._next
        self._next = self._sample()  # copied while the device computes
        return out
