"""Explicit truncated signatures of batched paths (Chen's recursion).

Counterpart of ``gpsig_tpu/ops/explicit.py``: the feature side of the VOSF
path (variational orthogonal signature features, ``Kuu = I``) and the
untruncated kernel's Mercer features. One step of the piecewise-linear
path multiplies the running signature by the truncated tensor exponential
of its increment,

    S ← S ⊗ exp⊗(Δx_t),   exp⊗(v) = (1, v, v⊗v/2!, …),

with level m's coordinates flattened to [N, d^m]. Each step builds every
new level from the previous step's levels, never from a level already
updated in this step. The JAX package runs the steps as a ``lax.scan`` and
has no Pallas kernel here; the port is a Python loop over the steps,
vectorised over the batch. Cost O(N·L·Σ_m d^m·m): the VOSF regime is a
small d at a moderate ``num_levels``.
"""

from __future__ import annotations

import torch


def truncated_signature(X, num_levels):
    """X: [N, L, d] → list of level coordinates [N, d^m], m = 1..num_levels:
    the exact signature of the piecewise-linear interpolation of X."""
    N, L, d = X.shape
    dX = torch.diff(X, dim=1)  # [N, L-1, d]
    levels = [X.new_zeros((N, d**m)) for m in range(1, num_levels + 1)]
    for t in range(L - 1):
        dx = dX[:, t]
        # exp terms E_k = dx^{⊗k}/k!, flattened
        E = [dx]
        for k in range(2, num_levels + 1):
            E.append((E[-1][:, :, None] * dx[:, None, :] / k).reshape(N, -1))
        new = []
        for m in range(1, num_levels + 1):
            term = levels[m - 1] + E[m - 1]  # S_m·1 + 1·E_m
            for a in range(1, m):
                prod = levels[a - 1][:, :, None] * E[m - a - 1][:, None, :]
                term = term + prod.reshape(N, -1)
            new.append(term)
        levels = new
    return levels


def signature_dim(d, num_levels, include_constant=True):
    """Σ_{m=1..num_levels} d^m, plus 1 for the constant level."""
    total = sum(d**m for m in range(1, num_levels + 1))
    return total + (1 if include_constant else 0)
