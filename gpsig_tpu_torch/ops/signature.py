"""Truncated signature-kernel recursions, plain PyTorch, any order.

Counterpart of ``gpsig_tpu/ops/signature.py``; see its module docstring for
the mathematics. These are the CPU path of the port and the oracle that
the CUDA kernels in ``ops/cuda`` are held against.

All functions take the increment matrix with the two sequence axes
trailing, ``M [..., Lx-1, Ly-1]``, and return per-level kernels stacked on
a leading axis, ``[num_levels+1, ...]`` (level 0 is the constant 1).
``order`` is the per-step truncation p of the tensor exponential: 1 is the
first-order recursion, ``order >= num_levels`` the exact signature of the
piecewise-linear path (the run-length recursion with p = min(order,
num_levels)).
"""

from __future__ import annotations

import torch


def ecumsum(x, dim):
    """Exclusive cumulative sum: out[i] = Σ_{i' < i} x[i']."""
    return torch.cumsum(x, dim=dim) - x


def ecumsum2(x):
    """Exclusive cumsum over both trailing axes: Σ_{i'<i, j'<j} x[i', j']."""
    return ecumsum(ecumsum(x, -1), -2)


def incremental_gram(K):
    """Double-difference a step-level Gram along its two trailing axes:
    M[i,j] = K[i+1,j+1] - K[i,j+1] - K[i+1,j] + K[i,j]."""
    d1 = K[..., 1:, :] - K[..., :-1, :]
    return d1[..., :, 1:] - d1[..., :, :-1]


def signature_kern(M, num_levels, order=1, return_levels=True):
    """Per-level signature kernels from an increment matrix [..., L1, L2]."""
    if order <= 1:
        K = _first_order(M, num_levels)
    else:
        K = _higher_order(M, num_levels, order)
    return K if return_levels else torch.sum(K, dim=0)


def _first_order(M, num_levels):
    ones = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    levels = [ones, torch.sum(M, dim=(-2, -1))]
    A = M
    for _ in range(2, num_levels + 1):
        A = M * ecumsum2(A)
        levels.append(torch.sum(A, dim=(-2, -1)))
    return torch.stack(levels, dim=0)


def _higher_order(M, num_levels, order):
    """Run-length DP: D[r][s] holds the contributions whose last run
    lengths are (r+1, s+1); None marks a state that is identically 0."""
    p = min(order, num_levels)
    ones = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    levels = [ones, torch.sum(M, dim=(-2, -1))]
    D = [[None] * p for _ in range(p)]
    D[0][0] = M
    for m in range(2, num_levels + 1):
        R = min(p, m)
        Dn = [[None] * p for _ in range(p)]
        total = _tree_sum(d for row in D for d in row)
        Dn[0][0] = M * ecumsum2(total)
        for r in range(1, R):
            row = _tree_sum(D[r - 1])
            if row is not None:
                Dn[r][0] = (M / (r + 1)) * ecumsum(row, -1)
            col = _tree_sum(D[s][r - 1] for s in range(p))
            if col is not None:
                Dn[0][r] = (M / (r + 1)) * ecumsum(col, -2)
        for r in range(1, R):
            for s in range(1, R):
                if D[r - 1][s - 1] is not None:
                    Dn[r][s] = (M / ((r + 1) * (s + 1))) * D[r - 1][s - 1]
        D = Dn
        levels.append(
            torch.sum(_tree_sum(d for row in D for d in row), dim=(-2, -1)))
    return torch.stack(levels, dim=0)


def _tree_sum(items):
    acc = None
    for it in items:
        if it is None:
            continue
        acc = it if acc is None else acc + it
    return acc


def signature_kern_tens_vs_seq(U, num_levels, order=1):
    """⟨z^{(m)}, S_m(x)⟩ for rank-1 tensors z^{(m)} = z_{m,1}⊗…⊗z_{m,m}.

    U : [..., F, L] with F = num_levels(num_levels+1)/2 factor rows stacked
        level-major and U[..., f, i] = ⟨φ(z_f), δφ(x)_i⟩.
    Returns [num_levels+1, ...]; level 0 entry is 1.

    DP over the sequence axis: E[r] after stage a sums the index tuples of
    length a+1 whose last run has length r+1 (runs of at most ``order``).
    """
    ones = torch.ones(U.shape[:-2], dtype=U.dtype, device=U.device)
    levels = [ones]
    p = max(1, order)
    offset = 0
    for m in range(1, num_levels + 1):
        R = min(p, m)
        E = [U[..., offset, :]] + [None] * (R - 1)
        for a in range(1, m):
            Ua = U[..., offset + a, :]
            En = [Ua * ecumsum(_tree_sum(E), -1)] + [None] * (R - 1)
            for r in range(1, min(R, a + 1)):
                if E[r - 1] is not None:
                    En[r] = (Ua / (r + 1)) * E[r - 1]
            E = En
        levels.append(torch.sum(_tree_sum(E), dim=-1))
        offset += m
    return torch.stack(levels, dim=0)


def signature_kern_tens(G, num_levels):
    """⟨z^{(m)}, w^{(m)}⟩ = Π_a ⟨z_{m,a}, w_{m,a}⟩ per level.

    G : [..., F] matched-position factor Grams. Returns [num_levels+1, ...];
    level 0 entry is 1."""
    levels = [torch.ones(G.shape[:-1], dtype=G.dtype, device=G.device)]
    offset = 0
    for m in range(1, num_levels + 1):
        levels.append(torch.prod(G[..., offset : offset + m], dim=-1))
        offset += m
    return torch.stack(levels, dim=0)


def tensor_factor_count(num_levels):
    """Number of factor vectors per inducing tensor (levels 1..num_levels)."""
    return num_levels * (num_levels + 1) // 2
