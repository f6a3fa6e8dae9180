"""Low-rank signature feature maps: Nyström base features and randomised
Hadamard sketches.

Counterpart of ``gpsig_tpu/ops/low_rank.py``:

1. Nyström: landmarks Z in step space, W = k(Z, Z),
   φ(x) = k(x, Z) W^{-1/2} (the pseudo-inverse square root at rank
   ``num_components``), so ⟨φ(x), φ(y)⟩ ≈ k(x, y);
2. per-level sequence features by the first-order recursion in feature
   space: P₁ = Δφ, P_m[i] = Δφ[i] ⊛ Σ_{i'<i} P_{m-1}[i'], where ⊛ is the
   column-pair (Khatri–Rao) product, and F_m = Σ_i P_m[i];
3. rank control: the full column-pair product has c₁c₂ columns; the sketch
   keeps ``rank_bound`` uniformly drawn pairs scaled by √(c₁c₂/r), an
   unbiased inner-product estimate. The pairs are drawn once and shared by
   every sequence (kernel state), so the map stays deterministic.

The JAX package has no Pallas kernel here (elementwise work and one
``eigh``), so plain PyTorch is the port; ``eigh`` stays the library's.
"""

from __future__ import annotations

import math

import torch

from gpsig_tpu_torch.ops.signature import ecumsum


def nystrom_sqrt_inv(W, num_components, jitter=1e-8):
    """W^{-1/2} restricted to the top ``num_components`` eigenpairs: [m, c].
    Eigenvalues at or below 10·jitter get 0. The reciprocal square root is
    taken of the kept eigenvalues only, so a dropped (possibly negative)
    one puts no NaN into the gradient; the values are the JAX package's."""
    W = 0.5 * (W + W.T) + jitter * torch.eye(W.shape[0], dtype=W.dtype,
                                             device=W.device)
    vals, vecs = torch.linalg.eigh(W)
    vals = torch.flip(vals, (0,))[:num_components]
    vecs = torch.flip(vecs, (1,))[:, :num_components]
    keep = vals > 10 * jitter
    inv_sqrt = torch.where(
        keep, 1.0 / torch.sqrt(torch.where(keep, vals, torch.ones_like(vals))),
        torch.zeros_like(vals))
    return vecs * inv_sqrt[None, :]


def nystrom_map(points, landmarks, base, num_components, jitter=1e-8):
    """φ(points): [..., d] → [..., num_components]."""
    W = base.gram(landmarks, landmarks)
    P = nystrom_sqrt_inv(W, num_components, jitter)
    shape = points.shape[:-1]
    Kxz = base.gram(points.reshape(-1, points.shape[-1]), landmarks)
    return (Kxz @ P).reshape(shape + (num_components,))


def draw_pair_indices(generator, c1, c2, rank_bound, device=None):
    """A uniform column-pair sample (i, j), i < c1, j < c2: [2, rank_bound]
    int64, drawn with ``generator`` (a ``torch.Generator``, or None for the
    default one) on its device and moved to ``device`` (default: the
    generator's)."""
    gen_device = "cpu" if generator is None else generator.device
    i = torch.randint(0, c1, (rank_bound,), generator=generator,
                      device=gen_device)
    j = torch.randint(0, c2, (rank_bound,), generator=generator,
                      device=gen_device)
    out = torch.stack([i, j], dim=0)
    return out if device is None else out.to(device)


def lr_hadamard_prod(A, B, pair_idx=None):
    """Column-pair product of feature blocks A [..., c1] and B [..., c2]:
    the full product [..., c1·c2], or with ``pair_idx`` [2, r] the sketched
    [..., r] columns scaled by √(c1·c2/r)."""
    c1, c2 = A.shape[-1], B.shape[-1]
    if pair_idx is None:
        out = A[..., :, None] * B[..., None, :]
        return out.reshape(A.shape[:-1] + (c1 * c2,))
    r = pair_idx.shape[1]
    scale = math.sqrt(c1 * c2 / r)
    return A[..., pair_idx[0]] * B[..., pair_idx[1]] * scale


def signature_features(dphi, num_levels, pair_indices=None):
    """Per-level low-rank sequence features from the step features'
    increments dphi [N, l, c]. ``pair_indices``: None (exact Khatri–Rao
    growth) or a sequence, for levels 2..num_levels, of [2, r] index
    tensors or None (that level exact). Returns [N, c_m], m = 1..nl."""
    feats = [torch.sum(dphi, dim=-2)]
    P = dphi
    for m in range(2, num_levels + 1):
        idx = None if pair_indices is None else pair_indices[m - 2]
        R = ecumsum(P, -2)  # Σ_{i'<i}
        P = lr_hadamard_prod(dphi, R, idx)
        feats.append(torch.sum(P, dim=-2))
    return feats
