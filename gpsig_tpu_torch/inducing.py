"""Inducing variables for sparse signature GPs: inducing tensors and
inducing sequences.

Counterpart of ``gpsig_tpu/inducing.py`` (``InducingTensors``,
``InducingSequences`` and their ``make_*_from_data``). Each inducing tensor
is u_z = Σ_m W_m ⟨z^{(m)}, φ_m(x)⟩ with z^{(m)} a rank-1 element of the
level-m tensor space, so

    Kuu[z, w] = Σ_m σ²σ_m² W_m(z) W_m(w) Π_a k(z_{m,a}, w_{m,a})
    Kuf[z, x] = Σ_m σ²σ_m² W_m(z) ⟨z^{(m)}, S̃_m(x)⟩

An inducing sequence is a short learnable pseudo-sequence z [Lz, d] with
u_z = f(z): Kuu = K(Z, Z), Kuf = K(Z, X) under any sequence kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch.config import default_jitter
from gpsig_tpu_torch.kernels.pde import _psd_project
from gpsig_tpu_torch.ops import signature as sigops


def _add_jitter(K, jitter):
    if jitter is None:
        jitter = default_jitter(K.dtype)
    return K + jitter * torch.eye(K.shape[-1], dtype=K.dtype,
                                  device=K.device)


class InducingTensors(nn.Module):
    def __init__(self, raw_Z, raw_W, num_levels, increments=False):
        super().__init__()
        self.raw_Z = nn.Parameter(raw_Z)  # [T, F, d] or [T, F, 2, d]
        # [T, num_levels] mixing weights (learn_weights), else absent
        self.register_parameter(
            "raw_W", None if raw_W is None else nn.Parameter(raw_W)
        )
        self.num_levels = num_levels
        self.increments = increments

    @classmethod
    def create(cls, Z, num_levels, increments=False, learn_weights=False):
        F = sigops.tensor_factor_count(num_levels)
        expect = 4 if increments else 3
        if Z.ndim != expect or Z.shape[1] != F:
            raise ValueError(
                f"Z must be [T, {F}, {'2, ' if increments else ''}d]; got "
                f"{tuple(Z.shape)}"
            )
        W = None
        if learn_weights:
            W = torch.ones((Z.shape[0], num_levels), dtype=Z.dtype,
                           device=Z.device)
        return cls(Z, W, num_levels, increments)

    @property
    def num_inducing(self):
        return self.raw_Z.shape[0]

    def _apply_W(self, levels, side=2):
        """levels: [nl, T, ...]; multiply by W along the tensor axes."""
        if self.raw_W is None:
            return levels
        W = torch.movedim(self.raw_W, -1, 0)  # [nl, T]
        if side == 2:  # [nl, T, T']
            return levels * W[:, :, None] * W[:, None, :]
        return levels * W[:, :, None]  # [nl, T, N]

    def Kuu(self, kernel, jitter=None):
        levels = kernel.K_tens(self.raw_Z, increments=self.increments,
                               return_levels=True)  # [nl, T, T]
        return _add_jitter(torch.sum(self._apply_W(levels, side=2), dim=0),
                           jitter)

    def Kuf(self, kernel, X):
        levels = kernel.K_tens_vs_seq(self.raw_Z, X, increments=self.increments,
                                      return_levels=True)  # [nl, T, N]
        return torch.sum(self._apply_W(levels, side=1), dim=0)


class InducingSequences(nn.Module):
    def __init__(self, raw_Z, joint_psd=False):
        super().__init__()
        self.raw_Z = nn.Parameter(raw_Z)  # [M, Lz, d] pseudo-sequences
        #: jointly PSD-project the [Z; X] training covariance block (see
        #: covariances_full): the stability treatment for finite-difference
        #: (PDE) kernels, whose separately guarded Kuu and raw Kuf disagree
        #: at the finite-difference noise scale
        self.joint_psd = joint_psd

    @classmethod
    def create(cls, Z, joint_psd=False):
        if Z.ndim != 3:
            raise ValueError(f"Z must be [M, Lz, d]; got {tuple(Z.shape)}")
        return cls(Z, joint_psd)

    @property
    def num_inducing(self):
        return self.raw_Z.shape[0]

    def _sym_gram(self, kernel):
        """Symmetric Z-Gram; a kernel with ``K_sym_psd`` (the PDE kernel,
        whose finite-difference Gram is only approximately PSD) is asked
        for its Cholesky-safe Kuu."""
        if hasattr(kernel, "K_sym_psd"):
            return kernel.K_sym_psd(self.raw_Z)
        return kernel.K(self.raw_Z)

    def Kuu(self, kernel, jitter=None):
        return _add_jitter(self._sym_gram(kernel), jitter)

    def Kuf(self, kernel, X):
        return kernel.K(self.raw_Z, X)

    def covariances(self, kernel, X, jitter=None):
        """(Kuu, Kuf) in one pass, the Z-side diagonal computed once where
        the kernel has ``seq_covariances``."""
        if hasattr(kernel, "seq_covariances"):
            Kuu, Kuf = kernel.seq_covariances(self.raw_Z, X)
        else:
            Kuu, Kuf = self._sym_gram(kernel), kernel.K(self.raw_Z, X)
        return _add_jitter(Kuu, jitter), Kuf

    def covariances_full(self, kernel, X, jitter=None):
        """(Kuu, Kuf, Knn) for one training batch, jointly PSD when
        ``joint_psd``: the kernel is evaluated once on [Z; X] (the shorter
        side padded by repeating its last observation: zero increments,
        which leave the kernel unchanged), the joint Gram is projected
        (straight-through, floor 0) and Kuu, Kuf and Knn are sliced from it,
        so Knn − diag(AᵀA) >= 0 by the Schur complement. One (M+B)² solve.
        Without ``joint_psd``, or for a kernel without ``K_sym_psd`` (an
        exact one), it is ``covariances`` and ``Kdiag``."""
        if not (self.joint_psd and hasattr(kernel, "K_sym_psd")):
            Kuu, Kuf = self.covariances(kernel, X, jitter)
            return Kuu, Kuf, kernel.Kdiag(X)
        Z = self.raw_Z
        M, Lz, d = Z.shape
        Xs = X.reshape(X.shape[0], -1, d) if X.ndim == 2 else X
        L = max(Lz, Xs.shape[1])
        J = torch.cat([_pad_last(Z, L), _pad_last(Xs, L)], dim=0)
        Kp = _psd_project(kernel.K(J), 0.0)
        return (_add_jitter(Kp[:M, :M], jitter), Kp[:M, M:],
                torch.diagonal(Kp)[M:])


def _pad_last(X, L):
    """[N, l, d] → [N, L, d], repeating the last observation."""
    if X.shape[1] == L:
        return X
    return torch.cat([X, X[:, -1:].expand(-1, L - X.shape[1], -1)], dim=1)


def make_inducing_tensors_from_data(generator, X, num_tensors, num_levels,
                                    num_features, increments=False,
                                    learn_weights=False, scale=1.0):
    """Initialise inducing-tensor factors from randomly drawn data
    increments. ``generator`` is a ``torch.Generator`` (or None for the
    global one); its draws are made on the generator's device and moved
    to X's."""
    if X.ndim == 2:
        X = X.reshape(X.shape[0], -1, num_features)
    flat = torch.diff(X, dim=1).reshape(-1, X.shape[-1])  # [N(L-1), d]
    F = sigops.tensor_factor_count(num_levels)
    n = num_tensors * F * (2 if increments else 1)
    gen_device = generator.device if generator is not None else "cpu"
    idx = torch.randint(0, flat.shape[0], (n,), generator=generator,
                        device=gen_device).to(X.device)
    Z = flat[idx] * scale
    shape = ((num_tensors, F, 2, num_features) if increments
             else (num_tensors, F, num_features))
    return InducingTensors.create(Z.reshape(shape), num_levels, increments,
                                  learn_weights)


def make_inducing_sequences_from_data(generator, X, num_inducing, length,
                                      num_features):
    """Initialise pseudo-sequences from random data subsequences: rows and
    start points drawn with ``generator`` (a ``torch.Generator``, or None
    for the global one; its draws differ from ``jax.random``'s), made on
    the generator's device and moved to X's. A window running past the end
    repeats the last observation, as the JAX gather clamps its indices."""
    if X.ndim == 2:
        X = X.reshape(X.shape[0], -1, num_features)
    N, L, _ = X.shape
    gen_device = generator.device if generator is not None else "cpu"
    rows = torch.randint(0, N, (num_inducing,), generator=generator,
                         device=gen_device).to(X.device)
    starts = torch.randint(0, max(1, L - length + 1), (num_inducing,),
                           generator=generator, device=gen_device)
    idx = starts.to(X.device)[:, None] + torch.arange(length, device=X.device)
    Z = X[rows[:, None], torch.clamp(idx, max=L - 1)]
    return InducingSequences.create(Z)
