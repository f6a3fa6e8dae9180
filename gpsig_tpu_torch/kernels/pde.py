"""Untruncated signature kernel (the SigGPDE path) as a kernel object.

Counterpart of ``gpsig_tpu/kernels/pde.py``: the signature kernel solved
as a Goursat PDE (``ops/goursat.py``) on the double-differenced base Gram,
with adjoint-PDE gradients; ``dyadic_order`` refines the finite-difference
grid 2^o times per step. Parameters are the unconstrained leaves, named as
the JAX fields: ``raw_sigma`` and ``raw_lengthscales`` (absent when
``lengthscales=None``), and a Poly base's ``base.raw_offset``.

The finite-difference Gram is only approximately PSD (negative eigenvalues
of order 1e-3 at ``dyadic_order=0`` on short, rough sequences). Symmetric
Grams can be floored by a straight-through projection: the value is exactly
PSD with min eigenvalue >= the floor; the gradient is that of the
symmetrised Gram (the eigh never enters autograd). ``psd_floor``: ``None``
(the default) leaves ``K(X)`` untouched but makes :meth:`K_sym_psd` (the
Kuu entry point of ``InducingSequences``) project at the dtype's jitter;
``0.0`` turns the guard off; ``> 0`` also projects every symmetric ``K(X)``
at that floor.

On a CUDA tensor every solve launches the Goursat kernels (forward and,
under autograd, the adjoint); on the CPU it runs their plain versions.
Not ported: ``row_block``, which bounded the TPU's VMEM per solve; the
kernels take every pair of a call at once (at the flagship prediction the
[32, 2048, 7, 49] increment tensor is 90 MB in float32).
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch import config
from gpsig_tpu_torch import params as pr
from gpsig_tpu_torch.kernels import static_kernels as sk
from gpsig_tpu_torch.ops import explicit as ex
from gpsig_tpu_torch.ops import goursat
from gpsig_tpu_torch.ops.signature import incremental_gram


def _psd_project(K, floor):
    """Straight-through eigenvalue floor: value = V·max(w, floor)·Vᵀ of the
    symmetrised K (exactly PSD), gradient = that of the symmetrised K."""
    Ks = 0.5 * (K + K.T)
    w, V = torch.linalg.eigh(Ks.detach())
    proj = (V * torch.clamp(w, min=floor)) @ V.T
    proj = 0.5 * (proj + proj.T)
    return Ks + (proj - Ks).detach()


class UntruncatedSignatureKernel(nn.Module):
    def __init__(self, base, raw_sigma, raw_lengthscales, num_features,
                 dyadic_order=0, normalization=False, engine="auto",
                 psd_floor=None):
        super().__init__()
        self.base = base
        self.raw_sigma = nn.Parameter(raw_sigma)
        self.register_parameter(
            "raw_lengthscales",
            None if raw_lengthscales is None else nn.Parameter(
                raw_lengthscales))
        self.num_features = num_features
        self.dyadic_order = dyadic_order
        self.normalization = normalization
        #: 'auto' / 'pallas' = refinement inside the solve, 'scan' = refine
        #: in memory first (ops/goursat.py); checked at the first solve
        self.engine = engine
        self.psd_floor = psd_floor

    @classmethod
    def create(cls, num_features, base=None, lengthscales=1.0, sigma=1.0,
               dyadic_order=0, normalization=False, engine="auto",
               psd_floor=None, dtype=torch.float64, device=None):
        kw = dict(dtype=dtype, device=config.resolve_device(device))
        raw_ell = None
        if lengthscales is not None:
            ell = torch.broadcast_to(torch.as_tensor(lengthscales, **kw),
                                     (num_features,))
            raw_ell = pr.inv_positive(ell).clone()
        return cls(base if base is not None else sk.LinearBase(),
                   pr.inv_positive(torch.as_tensor(sigma, **kw)), raw_ell,
                   num_features, dyadic_order, normalization, engine,
                   psd_floor)

    @property
    def sigma(self):
        return pr.positive(self.raw_sigma)

    @property
    def lengthscales(self):
        if self.raw_lengthscales is None:
            return None
        return pr.positive(self.raw_lengthscales)

    def _scaled(self, X):
        if X.ndim == 2:
            N, Ld = X.shape
            X = X.reshape(N, Ld // self.num_features, self.num_features)
        ell = self.lengthscales
        return X if ell is None else X / ell

    def _solve_pairs(self, X, Y=None):
        """k_sig for all pairs: [N1, N2]. For a symmetric Gram (``Y`` None)
        only the pairs i <= j are solved, and mirrored: the recursion is
        symmetric in its two sequences, so this halves the solves (the JAX
        package solves the whole grid). Autograd through the gather and the
        mirror adds ḡ_ij + ḡ_ji into each solved pair. The mirrored entries
        differ from a full solve's only by the rounding of the double
        difference, whose two orders of subtraction are not equal in
        floating point."""
        sym = Y is None
        Y = X if sym else Y
        N1, L1, d = X.shape
        N2, L2, _ = Y.shape
        G = self.base.gram(X.reshape(N1 * L1, d), Y.reshape(N2 * L2, d))
        inc = incremental_gram(G.reshape(N1, L1, N2, L2).permute(0, 2, 1, 3))
        if not sym:
            return goursat.signature_kernel_pde(inc, self.dyadic_order,
                                                self.engine)
        iu, ju = torch.triu_indices(N1, N1, device=X.device)
        k = goursat.signature_kernel_pde(inc[iu, ju], self.dyadic_order,
                                         self.engine)
        pos = torch.empty((N1, N1), dtype=torch.long, device=X.device)
        pair = torch.arange(iu.shape[0], device=X.device)
        pos[iu, ju] = pair
        pos[ju, iu] = pair
        return k[pos]

    def _diag_raw(self, X):
        inc = incremental_gram(self.base.gram(X, X))  # [N, L-1, L-1]
        return goursat.signature_kernel_pde(inc, self.dyadic_order,
                                            self.engine)

    def _floor_diag(self, X):
        """The self-kernels floored at 1: the true kernel has
        k(x, x) = ||S(x)||² >= 1, so lower estimates are finite-difference
        error. ``torch.maximum`` splits the gradient at a tie as
        ``jnp.maximum`` does (a sequence with zero increments sits at 1)."""
        diag = self._diag_raw(X)
        return torch.maximum(diag, torch.ones_like(diag))

    def K(self, X, X2=None):
        pr.refuse_chains(self, "K")
        Xs = self._scaled(X)
        sym = X2 is None
        Ys = Xs if sym else self._scaled(X2)
        K = self._solve_pairs(Xs, None if sym else Ys)
        if self.normalization:
            dx = self._floor_diag(Xs)
            dy = dx if sym else self._floor_diag(Ys)
            K = K / torch.sqrt(dx[:, None] * dy[None, :])
        K = self.sigma * K
        if sym and self.psd_floor is not None and self.psd_floor > 0.0:
            K = _psd_project(K, self.psd_floor)
        return K

    def K_sym_psd(self, X):
        """Symmetric Gram for the Kuu path, guaranteed PSD: with the default
        ``psd_floor=None`` floored at the dtype's jitter; ``0.0`` opts
        out."""
        K = self.K(X)  # psd_floor > 0 already projected inside K
        if self.psd_floor is None:
            K = _psd_project(K, config.default_jitter(K.dtype))
        return K

    def Kdiag(self, X):
        pr.refuse_chains(self, "Kdiag")
        Xs = self._scaled(X)
        if self.normalization:
            return self.sigma * torch.ones(Xs.shape[0], dtype=Xs.dtype,
                                           device=Xs.device)
        return self.sigma * self._diag_raw(Xs)

    def feature(self, X, num_levels):
        """Ψ(X): [N, 1 + Σ_{m ≤ num_levels} d^m], the rescaled truncated
        signature coordinates of this kernel's Mercer expansion, the VOSF
        ``Kuf`` under the untruncated prior. The kernel is
        k(x, y) = σ·Σ_I S_I(x)S_I(y) over all words I, so

            φ_I(x) = √σ · S_I(x)                (normalization=False)
            φ_I(x) = √σ · S_I(x) / ‖S(x)‖       (normalization=True)

        and any truncated prefix gives inter-domain features with Kuu = I.
        ‖S(x)‖² is the self-kernel by the same finite-difference solve and
        the same floor at 1 as ``K``'s normalisation (on a CUDA tensor the
        refined Goursat kernel, and its adjoint under autograd). Only the
        linear base lifts to explicit coordinates; other bases raise, as in
        the JAX package."""
        if not isinstance(self.base, sk.LinearBase):
            raise NotImplementedError(
                "VOSF features under the untruncated prior require the "
                "linear base kernel (explicit signature coordinates exist "
                f"only for the identity lift); got {type(self.base).__name__}")
        pr.refuse_chains(self, "feature")
        Xs = self._scaled(X)
        levels = ex.truncated_signature(Xs, num_levels)
        N = Xs.shape[0]
        F = torch.sqrt(self.sigma) * torch.cat(
            [Xs.new_ones((N, 1))] + levels, dim=-1)
        if self.normalization:
            F = F / torch.sqrt(self._floor_diag(Xs))[:, None]
        return F
