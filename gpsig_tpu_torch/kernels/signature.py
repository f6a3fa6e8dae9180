"""Truncated signature kernels over sequences, any order.

Counterpart of ``gpsig_tpu/kernels/signature.py`` (see its docstring for
the options). :class:`SignatureKernel` is an ``nn.Module`` whose
parameters are the *unconstrained* leaves, named as the JAX fields:
``raw_sigma``, ``raw_variances``, ``raw_lengthscales``, ``raw_lags``,
``raw_gamma`` (an absent one is ``None``), and a Poly base's
``base.raw_offset``. Bases: Linear, RBF, Poly, Cosine.

Dispatch mirrors the JAX package's precedence, by device and without size
thresholds, for ``num_levels <= 7``:

- the tuned order-1 kernels (``ops/cuda/fused_gram.py``, ``tens_seq.py``)
  where they qualify: order 1, ``difference=True``, RBF or Linear;
- otherwise the general kernels: the Gram ``fused_gram_ho.py``, Kuf
  ``tens_seq_general.py`` (the Poly offset folded in as a constant
  channel), and for the normalisation diagonal the self-increment matrices
  built in PyTorch and reduced by ``sig_gram.py``;
- a Gram between sequences of two lengths (inducing sequences against
  data) through increment matrices built in PyTorch and ``sig_gram.py``,
  as the JAX package's XLA route: the fused Grams take one length.

A CPU tensor runs those entry points' plain versions through the same
wrappers; a CUDA tensor launches the kernels, forward and backward (every
entry point's ``torch.autograd.Function`` has a backward kernel; the
tuned diagonal's backward is autograd through its plain version, as in
the JAX package). ``num_levels > 7`` runs plain PyTorch on the CPU and
raises ``NotImplementedError`` on CUDA, naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import torch
from torch import nn

from gpsig_tpu_torch import config
from gpsig_tpu_torch import params as pr
from gpsig_tpu_torch.kernels import static_kernels as sk
from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import fused_gram as fg
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
from gpsig_tpu_torch.ops.cuda import sig_gram as sg
from gpsig_tpu_torch.ops.cuda import tens_seq as ts
from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

_NL_GAP = ("num_levels > 7 on CUDA: ROADMAP Queue 2 item 10 (the sig_gram "
           "kernels beyond 7 levels, over an increment tensor built in "
           "PyTorch)")


class SignatureKernel(nn.Module):
    def __init__(self, base, raw_sigma, raw_variances, raw_lengthscales,
                 raw_lags, raw_gamma, num_features, num_levels, order=1,
                 normalization=True, difference=True, num_lags=0):
        super().__init__()
        self.base = base
        self.raw_sigma = nn.Parameter(raw_sigma)
        self.raw_variances = nn.Parameter(raw_variances)
        for name, value in (("raw_lengthscales", raw_lengthscales),
                            ("raw_lags", raw_lags), ("raw_gamma", raw_gamma)):
            self.register_parameter(
                name, None if value is None else nn.Parameter(value)
            )
        self.num_features = num_features
        self.num_levels = num_levels
        self.order = order
        self.normalization = normalization
        self.difference = difference
        self.num_lags = num_lags

    # -- constrained views ------------------------------------------------
    @property
    def sigma(self):
        return pr.positive(self.raw_sigma)

    @property
    def variances(self):
        return pr.positive(self.raw_variances)

    @property
    def lengthscales(self):
        if self.raw_lengthscales is None:
            return None
        return pr.positive(self.raw_lengthscales)

    @property
    def lags(self):
        if self.raw_lags is None:
            return None
        return pr.logistic(self.raw_lags)

    @property
    def gamma(self):
        if self.raw_gamma is None:
            return None
        return pr.positive(self.raw_gamma)

    @property
    def level_variances(self):
        """σ² σ_m², [num_levels+1]."""
        return self.sigma * self.variances

    # -- dispatch ---------------------------------------------------------
    def _rbf(self):
        """The tuned kernels' base flag: True for RBF, False for Linear."""
        return isinstance(self.base, sk.RBFBase)

    def _kind(self):
        """The general kernels' base kind."""
        if isinstance(self.base, sk.RBFBase):
            return "rbf"
        if isinstance(self.base, sk.LinearBase):
            return "linear"
        if isinstance(self.base, sk.PolyBase):
            return f"poly{self.base.degree}"
        if isinstance(self.base, sk.CosineBase):
            return "cosine"
        raise TypeError(f"unknown base kernel {type(self.base).__name__}")

    def _cuda_gap(self):
        """Why the CUDA kernels do not cover this configuration, or
        None."""
        if self.num_levels > fg.MAX_LEVELS:
            return _NL_GAP
        return None

    def _route(self, device):
        """Which ops/cuda entry points (kernel on CUDA, plain version on
        the CPU) compute this configuration: "tuned" (order 1,
        difference, RBF/Linear), "general", or None for plain PyTorch,
        which only a CPU device takes: on CUDA it raises
        NotImplementedError."""
        gap = self._cuda_gap()
        if gap is not None:
            if torch.device(device).type == "cuda":
                raise NotImplementedError(gap)
            return None
        if (self.order == 1 and self.difference
                and isinstance(self.base, (sk.RBFBase, sk.LinearBase))):
            return "tuned"
        return "general"

    def _poly_channels(self, X, Y):
        """Fold a Poly offset in as a constant channel, x_extra = 1 and
        y_extra = c, so the general kernels' ⟨x, y⟩ is ⟨x, y⟩ + c; other
        bases pass through."""
        if not isinstance(self.base, sk.PolyBase):
            return X, Y
        ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
        c = self.base.offset.to(Y.dtype).expand(Y.shape[:-1] + (1,))
        return torch.cat([X, ones], dim=-1), torch.cat([Y, c], dim=-1)

    # -- input handling ---------------------------------------------------
    def _as_sequences(self, X):
        """[N, L*d] or [N, L, d] → [N, L, d]."""
        if X.ndim == 2:
            N, Ld = X.shape
            d = self.num_features
            if Ld % d:
                raise ValueError(
                    f"flattened length {Ld} not divisible by num_features {d}"
                )
            X = X.reshape(N, Ld // d, d)
        return X

    def _augment(self, X):
        """ARD scaling and lag augmentation: [N, L, d] → [N, L, d(1+lags)],
        contiguous."""
        ell = self.lengthscales
        if ell is not None:
            X = X / ell
        if self.num_lags == 0:
            return X.contiguous()
        L = X.shape[-2]
        gamma = self.gamma
        blocks = [gamma[0] * X]
        for s in range(self.num_lags):
            shift = self.lags[s] * (L - 1)
            pos = torch.arange(L, dtype=X.dtype, device=X.device) - shift
            pos = torch.clamp(pos, 0.0, L - 1)
            i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, L - 2)
            frac = pos - i0.to(X.dtype)
            x0 = torch.index_select(X, -2, i0)
            x1 = torch.index_select(X, -2, i0 + 1)
            blocks.append(gamma[1 + s] * (x0 + frac[:, None] * (x1 - x0)))
        return torch.cat(blocks, dim=-1)

    # -- sequence-vs-sequence ---------------------------------------------
    def _increments(self, G):
        return sigops.incremental_gram(G) if self.difference else G

    def _K_levels(self, X, Y):
        route = self._route(X.device)
        if route is not None and X.shape[1] != Y.shape[1]:
            # sequences of two lengths (inducing sequences against data):
            # the fused Grams take one length, so the increment matrices
            # are built in PyTorch and reduced by the per-pair DP
            route = "pairs"
        if route == "tuned":
            return fg.fused_gram_levels(X, Y, self.num_levels, self._rbf())
        if route == "general":
            Xq, Yq = self._poly_channels(X, Y)
            return fgho.fused_gram_ho_levels(Xq, Yq, self.num_levels,
                                             self.order, self._kind(),
                                             self.difference)
        N1, L1, d = X.shape
        N2, L2, _ = Y.shape
        G = self.base.gram(X.reshape(N1 * L1, d), Y.reshape(N2 * L2, d))
        M = self._increments(G.reshape(N1, L1, N2, L2).permute(0, 2, 1, 3))
        if route == "pairs":
            levels = self._sig_gram(M.reshape((N1 * N2,) + M.shape[2:]))
            return levels.reshape(-1, N1, N2)
        # num_levels > 7, CPU only
        return sigops.signature_kern(M, self.num_levels, self.order)

    def _sig_gram(self, M):
        """[nl+1, B] from increment matrices M [B, l1, l2] by the per-pair
        DP."""
        if self.order == 1:
            return sg.sig_gram_levels(M, self.num_levels)
        return sg.sig_gram_levels_ho(M, self.num_levels, self.order)

    def _K_levels_diag(self, X):
        if self._route(X.device) == "tuned":
            return fg.fused_diag_levels(X, self.num_levels, self._rbf())
        # the self-increment matrices [N, l, l] in PyTorch (as the JAX
        # package leaves them to XLA), then the per-pair DP
        return self._sig_gram(self._increments(self.base.gram(X, X)))

    def K(self, X, X2=None, return_levels=False):
        """Signature-kernel Gram matrix [N1, N2]."""
        Xs = self._augment(self._as_sequences(X))
        sym = X2 is None
        Ys = Xs if sym else self._augment(self._as_sequences(X2))
        levels = self._K_levels(Xs, Ys)  # [nl+1, N1, N2]
        if self.normalization:
            dx = self._K_levels_diag(Xs)
            dy = dx if sym else self._K_levels_diag(Ys)
            levels = _normalize_levels(levels, dx[:, :, None], dy[:, None, :])
        weighted = self.level_variances[:, None, None] * levels
        return weighted if return_levels else torch.sum(weighted, dim=0)

    def seq_covariances(self, Z, X):
        """(K(Z,Z), K(Z,X)) sharing the Z-side diagonal recursion."""
        Zs = self._augment(self._as_sequences(Z))
        Xs = self._augment(self._as_sequences(X))
        zz = self._K_levels(Zs, Zs)
        zx = self._K_levels(Zs, Xs)
        if self.normalization:
            dz = self._K_levels_diag(Zs)
            dx = self._K_levels_diag(Xs)
            zz = _normalize_levels(zz, dz[:, :, None], dz[:, None, :])
            zx = _normalize_levels(zx, dz[:, :, None], dx[:, None, :])
        w = self.level_variances[:, None, None]
        return torch.sum(w * zz, dim=0), torch.sum(w * zx, dim=0)

    def Kdiag(self, X, return_levels=False):
        X = self._as_sequences(X)
        w = self.level_variances
        if self.normalization:
            # every normalised level's diagonal is exactly 1
            ones = torch.ones((self.num_levels + 1, X.shape[0]),
                              dtype=w.dtype, device=X.device)
            weighted = w[:, None] * ones
        else:
            weighted = w[:, None] * self._K_levels_diag(self._augment(X))
        return weighted if return_levels else torch.sum(weighted, dim=0)

    # -- inducing-tensor algebra ------------------------------------------
    # Z layout: [T, F, d] with F = num_levels(num_levels+1)/2 (level-major
    # factor stacking), or [T, F, 2, d] when increments=True.

    def _factor_gram_matched(self, Z1, Z2, increments):
        """Matched-position factor Grams: [T1, T2, F]."""
        if increments:
            G = self.base.matched(
                Z1[:, None, :, :, None, :], Z2[None, :, :, None, :, :]
            )  # [T1, T2, F, 2, 2]
            return G[..., 1, 1] - G[..., 1, 0] - G[..., 0, 1] + G[..., 0, 0]
        return self.base.matched(Z1[:, None], Z2[None, :])

    def _scale_tensors(self, Z):
        ell = self.lengthscales
        if ell is None:
            return Z.contiguous()
        if self.num_lags > 0:
            # factors live in the lag-augmented space R^{d(1+lags)}
            d = self.num_features
            reps = Z.shape[-1] // d
            return (Z * self.gamma.repeat_interleave(d)
                    / ell.repeat(reps)).contiguous()
        return (Z / ell).contiguous()

    def K_tens(self, Z, increments=False, return_levels=False):
        """Gram of inducing tensors over levels 1..nl: [T, T]."""
        Zs = self._scale_tensors(Z)
        G = self._factor_gram_matched(Zs, Zs, increments)
        levels = sigops.signature_kern_tens(G, self.num_levels)
        weighted = (self.level_variances[:, None, None] * levels)[1:]
        return weighted if return_levels else torch.sum(weighted, dim=0)

    def K_tens_diag(self, Z, increments=False, return_levels=False):
        Zs = self._scale_tensors(Z)
        if increments:
            G = self.base.matched(Zs[:, :, :, None, :], Zs[:, :, None, :, :])
            G = G[..., 1, 1] - G[..., 1, 0] - G[..., 0, 1] + G[..., 0, 0]
        else:
            G = self.base.matched(Zs, Zs)  # [T, F]
        diag = sigops.signature_kern_tens(G, self.num_levels)  # [nl+1, T]
        weighted = (self.level_variances[:, None] * diag)[1:]
        return weighted if return_levels else torch.sum(weighted, dim=0)

    def K_tens_vs_seq(self, Z, X, increments=False, return_levels=False):
        """Cross-covariance ⟨z, S(x)⟩: [T, N]."""
        Zs = self._scale_tensors(Z)
        Xs = self._augment(self._as_sequences(X))
        route = self._route(Xs.device)
        if route == "tuned":
            levels = ts.fused_tens_seq_levels(
                Zs, Xs, self.num_levels, self._rbf(), increments
            )
            return self._finish_tens_vs_seq(levels, Xs, return_levels)
        if route == "general":
            Xq, Zq = self._poly_channels(Xs, Zs)
            levels = tsg.fused_tens_seq_general_levels(
                Zq, Xq, self.num_levels, self.order, self._kind(),
                increments, self.difference)
            return self._finish_tens_vs_seq(levels, Xs, return_levels)
        # num_levels > 7, CPU only
        N, L, d = Xs.shape
        T, F = Zs.shape[0], Zs.shape[1]
        if increments:
            G = self.base.gram(Zs.reshape(T * F * 2, d), Xs.reshape(N * L, d))
            G = G.reshape(T, F, 2, N, L)
            G = G[:, :, 1] - G[:, :, 0]
        else:
            G = self.base.gram(Zs.reshape(T * F, d), Xs.reshape(N * L, d))
            G = G.reshape(T, F, N, L)
        U = G[..., 1:] - G[..., :-1] if self.difference else G
        U = torch.movedim(U, 1, 2)  # [T, N, F, l]
        levels = sigops.signature_kern_tens_vs_seq(U, self.num_levels,
                                                   self.order)
        return self._finish_tens_vs_seq(levels, Xs, return_levels)

    def _finish_tens_vs_seq(self, levels, Xs, return_levels):
        """Shared normalisation + level weighting for K_tens_vs_seq."""
        if self.normalization:
            dx = self._K_levels_diag(Xs)  # [nl+1, N]
            levels = levels / torch.sqrt(torch.clamp(dx, min=1e-30))[:, None]
        weighted = (self.level_variances[:, None, None] * levels)[1:]
        return weighted if return_levels else torch.sum(weighted, dim=0)


def _normalize_levels(levels, dx, dy, eps=1e-30):
    """k̃_m = k_m / √(k_m(x,x) k_m(y,y)); level 0 passes through unchanged."""
    norm = torch.sqrt(torch.clamp(dx, min=eps) * torch.clamp(dy, min=eps))
    return torch.cat([levels[:1], (levels / norm)[1:]], dim=0)


# ---------------------------------------------------------------------------
# Constructors mirroring the reference's subclass names.
# ---------------------------------------------------------------------------


def _make(base, num_features, num_levels, order=1, normalization=True,
          difference=True, num_lags=0, sigma=1.0, variances=None,
          lengthscales=None, dtype=torch.float64, device=None):
    kw = dict(dtype=dtype, device=config.resolve_device(device))
    nl1 = num_levels + 1
    if variances is None:
        variances = torch.ones((nl1,), **kw)
    else:
        variances = torch.broadcast_to(torch.as_tensor(variances, **kw),
                                       (nl1,)).clone()
    raw_ell = None
    if lengthscales is not None:
        ell = torch.broadcast_to(torch.as_tensor(lengthscales, **kw),
                                 (num_features,))
        raw_ell = pr.inv_positive(ell).clone()
    raw_lags = raw_gamma = None
    if num_lags > 0:
        raw_lags = pr.inv_logistic(torch.linspace(0.1, 0.5, num_lags, **kw))
        raw_gamma = pr.inv_positive(torch.ones((1 + num_lags,), **kw))
    return SignatureKernel(
        base,
        raw_sigma=pr.inv_positive(torch.as_tensor(sigma, **kw)),
        raw_variances=pr.inv_positive(variances),
        raw_lengthscales=raw_ell,
        raw_lags=raw_lags,
        raw_gamma=raw_gamma,
        num_features=num_features,
        num_levels=num_levels,
        order=order,
        normalization=normalization,
        difference=difference,
        num_lags=num_lags,
    )


def SignatureLinear(num_features, num_levels, lengthscales=1.0, **kw):
    return _make(sk.LinearBase(), num_features, num_levels,
                 lengthscales=lengthscales, **kw)


def SignatureRBF(num_features, num_levels, lengthscales=1.0, **kw):
    return _make(sk.RBFBase(), num_features, num_levels,
                 lengthscales=lengthscales, **kw)


def SignaturePoly(num_features, num_levels, lengthscales=1.0, offset=1.0,
                  degree=2, dtype=torch.float64, device=None, **kw):
    base = sk.PolyBase.create(offset=offset, degree=degree, dtype=dtype,
                              device=device)
    return _make(base, num_features, num_levels, lengthscales=lengthscales,
                 dtype=dtype, device=device, **kw)


def SignatureCosine(num_features, num_levels, lengthscales=1.0, **kw):
    return _make(sk.CosineBase(), num_features, num_levels,
                 lengthscales=lengthscales, **kw)
