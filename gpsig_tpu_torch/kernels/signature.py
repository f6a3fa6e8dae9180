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
  data), or past the fused Grams' 1024 DP rows (``plan.MAX_ROWS``),
  through increment matrices built in PyTorch and ``sig_gram.py``, as the
  JAX package's XLA route, the shorter sequence on the kernel's rows, in
  chunks of at most ``PAIRS_CHUNK_BYTES`` recomputed in the backward, a
  symmetric Gram its triangle only.

Past 7 levels (up to 127) the route is the JAX package's too: ``K``, the
two-length Gram and both diagonals through increment matrices built in
PyTorch and ``sig_gram.py`` (which takes ``num_levels + 1 <= 128`` and p =
min(order, num_levels) <= 7), and ``K_tens_vs_seq`` through the plain
``signature_kern_tens_vs_seq`` on the tensor's device, as the JAX package
computes it in XLA, outside any Pallas kernel; autograd is its backward.

A CPU tensor runs those entry points' plain versions through the same
wrappers; a CUDA tensor launches the kernels, forward and backward (every
entry point's ``torch.autograd.Function`` has a backward kernel; the
tuned diagonal's backward is autograd through its plain version, as in
the JAX package). The kernels take every d that device memory holds
(past a block's shared memory they read the sequences from global memory
and the backwards sum in a device workspace) and every sequence length:
the order-1 diagonal and sig_gram in bands of rows, the Grams past 1024
rows through sig_gram. On CUDA only p = min(order, num_levels) > 7 past 7
levels, and a workspace past device memory, raise ``ValueError``. The Kuf
kernels (``K_tens_vs_seq``, forward and backward, order 1 and general)
take any L and every d that device memory holds (``plan.kuf_fwd_plan``,
``plan.kuf_bwd_plan``): the order-1 pair up to d = 3, past that the
general pair at order 1, which past its shared memory reads x and z from
global memory and sums the gradients in a device workspace.

A chain axis. A sampler's C chains evaluate one kernel at C settings of
its hyperparameters: ``raw_lengthscales`` [C, d] and ``raw_variances``
[C, nl+1] (``params.substituted`` puts such tensors, functions of the
sampler's θ, into a kernel built once; ``raw_sigma`` stays a scalar).
``K`` then returns [C, N1, N2] and ``Kdiag`` [C, N], the scaled sequences
[C, N, L, d] going through ONE launch of each tuned order-1 kernel (the
Gram, its diagonal and the Gram's backward), the port's form of the JAX
package's ``jax.vmap`` over the target. Only that route takes a chain
axis (order 1, ``difference=True``, RBF or Linear, ``num_levels <= 7``,
no lags, one sequence length up to ``plan.MAX_ROWS`` rows); every other
route and entry point raises ``ValueError`` rather than loop over chains.
``torch.func.vmap`` is not the tool: ``gauss.stable_cholesky`` reads the
card to choose its jitter, ``precise_linalg`` sets global flags, the
kernels launch through ``ctypes``, and a target that built modules from θ
would make ``nn.Parameter`` leaves that cut the gradient.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gpsig_tpu_torch import config
from gpsig_tpu_torch import params as pr
from gpsig_tpu_torch.kernels import static_kernels as sk
from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import fused_gram as fg
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
from gpsig_tpu_torch.ops.cuda import plan
from gpsig_tpu_torch.ops.cuda import sig_gram as sg
from gpsig_tpu_torch.ops.cuda import tens_seq as ts
from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

#: bytes of the paired difference array one block of the inducing
#: tensors' factor Gram broadcasts (``_factor_gram_matched``)
FACTOR_GRAM_CHUNK_BYTES = 1 << 28
#: bytes of increment matrices one chunk of the pairs route builds
#: (``_pairs_levels``, ``_K_levels_diag``)
PAIRS_CHUNK_BYTES = 1 << 28


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

    def _route(self, device):
        """Which ops/cuda entry points compute this configuration on
        ``device``: "tuned" (order 1, difference, RBF/Linear), "general",
        or past the fused kernels' 7 levels "pairs" (increment matrices and
        sig_gram). Every device takes the same route; the entry points
        launch the kernel on CUDA and run its plain version on the CPU."""
        if self.num_levels > fg.MAX_LEVELS:
            return "pairs"
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
        contiguous; lengthscales [C, d] give [C, N, L, d]."""
        ell = self.lengthscales
        if ell is not None:
            X = X / (ell[:, None, None, :] if ell.ndim == 2 else ell)
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

    # -- the chain axis -----------------------------------------------------
    def _check_chains(self, what, X=None, X2=None):
        """With a chain axis on the hyperparameters, raise ``ValueError``
        unless the tuned order-1 route takes ``what`` on these inputs."""
        C = pr.chain_count(self)
        if C is None:
            return
        route = self._route(None)
        lengths = {self._as_sequences(x).shape[1]
                   for x in (X, X2) if x is not None}
        rows = max(lengths, default=2) - 1
        if (what not in ("K", "Kdiag") or route != "tuned"
                or self.num_lags > 0 or len(lengths) > 1
                or rows > plan.MAX_ROWS):
            raise ValueError(
                f"SignatureKernel.{what}: the hyperparameters carry a chain "
                f"axis (C = {C}), which only the tuned order-1 route's K "
                "and Kdiag take (order 1, difference=True, RBF or Linear "
                f"base, num_levels <= {fg.MAX_LEVELS}, no lags, one "
                f"sequence length of at most {plan.MAX_ROWS + 1} steps); "
                f"this is the {route} route, order {self.order}, "
                f"{self.num_lags} lags, lengths {sorted(lengths)}")

    # -- sequence-vs-sequence ---------------------------------------------
    def _increments(self, G):
        return sigops.incremental_gram(G) if self.difference else G

    def _K_levels(self, X, Y, symmetric=False):
        """[nl+1, N1, N2]; ``symmetric``: Y is X, so the fused Grams solve
        only their triangle of pairs (the Poly offset channel keeps the
        Gram symmetric, though it makes the two sides differ)."""
        route = self._route(X.device)
        rows = X.shape[-2] - 1 if self.difference else X.shape[-2]
        if X.shape[-2] != Y.shape[-2] or rows > plan.MAX_ROWS:
            # sequences of two lengths (inducing sequences against data),
            # or past the fused Grams' rows: the increment matrices are
            # built in PyTorch and reduced by the per-pair DP, whose rows
            # take every length
            route = "pairs"
        if route == "tuned":
            return fg.fused_gram_levels(X, Y, self.num_levels, self._rbf(),
                                        symmetric)
        if route == "general":
            Xq, Yq = self._poly_channels(X, Y)
            return fgho.fused_gram_ho_levels(Xq, Yq, self.num_levels,
                                             self.order, self._kind(),
                                             self.difference, symmetric)
        return self._pairs_levels(X, Y, symmetric)

    def _pairs_levels(self, X, Y, symmetric):
        """[nl+1, N1, N2] through increment matrices built in PyTorch and
        reduced by the per-pair DP: every pair, or with ``symmetric`` the
        triangle i <= j only. Each matrix lies with the shorter sequence on
        its last axis, the kernel's rows (the truncated kernel is symmetric
        under Mᵀ, so a pair's levels do not change). The pairs go in blocks
        of sequences whose matrices take at most PAIRS_CHUNK_BYTES, each
        recomputed in the backward rather than kept."""
        if Y.shape[1] > X.shape[1]:  # the shorter side on the rows
            return self._pairs_levels(Y, X, symmetric).transpose(1, 2)
        (N1, L1, d), (N2, L2, _) = X.shape, Y.shape
        per = max(1, PAIRS_CHUNK_BYTES // (L1 * L2 * X.element_size()))
        if symmetric:  # square blocks, the triangle's mirrored
            ni = nj = max(1, min(N1, math.isqrt(per)))
        else:
            nj = min(N2, per)
            ni = max(1, per // nj)

        def block(A, B, tri):
            G = self.base.gram(A.reshape(-1, d), B.reshape(-1, d))
            M = self._increments(G.reshape(A.shape[0], L1, B.shape[0], L2)
                                 .permute(0, 2, 1, 3))
            if tri:  # a diagonal block of a symmetric Gram: its triangle
                iu, ju = torch.triu_indices(A.shape[0], A.shape[0],
                                            device=X.device)
                return self._sig_gram(M[iu, ju].contiguous())
            return self._sig_gram(M.reshape((-1,) + M.shape[2:]))

        split = ni < N1 or nj < N2
        rows = []
        for i0 in range(0, N1, ni):
            A = X[i0:i0 + ni]
            parts = []
            for j0 in range(0, N2, nj):
                B = Y[j0:j0 + nj]
                if symmetric and j0 + B.shape[0] <= i0:
                    parts.append(None)  # below the diagonal: from its mirror
                    continue
                if symmetric and j0 == i0 and B.shape[0] == A.shape[0]:
                    n = A.shape[0]
                    tri = _chunk(block, split, A, B, True)
                    pos = torch.zeros((n, n), dtype=torch.long,
                                      device=X.device)
                    iu, ju = torch.triu_indices(n, n, device=X.device)
                    pos[iu, ju] = torch.arange(iu.numel(), device=X.device)
                    parts.append(tri[:, torch.maximum(pos, pos.T)])
                else:
                    parts.append(_chunk(block, split, A, B, False).reshape(
                        -1, A.shape[0], B.shape[0]))
            rows.append(parts)
        if symmetric:
            for r, parts in enumerate(rows):
                for c, part in enumerate(parts):
                    if part is None:
                        parts[c] = rows[c][r].transpose(1, 2)
        return torch.cat([torch.cat(parts, dim=2) for parts in rows], dim=1)

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
        # package leaves them to XLA), then the per-pair DP, in chunks of
        # sequences whose matrices take at most PAIRS_CHUNK_BYTES

        def block(Xc):
            return self._sig_gram(self._increments(self.base.gram(Xc, Xc)))

        N = X.shape[0]
        step = max(1, PAIRS_CHUNK_BYTES // (X.shape[1] ** 2
                                            * X.element_size()))
        return torch.cat([_chunk(block, step < N, X[k:k + step])
                          for k in range(0, N, step)], dim=-1)

    def K(self, X, X2=None, return_levels=False):
        """Signature-kernel Gram matrix [N1, N2] ([C, N1, N2] with a chain
        axis on the hyperparameters)."""
        self._check_chains("K", X, X2)
        Xs = self._augment(self._as_sequences(X))
        sym = X2 is None
        Ys = Xs if sym else self._augment(self._as_sequences(X2))
        levels = self._K_levels(Xs, Ys, symmetric=sym)  # [nl+1, N1, N2]
        if self.normalization:
            dx = self._K_levels_diag(Xs)
            dy = dx if sym else self._K_levels_diag(Ys)
            levels = _normalize_levels(levels, dx[..., :, None],
                                       dy[..., None, :])
        weighted = self.level_variances[..., None, None] * levels
        return weighted if return_levels else torch.sum(weighted, dim=-3)

    def seq_covariances(self, Z, X):
        """(K(Z,Z), K(Z,X)) sharing the Z-side diagonal recursion."""
        self._check_chains("seq_covariances")
        Zs = self._augment(self._as_sequences(Z))
        Xs = self._augment(self._as_sequences(X))
        zz = self._K_levels(Zs, Zs, symmetric=True)
        zx = self._K_levels(Zs, Xs)
        if self.normalization:
            dz = self._K_levels_diag(Zs)
            dx = self._K_levels_diag(Xs)
            zz = _normalize_levels(zz, dz[:, :, None], dz[:, None, :])
            zx = _normalize_levels(zx, dz[:, :, None], dx[:, None, :])
        w = self.level_variances[:, None, None]
        return torch.sum(w * zz, dim=0), torch.sum(w * zx, dim=0)

    def Kdiag(self, X, return_levels=False):
        self._check_chains("Kdiag", X)
        X = self._as_sequences(X)
        w = self.level_variances
        if self.normalization:
            # every normalised level's diagonal is exactly 1
            ones = torch.ones((self.num_levels + 1, X.shape[0]),
                              dtype=w.dtype, device=X.device)
            weighted = w[..., None] * ones
            if pr.chain_count(self) is not None:  # lengthscales alone
                weighted = weighted.expand(
                    (pr.chain_count(self),) + ones.shape)
        else:
            weighted = w[..., None] * self._K_levels_diag(self._augment(X))
        return weighted if return_levels else torch.sum(weighted, dim=-2)

    # -- inducing-tensor algebra ------------------------------------------
    # Z layout: [T, F, d] with F = num_levels(num_levels+1)/2 (level-major
    # factor stacking), or [T, F, 2, d] when increments=True.

    def _factor_gram_matched(self, Z1, Z2, increments):
        """Matched-position factor Grams: [T1, T2, F], the base's paired
        evaluation of every position pair, as in the JAX package, in
        blocks of T1 rows whose broadcast [t, T2, F(, 2, 2), d] array stays
        within FACTOR_GRAM_CHUNK_BYTES (the whole array is 58 GB at
        T = 500, d = 963, UEA PEMS-SF's width, where XLA fuses it away).
        Under autograd each block is recomputed in the backward rather than
        kept."""

        def block(A):
            if increments:
                G = self.base.matched(A[:, None, :, :, None, :],
                                      Z2[None, :, :, None, :, :])
                return (G[..., 1, 1] - G[..., 1, 0] - G[..., 0, 1]
                        + G[..., 0, 0])
            return self.base.matched(A[:, None], Z2[None, :])

        row = Z2.numel() * (2 if increments else 1) * Z2.element_size()
        step = max(1, FACTOR_GRAM_CHUNK_BYTES // row)
        if step >= Z1.shape[0]:
            return block(Z1)
        parts = [Z1[i:i + step] for i in range(0, Z1.shape[0], step)]
        if torch.is_grad_enabled():
            return torch.cat([checkpoint(block, A, use_reentrant=False,
                                         preserve_rng_state=False)
                              for A in parts])
        return torch.cat([block(A) for A in parts])

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
        self._check_chains("K_tens")
        Zs = self._scale_tensors(Z)
        G = self._factor_gram_matched(Zs, Zs, increments)
        levels = sigops.signature_kern_tens(G, self.num_levels)
        weighted = (self.level_variances[:, None, None] * levels)[1:]
        return weighted if return_levels else torch.sum(weighted, dim=0)

    def K_tens_diag(self, Z, increments=False, return_levels=False):
        self._check_chains("K_tens_diag")
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
        self._check_chains("K_tens_vs_seq")
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
        # past 7 levels: the plain recursion on the tensor's device, as the
        # JAX package leaves it to XLA
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


def _chunk(block, split, *args):
    """``block(*args)``, one chunk of the pairs route; where the work is
    ``split`` into chunks, under autograd, under ``checkpoint``: the
    backward recomputes the chunk's increment matrices rather than keeping
    every chunk's."""
    if split and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return block(*args)


def _normalize_levels(levels, dx, dy, eps=1e-30):
    """k̃_m = k_m / √(k_m(x,x) k_m(y,y)); level 0 passes through unchanged.
    The levels are the third axis from the end ([..., nl+1, N1, N2])."""
    norm = torch.sqrt(torch.clamp(dx, min=eps) * torch.clamp(dy, min=eps))
    return torch.cat([levels[..., :1, :, :], (levels / norm)[..., 1:, :, :]],
                     dim=-3)


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
