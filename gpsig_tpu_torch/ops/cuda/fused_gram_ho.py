"""Fused signature Gram of the general engine: CUDA kernel and its plain
PyTorch version.

Counterpart of ``gpsig_tpu/ops/pallas/fused_gram_ho.py``
(``fused_gram_ho_levels``); the kernel is ``csrc/fused_gram_ho.cu``, whose
opening note gives the design. Semantics: pre-scaled sequences, any
``order``, ``difference`` True or False, base ``kind`` 'linear', 'rbf',
'poly<K>' or 'cosine' (for 'poly<K>' the caller has appended the offset
channel: x_extra = 1, y_extra = c), ``num_levels <= 7``, RBF exponent
unclamped. The tuned order-1 kernel (``fused_gram.py``) takes precedence
where it applies; this one covers every other configuration.

Dispatch: a CPU tensor runs the plain version (autograd differentiates
it); a CUDA tensor goes through a ``torch.autograd.Function`` whose forward
launches the kernel and whose backward raises ``NotImplementedError``
(ROADMAP Queue 2 item 7, ``_ho_bwd_kernel``). ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import _build
from gpsig_tpu_torch.ops.cuda.fused_gram import MAX_LEVELS, _on_cpu

#: most rows (L - 1 with difference, L without) the compiled kernels take:
#: 32 lanes at 4 rows per lane
MAX_ROWS = 128
#: codes of csrc/common.cuh's BaseKind
_KIND_CODES = {"linear": 0, "rbf": 1, "cosine": 2, "poly": 3}

launches = 0

_BWD_GAP = ("gradients of the general Gram on CUDA: ROADMAP Queue 2 item 7 "
            "(_ho_bwd_kernel), slice 1 training")


def kind_params(kind):
    """(packs_norms, degree) of a base kind; degree is None unless the kind
    is 'poly<K>' (as ``fused_gram_ho._kind_params``)."""
    if kind in ("rbf", "cosine"):
        return True, None
    if kind == "linear":
        return False, None
    if kind.startswith("poly") and kind[4:].isdigit() and int(kind[4:]) > 0:
        return False, int(kind[4:])
    raise ValueError(f"unknown base kind {kind!r}")


def _kind_code(kind):
    """(BaseKind code, degree) passed to the kernels."""
    _, degree = kind_params(kind)
    return _KIND_CODES["poly" if degree else kind], degree or 0


def base_gram(a, b, kind):
    """k(a_i, b_j) for a [n, d], b [m, d] as the kernels compute it: the
    RBF exponent -|a|²/2 - |b|²/2 + ⟨a, b⟩ unclamped, the cosine's
    distance clamped at 0 under the square root."""
    norms, degree = kind_params(kind)
    dot = a @ b.T
    if not norms:
        return dot if degree is None else dot**degree
    acc = (-0.5 * torch.sum(a * a, -1)[:, None]
           - 0.5 * torch.sum(b * b, -1)[None, :] + dot)
    if kind == "rbf":
        return torch.exp(acc)
    return torch.cos(torch.sqrt(torch.clamp(-2.0 * acc, min=0.0) + 1e-36))


def fused_gram_ho_levels_ref(X, Y, num_levels, order, kind="rbf",
                             difference=True):
    """Plain version of :func:`fused_gram_ho_levels` (as
    ``_xla_reference_ho``)."""
    N1, L, d = X.shape
    N2 = Y.shape[0]
    G = base_gram(X.reshape(N1 * L, d), Y.reshape(N2 * L, d), kind)
    G = G.reshape(N1, L, N2, L).permute(0, 2, 1, 3)
    M = sigops.incremental_gram(G) if difference else G
    return sigops.signature_kern(M, num_levels, order)


def _check_shapes(name, num_levels, order, difference, X, Y):
    if X.ndim != 3 or Y.ndim != 3 or X.shape[1:] != Y.shape[1:]:
        raise ValueError(
            f"{name}: sequences must be [N, L, d] with one L and d; got "
            f"{tuple(X.shape)}, {tuple(Y.shape)}")
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"{name}: num_levels must be 1..{MAX_LEVELS}")
    if order < 1:
        raise ValueError(f"{name}: order must be >= 1")
    L = X.shape[1]
    rows = L - 1 if difference else L
    if L < 2 or rows > MAX_ROWS:
        raise ValueError(
            f"{name}: sequence length {L} outside the compiled range "
            f"2..{MAX_ROWS + 1 if difference else MAX_ROWS}")


def _launch(X, Y, num_levels, order, kind, difference):
    global launches
    name = "fused_gram_ho_levels"
    _build.check_inputs(name, (X, Y))
    _check_shapes(name, num_levels, order, difference, X, Y)
    code, degree = _kind_code(kind)
    (N1, L, d), N2 = X.shape, Y.shape[0]
    out = torch.empty((num_levels + 1, N1, N2), dtype=X.dtype,
                      device=X.device)
    if N1 and N2:
        _build.launch("gpsig_fused_gram_ho", X.device, X, Y, out, N1, N2, L,
                      d, num_levels, order, code, degree, difference,
                      X.dtype == torch.float64)
        launches += 1
    return out


class _GramHoLevels(torch.autograd.Function):
    """Forward: the kernel. Backward: not ported yet, raises."""

    @staticmethod
    def forward(ctx, X, Y, num_levels, order, kind, difference):
        return _launch(X, Y, num_levels, order, kind, difference)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(_BWD_GAP)


def fused_gram_ho_levels(X, Y, num_levels, order, kind="rbf",
                         difference=True):
    """[nl+1, N1, N2] per-level signature kernels of X [N1, L, d] against
    Y [N2, L, d] at any order, for any base kind."""
    if _on_cpu(X, Y):
        return fused_gram_ho_levels_ref(X, Y, num_levels, order, kind,
                                        difference)
    return _GramHoLevels.apply(X, Y, num_levels, order, kind, difference)
