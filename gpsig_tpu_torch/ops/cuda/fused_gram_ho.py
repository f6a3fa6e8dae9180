"""Fused signature Gram of the general engine: CUDA kernel and its plain
PyTorch version.

Counterpart of ``gpsig_tpu/ops/pallas/fused_gram_ho.py``
(``fused_gram_ho_levels``) and ``fused_gram_ho_bwd.py``
(``fused_gram_ho_bwd_pallas``); the kernels are ``csrc/fused_gram_ho.cu``
and ``csrc/fused_gram_ho_bwd.cuh``, whose opening notes give the designs.
Semantics: pre-scaled sequences, any ``order``, ``difference`` True or
False, base ``kind`` 'linear', 'rbf', 'poly<K>' or 'cosine' (for
'poly<K>' the caller has appended the offset channel: x_extra = 1,
y_extra = c), ``num_levels <= 7``, RBF exponent
unclamped, any length the launch plan takes (``plan.py``). The tuned
order-1 kernel (``fused_gram.py``) takes precedence where it applies; this
one covers every other configuration. ``symmetric=True`` says that the
Gram is symmetric (Y is X, or X with a Poly offset channel: k(x_a, y_b) =
k(x_b, y_a)): the kernel then solves only the pairs on and above the
diagonal and writes each twice; on the CPU the flag changes nothing.
The kernel checks only that X and Y have one shape: the caller guarantees
the symmetry, or gets the upper triangle mirrored into the lower one.

Dispatch: a CPU tensor runs the plain version (autograd differentiates
it); a CUDA tensor goes through a ``torch.autograd.Function`` whose forward
launches the kernel and whose backward launches the backward kernel, or
raises. ``launches`` and ``bwd_launches`` count the two kernels' launches.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import _build, plan
from gpsig_tpu_torch.ops.cuda.fused_gram import (MAX_LEVELS,
                                                 _check_symmetric, _on_cpu)

#: codes of csrc/common.cuh's BaseKind
_KIND_CODES = {"linear": 0, "rbf": 1, "cosine": 2, "poly": 3}

launches = 0
bwd_launches = 0


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


def fused_gram_ho_levels_bwd_ref(X, Y, g, num_levels, order, kind="rbf",
                                 difference=True):
    """Plain version of :func:`fused_gram_ho_levels_bwd`: autograd through
    :func:`fused_gram_ho_levels_ref`."""
    with torch.enable_grad():
        Xg = X.detach().requires_grad_()
        Yg = Y.detach().requires_grad_()
        out = fused_gram_ho_levels_ref(Xg, Yg, num_levels, order, kind,
                                       difference)
        return torch.autograd.grad(out, (Xg, Yg), g)


def _check_shapes(name, num_levels, order, difference, X, Y):
    if X.ndim != 3 or Y.ndim != 3 or X.shape[1:] != Y.shape[1:]:
        raise ValueError(
            f"{name}: sequences must be [N, L, d] with one L and d; got "
            f"{tuple(X.shape)}, {tuple(Y.shape)}")
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"{name}: num_levels must be 1..{MAX_LEVELS}")
    if order < 1:
        raise ValueError(f"{name}: order must be >= 1")
    if X.shape[1] < 2:
        raise ValueError(f"{name}: sequence length {X.shape[1]} < 2")


def _plan(name, X, difference, backward, num_levels=None, order=None,
          N2=1):
    """The plan for X [N, L, d]'s L - 1 (difference) or L rows: the
    forward's (S, R, W) (``plan.gram_fwd_plan`` at p = min(order,
    num_levels)), the backward's launch against N2 sequences (``plan.
    gram_ho_bwd_launch``); raises where no launch takes the shape (past
    ``plan.MAX_ROWS`` rows)."""
    N1, L, d = X.shape
    rows = L - 1 if difference else L
    size = X.element_size()
    if backward:
        p = plan.gram_ho_bwd_launch(N1, N2, rows, L, d, size)
        plan.check_fits(name, rows, p, p["smem"] if p else 0,
                        f"L={L}, d={d}")
        return p
    wr = plan.gram_fwd_plan(rows, L, d, min(order, num_levels), num_levels,
                            size)
    smem = plan.gram_fwd_smem(L, d, *(wr or (32, 4, 2)), size)
    plan.check_fits(name, rows, wr, smem, f"L={L}, d={d}")
    return wr


def _launch(X, Y, num_levels, order, kind, difference, symmetric):
    global launches
    name = "fused_gram_ho_levels"
    _build.check_inputs(name, (X, Y))
    _check_shapes(name, num_levels, order, difference, X, Y)
    _check_symmetric(name, symmetric, X, Y)
    S, R, W = _plan(name, X, difference, False, num_levels, order)
    code, degree = _kind_code(kind)
    (N1, L, d), N2 = X.shape, Y.shape[0]
    out = torch.empty((num_levels + 1, N1, N2), dtype=X.dtype,
                      device=X.device)
    if N1 and N2:
        _build.launch("gpsig_fused_gram_ho", X.device, X, Y, out, N1, N2, L,
                      d, num_levels, order, code, degree, difference, S, R,
                      W, symmetric, X.dtype == torch.float64)
        launches += 1
    return out


class _GramHoLevels(torch.autograd.Function):
    """Forward: the kernel. Backward: the backward kernel. X and Y may be
    one tensor; both gradients are returned and autograd adds them."""

    @staticmethod
    def forward(ctx, X, Y, num_levels, order, kind, difference,
                symmetric=False):
        ctx.save_for_backward(X, Y)
        ctx.args = (num_levels, order, kind, difference)
        return _launch(X, Y, num_levels, order, kind, difference, symmetric)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        X, Y = ctx.saved_tensors
        Xbar, Ybar = fused_gram_ho_levels_bwd(X, Y, g.contiguous(),
                                              *ctx.args)
        need_x, need_y = ctx.needs_input_grad[:2]
        return (Xbar if need_x else None, Ybar if need_y else None, None,
                None, None, None, None)


def fused_gram_ho_levels(X, Y, num_levels, order, kind="rbf",
                         difference=True, symmetric=False):
    """[nl+1, N1, N2] per-level signature kernels of X [N1, L, d] against
    Y [N2, L, d] at any order, for any base kind; ``symmetric``: the Gram
    is symmetric, and the kernel solves the triangle of pairs (the caller
    guarantees k(x_a, y_b) = k(x_b, y_a); only the shapes are checked)."""
    if _on_cpu(X, Y):
        return fused_gram_ho_levels_ref(X, Y, num_levels, order, kind,
                                        difference)
    return _GramHoLevels.apply(X, Y, num_levels, order, kind, difference,
                               symmetric)


def fused_gram_ho_levels_bwd(X, Y, g, num_levels, order, kind="rbf",
                             difference=True):
    """(X̄, Ȳ): the VJP of :func:`fused_gram_ho_levels` for the level
    cotangents g [nl+1, N1, N2] (counterpart of
    ``fused_gram_ho_bwd_pallas``)."""
    global bwd_launches
    if _on_cpu(X, Y, g):
        return fused_gram_ho_levels_bwd_ref(X, Y, g, num_levels, order, kind,
                                            difference)
    name = "fused_gram_ho_levels_bwd"
    _build.check_inputs(name, (X, Y, g))
    _check_shapes(name, num_levels, order, difference, X, Y)
    code, degree = _kind_code(kind)
    (N1, L, d), N2 = X.shape, Y.shape[0]
    p = _plan(name, X, difference, True, N2=N2)
    if tuple(g.shape) != (num_levels + 1, N1, N2):
        raise ValueError(f"{name}: g must be [{num_levels + 1}, {N1}, {N2}];"
                         f" got {tuple(g.shape)}")
    Xbar = torch.zeros_like(X)
    Ybar = torch.zeros_like(Y)
    if N1 and N2:
        # one warp a pair (R rows a lane), or a block of W warps: the two
        # are compiled apart (csrc/fused_gram_ho_bwd*.cu)
        entry, spread = (("gpsig_fused_gram_ho_bwd", p["R"]) if p["W"] == 1
                         else ("gpsig_fused_gram_ho_bwd_block", p["W"]))
        work = torch.empty(p["work"], dtype=X.dtype, device=X.device) \
            if p["work"] else 0
        _build.launch(entry, X.device, X, Y, g, Xbar, Ybar, work, N1, N2, L,
                      d, num_levels, order, code, degree, difference, spread,
                      p["chunk"], p["staged"], p["blocks"],
                      X.dtype == torch.float64)
        bwd_launches += 1
    return Xbar, Ybar
