"""Fused order-1 signature Gram and diagonal: CUDA kernels and their plain
PyTorch versions.

Counterpart of ``gpsig_tpu/ops/pallas/fused_gram.py`` (``fused_gram_levels``,
``fused_diag_levels`` and ``fused_gram_levels_bwd_pallas``); the kernels
are in ``csrc/fused_gram.cu`` (Gram), ``csrc/fused_diag.cuh`` (diagonal)
and ``csrc/fused_gram_bwd.cu`` (Gram backward), whose opening notes give
the designs. Semantics: pre-scaled sequences, order 1, ``difference=True``, RBF
(``rbf=True``) or Linear base, ``num_levels <= 7``, RBF distance
unclamped, every d, any length the launch plan takes (``plan.py``: the
Gram and its backward at most ``plan.MAX_ROWS`` increment rows, L = 1025;
the diagonal every L). ``symmetric=True`` says
that Y is X (``K(X)``): the Gram kernel then solves only the pairs on and
above the diagonal and writes each twice, so the output is exactly
symmetric; on the CPU the flag changes nothing. The kernel checks only
that X and Y have one shape: the caller guarantees that k(x_a, y_b) =
k(x_b, y_a), or gets the upper triangle mirrored into the lower one.

The chain axis: X [C, N1, L, d] and Y [C, N2, L, d] are C independent
problems (the chains of a sampler, each with its own lengthscales), and
the Gram, its backward and the diagonal return [C, nl+1, N1, N2], X̄ and Ȳ
[C, N, L, d] and [C, nl+1, N] from ONE launch each: the Gram kernels take
the chain on their grid, the diagonal flattens the chains into its N. This
is the counterpart of the grid axis that ``pallas_call``'s batching rule
adds under ``jax.vmap``. The plain versions take the same leading axis.

Dispatch: a CPU tensor runs the plain version (autograd differentiates
it); a CUDA tensor goes through a ``torch.autograd.Function`` whose forward
launches the kernel and whose backward launches the backward kernel (the
diagonal's backward is autograd through its plain version, as in the JAX
package), or raises. Each launch counts in a module-level integer
(``gram_launches``, ``diag_launches``, ``gram_bwd_launches``) that a run may
reset and read to show the kernels were used.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import _build, plan

MAX_LEVELS = 7
#: most chains one launch of the Gram kernels takes (the grid's y extent)
MAX_CHAINS = 65535

gram_launches = 0
diag_launches = 0
gram_bwd_launches = 0


def _rbf_gram(a, b):
    """exp(-½(|a|² + |b|² - 2⟨a, b⟩)), deliberately unclamped."""
    na = torch.sum(a * a, -1)
    nb = torch.sum(b * b, -1)
    return torch.exp(
        -0.5 * (na[..., :, None] + nb[..., None, :]
                - 2.0 * torch.matmul(a, b.transpose(-1, -2)))
    )


def _levels_after_chains(levels, lead):
    """[nl+1, *lead, ...] → [*lead, nl+1, ...]: the chain axis first."""
    return torch.movedim(levels, 0, len(lead)) if lead else levels


def fused_gram_levels_ref(X, Y, num_levels, rbf=True):
    """Plain version of :func:`fused_gram_levels` (as ``_xla_reference``),
    with the same optional chain axis."""
    *lead, N1, L, d = X.shape
    N2 = Y.shape[-3]
    a = X.reshape(*lead, N1 * L, d)
    b = Y.reshape(*lead, N2 * L, d)
    G = _rbf_gram(a, b) if rbf else a @ b.transpose(-1, -2)
    G = G.reshape(*lead, N1, L, N2, L).transpose(-3, -2)
    return _levels_after_chains(
        sigops.signature_kern(sigops.incremental_gram(G), num_levels), lead)


def fused_diag_levels_ref(X, num_levels, rbf=True):
    """Plain version of :func:`fused_diag_levels` (as
    ``_xla_reference_diag``), with the same optional chain axis."""
    G = _rbf_gram(X, X) if rbf else X @ X.transpose(-1, -2)
    return _levels_after_chains(
        sigops.signature_kern(sigops.incremental_gram(G), num_levels),
        X.shape[:-3])


def fused_gram_levels_bwd_ref(X, Y, g, num_levels, rbf=True):
    """Plain version of :func:`fused_gram_levels_bwd`: autograd through
    :func:`fused_gram_levels_ref`."""
    with torch.enable_grad():
        Xg = X.detach().requires_grad_()
        Yg = Y.detach().requires_grad_()
        out = fused_gram_levels_ref(Xg, Yg, num_levels, rbf)
        return torch.autograd.grad(out, (Xg, Yg), g)


def _check_shapes(name, num_levels, *seqs):
    """Sequences [N, L, d], or [C, N, L, d] with one chain count C, of one
    L and d; returns C (1 without a chain axis)."""
    ndim = seqs[0].ndim
    lead = tuple(seqs[0].shape[:-3]) if ndim in (3, 4) else None
    L, d = seqs[0].shape[-2:] if lead is not None else (None, None)
    for s in seqs:
        if (lead is None or s.ndim != ndim or tuple(s.shape[:-3]) != lead
                or tuple(s.shape[-2:]) != (L, d)):
            raise ValueError(
                f"{name}: sequences must be [N, L, d] (or [C, N, L, d], one "
                f"C) with one L and d; got {[tuple(x.shape) for x in seqs]}"
            )
    C = lead[0] if lead else 1
    if not 1 <= C <= MAX_CHAINS:
        raise ValueError(f"{name}: {C} chains; a launch takes 1.."
                         f"{MAX_CHAINS} (the grid's second axis)")
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"{name}: num_levels must be 1..{MAX_LEVELS}")
    if L < 2:
        raise ValueError(f"{name}: sequence length {L} < 2")
    return C


def _forward_plan(name, X, diag, num_levels=None):
    """The forward kernels' plan for X [N, L, d]: the diagonal's
    (``plan.diag_plan``: every L and d), the Gram's (S, R, W)
    (``plan.gram_fwd_plan`` at ``num_levels``); raises where no launch
    takes the shape (the Gram past ``plan.MAX_ROWS`` rows)."""
    N, L, d = X.shape[-3:]
    rows, item = L - 1, X.element_size()
    if diag:
        return plan.diag_plan(N, L, d, num_levels, item)
    wr = plan.gram_fwd_plan(rows, L, d, 1, num_levels, item, tuned=True)
    smem = plan.gram_fwd_smem(L, d, *(wr or (32, 4, 2)), item)
    plan.check_fits(name, rows, wr, smem, f"L={L}, d={d}")
    return wr


def _backward_plan(name, X, N2=1, chains=1):
    """The backward kernel's launch (``plan.gram_bwd_launch``) for X [N, L,
    d] (or ``chains`` of them) against N2 sequences; raises where no launch
    takes the shape (past ``plan.MAX_ROWS`` rows)."""
    N1, L, d = X.shape[-3:]
    p = plan.gram_bwd_launch(N1, N2, L, d, X.element_size(), chains)
    plan.check_fits(name, L - 1, p, p["smem"] if p else 0, f"L={L}, d={d}")
    if p["work"] * X.element_size() > plan.WORKSPACE_BYTES:
        raise ValueError(
            f"{name}: {chains} chains at L={L}, d={d} need "
            f"{p['work'] * X.element_size()} bytes of X̄ workspace; a launch "
            f"takes at most {plan.WORKSPACE_BYTES} (launch fewer chains)")
    return p


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _check_symmetric(name, symmetric, X, Y):
    if symmetric and X.shape != Y.shape:
        raise ValueError(f"{name}: symmetric needs Y shaped as X; got "
                         f"{tuple(X.shape)}, {tuple(Y.shape)}")


def _launch_gram(X, Y, num_levels, rbf, symmetric):
    global gram_launches
    name = "fused_gram_levels"
    _build.check_inputs(name, (X, Y))
    C = _check_shapes(name, num_levels, X, Y)
    _check_symmetric(name, symmetric, X, Y)
    S, R, W = _forward_plan(name, X, diag=False, num_levels=num_levels)
    (N1, L, d), N2 = X.shape[-3:], Y.shape[-3]
    out = torch.empty(X.shape[:-3] + (num_levels + 1, N1, N2),
                      dtype=X.dtype, device=X.device)
    if N1 and N2:
        _build.launch("gpsig_fused_gram", X.device, X, Y, out, C, N1, N2, L,
                      d, num_levels, rbf, S, R, W, symmetric,
                      X.dtype == torch.float64)
        gram_launches += 1
    return out


def _launch_diag(X, num_levels, rbf):
    global diag_launches
    name = "fused_diag_levels"
    _build.check_inputs(name, (X,))
    _check_shapes(name, num_levels, X)
    lead = X.shape[:-3]
    if lead:  # the chains flattened into one batch of sequences
        out = _launch_diag(X.reshape((-1,) + X.shape[-2:]), num_levels, rbf)
        return _levels_after_chains(
            out.reshape((num_levels + 1,) + X.shape[:-2]), lead)
    N, L, d = X.shape
    out = torch.empty((num_levels + 1, N), dtype=X.dtype, device=X.device)
    if N:
        p = _forward_plan(name, X, diag=True, num_levels=num_levels)
        work = torch.empty(p["work"], dtype=X.dtype, device=X.device) \
            if p["work"] else 0
        _build.launch("gpsig_fused_diag", X.device, X, out, work, N, L, d,
                      num_levels, rbf, p["S"], p["R"], p["W"], p["bands"],
                      p["stage"], p["carry_smem"], p["blocks"],
                      X.dtype == torch.float64)
        diag_launches += 1
    return out


class _GramLevels(torch.autograd.Function):
    """Forward: the Gram kernel. Backward: the Gram backward kernel. X and
    Y may be one tensor; both gradients are returned and autograd adds
    them."""

    @staticmethod
    def forward(ctx, X, Y, num_levels, rbf, symmetric=False):
        ctx.save_for_backward(X, Y)
        ctx.num_levels, ctx.rbf = num_levels, rbf
        return _launch_gram(X, Y, num_levels, rbf, symmetric)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        X, Y = ctx.saved_tensors
        Xbar, Ybar = fused_gram_levels_bwd(X, Y, g.contiguous(),
                                           ctx.num_levels, ctx.rbf)
        need_x, need_y = ctx.needs_input_grad[:2]
        return (Xbar if need_x else None, Ybar if need_y else None, None,
                None, None)


class _DiagLevels(torch.autograd.Function):
    """Forward: the diagonal kernel. Backward: autograd through the plain
    version, recomputed here. This is the JAX package's own route
    (``_diag_vjp_bwd`` differentiates ``_xla_reference_diag``; it has no
    backward kernel for the diagonal), not a fallback."""

    @staticmethod
    def forward(ctx, X, num_levels, rbf):
        ctx.save_for_backward(X)
        ctx.num_levels, ctx.rbf = num_levels, rbf
        return _launch_diag(X, num_levels, rbf)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (X,) = ctx.saved_tensors
        with torch.enable_grad():
            Xg = X.detach().requires_grad_()
            out = fused_diag_levels_ref(Xg, ctx.num_levels, ctx.rbf)
            (Xbar,) = torch.autograd.grad(out, Xg, g)
        return Xbar, None, None


def fused_gram_levels(X, Y, num_levels, rbf=True, symmetric=False):
    """[nl+1, N1, N2] per-level signature kernels of X [N1, L, d] against
    Y [N2, L, d]; ``symmetric``: Y is X, and the kernel solves the triangle
    of pairs (the caller guarantees k(x_a, y_b) = k(x_b, y_a); only the
    shapes are checked). With a chain axis, X [C, N1, L, d] and Y [C, N2,
    L, d] give [C, nl+1, N1, N2] from one launch."""
    if _on_cpu(X, Y):
        return fused_gram_levels_ref(X, Y, num_levels, rbf)
    return _GramLevels.apply(X, Y, num_levels, rbf, symmetric)


def fused_diag_levels(X, num_levels, rbf=True):
    """[nl+1, N] per-level self kernels k_m(x_n, x_n) of X [N, L, d]; X
    [C, N, L, d] gives [C, nl+1, N] from one launch over C·N sequences."""
    if _on_cpu(X):
        return fused_diag_levels_ref(X, num_levels, rbf)
    if not (X.requires_grad and torch.is_grad_enabled()):
        # nothing to differentiate: the kernel without the autograd node
        # (its host time is a share of a call this small)
        return _launch_diag(X, num_levels, rbf)
    return _DiagLevels.apply(X, num_levels, rbf)


def fused_gram_levels_bwd(X, Y, g, num_levels, rbf=True):
    """(X̄, Ȳ): the VJP of :func:`fused_gram_levels` for the level
    cotangents g [nl+1, N1, N2] (counterpart of
    ``fused_gram_levels_bwd_pallas``); with a chain axis g [C, nl+1, N1,
    N2], one launch."""
    global gram_bwd_launches
    if _on_cpu(X, Y, g):
        return fused_gram_levels_bwd_ref(X, Y, g, num_levels, rbf)
    name = "fused_gram_levels_bwd"
    _build.check_inputs(name, (X, Y, g))
    C = _check_shapes(name, num_levels, X, Y)
    (N1, L, d), N2 = X.shape[-3:], Y.shape[-3]
    p = _backward_plan(name, X, N2, C)
    want = X.shape[:-3] + (num_levels + 1, N1, N2)
    if tuple(g.shape) != want:
        raise ValueError(f"{name}: g must be {list(want)}; got "
                         f"{tuple(g.shape)}")
    Xbar = torch.zeros_like(X)
    Ybar = torch.zeros_like(Y)
    if N1 and N2:
        work = torch.empty(p["work"], dtype=X.dtype, device=X.device) \
            if p["work"] else 0
        _build.launch("gpsig_fused_gram_bwd", X.device, X, Y, g, Xbar, Ybar,
                      work, C, N1, N2, L, d, num_levels, rbf, p["S"], p["W"],
                      p["chunk"], p["staged"], p["blocks"],
                      X.dtype == torch.float64)
        gram_bwd_launches += 1
    return Xbar, Ybar
