"""Untruncated signature kernel via the Goursat PDE: the plain wavefront
solve, its adjoint, and the dispatch to the CUDA kernels.

Counterpart of ``gpsig_tpu/ops/goursat.py``. k_sig(x, y) = u(S, T), where
u solves ∂²u/∂s∂t = ⟨ẋ_s, ẏ_t⟩ u with u(0, ·) = u(·, 0) = 1, discretised
on the (S+1)×(T+1) grid by the explicit midpoint scheme

    u[i+1,j+1] = u[i+1,j] + u[i,j+1] - u[i,j]
                 + inc[i,j] · (u[i+1,j] + u[i,j+1]) / 2,

inc[i,j] = ⟨δx_i, δy_j⟩ (the double-differenced base-kernel Gram), the grid
optionally refined 2^dyadic_order times per axis. The gradient solves the
adjoint recursion by a reverse sweep instead of differentiating through
the forward one:

    μ[i,j] = -μ[i+1,j+1] + μ[i,j+1]·(1 + inc[i-1,j]/2)
             + μ[i+1,j]·(1 + inc[i,j-1]/2),        μ[S,T] = ḡ,
    ∂u(S,T)/∂inc[i,j] = μ[i+1,j+1] · (u[i+1,j] + u[i,j+1]) / 2.

The plain functions here (:func:`goursat_grid`, :func:`goursat_corner`,
whose backward is the adjoint sweep) port the JAX package's antidiagonal
``lax.scan`` as a Python loop over the skewed diagonals, vectorised over
the batch. Unlike the JAX scan they also take S = 0 or T = 0 (a sequence
of length 1), where u(S, T) = 1.

Dispatch by device, through ``ops/cuda/goursat.py``:

- :func:`goursat_corner_refined` (``engine="auto"``, and its JAX alias
  ``"pallas"``): on a CUDA tensor the kernel with in-kernel refinement
  (the TPU's ``_fused_kernel``), whose backward is the adjoint kernel;
- :func:`goursat_corner_fast`: on a CUDA tensor the wavefront kernel on a
  given grid (the TPU's ``_kernel``), whose backward is the adjoint kernel
  at dyadic order 0. ``engine="scan"`` means "refine in memory, then the
  unrefined wavefront" in JAX; on the card that wavefront is this kernel,
  reached as ``goursat_corner_fast(refine_increments(inc, o))``, so the
  port has no plain route on a CUDA tensor;
- on a CPU tensor both run the plain sweep (autograd through
  :func:`refine_increments` chains its adjoint to the unrefined grid, as
  the JAX package's scan fallback does).
"""

from __future__ import annotations

import torch

# circular by design: the kernel wrappers' plain versions are this
# module's sweep; both modules only look each other up at call time
from gpsig_tpu_torch.ops.cuda import goursat as cg

ENGINES = ("auto", "pallas", "scan")


def refine_increments(inc, dyadic_order):
    """Refine the increment grid 2^o × per axis (each sub-cell gets
    inc/4^o)."""
    if dyadic_order <= 0:
        return inc
    f = 2**dyadic_order
    inc = torch.repeat_interleave(inc, f, dim=-2)
    inc = torch.repeat_interleave(inc, f, dim=-1)
    return inc / (f * f)


def _skewpad(inc):
    """Skew inc [..., S, T] into [..., S+1, S+T-1] with
    out[..., i, c] = inc[..., i-1, c-(i-1)] (zero elsewhere): column c
    holds antidiagonal c of inc, shifted down one row, which is the
    alignment the wavefront update needs."""
    S, T = inc.shape[-2], inc.shape[-1]
    i = torch.arange(S + 1, device=inc.device)[:, None]
    c = torch.arange(S + T - 1, device=inc.device)[None, :]
    j = c - (i - 1)
    valid = (i >= 1) & (j >= 0) & (j < T)
    out = inc[..., torch.clamp(i - 1, 0, S - 1), torch.clamp(j, 0, T - 1)]
    return torch.where(valid, out, torch.zeros((), dtype=inc.dtype,
                                               device=inc.device))


def _forward_scan(inc):
    """Wavefront forward solve, S, T >= 1. Returns the skewed u diagonals
    u_sk [S+T, ..., S+1] (u_sk[d-1, ..., i] = u[i, d-i] for d = 1..S+T) and
    the corner u[S, T]."""
    S, T = inc.shape[-2], inc.shape[-1]
    batch = inc.shape[:-2]
    kw = dict(dtype=inc.dtype, device=inc.device)
    cols = torch.movedim(_skewpad(inc), -1, 0)  # [S+T-1, ..., S+1]
    i_b = torch.arange(S + 1, device=inc.device)
    zero, one = torch.zeros((), **kw), torch.ones((), **kw)
    prev2 = torch.where(i_b == 0, one, zero).expand(batch + (S + 1,))
    prev = torch.where((i_b == 1) | (i_b == 0), one, zero)  # T >= 1
    prev = prev.expand(batch + (S + 1,))
    diags = [prev]
    for d in range(2, S + T + 1):
        acol = cols[d - 2]
        prev_sh = torch.roll(prev, 1, dims=-1)
        prev2_sh = torch.roll(prev2, 1, dims=-1)
        upd = prev + prev_sh - prev2_sh + acol * (prev + prev_sh) * 0.5
        interior = (i_b >= max(1, d - T)) & (i_b <= min(S, d - 1))
        boundary = ((i_b == 0) & (d <= T)) | (i_b == d)
        curr = torch.where(interior, upd, torch.where(boundary, one, zero))
        diags.append(curr)
        prev2, prev = prev, curr
    return torch.stack(diags), diags[-1][..., S]


def _unskew(u_sk, S, T):
    """Dense grid [..., S+1, T+1] from skewed diagonals [S+T, ..., S+1]
    (diagonals 1..S+T; the (0, 0) cell is 1)."""
    dense = torch.movedim(u_sk, 0, -2)  # [..., S+T, S+1]
    I = torch.arange(S + 1, device=u_sk.device)[:, None]
    J = torch.arange(T + 1, device=u_sk.device)[None, :]
    D = torch.clamp(I + J - 1, 0, S + T - 1)
    u = dense[..., D, I.expand_as(D)]
    return torch.where((I == 0) & (J == 0),
                       torch.ones((), dtype=u.dtype, device=u.device), u)


def _adjoint_scan(inc, gbar):
    """Reverse wavefront solving the adjoint recursion, S, T >= 1; returns
    the dense μ grid [..., S+1, T+1] (zero on the i = 0 and j = 0
    boundaries). Diagonal d holds μ[i, d-i]; for it the skewed column d-1
    gives inc[i-1, d-i] at position i and inc[i, d-i-1] at i+1."""
    S, T = inc.shape[-2], inc.shape[-1]
    kw = dict(dtype=inc.dtype, device=inc.device)
    cols = torch.movedim(_skewpad(inc), -1, 0)
    i_b = torch.arange(S + 1, device=inc.device)
    zero = torch.zeros(gbar.shape + (S + 1,), **kw)
    top = torch.where(i_b == S, gbar[..., None], zero)  # μ diagonal S+T
    nxt, nxt2 = top, zero  # μ diagonals d+1, d+2
    diags = []
    for d in range(S + T - 1, 1, -1):
        acol = cols[d - 1]
        a_up = torch.roll(acol, -1, dims=-1)
        nxt_up = torch.roll(nxt, -1, dims=-1)
        nxt2_up = torch.roll(nxt2, -1, dims=-1)
        upd = -nxt2_up + nxt * (1.0 + 0.5 * acol) + nxt_up * (1.0 + 0.5 * a_up)
        interior = (i_b >= max(1, d - T)) & (i_b <= min(S, d - 1))
        curr = torch.where(interior, upd, zero)
        diags.append(curr)
        nxt2, nxt = nxt, curr
    mu = _unskew(torch.stack([zero, *diags[::-1], top]), S, T)
    I = torch.arange(S + 1, device=inc.device)[:, None]
    J = torch.arange(T + 1, device=inc.device)[None, :]
    return torch.where((I == 0) | (J == 0), torch.zeros((), **kw), mu)


def goursat_grid(inc):
    """Full Goursat solution grid u [..., S+1, T+1] (autograd goes through
    the sweep)."""
    S, T = inc.shape[-2], inc.shape[-1]
    if S == 0 or T == 0:
        return torch.ones(inc.shape[:-2] + (S + 1, T + 1), dtype=inc.dtype,
                          device=inc.device)
    return _unskew(_forward_scan(inc)[0], S, T)


class _Corner(torch.autograd.Function):
    """The plain sweep; its backward is the plain adjoint sweep."""

    @staticmethod
    def forward(ctx, inc):
        S, T = inc.shape[-2], inc.shape[-1]
        if S == 0 or T == 0:
            ctx.save_for_backward(inc, None)
            return torch.ones(inc.shape[:-2], dtype=inc.dtype,
                              device=inc.device)
        u_sk, corner = _forward_scan(inc)
        ctx.save_for_backward(inc, u_sk)
        return corner

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gbar):
        inc, u_sk = ctx.saved_tensors
        if u_sk is None:
            return torch.zeros_like(inc)
        S, T = inc.shape[-2], inc.shape[-1]
        u = _unskew(u_sk, S, T)
        mu = _adjoint_scan(inc, gbar)
        return mu[..., 1:, 1:] * (u[..., 1:, :-1] + u[..., :-1, 1:]) * 0.5


def goursat_corner(inc):
    """u(S, T) for inc [..., S, T] → [...] by the plain sweep, with the
    adjoint-PDE gradient; runs on the tensor's device (the kernels'
    reference)."""
    return _Corner.apply(inc)


def goursat_corner_fast(inc):
    """u(S, T) for a given grid inc [..., S, T] → [...]: the wavefront
    kernel on a CUDA tensor (backward: the adjoint kernel), the plain sweep
    on the CPU."""
    return cg.goursat_corner_fast(inc)


def goursat_corner_refined(inc, dyadic_order):
    """u(S·f, T·f) of the 2^o-refined solve from the *unrefined* increments
    inc [..., Su, Tu] → [...]: the kernel with in-kernel refinement on a
    CUDA tensor (backward: the adjoint kernel, which saves only the
    unrefined inc), refine-then-sweep on the CPU."""
    return cg.goursat_corner_refined(inc, dyadic_order)


def signature_kernel_pde(inc, dyadic_order=0, engine="auto"):
    """Untruncated signature kernel from a raw increment grid
    inc [..., Lx-1, Ly-1] → [...].

    engine: 'auto' (or 'pallas', the JAX name) = refinement inside the
    solve; 'scan' = refine in memory, then the wavefront on the refined
    grid (module docstring)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown goursat engine {engine!r} "
                         "(expected 'auto', 'pallas', or 'scan')")
    if engine == "scan":
        return goursat_corner_fast(refine_increments(inc, dyadic_order))
    return goursat_corner_refined(inc, dyadic_order)
