"""Goursat (signature-PDE) wavefront: CUDA kernels and their plain PyTorch
versions.

Counterpart of ``gpsig_tpu/ops/pallas/goursat_pallas.py``: ``_kernel``
(the corner on a given increment grid, ``goursat_corner_pallas``) and
``_fused_kernel`` (the corner of the 2^o-refined solve from the unrefined
grid, ``goursat_corner_fused``, and with ``with_grad`` its adjoint-PDE
gradient, ``goursat_grad_fused``). The forwards are ``csrc/goursat.cu``,
the gradient ``csrc/goursat_bwd.cu``, sharing the sweep in
``csrc/goursat.cuh``, whose opening notes give the designs. Inputs are the
increment grids [..., S, T] as they are: none of the TPU layout (the
skewed diagonal-major copy, 128-lane padding, one-hot expansion matmuls,
the VMEM gate) is carried over, and every shape is taken, the gradient's
too (the JAX package falls back to its scan adjoint above its VMEM
budget; the port has no such fallback).

Dispatch: a CPU tensor runs the plain version (``ops/goursat.py``'s
sweep, differentiated by its adjoint); a CUDA tensor goes through a
``torch.autograd.Function`` whose forward launches the forward kernel and
whose backward launches the gradient kernel, or raises. Counters:
``launches`` (the TPU's ``_kernel``: :func:`goursat_corner_fast`),
``fused_launches`` (``_fused_kernel``'s forward:
:func:`goursat_corner_refined`), ``grad_launches`` (``_fused_kernel`` with
``with_grad``: :func:`goursat_grad_refined`, the backward of both).
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.ops import goursat as plain
from gpsig_tpu_torch.ops.cuda import _build
from gpsig_tpu_torch.ops.cuda.fused_gram import _on_cpu

#: largest dyadic order and refined side the kernels take (the gradient's
#: u store is indexed in 64 bits, the sweep's positions in 32)
MAX_ORDER = 10
MAX_REFINED = 1 << 15
#: the gradient keeps its whole u grid in shared memory up to this many
#: bytes (with its three diagonal buffers), else in a global workspace
SMEM_STORE_BYTES = 160 * 1024

launches = 0
fused_launches = 0
grad_launches = 0


def goursat_corner_ref(inc):
    """Plain version of :func:`goursat_corner_fast`."""
    return plain.goursat_corner(inc)


def goursat_corner_refined_ref(inc, dyadic_order):
    """Plain version of :func:`goursat_corner_refined`: refine, then
    sweep."""
    return plain.goursat_corner(plain.refine_increments(inc, dyadic_order))


def goursat_grad_refined_ref(inc, dyadic_order, gbar):
    """Plain version of :func:`goursat_grad_refined`: autograd through
    :func:`goursat_corner_refined_ref`, whose backward is the plain
    adjoint sweep."""
    with torch.enable_grad():
        a = inc.detach().requires_grad_()
        out = goursat_corner_refined_ref(a, dyadic_order)
        (grad,) = torch.autograd.grad(out, a, gbar)
    return grad


def _check(name, inc, dyadic_order, *more):
    """Validate a flat [B, S, T] grid (and the tensors ``more``)."""
    _build.check_inputs(name, (inc, *more))
    if inc.ndim != 3:
        raise ValueError(f"{name}: inc must be [B, S, T]; got "
                         f"{tuple(inc.shape)}")
    if not 0 <= dyadic_order <= MAX_ORDER:
        raise ValueError(f"{name}: dyadic_order must be 0..{MAX_ORDER}")
    if max(inc.shape[1:]) << dyadic_order > MAX_REFINED:
        raise ValueError(f"{name}: refined grid {tuple(inc.shape[1:])} "
                         f"x 2^{dyadic_order} exceeds {MAX_REFINED} per side")


def _launch_fwd(inc, dyadic_order, refined):
    global launches, fused_launches
    name = "goursat_corner_refined" if refined else "goursat_corner_fast"
    _check(name, inc, dyadic_order)
    B, S, T = inc.shape
    out = torch.empty((B,), dtype=inc.dtype, device=inc.device)
    if B:
        f64 = inc.dtype == torch.float64
        if refined:
            _build.launch("gpsig_goursat_refined", inc.device, inc, out, B, S,
                          T, dyadic_order, f64)
            fused_launches += 1
        else:
            _build.launch("gpsig_goursat", inc.device, inc, out, B, S, T, f64)
            launches += 1
    return out


def grad_workspace_elems(Su, Tu, dyadic_order, itemsize):
    """Per-pair elements of the gradient's global u store, 0 where the
    store fits shared memory: the refined grid swept with its shorter side
    R over the threads, (R+1)(C+1) values (plus three (R+1) diagonals) in
    shared memory, or (R+C+1)(R+1) stored diagonal by diagonal in device
    memory."""
    Sr, Tr = Su << dyadic_order, Tu << dyadic_order
    R, C = min(Sr, Tr), max(Sr, Tr)
    if (R + 1) * (C + 4) * itemsize <= SMEM_STORE_BYTES:
        return 0
    return (R + C + 1) * (R + 1)


def goursat_grad_refined(inc, dyadic_order, gbar):
    """ḡ[b] · ∂u_b(S·f, T·f)/∂inc_b for unrefined inc [B, Su, Tu] and
    gbar [B] → [B, Su, Tu] (the TPU's ``goursat_grad_fused`` times ḡ): a
    forward recompute that keeps every u, then the adjoint sweep, summed
    into unrefined cells."""
    global grad_launches
    if _on_cpu(inc, gbar):
        return goursat_grad_refined_ref(inc, dyadic_order, gbar)
    name = "goursat_grad_refined"
    _check(name, inc, dyadic_order, gbar)
    B, Su, Tu = inc.shape
    if tuple(gbar.shape) != (B,):
        raise ValueError(f"{name}: gbar must be [{B}]; got "
                         f"{tuple(gbar.shape)}")
    out = torch.zeros_like(inc)
    if B:
        elems = grad_workspace_elems(Su, Tu, dyadic_order,
                                     inc.element_size())
        work = (torch.empty((B, elems), dtype=inc.dtype, device=inc.device)
                if elems else 0)
        _build.launch("gpsig_goursat_grad", inc.device, inc, gbar, out, work,
                      B, Su, Tu, dyadic_order, inc.dtype == torch.float64)
        grad_launches += 1
    return out


class _CornerFast(torch.autograd.Function):
    """Forward: the wavefront kernel. Backward: the gradient kernel at
    dyadic order 0."""

    @staticmethod
    def forward(ctx, inc):
        ctx.save_for_backward(inc)
        return _launch_fwd(inc, 0, refined=False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (inc,) = ctx.saved_tensors
        return goursat_grad_refined(inc, 0, g.contiguous())


class _CornerRefined(torch.autograd.Function):
    """Forward: the kernel with in-kernel refinement. Backward: the
    gradient kernel; the saved tensor is the unrefined inc."""

    @staticmethod
    def forward(ctx, inc, dyadic_order):
        ctx.save_for_backward(inc)
        ctx.dyadic_order = dyadic_order
        return _launch_fwd(inc, dyadic_order, refined=True)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (inc,) = ctx.saved_tensors
        return goursat_grad_refined(inc, ctx.dyadic_order,
                                    g.contiguous()), None


def _flat_apply(fn, inc, *args):
    """``fn`` on inc [..., S, T] flattened to [B, S, T] → [...]."""
    batch, (S, T) = inc.shape[:-2], inc.shape[-2:]
    out = fn(inc.reshape((batch.numel(), S, T)).contiguous(), *args)
    return out.reshape(batch)


def goursat_corner_fast(inc):
    """u(S, T) for given grids inc [..., S, T] → [...]."""
    if _on_cpu(inc):
        return goursat_corner_ref(inc)
    return _flat_apply(_CornerFast.apply, inc)


def goursat_corner_refined(inc, dyadic_order):
    """u(S·f, T·f), f = 2^o, of the refined solve from unrefined grids
    inc [..., Su, Tu] → [...]."""
    if _on_cpu(inc):
        return goursat_corner_refined_ref(inc, dyadic_order)
    return _flat_apply(_CornerRefined.apply, inc, dyadic_order)
