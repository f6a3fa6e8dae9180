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
from gpsig_tpu_torch.ops.cuda import _build, plan
from gpsig_tpu_torch.ops.cuda.fused_gram import _on_cpu

#: the grids the kernels take: dyadic order at most MAX_ORDER, the refined
#: sides' sum (the last diagonal's position) below MAX_POSITIONS and a
#: pair's unrefined cells below 2^31, so that a sweep's positions, a
#: pair's offsets and a block's band rows fit 32 bits (csrc/goursat.cuh's
#: refined_fits; offsets across pairs are 64-bit): past that a sweep takes
#: over 2^28 steps a pair, or a pair 8 GB
MAX_ORDER = 30
MAX_POSITIONS = 1 << 28
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
    if (sum(inc.shape[1:]) << dyadic_order >= MAX_POSITIONS
            or inc.shape[1] * inc.shape[2] >= 1 << 31):
        raise ValueError(f"{name}: refined grid {tuple(inc.shape[1:])} "
                         f"x 2^{dyadic_order}: its sides sum to "
                         f"{MAX_POSITIONS} or more sweep positions, or a "
                         "pair holds 2^31 or more cells")


def _check_memory(name, inc, nbytes):
    """Raise ValueError where a launch's workspace exceeds the device's
    memory."""
    total = torch.cuda.get_device_properties(inc.device).total_memory
    if nbytes > total:
        raise ValueError(f"{name}: {tuple(inc.shape)} needs {nbytes} bytes "
                         f"of workspace; the device holds {total}")


def _launch_fwd(inc, dyadic_order, refined):
    global launches, fused_launches
    name = "goursat_corner_refined" if refined else "goursat_corner_fast"
    _check(name, inc, dyadic_order)
    B, S, T = inc.shape
    out = torch.empty((B,), dtype=inc.dtype, device=inc.device)
    if B:
        p = plan.goursat_fwd_plan(S, T, dyadic_order, inc.element_size())
        if p["smem"] > plan.SMEM_BYTES:
            raise ValueError(f"{name}: {tuple(inc.shape)} at dyadic order "
                             f"{dyadic_order} takes {p['bands']} bands, whose "
                             "progress marks exceed a block's shared memory")
        work = 0
        if p["bands"] > 1 and not p["bnd_smem"]:
            shape = (B, p["W"], (max(S, T) << dyadic_order) + 1)
            _check_memory(name, inc, inc.element_size() * shape[0]
                          * shape[1] * shape[2])
            work = torch.empty(shape, dtype=inc.dtype, device=inc.device)
        args = (p["RL"], p["S"], p["bands"], p["W"], p["stage"],
                p["bnd_smem"], p["cols"], inc.dtype == torch.float64)
        if refined:
            _build.launch("gpsig_goursat_refined", inc.device, inc, out, work,
                          B, S, T, dyadic_order, *args)
            fused_launches += 1
        else:
            _build.launch("gpsig_goursat", inc.device, inc, out, work, B, S,
                          T, *args)
            launches += 1
    return out


#: the gradient's warp design: one warp a pair up to this many refined
#: rows (the shorter refined side) and up to 2^3 refined rows a unrefined
#: row, while its boundary rows and checkpoints take at most
#: WARP_SMEM_BYTES of shared memory
WARP_MAX_ROWS = 256
WARP_MAX_ORDER = 3
WARP_SMEM_BYTES = 48 * 1024


def warp_plan(Su, Tu, dyadic_order, itemsize):
    """The gradient's warp design for a [Su, Tu] pair (``csrc/
    goursat_bwd.cu``), or None where the block design takes it: a dict of
    the refined rows a lane (``RL``: 2, 4 or 8, the fewest that cover the
    rows over 32 lanes, and at least 2^o, so that a lane owns whole
    unrefined rows), the columns a checkpoint segment spans (``K``: 16, or
    8 in float64 past two rows a lane, where the K x RL values it
    recomputes in registers are twice as wide), the lanes that hold rows
    (``lanes``), the segments (``segments``) and the shared memory of one
    warp (``smem``: the row above each lane's rows at every column, and
    every lane's rows at its checkpoint columns; the kernel stages the
    pair's increments beside them where WARP_SMEM_BYTES still takes
    them)."""
    R, C = sorted((Su << dyadic_order, Tu << dyadic_order))
    if not (1 <= R <= WARP_MAX_ROWS and dyadic_order <= WARP_MAX_ORDER):
        return None
    RL = max(1 << dyadic_order, next(r for r in (2, 4, 8) if 32 * r >= R))
    K = 16 if itemsize == 4 or RL == 2 else 8
    lanes = -(-R // RL)
    segments = -(-(C + lanes - 1) // K)
    smem = itemsize * lanes * (C + 1 + segments * RL)
    if smem > WARP_SMEM_BYTES:
        return None
    return dict(RL=RL, K=K, lanes=lanes, segments=segments, smem=smem)


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
    forward recompute, then the adjoint sweep, summed into unrefined cells
    without atomics (two launches give the same bits); one warp a pair
    where ``warp_plan`` takes the shape, else one block a pair."""
    global grad_launches
    if _on_cpu(inc, gbar):
        return goursat_grad_refined_ref(inc, dyadic_order, gbar)
    name = "goursat_grad_refined"
    _check(name, inc, dyadic_order, gbar)
    B, Su, Tu = inc.shape
    if tuple(gbar.shape) != (B,):
        raise ValueError(f"{name}: gbar must be [{B}]; got "
                         f"{tuple(gbar.shape)}")
    warp = warp_plan(Su, Tu, dyadic_order, inc.element_size())
    out = torch.empty_like(inc)  # every cell written once
    elems = 0 if warp else grad_workspace_elems(Su, Tu, dyadic_order,
                                                inc.element_size())
    # the block design's per-refined-row sums, after its u store
    work = 0
    if not warp:
        shape = (B, elems + (Su * Tu << dyadic_order))
        _check_memory(name, inc, inc.element_size() * shape[0] * shape[1])
        work = torch.empty(shape, dtype=inc.dtype, device=inc.device)
    if B:
        _build.launch("gpsig_goursat_grad", inc.device, inc, gbar, out, work,
                      B, Su, Tu, dyadic_order, warp["RL"] if warp else 0,
                      1 if elems else 0, inc.dtype == torch.float64)
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


def _no_grad_needed(inc):
    """No gradient can flow to inc: the forward kernel runs without its
    autograd node (whose host time is a share of a small call)."""
    return not (inc.requires_grad and torch.is_grad_enabled())


def goursat_corner_fast(inc):
    """u(S, T) for given grids inc [..., S, T] → [...]."""
    if _on_cpu(inc):
        return goursat_corner_ref(inc)
    if _no_grad_needed(inc):
        return _flat_apply(_launch_fwd, inc, 0, False)
    return _flat_apply(_CornerFast.apply, inc)


def goursat_corner_refined(inc, dyadic_order):
    """u(S·f, T·f), f = 2^o, of the refined solve from unrefined grids
    inc [..., Su, Tu] → [...]."""
    if _on_cpu(inc):
        return goursat_corner_refined_ref(inc, dyadic_order)
    if _no_grad_needed(inc):
        return _flat_apply(_launch_fwd, inc, dyadic_order, True)
    return _flat_apply(_CornerRefined.apply, inc, dyadic_order)
