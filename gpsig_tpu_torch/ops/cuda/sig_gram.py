"""Per-pair signature DP over prebuilt increment matrices: CUDA kernel and
its plain PyTorch version.

Counterpart of ``gpsig_tpu/ops/pallas/sig_gram.py`` (``sig_gram_levels``,
order 1, and ``sig_gram_levels_ho``, order >= 2, with their custom VJPs);
the forwards are ``csrc/sig_gram.cuh``, the backwards
``csrc/sig_gram_bwd.cuh``, whose opening notes give the designs. M [B, L1, L2]
→ [nl+1, B], ``num_levels <= 127`` (``num_levels + 1 <= 128``, as the JAX
kernels), every order, any L1 and L2 whose band carries (or, past order
7, rows' states) fit the workspace: L2, the DP's rows, on a segment of
8-32 lanes up to what one warp holds, in bands on up to 8 warps past it
(``plan.sig_gram_plan``). Up to 7 levels the DP state lives in registers;
past 7 the deep path (``csrc/deep_levels.cuh``) keeps its per-level
carries in shared memory where the block's fit, else in a device
workspace this wrapper allocates, as the bands' carries. Past order
p = min(order, num_levels) = 7 the run-time-order instance
(``csrc/sig_gram_order.cuh``, ``plan.sig_gram_order_plan``) takes a
matrix on a block of warps, a row a thread, its rows' packed state in
shared memory (at p = 8 the grid in registers) or, where that does not
fit, in the workspace; its backward's checkpoints of the carries over
columns are always in the workspace. The kernel
layer uses it for the normalisation diagonal of every configuration that the
tuned ``_diag_kernel`` does not take, on self-increment matrices it builds
in PyTorch (as the JAX package leaves them to XLA), for every Gram between
two lengths, past 7 levels or past the fused Grams' ``plan.MAX_ROWS``
rows, the shorter side on L2. No (8, 128) padding: the kernel reads M as it
is.

Dispatch: a CPU tensor runs the plain version (``signature_kern``,
autograd differentiates it); a CUDA tensor goes through a
``torch.autograd.Function`` whose forward launches the kernel and whose
backward launches the backward kernel, or raises. ``launches`` counts the
order-1 forward's launches (the TPU's ``_fwd_kernel``), ``ho_launches`` the
higher-order one's (``_fwd_kernel_ho``), ``bwd_launches`` and
``ho_bwd_launches`` the backward's (``_bwd_kernel``, ``_bwd_kernel_ho``);
the run-time-order instance's count under ``ho_launches`` and
``ho_bwd_launches``: in a call at p > 7 every launch is the instance's.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import _build, plan
from gpsig_tpu_torch.ops.cuda.fused_gram import _on_cpu

#: most levels the kernels take (num_levels + 1 <= 128)
MAX_LEVELS = plan.SIG_GRAM_MAX_LEVELS

launches = 0
ho_launches = 0
bwd_launches = 0
ho_bwd_launches = 0


def sig_gram_levels_ref(M, num_levels):
    """Plain version of :func:`sig_gram_levels`."""
    return sigops.signature_kern(M, num_levels, 1)


def sig_gram_levels_ho_ref(M, num_levels, order):
    """Plain version of :func:`sig_gram_levels_ho`."""
    return sigops.signature_kern(M, num_levels, order)


def sig_gram_levels_bwd_ref(M, g, num_levels):
    """Plain version of :func:`sig_gram_levels_bwd`: autograd through
    :func:`sig_gram_levels_ref`."""
    return sig_gram_levels_ho_bwd_ref(M, g, num_levels, 1)


def sig_gram_levels_ho_bwd_ref(M, g, num_levels, order):
    """Plain version of :func:`sig_gram_levels_ho_bwd`: autograd through
    :func:`sig_gram_levels_ho_ref`."""
    with torch.enable_grad():
        Mg = M.detach().requires_grad_()
        out = sigops.signature_kern(Mg, num_levels, order)
        (Mbar,) = torch.autograd.grad(out, Mg, g)
    return Mbar


def _check(name, M, num_levels, order, backward, *more):
    """Validate M (and the other tensors ``more``); returns (B, L1, L2) and
    the launch plan (``plan.sig_gram_plan``)."""
    _build.check_inputs(name, (M, *more))
    if M.ndim != 3 or min(M.shape[1:]) < 1:
        raise ValueError(f"{name}: M must be [B, L1, L2]; got "
                         f"{tuple(M.shape)}")
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"{name}: num_levels must be 1..{MAX_LEVELS}")
    if order < 1:
        raise ValueError(f"{name}: order must be >= 1")
    p = min(order, num_levels)
    B, L1, L2 = M.shape
    lp = plan.sig_gram_plan(B, L1, L2, num_levels, p, M.element_size(),
                            backward)
    if lp is None:
        what = ("rows' states and checkpoints" if p > plan.SIG_GRAM_MAX_ORDER
                else "band carries")
        raise ValueError(
            f"{name}: M [{B}, {L1}, {L2}] needs more than "
            f"{plan.WORKSPACE_BYTES} bytes of workspace for one matrix's "
            f"{what}; the kernels take at most that")
    return (B, L1, L2), lp


def _plan_args(M, lp):
    """The workspace (0 where none) and the plan's launch arguments."""
    work = (torch.empty((lp["work"],), dtype=M.dtype, device=M.device)
            if lp["work"] else 0)
    return work, (lp["S"], lp["R"], lp["bands"], lp["W"],
                  int(lp["area_smem"]), lp["blocks"], lp["area"],
                  int(M.dtype == torch.float64))


def _launch(M, num_levels, order):
    global launches, ho_launches
    name = "sig_gram_levels" if order == 1 else "sig_gram_levels_ho"
    (B, L1, L2), lp = _check(name, M, num_levels, order, False)
    out = torch.empty((num_levels + 1, B), dtype=M.dtype, device=M.device)
    if B:
        work, args = _plan_args(M, lp)
        _build.launch("gpsig_sig_gram", M.device, M, out, work, B, L1, L2,
                      num_levels, order, *args)
        if order == 1:
            launches += 1
        else:
            ho_launches += 1
    return out


class _SigGramLevels(torch.autograd.Function):
    """Forward: the kernel. Backward: the backward kernel."""

    @staticmethod
    def forward(ctx, M, num_levels, order):
        ctx.save_for_backward(M)
        ctx.args = (num_levels, order)
        return _launch(M, num_levels, order)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (M,) = ctx.saved_tensors
        num_levels, order = ctx.args
        g = g.contiguous()
        if order == 1:
            Mbar = sig_gram_levels_bwd(M, g, num_levels)
        else:
            Mbar = sig_gram_levels_ho_bwd(M, g, num_levels, order)
        return Mbar, None, None


def sig_gram_levels(M, num_levels):
    """[nl+1, B] order-1 per-level signature kernels of M [B, L1, L2]."""
    if _on_cpu(M):
        return sig_gram_levels_ref(M, num_levels)
    return _SigGramLevels.apply(M, num_levels, 1)


def sig_gram_levels_ho(M, num_levels, order):
    """[nl+1, B] per-level signature kernels of M [B, L1, L2] at order
    >= 2 (p = min(order, num_levels))."""
    if order < 2:
        raise ValueError("sig_gram_levels_ho takes order >= 2; order 1 is "
                         "sig_gram_levels")
    if _on_cpu(M):
        return sig_gram_levels_ho_ref(M, num_levels, order)
    return _SigGramLevels.apply(M, num_levels, order)


def sig_gram_levels_bwd(M, g, num_levels):
    """M̄: the VJP of :func:`sig_gram_levels` for the level cotangents
    g [nl+1, B] (counterpart of the custom VJP's ``_bwd_kernel``)."""
    if _on_cpu(M, g):
        return sig_gram_levels_bwd_ref(M, g, num_levels)
    return _launch_bwd(M, g, num_levels, 1)


def sig_gram_levels_ho_bwd(M, g, num_levels, order):
    """M̄: the VJP of :func:`sig_gram_levels_ho` (``_bwd_kernel_ho``)."""
    if _on_cpu(M, g):
        return sig_gram_levels_ho_bwd_ref(M, g, num_levels, order)
    return _launch_bwd(M, g, num_levels, order)


def _launch_bwd(M, g, num_levels, order):
    global bwd_launches, ho_bwd_launches
    name = "sig_gram_levels_bwd" if order == 1 else "sig_gram_levels_ho_bwd"
    (B, L1, L2), lp = _check(name, M, num_levels, order, True, g)
    if tuple(g.shape) != (num_levels + 1, B):
        raise ValueError(f"{name}: g must be [{num_levels + 1}, {B}]; got "
                         f"{tuple(g.shape)}")
    Mbar = torch.empty_like(M)
    if B:
        work, args = _plan_args(M, lp)
        _build.launch("gpsig_sig_gram_bwd", M.device, M, g, Mbar, work, B, L1,
                      L2, num_levels, order, *args)
        if order == 1:
            bwd_launches += 1
        else:
            ho_bwd_launches += 1
    return Mbar
