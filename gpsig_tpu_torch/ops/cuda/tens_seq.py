"""Fused inducing-tensor-vs-sequence levels (Kuf): CUDA kernel and its
plain PyTorch version.

Counterpart of ``gpsig_tpu/ops/pallas/tens_seq.py``
(``fused_tens_seq_levels`` and ``tens_seq_bwd_pallas``); the kernels are in
``csrc/tens_seq.cuh`` (forward) and ``csrc/tens_seq_bwd.cuh`` (backward),
whose opening notes give the designs. Semantics: pre-scaled inputs, order
1, ``difference=True``, RBF or Linear base, ``num_levels <= 7``, RBF
distance unclamped, any d that device memory holds: the order-1 kernels
take d <= 3 (``plan.KUF_TUNED_MAX_D``); past that (``plan.kuf_fwd_plan``,
``plan.kuf_bwd_plan``) the same function runs on the general Kuf kernels
(``tens_seq_general.py``'s) at order 1, which read x and z from global
memory where shared memory ends and sum the gradients in a workspace.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import _build, plan
from gpsig_tpu_torch.ops.cuda.fused_gram import (MAX_LEVELS, _on_cpu,
                                                  _rbf_gram)

#: grid rows are tensors; CUDA caps gridDim.y at 65535
MAX_TENSORS = 65535

launches = 0
bwd_launches = 0


def fused_tens_seq_levels_ref(Z, X, num_levels, rbf=True, increments=False):
    """Plain version of :func:`fused_tens_seq_levels` (as
    ``_xla_reference_tens_seq``)."""
    T, F = Z.shape[0], Z.shape[1]
    N, L, d = X.shape
    z2 = Z.reshape(-1, d)
    x2 = X.reshape(-1, d)
    G = _rbf_gram(z2, x2) if rbf else z2 @ x2.T
    if increments:
        G = G.reshape(T, F, 2, N, L)
        G = G[:, :, 1] - G[:, :, 0]
    else:
        G = G.reshape(T, F, N, L)
    U = G[..., 1:] - G[..., :-1]
    U = torch.movedim(U, 1, 2)  # [T, N, F, L-1]
    return sigops.signature_kern_tens_vs_seq(U, num_levels)


def tens_seq_bwd_ref(Z, X, g, num_levels, rbf=True, increments=False):
    """Plain version of :func:`tens_seq_bwd`: autograd through
    :func:`fused_tens_seq_levels_ref` (as ``_tens_seq_vjp_bwd`` on the
    CPU)."""
    with torch.enable_grad():
        Zg = Z.detach().requires_grad_()
        Xg = X.detach().requires_grad_()
        out = fused_tens_seq_levels_ref(Zg, Xg, num_levels, rbf, increments)
        return torch.autograd.grad(out, (Zg, Xg), g)


def _check(name, Z, X, num_levels, increments, *more):
    """Validate the kernels' inputs; returns (T, N, L, d)."""
    _build.check_inputs(name, (Z, X, *more))
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"{name}: num_levels must be 1..{MAX_LEVELS}")
    F = sigops.tensor_factor_count(num_levels)
    N, L, d = X.shape if X.ndim == 3 else (None, None, None)
    want = (F, 2, d) if increments else (F, d)
    if X.ndim != 3 or tuple(Z.shape[1:]) != want:
        raise ValueError(
            f"{name}: need Z [T, {', '.join(map(str, want))}] and X [N, L, d];"
            f" got {tuple(Z.shape)}, {tuple(X.shape)}"
        )
    T = Z.shape[0]
    if T > MAX_TENSORS:
        raise ValueError(f"{name}: at most {MAX_TENSORS} tensors per call")
    return T, N, L, d


def _launch(Z, X, num_levels, rbf, increments):
    global launches
    T, N, L, d = _check("fused_tens_seq_levels", Z, X, num_levels,
                        increments)
    out = torch.empty((num_levels + 1, T, N), dtype=X.dtype, device=X.device)
    if T and N:
        fp = plan.kuf_fwd_plan(N, plan.factor_count(num_levels, increments),
                               d, num_levels, X.element_size(), tuned=True)
        Xt = X.permute(1, 2, 0).contiguous()  # [L, d, N]: coalesced x_i
        if fp["route"] == "tuned":
            _build.launch("gpsig_tens_seq", X.device, Z, Xt, out, T, N, L, d,
                          num_levels, rbf, increments,
                          X.dtype == torch.float64, fp["threads"])
        else:
            _build.launch("gpsig_tens_seq_general", X.device, Z, Xt, out, T,
                          N, L, d, num_levels, 1, int(rbf), 0, increments,
                          True, X.dtype == torch.float64, fp["threads"],
                          fp["staged"])
        launches += 1
    return out


class _TensSeqLevels(torch.autograd.Function):
    """Forward: the Kuf kernel. Backward: the Kuf backward kernel."""

    @staticmethod
    def forward(ctx, Z, X, num_levels, rbf, increments):
        ctx.save_for_backward(Z, X)
        ctx.args = (num_levels, rbf, increments)
        return _launch(Z, X, num_levels, rbf, increments)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        Z, X = ctx.saved_tensors
        Zbar, Xbar = tens_seq_bwd(Z, X, g.contiguous(), *ctx.args)
        need_z, need_x = ctx.needs_input_grad[:2]
        return (Zbar if need_z else None, Xbar if need_x else None, None,
                None, None)


def fused_tens_seq_levels(Z, X, num_levels, rbf=True, increments=False):
    """[nl+1, T, N] per-level ⟨z^{(m)}, S_m(x)⟩ for Z [T, F, d] (or
    [T, F, 2, d] with ``increments``) against X [N, L, d]."""
    if _on_cpu(Z, X):
        return fused_tens_seq_levels_ref(Z, X, num_levels, rbf, increments)
    return _TensSeqLevels.apply(Z, X, num_levels, rbf, increments)


def tens_seq_bwd(Z, X, g, num_levels, rbf=True, increments=False):
    """(Z̄, X̄): the VJP of :func:`fused_tens_seq_levels` for the level
    cotangents g [nl+1, T, N] (counterpart of ``tens_seq_bwd_pallas``)."""
    global bwd_launches
    if _on_cpu(Z, X, g):
        return tens_seq_bwd_ref(Z, X, g, num_levels, rbf, increments)
    name = "tens_seq_bwd"
    T, N, L, d = _check(name, Z, X, num_levels, increments, g)
    if tuple(g.shape) != (num_levels + 1, T, N):
        raise ValueError(f"{name}: g must be [{num_levels + 1}, {T}, {N}];"
                         f" got {tuple(g.shape)}")
    Zbar = torch.zeros_like(Z)
    if not (T and N):
        return Zbar, torch.zeros_like(X)
    bp = plan.kuf_bwd_plan(T, N, plan.factor_count(num_levels, increments), d,
                           X.element_size(), tuned=True)
    plan.check_kuf(name, bp, f"d={d}")
    Xbar = torch.zeros_like(X)
    if bp["route"] == "tuned":
        _build.launch("gpsig_tens_seq_bwd", X.device, Z, X, g, Zbar, Xbar, T,
                      N, L, d, num_levels, rbf, increments,
                      X.dtype == torch.float64, bp["ppw"], bp["blocks"])
        bwd_launches += 1
        return Zbar, Xbar
    work = (torch.empty(bp["work"], dtype=X.dtype, device=X.device)
            if bp["work"] else 0)
    _build.launch("gpsig_tens_seq_general_bwd", X.device, Z, X, g, Zbar, Xbar,
                  work, T, N, L, d, num_levels, 1, int(rbf), 0, increments,
                  True, X.dtype == torch.float64, bp["threads"], bp["ppw"],
                  bp["items"], bp["blocks"], bp["staged"])
    bwd_launches += 1
    return Zbar, Xbar
