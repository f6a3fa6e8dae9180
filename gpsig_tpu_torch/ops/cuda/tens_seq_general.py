"""Fused inducing-tensor-vs-sequence levels (Kuf) of the general engine:
CUDA kernel and its plain PyTorch version.

Counterpart of ``gpsig_tpu/ops/pallas/tens_seq_general.py``
(``fused_tens_seq_general_levels`` and ``tens_seq_general_bwd_pallas``);
the kernels are ``csrc/tens_seq_general.cu`` and
``csrc/tens_seq_general_bwd.cu``, whose opening notes give the designs.
Semantics: pre-scaled inputs, any ``order``, ``difference`` and
``increments`` True or False, base ``kind`` as in ``fused_gram_ho.py``
(for 'poly<K>' the caller has appended the offset channel: x_extra = 1,
z_extra = c), ``num_levels <= 7``, RBF exponent unclamped, any L and any d
that device memory holds (``plan.kuf_fwd_plan``, ``plan.kuf_bwd_plan``).
The tuned order-1 kernel (``tens_seq.py``) takes precedence where it
applies.

Dispatch: a CPU tensor runs the plain version (autograd differentiates
it); a CUDA tensor goes through a ``torch.autograd.Function`` whose forward
launches the kernel and whose backward launches the backward kernel, or
raises. ``launches`` and ``bwd_launches`` count the two kernels' launches.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch.ops import signature as sigops
from gpsig_tpu_torch.ops.cuda import _build, plan
from gpsig_tpu_torch.ops.cuda.fused_gram import _on_cpu
from gpsig_tpu_torch.ops.cuda.fused_gram_ho import _kind_code, base_gram
from gpsig_tpu_torch.ops.cuda.tens_seq import _check

launches = 0
bwd_launches = 0


def fused_tens_seq_general_levels_ref(Z, X, num_levels, order, kind="rbf",
                                      increments=False, difference=True):
    """Plain version of :func:`fused_tens_seq_general_levels` (as
    ``_xla_reference_tens_seq_general``)."""
    T, F = Z.shape[0], Z.shape[1]
    N, L, d = X.shape
    G = base_gram(Z.reshape(-1, d), X.reshape(-1, d), kind)
    if increments:
        G = G.reshape(T, F, 2, N, L)
        G = G[:, :, 1] - G[:, :, 0]
    else:
        G = G.reshape(T, F, N, L)
    U = G[..., 1:] - G[..., :-1] if difference else G
    U = torch.movedim(U, 1, 2)  # [T, N, F, l]
    return sigops.signature_kern_tens_vs_seq(U, num_levels, order)


def tens_seq_general_bwd_ref(Z, X, g, num_levels, order, kind="rbf",
                             increments=False, difference=True):
    """Plain version of :func:`tens_seq_general_bwd`: autograd through
    :func:`fused_tens_seq_general_levels_ref`."""
    with torch.enable_grad():
        Zg = Z.detach().requires_grad_()
        Xg = X.detach().requires_grad_()
        out = fused_tens_seq_general_levels_ref(Zg, Xg, num_levels, order,
                                                kind, increments, difference)
        return torch.autograd.grad(out, (Zg, Xg), g)


def _check_general(name, Z, X, num_levels, order, increments, difference,
                   *more):
    """_check plus the general kernels' own limits; returns (T, N, L, d)."""
    T, N, L, d = _check(name, Z, X, num_levels, increments, *more)
    if order < 1:
        raise ValueError(f"{name}: order must be >= 1")
    if L < (2 if difference else 1):
        raise ValueError(f"{name}: sequence length {L} too short")
    return T, N, L, d


def _launch(Z, X, num_levels, order, kind, increments, difference):
    global launches
    name = "fused_tens_seq_general_levels"
    T, N, L, d = _check_general(name, Z, X, num_levels, order, increments,
                                difference)
    code, degree = _kind_code(kind)
    out = torch.empty((num_levels + 1, T, N), dtype=X.dtype, device=X.device)
    if T and N:
        fp = plan.kuf_fwd_plan(N, plan.factor_count(num_levels, increments),
                               d, num_levels, X.element_size())
        Xt = X.permute(1, 2, 0).contiguous()  # [L, d, N]: coalesced x_i
        _build.launch("gpsig_tens_seq_general", X.device, Z, Xt, out, T, N, L,
                      d, num_levels, order, code, degree, increments,
                      difference, X.dtype == torch.float64, fp["threads"],
                      fp["staged"])
        launches += 1
    return out


class _TensSeqGeneralLevels(torch.autograd.Function):
    """Forward: the kernel. Backward: the backward kernel."""

    @staticmethod
    def forward(ctx, Z, X, num_levels, order, kind, increments, difference):
        ctx.save_for_backward(Z, X)
        ctx.args = (num_levels, order, kind, increments, difference)
        return _launch(Z, X, num_levels, order, kind, increments, difference)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        Z, X = ctx.saved_tensors
        Zbar, Xbar = tens_seq_general_bwd(Z, X, g.contiguous(), *ctx.args)
        need_z, need_x = ctx.needs_input_grad[:2]
        return (Zbar if need_z else None, Xbar if need_x else None, None,
                None, None, None, None)


def fused_tens_seq_general_levels(Z, X, num_levels, order, kind="rbf",
                                  increments=False, difference=True):
    """[nl+1, T, N] per-level ⟨z^{(m)}, S_m(x)⟩ for Z [T, F, d] (or
    [T, F, 2, d] with ``increments``) against X [N, L, d], any order and
    base kind."""
    if _on_cpu(Z, X):
        return fused_tens_seq_general_levels_ref(Z, X, num_levels, order,
                                                 kind, increments,
                                                 difference)
    return _TensSeqGeneralLevels.apply(Z, X, num_levels, order, kind,
                                       increments, difference)


def tens_seq_general_bwd(Z, X, g, num_levels, order, kind="rbf",
                         increments=False, difference=True):
    """(Z̄, X̄): the VJP of :func:`fused_tens_seq_general_levels` for the
    level cotangents g [nl+1, T, N] (counterpart of
    ``tens_seq_general_bwd_pallas``)."""
    global bwd_launches
    if _on_cpu(Z, X, g):
        return tens_seq_general_bwd_ref(Z, X, g, num_levels, order, kind,
                                        increments, difference)
    name = "tens_seq_general_bwd"
    T, N, L, d = _check_general(name, Z, X, num_levels, order, increments,
                                difference, g)
    if tuple(g.shape) != (num_levels + 1, T, N):
        raise ValueError(f"{name}: g must be [{num_levels + 1}, {T}, {N}];"
                         f" got {tuple(g.shape)}")
    code, degree = _kind_code(kind)
    Zbar = torch.zeros_like(Z)
    Xbar = torch.zeros_like(X)
    if T and N:
        bp = plan.kuf_bwd_plan(T, N, plan.factor_count(num_levels, increments),
                               d, X.element_size())
        plan.check_kuf(name, bp, f"d={d}")
        work = (torch.empty(bp["work"], dtype=X.dtype, device=X.device)
                if bp["work"] else 0)
        _build.launch("gpsig_tens_seq_general_bwd", X.device, Z, X, g, Zbar,
                      Xbar, work, T, N, L, d, num_levels, order, code, degree,
                      increments, difference, X.dtype == torch.float64,
                      bp["threads"], bp["ppw"], bp["items"], bp["blocks"],
                      bp["staged"])
        bwd_launches += 1
    return Zbar, Xbar
