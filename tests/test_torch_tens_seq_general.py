"""Parity of the port's general Kuf (``ops/cuda/tens_seq_general.py``)
with ``gpsig_tpu/ops/pallas/tens_seq_general.py``, every base kind × both
``difference`` × both ``increments`` × order 1-3.

- The plain version against the JAX package's own plain reference
  (``_xla_reference_tens_seq_general``) in float64: rtol 1e-10.
- Against the Pallas kernel (``_tsg_kernel``) in interpret mode: its
  in-kernel matrix products accumulate in float32 even on float64 inputs:
  scaled error 1e-5.

- A float64 model of the forward kernel's blocking (sequences a thread,
  levels one at a time) against both, rtol 1e-10; the launch plans of
  both general Kuf kernels at every d up to 2048.

The CUDA kernel itself is checked on the card by
``test_torch_cuda_kernels.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops.pallas import tens_seq_general as jtsg
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho
from gpsig_tpu_torch.ops.cuda import plan
from gpsig_tpu_torch.ops.cuda import tens_seq_general as ttsg

torch.set_num_threads(1)
KINDS = ["linear", "rbf", "poly2", "poly3", "cosine"]


def _inputs(rng, T, N, L, d, nl, kind, increments):
    """Factor stacks and random walks, with the Poly offset channel
    (x_extra = 1, z_extra = 0.7) that the kernel layer appends."""
    F = nl * (nl + 1) // 2
    Z = 0.4 * rng.standard_normal((T, F, 2, d) if increments else (T, F, d))
    X = (0.3 * rng.standard_normal((N, L, d))).cumsum(1)
    if kind.startswith("poly"):
        Z = np.concatenate([Z, np.full(Z.shape[:-1] + (1,), 0.7)], -1)
        X = np.concatenate([X, np.ones((N, L, 1))], -1)
    return Z, X


def _scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_ref_matches_xla_reference(kind, order, difference):
    rng = np.random.default_rng(order)
    for increments in (False, True):
        Z, X = _inputs(rng, 5, 4, 9, 2, 4, kind, increments)
        want = jtsg._xla_reference_tens_seq_general(
            jnp.asarray(Z), jnp.asarray(X), 4, order, kind, increments,
            difference)
        got = ttsg.fused_tens_seq_general_levels_ref(
            torch.as_tensor(Z), torch.as_tensor(X), 4, order, kind,
            increments, difference)
        assert got.shape == (5, 5, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly2", "cosine"])
def test_wrapper_matches_pallas_interpret(kind, order, difference):
    rng = np.random.default_rng(20 + order)
    increments = order != 2
    Z, X = _inputs(rng, 4, 3, 8, 2, 3, kind, increments)
    want = jtsg.fused_tens_seq_general_levels(
        jnp.asarray(Z), jnp.asarray(X), 3, order, kind, increments,
        difference, interpret=True)
    got = ttsg.fused_tens_seq_general_levels(
        torch.as_tensor(Z), torch.as_tensor(X), 3, order, kind, increments,
        difference)
    assert _scaled_err(got, want) < 1e-5


def test_wrapper_takes_plain_path_on_cpu_without_launching():
    Z, X = _inputs(np.random.default_rng(2), 3, 2, 8, 2, 3, "cosine", True)
    Z, X = torch.as_tensor(Z), torch.as_tensor(X)
    before = ttsg.launches
    torch.testing.assert_close(
        ttsg.fused_tens_seq_general_levels(Z, X, 3, 2, "cosine", True,
                                           False),
        ttsg.fused_tens_seq_general_levels_ref(Z, X, 3, 2, "cosine", True,
                                               False),
        rtol=0, atol=0)
    assert ttsg.launches == before


def test_backward_function_hands_off_to_bwd():
    """The backward is ported: ``_TensSeqGeneralLevels.backward`` hands the
    saved inputs and the cotangent to ``tens_seq_general_bwd`` (the kernel
    on the card, the plain VJP for these CPU tensors) and returns a
    gradient only for the inputs that need one."""
    Z, X = map(torch.as_tensor,
               _inputs(np.random.default_rng(7), 3, 2, 6, 2, 2, "rbf", True))
    g = torch.as_tensor(np.random.default_rng(8).standard_normal((3, 3, 2)))
    args = (2, 2, "rbf", True, True)
    ctx = SimpleNamespace(saved_tensors=(Z, X), args=args,
                          needs_input_grad=(False, True) + (False,) * 5)
    gz, gx, *rest = ttsg._TensSeqGeneralLevels.backward(ctx, g)
    _, want = ttsg.tens_seq_general_bwd_ref(Z, X, g, *args)
    torch.testing.assert_close(gx, want, rtol=1e-12, atol=0)
    assert gz is None and rest == [None] * 5


# -- a model of the general Kuf forward's blocking (tens_seq_general.cu) ----


def kuf_fwd_blocking_model(Z, X, nl, order, kind, increments, difference):
    """The forward kernel's schedule: the plan's blocks of ``threads``
    threads, each thread R sequences of one tensor (sequence n = block ·
    threads · R + r · threads + thread, so a warp's loads of one r are
    contiguous), walking their points once; at each point the levels one
    at a time (they share no factor): the level's factor values by one
    activation of each factor point over the R sequences (pairs
    differenced with increments), U against the previous point's values,
    and the level's stages at the point with the running sums in
    registers."""
    T = Z.shape[0]
    N, L, d = X.shape
    norms, degree = tfgho.kind_params(kind)
    P = min(order, nl)
    zp = Z.reshape(T, -1, d)
    F2 = zp.shape[1]
    fp = plan.kuf_fwd_plan(N, F2, d, nl, X.element_size())
    nt, R = fp["threads"], fp["seqs"]
    blocks = -(-N // (nt * R))
    n = (torch.arange(blocks)[:, None, None] * nt * R
         + torch.arange(R)[None, None, :] * nt
         + torch.arange(nt)[None, :, None])  # [block, thread, r]
    assert sorted(n[n < N].tolist()) == list(range(N))
    idx = n.clamp(max=N - 1).flatten()
    xs = X[idx]  # [blocks · threads · R, L, d]
    nz = -0.5 * (zp * zp).sum(-1) if norms else torch.zeros(T, F2)
    F = nl * (nl + 1) // 2
    prev = torch.zeros(F, T, len(idx), dtype=X.dtype)
    S = {}
    lev = torch.zeros(nl, T, len(idx), dtype=X.dtype)
    for i in range(L):
        x = xs[:, i]
        nx = -0.5 * (x * x).sum(-1) if norms else torch.zeros(len(idx))
        for m in range(1, nl + 1):
            off = m * (m - 1) // 2
            u = []
            for f in range(off, off + m):
                gv = 0
                for h in range(2 if increments else 1):
                    q = 2 * f + h if increments else f
                    acc = zp[:, q] @ x.T + nz[:, q, None] + nx[None]
                    sign = -1.0 if increments and h == 0 else 1.0
                    gv = gv + sign * ttsg_activate(acc, kind, degree)
                u.append(gv - prev[f] if difference else gv)
                prev[f] = gv
            if difference and i == 0:
                continue
            Rm = min(P, m)
            cur = [u[0]] + [0] * (Rm - 1)
            for a in range(1, m):
                key = (m, a - 1)
                Sa = S.get(key, 0)
                live_prev, live = min(Rm, a), min(Rm, a + 1)
                nxt = [u[a] * Sa] + [u[a] / (r + 1) * cur[r - 1]
                                     if r < live else 0
                                     for r in range(1, Rm)]
                S[key] = Sa + sum(cur[:live_prev])
                cur = nxt
            lev[m - 1] += sum(cur[:Rm])
    out = torch.ones(nl + 1, T, N, dtype=X.dtype)
    keep = (n.flatten() < N)
    out[1:, :, n.flatten()[keep]] = lev[:, :, keep]
    return out


def ttsg_activate(acc, kind, degree):
    """csrc/common.cuh's activate."""
    if kind == "rbf":
        return torch.exp(acc)
    if kind == "cosine":
        return torch.cos(torch.sqrt(torch.clamp(-2.0 * acc, min=0.0)
                                    + 1e-36))
    return acc**degree if degree else acc


@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_blocking_model_matches_ref_and_jax(kind, order, difference):
    """The forward kernel's blocking (R sequences a thread, levels one at a
    time) against the plain version and the JAX reference, float64, rtol
    1e-10, both ``increments``, at N on both sides of a block's sequences
    and L = 2 and 150."""
    rng = np.random.default_rng(40 + order)
    nl = 4
    for increments in (True, False):
        for N, L in ((3, 2), (70, 9), (130, 150)):
            Z, X = _inputs(rng, 2, N, L, 2, nl, kind, increments)
            X = X * np.sqrt(9 / L)
            tZ, tX = torch.as_tensor(Z), torch.as_tensor(X)
            got = kuf_fwd_blocking_model(tZ, tX, nl, order, kind, increments,
                                         difference)
            want = ttsg.fused_tens_seq_general_levels_ref(
                tZ, tX, nl, order, kind, increments, difference)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-10, atol=1e-13)
            jwant = jtsg._xla_reference_tens_seq_general(
                jnp.asarray(Z), jnp.asarray(X), nl, order, kind, increments,
                difference)
            np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                       rtol=1e-10, atol=1e-13)


# -- launch plans (ops/cuda/plan.py): every d gets one ----------------------


def _parent_fits(F2, F, d, itemsize, backward):
    """Shared memory of the general Kuf kernels before the plan: the
    forward's factors, half norms and 128 threads' x and factor columns;
    the backward's factors and, per thread at its smallest block of 32, x
    by parity, its factor and Ū buffers and its Z̄ columns."""
    if backward:
        size = F2 * (d + 1) + (3 * d + 4 * F + F2 * (d + 1)) * 32
    else:
        size = F2 * (d + 1) + (d + F) * 128
    return itemsize * size <= plan.SMEM_BYTES


@pytest.mark.parametrize("nl", range(1, 8))
def test_every_d_gets_a_plan(nl):
    """Both general Kuf kernels get a launch plan at every d up to 2048,
    both ``increments`` and both dtypes, keep shared memory wherever the
    kernels before the plan fitted, and stay in the workspace's bound; the
    backward's block is a power of two warps (its column sums rotate)."""
    F = nl * (nl + 1) // 2
    for itemsize in (4, 8):
        seqs = plan.kuf_fwd_seqs(nl, itemsize)
        for increments in (True, False):
            F2 = plan.factor_count(nl, increments)
            for d in range(1, 2049):
                for N in (1, 50, 2048):
                    fp = plan.kuf_fwd_plan(N, F2, d, nl, itemsize)
                    assert fp["smem"] <= plan.SMEM_BYTES
                    assert fp["seqs"] == seqs
                    assert fp["threads"] in (32, 64, 128)
                    assert (fp["threads"] == 128
                            or fp["threads"] * seqs >= N)
                    if _parent_fits(F2, F, d, itemsize, False):
                        assert fp["staged"]
                for T, N in ((500, 50), (1, 1), (64, 3), (3, 2048)):
                    bp = plan.kuf_bwd_plan(T, N, F2, d, itemsize)
                    assert bp is not None and bp["smem"] <= plan.SMEM_BYTES
                    assert bp["threads"] in (32, 64, 128)
                    assert bp["route"] == "general"
                    warps = bp["threads"] // plan.KUF_LANES
                    assert bp["items"] == T * -(-N // (warps * bp["ppw"]))
                    if _parent_fits(F2, F, d, itemsize, True):
                        assert bp["staged"]
                    if bp["staged"]:
                        assert bp["blocks"] == bp["items"]
                    else:
                        assert 1 <= bp["blocks"] <= min(bp["items"],
                                                        plan.KUF_MAX_BLOCKS)
                        assert bp["work"] == bp["blocks"] * bp["threads"] * (
                            plan.kuf_bwd_columns(F2, d))
                        assert (bp["work"] * itemsize
                                <= plan.WORKSPACE_BYTES)


def test_forward_sequences_a_thread():
    """R of the forward (csrc/tens_seq_general.cuh's tsg_seqs): the most of
    4, 2, 1 whose DP state fits 128 registers."""
    assert [plan.kuf_fwd_seqs(nl, 4) for nl in range(1, 8)] == [
        4, 4, 4, 4, 4, 2, 2]
    assert [plan.kuf_fwd_seqs(nl, 8) for nl in range(1, 8)] == [
        4, 4, 4, 2, 2, 1, 1]


def test_backward_plan_at_the_main_shapes():
    """The training shape takes four warps, several pairs a warp and shared
    memory; the L = 150 shape one pair a warp (the grid is small)."""
    bp = plan.kuf_bwd_plan(500, 50, 30, 2, 4)
    assert (bp["threads"], bp["ppw"], bp["staged"]) == (128, 6, True)
    bp = plan.kuf_bwd_plan(64, 50, 20, 2, 4)
    assert (bp["threads"], bp["ppw"], bp["items"]) == (128, 1, 64 * 13)
