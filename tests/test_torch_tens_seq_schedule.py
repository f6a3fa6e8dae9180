"""Float64 models of the order-1 Kuf kernels' schedules
(``csrc/tens_seq.cuh``, ``csrc/tens_seq_bwd.cuh``) and their launch plans
(``ops/cuda/plan.py``), on the CPU.

- The forward's: the plan's blocks of threads, one sequence a thread
  (n = block · threads + thread) and the ragged edge, each factor point a
  4-vector record against (x, 1) up to d = 3 and past it ceil(d / 4)
  chunks of z and a half norm, the levels one at a time, and in float32
  log2(e) folded into the records so the exponential is 2^a.
- The backward's: a pair's time axis over 32 lanes at KP points a lane in
  chunks, pass 1 to the last chunk's start carries, pass 2 rebuilding each
  chunk's start carries by subtraction, Ū of a chunk's first point carried
  across the chunk edge, each lane's Z̄ column summed over the pairs of the
  plan's two-warp blocks, X̄ of the owned slots. The C++ constants the plans
  mirror are read from the sources.

Each is held against the plain versions (``ops/cuda/tens_seq.py``) and the
JAX package on the same numpy-seeded inputs: ``_xla_reference_tens_seq``
for the forward, ``jax.vjp`` of its ``fused_tens_seq_levels`` (the Pallas
forward in interpret mode, whose VJP on the CPU is the reference's) and of
``_xla_reference_tens_seq`` for the backward; rtol 1e-10 (one function,
the summation order differs). The lengths cross one, two and three chunks
and their edges. The CUDA kernels themselves are checked on the card by
``test_torch_cuda_kernels.py``.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops.pallas import tens_seq as jts
from gpsig_tpu_torch.ops.cuda import plan
from gpsig_tpu_torch.ops.cuda import tens_seq as tts

torch.set_num_threads(1)
LOG2E = 1.0 / math.log(2.0)
LENGTHS = [2, 3, 50, 65, 66, 129, 150]


def _inputs(seed, T, N, L, d, nl, increments):
    rng = np.random.default_rng(seed)
    F = nl * (nl + 1) // 2
    Z = 0.4 * rng.standard_normal((T, F, 2, d) if increments else (T, F, d))
    X = (0.3 * np.sqrt(9 / max(L, 9)) * rng.standard_normal((N, L, d))
         ).cumsum(1)
    g = rng.standard_normal((nl + 1, T, N))
    return Z, X, g


def _records(Z, d, rbf, scale):
    """The staged factor points: (scale z, scale (-|z|^2/2)) zero-padded to
    a 4-vector, [T, F2, 4]."""
    T = Z.shape[0]
    zp = Z.reshape(T, -1, d)
    rec = torch.zeros(T, zp.shape[1], 4, dtype=Z.dtype)
    rec[..., :d] = scale * zp
    if rbf:
        rec[..., 3] = -0.5 * scale * (zp * zp).sum(-1)
    return rec


def _activate(a, rbf, fold):
    if not rbf:
        return a
    return torch.exp2(a) if fold else torch.exp(a)


def kuf1_fwd_schedule_model(Z, X, nl, rbf, increments, fold):
    """The order-1 forward kernel's schedule (tens_seq.cuh): the plan's
    blocks of ``threads`` threads, one sequence a thread, walking its
    points once with x_i as (x, 1) against the records (past d = 3: the
    accumulators of every factor point summed over ceil(d / 4) chunks of z,
    then the half norms added); at each point the levels one at a time: the
    level's accumulators, the activation
    (``fold``: 2^a on operands scaled by log2(e), the float32 kernel's), g,
    U against the previous point and the order-1 DP, descending the
    stages."""
    T = Z.shape[0]
    N, L, d = X.shape
    P = 2 if increments else 1
    F = nl * (nl + 1) // 2
    fp = plan.kuf_fwd_plan(N, P * F, d, nl, X.element_size(), tuned=True)
    assert (fp["route"], fp["seqs"]) == ("tuned", 1)
    nt = fp["threads"]
    blocks = -(-N // nt)
    n = (torch.arange(blocks)[:, None] * nt
         + torch.arange(nt)[None, :])  # [block, thread]
    assert sorted(n[n < N].tolist()) == list(range(N))
    idx = n.clamp(max=N - 1).flatten()
    scale = LOG2E if rbf and fold else 1.0
    nx = (-0.5 * scale * (X[idx] ** 2).sum(-1) if rbf
          else torch.zeros(len(idx), L, dtype=X.dtype))
    if d <= plan.KUF_TUNED_MAX_D:
        rec = _records(Z, d, rbf, scale)
        xs = torch.zeros(len(idx), L, 4, dtype=X.dtype)
        xs[..., :d] = X[idx]
        xs[..., 3] = 1.0
    else:  # chunks of z, the half norms apart
        zp = Z.reshape(T, P * F, d)
        rec = torch.zeros(T, P * F, 4 * -(-d // 4), dtype=X.dtype)
        rec[..., :d] = scale * zp
        xs = torch.zeros(len(idx), L, rec.shape[-1], dtype=X.dtype)
        xs[..., :d] = X[idx]
        if rbf:
            nx = nx[None, None] - 0.5 * scale * (zp * zp).sum(-1)[..., None,
                                                                  None]
    prev = torch.zeros(F, T, len(idx), dtype=X.dtype)
    S = torch.zeros(max(F - nl, 1), T, len(idx), dtype=X.dtype)
    lev = torch.zeros(nl, T, len(idx), dtype=X.dtype)
    nx = nx.expand(T, P * F, len(idx), L)
    for i in range(L):
        k = _activate(torch.einsum("tfc,nc->tfn", rec, xs[:, i])
                      + nx[..., i], rbf, fold)
        for m in range(1, nl + 1):
            off, soff = m * (m - 1) // 2, (m - 1) * (m - 2) // 2
            u = []
            for f in range(off, off + m):
                gv = (k[:, P * f + 1] - k[:, P * f] if increments
                      else k[:, f])
                u.append(gv - prev[f])
                prev[f] = gv
            if i == 0:
                continue
            if m == 1:
                lev[0] += u[0]
                continue
            lev[m - 1] += u[m - 1] * S[soff + m - 2]
            for s in range(m - 2, 0, -1):
                S[soff + s] += u[s] * S[soff + s - 1]
            S[soff] += u[0]
    out = torch.ones(nl + 1, T, N, dtype=X.dtype)
    keep = n.flatten() < N
    out[1:, :, n.flatten()[keep]] = lev[:, :, keep]
    return out


def _prefix(v):
    """Exclusive prefix over a chunk's points (lane major) and its total."""
    flat = v.flatten(-2)
    return (torch.cumsum(flat, -1) - flat).view_as(v), flat.sum(-1)


def _suffix(v):
    """Exclusive suffix over a chunk's points and its total."""
    flat = v.flatten(-2)
    rev = torch.flip(torch.cumsum(torch.flip(flat, [-1]), -1), [-1])
    return (rev - flat).view_as(v), flat.sum(-1)


def kuf1_bwd_schedule_model(Z, X, g, nl, rbf, increments, fold):
    """(Z̄, X̄) by the order-1 backward kernel's schedule
    (tens_seq_bwd.cuh): a pair (t, n) on 32 lanes, KP = 2 points a lane,
    chunks of 64 DP points; pass 1 over every chunk but the last
    (levels >= 2) to the last chunk's start carries; pass 2 from the last
    chunk down, each chunk's start carries rebuilt by subtraction (exactly
    0 at the first), the forward stages by prefixes, the adjoints by
    suffixes with the later chunks' reverse carries, Ū of the next chunk's
    first point carried for ḡ; each lane evaluates its KP points and the
    one before (KP + 1 slots) and owns the later KP (and the pair's point
    0). The chain adds each factor point's (sum u x, sum u) over the lane's
    slots to the lane's column and each slot's sum u z (z scaled by
    log2(e) with ``fold``, scaled back at the flush) to X̄; the columns are
    summed over the pairs of the plan's two-warp blocks."""
    T = Z.shape[0]
    N, L, d = X.shape
    P = 2 if increments else 1
    F = nl * (nl + 1) // 2
    F2 = P * F
    bp = plan.kuf_bwd_plan(T, N, F2, d, X.element_size(), tuned=True)
    assert (bp["route"], bp["threads"]) == ("tuned", 2 * plan.KUF_LANES)
    KP, S = plan.KUF_POINTS, plan.KUF_LANES
    CH, KS = S * KP, KP + 1
    rows = L - 1
    nch = -(-rows // CH)
    scale = LOG2E if rbf and fold else 1.0
    rec = _records(Z, d, rbf, scale)
    lane = torch.arange(S)
    w = g[1:]
    cols = torch.zeros(T, N, S, F2, 4, dtype=X.dtype)
    Xbar = torch.zeros_like(X)
    carry = {m: [torch.zeros(T, N, dtype=X.dtype) for _ in range(m - 1)]
             for m in range(1, nl + 1)}
    rcarry = {m: [torch.zeros(T, N, dtype=X.dtype) for _ in range(m - 1)]
              for m in range(1, nl + 1)}
    ubn = {m: torch.zeros(T, N, m, dtype=X.dtype) for m in range(1, nl + 1)}
    for it in range(2 * nch - 1):
        forward = it < nch - 1
        c = it if forward else 2 * nch - 2 - it
        j0 = c * CH + lane * KP
        s = j0[:, None] + torch.arange(KS)[None]  # [S, KS] sequence points
        sc = s.clamp(max=L - 1)
        xs = torch.zeros(N, S, KS, 4, dtype=X.dtype)
        xs[..., :d] = X[:, sc]
        xs[..., 3] = 1.0
        nx = (-0.5 * scale * (X[:, sc] ** 2).sum(-1) if rbf
              else torch.zeros(N, S, KS, dtype=X.dtype))
        live = (j0[:, None] + torch.arange(KP)[None] < rows).to(X.dtype)
        own = torch.zeros(S, KS, dtype=X.dtype)
        own[:, 1:] = live
        own0 = c == 0
        xb = torch.zeros(T, N, S, KS, 3, dtype=X.dtype)
        su = torch.zeros(T, N, S, KS, dtype=X.dtype)
        kv = _activate(torch.einsum("tfc,nsqc->tfnsq", rec, xs)
                       + nx[None, None], rbf, fold)  # [T, F2, N, S, KS]
        for m in range(1, nl + 1):
            if m == 1 and forward:
                continue
            off = m * (m - 1) // 2
            gv = [kv[:, P * f + 1] - kv[:, P * f] if increments else kv[:, f]
                  for f in range(off, off + m)]
            U = [(v[..., 1:] - v[..., :-1]) * live for v in gv]
            E, Pre = U[0], []
            for a in range(1, m):
                ex, total = _prefix(E)
                if forward:
                    start = carry[m][a - 1]
                    carry[m][a - 1] = start + total
                else:
                    start = (torch.zeros_like(total) if c == 0 else
                             carry[m][a - 1] if c == nch - 1 else
                             carry[m][a - 1] - total)
                    carry[m][a - 1] = start
                Pre.append(start[..., None, None] + ex)
                E = U[a] * Pre[a - 1]
            if forward:
                continue
            eb = w[m - 1][..., None, None].expand_as(U[0])
            ub = [None] * m
            for a in range(m - 1, 0, -1):
                ub[a] = eb * Pre[a - 1] * live
                ex, total = _suffix(U[a] * eb)
                rc = rcarry[m][a - 1]
                rcarry[m][a - 1] = rc + total
                eb = rc[..., None, None] + ex
            ub[0] = eb * live
            for f in range(m):
                nxt = torch.cat([ub[f][..., 1:, 0], ubn[m][..., f, None]], -1)
                ubn[m][..., f] = ub[f][..., 0, 0]
                gb = torch.zeros(T, N, S, KS, dtype=X.dtype)
                if own0:
                    gb[:, :, 0, 0] = -ub[f][:, :, 0, 0]
                ext = torch.cat([ub[f], nxt[..., None]], -1)
                gb[..., 1:] = (ext[..., :-1] - ext[..., 1:]) * live
                for h in range(P):
                    fp = P * (off + f) + h
                    sign = -1.0 if increments and h == 0 else 1.0
                    u = sign * gb * (kv[:, fp] if rbf else 1.0)
                    cols[:, :, :, fp] += torch.einsum("tnsq,nsqc->tnsc", u,
                                                      xs)
                    xb += u[..., None] * rec[:, fp, None, None, None, :3]
                    su += u
        if forward:
            continue
        xval = xb[..., :d] / scale - (xs[None, ..., :d] * su[..., None]
                                      if rbf else 0)
        for q in range(KS):
            for ln in range(S):
                if (q == 0 and own0 and ln == 0) or (q > 0 and own[ln, q]):
                    Xbar[:, int(s[ln, q])] += xval[:, :, ln, q].sum(0)
    # Z̄: each block's columns over its warps' pairs, then over the blocks
    warps, ppw = bp["threads"] // S, bp["ppw"]
    per_item = warps * ppw
    nbt = -(-N // per_item)
    assert bp["blocks"] == bp["items"] == T * nbt
    zp = Z.reshape(T, F2, d)
    Zbar = torch.zeros(T, F2, d, dtype=X.dtype)
    seen = torch.zeros(T, N, dtype=torch.long)
    for item in range(bp["items"]):
        t, nb = divmod(item, nbt)
        block = torch.zeros(F2, 4, dtype=X.dtype)
        for k in range(ppw):
            for wp in range(warps):
                n = nb * per_item + k * warps + wp
                if n < N:
                    seen[t, n] += 1
                    block += cols[t, n].sum(0)
        Zbar[t] += block[:, :d] - (zp[t] * block[:, 3:] if rbf else 0)
    assert bool((seen == 1).all())
    return Zbar.reshape(Z.shape), Xbar


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-13 * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("increments", [True, False])
@pytest.mark.parametrize("L", LENGTHS)
def test_forward_schedule_model_matches_ref_and_jax(L, increments, rbf,
                                                    monkeypatch):
    """The forward's schedule against the plain version, and in the first
    of the five cases the JAX reference, float64, rtol 1e-10, with and
    without the float32 kernel's log2(e) fold: N on both sides of a
    block's 32, 64 and 128 sequences (N = 3, 33, 70, 130), d = 1-3 (one
    record a factor point) and 4-9 (chunks), nl 1-7."""
    for k, (N, d, nl) in enumerate(((3, 3, 1 + L % 7), (70, 2, 1 + (L + 3) % 7),
                                    (33, 1, 1 + (L + 5) % 7),
                                    (130, 3, 1 + (L + 1) % 7),
                                    (5, 4 + L % 6, 1 + (L + 2) % 7))):
        Z, X, _ = _inputs(10 * L + k, 2, N, L, d, nl, increments)
        tZ, tX = torch.as_tensor(Z), torch.as_tensor(X)
        wants = [tts.fused_tens_seq_levels_ref(tZ, tX, nl, rbf, increments)]
        if k == 0:  # the JAX side, eager: one case a test keeps it quick
            wants.append(jts._xla_reference_tens_seq(
                jnp.asarray(Z), jnp.asarray(X), nl, rbf, increments))
        for fold in (False, True):
            got = kuf1_fwd_schedule_model(tZ, tX, nl, rbf, increments, fold)
            for want in wants:
                _close([got], [want])


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("increments", [True, False])
@pytest.mark.parametrize("L", LENGTHS)
def test_backward_schedule_model_matches_ref_and_jax(L, increments, rbf,
                                                     monkeypatch):
    """The backward's schedule (lanes over the time axis, chunks, carries
    rebuilt by subtraction, Ū across a chunk edge, the Z̄ columns over the
    plan's warps and pairs) against the plain VJP, and in the first of the
    three cases ``jax.vjp`` of the JAX package, float64, rtol 1e-10: one
    pair a warp and, forced, several (a block's warps then take pairs of
    one tensor in turn), each with and without the log2(e) fold, d = 1-3,
    nl 1-7. With ``increments`` and RBF at L = 50 and 150 the JAX side is
    ``jax.vjp`` of ``fused_tens_seq_levels`` itself (its Pallas forward in
    interpret mode), else of its reference."""
    for k, (N, d, nl) in enumerate(((3, 3, 1 + L % 7), (9, 2, 1 + (L + 2) % 7),
                                    (5, 1, 7))):
        Z, X, g = _inputs(20 * L + k, 2, N, L, d, nl, increments)
        tZ, tX, tg = map(torch.as_tensor, (Z, X, g))
        wants = [tts.tens_seq_bwd_ref(tZ, tX, tg, nl, rbf, increments)]
        if k == 0:  # the JAX side, eager: one case a test keeps it quick
            if increments and rbf and L in (50, 150):
                fn = lambda z, x: jts.fused_tens_seq_levels(  # noqa: E731
                    z, x, nl, rbf, increments, True)
            else:
                fn = lambda z, x: jts._xla_reference_tens_seq(  # noqa: E731
                    z, x, nl, rbf, increments)
            _, vjp = jax.vjp(fn, jnp.asarray(Z), jnp.asarray(X))
            wants.append(vjp(jnp.asarray(g)))
        for target, fold in ((plan.KUF_TUNED_BWD_TARGET_BLOCKS, k == 1),
                             (1, k != 1)):
            monkeypatch.setattr(plan, "KUF_TUNED_BWD_TARGET_BLOCKS", target)
            got = kuf1_bwd_schedule_model(tZ, tX, tg, nl, rbf, increments,
                                          fold)
            for want in wants:
                _close(got, want)


# -- the launch plans -------------------------------------------------------


def _constant(source, name):
    text = (Path(tts.__file__).parents[2] / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_mirrors_the_kernels_constants():
    """The plan's constants are the kernels' (csrc/tens_seq*.cuh): the
    record's width, the backward's block and points a lane."""
    assert _constant("tens_seq.cuh", "kMaxD") == plan.KUF_TUNED_MAX_D
    assert _constant("tens_seq_bwd.cuh", "kMaxD") == plan.KUF_TUNED_MAX_D
    assert (_constant("tens_seq_bwd.cuh", "kThreads")
            == plan.KUF_TUNED_BWD_THREADS)
    assert _constant("tens_seq_bwd.cuh", "kPoints") == plan.KUF_POINTS
    assert _constant("tens_seq_bwd.cuh", "kLanes") == plan.KUF_LANES


@pytest.mark.parametrize("nl", range(1, 8))
def test_order1_plans_take_every_N_and_d(nl):
    """Every N of {1, 31, 33, 50, 128, 2048}, every d up to 2048, both
    ``increments`` and dtypes get a plan of each order-1 Kuf kernel: the
    order-1 forward wherever its records fit the shared memory (one a
    factor point up to d = 3, then ceil(d / 4) and a half norm), the
    order-1 backward up to d = 3 (the record's width), the general
    kernels' own plans past those. The order-1 forward's fewest threads of
    32, 64, 128 cover N, one sequence a thread; the backward's two-warp
    block fits the shared memory (the records and a 4-vector column a
    factor point a lane) and its grid covers every pair once."""
    for itemsize in (4, 8):
        for increments in (True, False):
            F2 = plan.factor_count(nl, increments)
            for N in (1, 31, 33, 50, 128, 2048):
                for T in (1, 500):
                    for d in range(1, 2049):
                        fp = plan.kuf_fwd_plan(N, F2, d, nl, itemsize, True)
                        smem = itemsize * F2 * (
                            4 if d <= 3 else 4 * -(-d // 4) + 1)
                        if smem > plan.SMEM_BYTES:
                            assert fp == plan.kuf_fwd_plan(N, F2, d, nl,
                                                           itemsize)
                        else:
                            assert fp == dict(
                                route="tuned", seqs=1, staged=True,
                                threads=min(t for t in (32, 64, 128)
                                            if t >= N or t == 128),
                                smem=smem)
                        bp = plan.kuf_bwd_plan(T, N, F2, d, itemsize, True)
                        if d > plan.KUF_TUNED_MAX_D:
                            assert bp == plan.kuf_bwd_plan(T, N, F2, d,
                                                           itemsize)
                            continue
                        assert bp["route"] == "tuned"
                        assert bp["threads"] == plan.KUF_TUNED_BWD_THREADS
                        assert bp["smem"] == 4 * itemsize * F2 * 65
                        assert bp["smem"] <= plan.SMEM_BYTES
                        assert 1 <= bp["ppw"] <= max(-(-N // 2), 1)
                        assert bp["blocks"] == bp["items"] == T * -(
                            -N // (2 * bp["ppw"]))


def test_order1_forward_takes_d_while_its_records_fit():
    """The order-1 forward's widest d at nl = 5 and 7 with increments: its
    records fill the shared memory at d = 1936 / 1036 in float32 and 964 /
    516 in float64; one more and the general kernel takes the shape."""
    for nl, itemsize, widest in ((5, 4, 1936), (7, 4, 1036), (5, 8, 964),
                                 (7, 8, 516)):
        F2 = plan.factor_count(nl, True)
        assert plan.kuf_fwd_plan(8, F2, widest, nl, itemsize,
                                 True)["route"] == "tuned"
        assert plan.kuf_fwd_plan(8, F2, widest + 1, nl, itemsize,
                                 True)["route"] == "general"


def test_order1_plans_at_the_main_shapes():
    """The flagship serving Kuf and the L = 150 one take blocks of 128
    sequences, the training one (N = 50) of 64; the training backward 2
    pairs a warp (6,500 blocks of two warps), the L = 150 backward one
    (1,600 blocks), the N = 840 backward 49 (4,500 blocks)."""
    assert plan.kuf_fwd_plan(2048, 30, 3, 5, 4, True)["threads"] == 128
    assert plan.kuf_fwd_plan(2048, 20, 2, 4, 4, True)["threads"] == 128
    assert plan.kuf_fwd_plan(50, 30, 3, 5, 4, True)["threads"] == 64
    bp = plan.kuf_bwd_plan(500, 50, 30, 3, 4, True)
    assert (bp["route"], bp["ppw"], bp["blocks"]) == ("tuned", 2, 6500)
    bp = plan.kuf_bwd_plan(64, 50, 20, 2, 4, True)
    assert (bp["ppw"], bp["blocks"]) == (1, 1600)
    bp = plan.kuf_bwd_plan(500, 840, 30, 3, 4, True)
    assert (bp["ppw"], bp["blocks"]) == (49, 4500)
