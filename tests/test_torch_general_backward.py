"""The general engines' backward entry points against the JAX package, and
the wiring of their ``torch.autograd.Function``s.

- ``fused_gram_ho_levels_bwd_ref``, ``tens_seq_general_bwd_ref`` and
  ``sig_gram_levels{,_ho}_bwd_ref`` (the plain versions the CUDA backward
  kernels are held against) against ``jax.vjp`` of ``_xla_reference_ho``,
  ``_xla_reference_tens_seq_general`` and ``ops.signature.signature_kern``,
  float64, rtol 1e-10 (one function differentiated by two autodiff
  systems: rounding only), over every base kind, ``difference``, order 1-3
  and ``increments``;
- a few cases against the Pallas backward kernels in interpret mode,
  float32 on the JAX side, at the tolerances of
  ``tests/test_pallas_kernels.py`` (the Pallas kernels compute in float32);
- the Functions on the CPU, with their kernel launches replaced by the
  plain versions (the kernels themselves run only on the card; see
  ``test_torch_cuda_kernels.py``);
- a float64 model of the general Kuf backward kernel's schedule (a pair's
  time axis over a warp's lanes, chunks with carries, the Z̄ reduction)
  against the plain version and ``jax.vjp``, rtol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops import signature as jsig
from gpsig_tpu.ops.pallas import fused_gram_ho as jfgho
from gpsig_tpu.ops.pallas import sig_gram as jsg
from gpsig_tpu.ops.pallas import tens_seq_general as jtsg
from gpsig_tpu.ops.pallas.fused_gram_ho_bwd import fused_gram_ho_bwd_pallas
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho
from gpsig_tpu_torch.ops.cuda import plan
from gpsig_tpu_torch.ops.cuda import sig_gram as tsg
from gpsig_tpu_torch.ops.cuda import tens_seq_general as ttsg

torch.set_num_threads(1)
KINDS = ["linear", "rbf", "poly2", "poly3", "cosine"]


def _walks(rng, n, L, d):
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


def _close(got, want, rtol=1e-10, atol=1e-13):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


def _scaled_close(got, want, tol):
    """|got - want| <= tol · max|want|, per output (as the Pallas tests)."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w,
                                   atol=tol * np.abs(w).max(), rtol=0)


def _offset_channel(X, Y, kind, c=0.7):
    """The kernel layer's Poly offset channel: x_extra = 1, y_extra = c."""
    if not kind.startswith("poly"):
        return X, Y
    return (np.concatenate([X, np.ones(X.shape[:-1] + (1,))], -1),
            np.concatenate([Y, np.full(Y.shape[:-1] + (1,), c)], -1))


def _gram_inputs(seed, kind, nl, N1=3, N2=4, L=6):
    rng = np.random.default_rng(seed)
    X, Y = _offset_channel(_walks(rng, N1, L, 2), _walks(rng, N2, L, 2), kind)
    return X, Y, rng.standard_normal((nl + 1, N1, N2))


def _tens_inputs(seed, kind, nl, increments, T=4, N=3, L=7):
    rng = np.random.default_rng(seed)
    F = nl * (nl + 1) // 2
    Z = 0.4 * rng.standard_normal((T, F, 2, 2) if increments else (T, F, 2))
    X, Z = _offset_channel(_walks(rng, N, L, 2), Z, kind)
    return Z, X, rng.standard_normal((nl + 1, T, N))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("difference", [True, False])
def test_gram_ho_backward_ref_matches_jax_vjp(kind, difference):
    for order in (1, 2, 3):
        nl = 4
        X, Y, g = _gram_inputs(order, kind, nl)
        _, vjp = jax.vjp(lambda x, y: jfgho._xla_reference_ho(
            x, y, nl, order, kind, difference), jnp.asarray(X),
            jnp.asarray(Y))
        args = (*map(torch.as_tensor, (X, Y, g)), nl, order, kind, difference)
        got = tfgho.fused_gram_ho_levels_bwd_ref(*args)
        assert got[0].shape == X.shape and got[1].shape == Y.shape
        _close(got, vjp(jnp.asarray(g)))
        # the public entry takes the plain route for CPU tensors
        _close(tfgho.fused_gram_ho_levels_bwd(*args), got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("difference", [True, False])
def test_tens_seq_general_backward_ref_matches_jax_vjp(kind, difference):
    for order in (1, 2, 3):
        for increments in (True, False):
            nl = 3
            Z, X, g = _tens_inputs(order, kind, nl, increments)
            _, vjp = jax.vjp(
                lambda z, x: jtsg._xla_reference_tens_seq_general(
                    z, x, nl, order, kind, increments, difference),
                jnp.asarray(Z), jnp.asarray(X))
            args = (*map(torch.as_tensor, (Z, X, g)), nl, order, kind,
                    increments, difference)
            got = ttsg.tens_seq_general_bwd_ref(*args)
            assert got[0].shape == Z.shape and got[1].shape == X.shape
            _close(got, vjp(jnp.asarray(g)))
            _close(ttsg.tens_seq_general_bwd(*args), got)


@pytest.mark.parametrize("nl", [1, 3, 5])
@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_sig_gram_backward_ref_matches_jax_vjp(nl, order):
    # non-symmetric M with L1 != L2: the kernels stream M's rows, and M̄ is
    # not symmetric
    rng = np.random.default_rng(10 * nl + order)
    M = 0.4 * rng.standard_normal((3, 6, 9))
    g = rng.standard_normal((nl + 1, 3))
    _, vjp = jax.vjp(lambda m: jsig.signature_kern(m, nl, order),
                     jnp.asarray(M))
    tM, tg = torch.as_tensor(M), torch.as_tensor(g)
    if order == 1:
        got = tsg.sig_gram_levels_bwd_ref(tM, tg, nl)
        _close((tsg.sig_gram_levels_bwd(tM, tg, nl),), (got,))
    else:
        got = tsg.sig_gram_levels_ho_bwd_ref(tM, tg, nl, order)
        _close((tsg.sig_gram_levels_ho_bwd(tM, tg, nl, order),), (got,))
    _close((got,), vjp(jnp.asarray(g)))


# -- against the Pallas backward kernels in interpret mode ------------------


@pytest.mark.parametrize("kind,order,difference", [
    ("rbf", 2, True), ("poly2", 1, True), ("cosine", 3, False)])
def test_gram_ho_backward_ref_matches_pallas_interpret(kind, order,
                                                       difference):
    nl = 4
    X, Y, g = _gram_inputs(20, kind, nl, N1=4, N2=5, L=7)
    want = fused_gram_ho_bwd_pallas(
        *(jnp.asarray(a, jnp.float32) for a in (X, Y, g)), nl, order, kind,
        difference, interpret=True)
    got = tfgho.fused_gram_ho_levels_bwd_ref(
        *map(torch.as_tensor, (X, Y, g)), nl, order, kind, difference)
    _scaled_close(got, want, 3e-5)


@pytest.mark.parametrize("kind,order,difference,increments", [
    ("rbf", 2, True, True), ("poly3", 2, False, False)])
def test_tens_seq_general_backward_ref_matches_pallas_interpret(
        kind, order, difference, increments):
    nl = 4
    Z, X, g = _tens_inputs(21, kind, nl, increments, T=9, N=3, L=11)
    want = jtsg.tens_seq_general_bwd_pallas(
        *(jnp.asarray(a, jnp.float32) for a in (Z, X, g)), nl, order, kind,
        increments, difference, interpret=True)
    got = ttsg.tens_seq_general_bwd_ref(
        *map(torch.as_tensor, (Z, X, g)), nl, order, kind, increments,
        difference)
    _close(got, want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("nl,order", [(4, 1), (4, 2), (5, 3)])
def test_sig_gram_backward_ref_matches_pallas_interpret(nl, order):
    rng = np.random.default_rng(20 + order)
    M = 0.4 * rng.standard_normal((3, 9, 7))
    w = rng.standard_normal((nl + 1, 3))
    jM, jw = jnp.asarray(M, jnp.float32), jnp.asarray(w, jnp.float32)
    tM, tw = torch.as_tensor(M), torch.as_tensor(w)
    if order == 1:
        (want,) = jsg._vjp_bwd(nl, True, jM, jw)
        got = tsg.sig_gram_levels_bwd_ref(tM, tw, nl)
    else:
        want = jsg._sig_gram_ho_bwd_impl(jM, jw, nl, order, interpret=True)
        got = tsg.sig_gram_levels_ho_bwd_ref(tM, tw, nl, order)
    _scaled_close((got,), (want,), 5e-6)


# -- the autograd.Functions, with plain versions standing in for launches --


@pytest.fixture
def plain_launches(monkeypatch):
    """Route the Functions' launches to the plain versions and count the
    backward calls."""
    calls = {"gram": 0, "tens": 0, "sig": 0, "sig_ho": 0}

    def counted(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    def plain(fn):
        def wrapped(*args):
            with torch.no_grad():
                return fn(*args)
        return wrapped

    monkeypatch.setattr(tfgho, "_launch",
                        lambda X, Y, nl, order, kind, difference, symmetric:
                        plain(tfgho.fused_gram_ho_levels_ref)(
                            X, Y, nl, order, kind, difference))
    monkeypatch.setattr(tfgho, "fused_gram_ho_levels_bwd",
                        counted("gram", tfgho.fused_gram_ho_levels_bwd_ref))
    monkeypatch.setattr(ttsg, "_launch",
                        plain(ttsg.fused_tens_seq_general_levels_ref))
    monkeypatch.setattr(ttsg, "tens_seq_general_bwd",
                        counted("tens", ttsg.tens_seq_general_bwd_ref))
    monkeypatch.setattr(tsg, "_launch", plain(tsg.sig_gram_levels_ho_ref))
    monkeypatch.setattr(tsg, "sig_gram_levels_bwd",
                        counted("sig", tsg.sig_gram_levels_bwd_ref))
    monkeypatch.setattr(tsg, "sig_gram_levels_ho_bwd",
                        counted("sig_ho", tsg.sig_gram_levels_ho_bwd_ref))
    return calls


@pytest.mark.parametrize("kind,order,difference", [
    ("rbf", 2, True), ("poly2", 1, True), ("cosine", 2, False)])
def test_gram_ho_function_wiring(plain_launches, kind, order, difference):
    rng = np.random.default_rng(3)
    Xn, Yn = _offset_channel(_walks(rng, 4, 6, 2), _walks(rng, 3, 6, 2),
                             kind)
    X = torch.tensor(Xn, requires_grad=True)
    Y = torch.tensor(Yn, requires_grad=True)
    args = (3, order, kind, difference)
    # torch.sum hands the backward an expanded (stride-0) cotangent
    out = tfgho._GramHoLevels.apply(X, Y, *args)
    gx, gy = torch.autograd.grad(out.sum(), (X, Y))
    assert plain_launches["gram"] == 1
    wx, wy = torch.autograd.grad(
        tfgho.fused_gram_ho_levels_ref(X, Y, *args).sum(), (X, Y))
    _close((gx, gy), (wx, wy), rtol=1e-12)
    # X is Y: both gradients reach the one tensor and add up
    (gxx,) = torch.autograd.grad(
        (tfgho._GramHoLevels.apply(X, X, *args) ** 2).sum(), X)
    (wxx,) = torch.autograd.grad(
        (tfgho.fused_gram_ho_levels_ref(X, X, *args) ** 2).sum(), X)
    _close((gxx,), (wxx,), rtol=1e-12)
    # only the inputs that need a gradient get one
    Yc = Y.detach()
    (gx,) = torch.autograd.grad(
        tfgho._GramHoLevels.apply(X, Yc, *args).sum(), X)
    assert gx.shape == X.shape and Yc.grad is None
    assert torch.autograd.gradcheck(
        lambda a, b: tfgho._GramHoLevels.apply(a, b, 2, order, kind,
                                               difference), (X, Y))


@pytest.mark.parametrize("increments", [True, False])
@pytest.mark.parametrize("difference", [True, False])
def test_tens_seq_general_function_wiring(plain_launches, increments,
                                          difference):
    Z, X, _ = _tens_inputs(5, "cosine", 2, increments, T=3, N=2, L=5)
    Z = torch.tensor(Z, requires_grad=True)
    X = torch.tensor(X, requires_grad=True)
    args = (2, 2, "cosine", increments, difference)
    out = ttsg._TensSeqGeneralLevels.apply(Z, X, *args)
    gz, gx = torch.autograd.grad(out.sum(), (Z, X))
    assert plain_launches["tens"] == 1
    wz, wx = torch.autograd.grad(
        ttsg.fused_tens_seq_general_levels_ref(Z, X, *args).sum(), (Z, X))
    _close((gz, gx), (wz, wx), rtol=1e-12)
    Xc = X.detach()
    (gz,) = torch.autograd.grad(
        ttsg._TensSeqGeneralLevels.apply(Z, Xc, *args).sum(), Z)
    assert gz.shape == Z.shape and Xc.grad is None
    assert torch.autograd.gradcheck(
        lambda z, x: ttsg._TensSeqGeneralLevels.apply(z, x, *args), (Z, X))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_sig_gram_function_wiring(plain_launches, order):
    rng = np.random.default_rng(6)
    M = torch.tensor(0.4 * rng.standard_normal((2, 4, 5)), requires_grad=True)
    out = tsg._SigGramLevels.apply(M, 3, order)
    (gm,) = torch.autograd.grad(out.sum(), M)
    key = "sig" if order == 1 else "sig_ho"
    assert plain_launches[key] == 1 and sum(plain_launches.values()) == 1
    (wm,) = torch.autograd.grad(
        tsg.sig_gram_levels_ho_ref(M, 3, order).sum(), M)
    _close((gm,), (wm,), rtol=1e-12)
    assert torch.autograd.gradcheck(
        lambda m: tsg._SigGramLevels.apply(m, 3, order), (M,))


# -- a model of the general Kuf backward's schedule (tens_seq_general_bwd.cu)


def _base_and_grad(acc, kind):
    """A factor point's base value and d value / d acc (activate and
    activate_grad of csrc/common.cuh)."""
    _, degree = tfgho.kind_params(kind)
    if kind == "rbf":
        v = torch.exp(acc)
        return v, v
    if kind == "cosine":
        t = torch.sqrt(torch.clamp(-2.0 * acc, min=0.0) + 1e-36)
        return torch.cos(t), torch.where(acc > 0, torch.zeros_like(t),
                                         torch.sin(t) / t)
    if degree:
        return acc**degree, degree * acc ** (degree - 1)
    return acc, torch.ones_like(acc)


def _scan(v):
    """Exclusive prefix over a chunk's points (lane major: lane, then its
    points) and the chunk's total: a warp's scan of R values a lane."""
    flat = v.flatten(-2)
    return (torch.cumsum(flat, -1) - flat).view_as(v), flat.sum(-1)


def _suffix(v):
    """Exclusive suffix over a chunk's points and the chunk's total."""
    flat = v.flatten(-2)
    rev = torch.flip(torch.cumsum(torch.flip(flat, [-1]), -1), [-1])
    return (rev - flat).view_as(v), flat.sum(-1)


def kuf_bwd_schedule_model(Z, X, g, nl, order, kind, increments, difference,
                           S=plan.KUF_LANES, R=plan.KUF_POINTS):
    """(Z̄, X̄) of the general Kuf by the backward kernel's schedule: a pair
    (t, n) on S lanes, R DP points a lane, the time axis walked in chunks
    of S·R points. Pass 1 (more than one chunk) runs the forward's stages
    over every chunk but the last to the last chunk's start carries; pass 2
    walks the chunks backwards: each chunk's start carries rebuilt by
    subtraction (exactly 0 at the first chunk), its forward stages by
    prefix scans, the adjoints by suffix scans with the carries of the
    later chunks, Ū of the next chunk's first point carried for ḡ. Levels
    one at a time (they share no factor). The chain: each lane's sums over
    its points into its columns (Z̄) and, over the levels, its points' X̄;
    the pairs are grouped into the plan's work items and warps, and the
    columns summed over them."""
    T = Z.shape[0]
    N, L, d = X.shape
    norms, _ = tfgho.kind_params(kind)
    P = min(order, nl)
    zp = Z.reshape(T, -1, d)
    F2 = zp.shape[1]
    nz = -0.5 * (zp * zp).sum(-1) if norms else torch.zeros(T, F2)
    rows = L - 1 if difference else L
    SR = S * R
    nch = -(-rows // SR)
    lane = torch.arange(S)
    w = g[1:]
    zcols = torch.zeros(T, N, S, F2, d + 1, dtype=X.dtype)
    Xbar = torch.zeros_like(X)

    def points(c):
        j0 = c * SR + lane * R
        s = j0[:, None] + torch.arange(R + 1)[None] - (0 if difference else 1)
        return j0, s

    def factors(c, m, grad):
        """Level m's factor values g_f and, with grad, the factor points'
        derivatives at each lane's R + 1 slots (slot 0 unused without
        difference), and U at its R DP points (0 past the rows)."""
        j0, s = points(c)
        xs = X[:, s.clamp(0, L - 1)]  # [N, S, R+1, d]
        nx = -0.5 * (xs * xs).sum(-1) if norms else torch.zeros(xs.shape[:-1])
        off = m * (m - 1) // 2
        gv, dk = [], []
        for f in range(off, off + m):
            val = 0
            for h in range(2 if increments else 1):
                fp = 2 * f + h if increments else f
                acc = (torch.einsum("tc,nsqc->tnsq", zp[:, fp], xs)
                       + nz[:, fp, None, None, None] + nx[None])
                v, gr = _base_and_grad(acc, kind)
                sign = -1.0 if increments and h == 0 else 1.0
                val = val + sign * v
                dk.append((fp, sign * gr))
            gv.append(val)
        live = (j0[:, None] + torch.arange(R)[None] < rows).to(X.dtype)
        U = [(v[..., 1:] - (v[..., :-1] if difference else 0)) * live
             for v in gv]
        return U, (dk if grad else None), xs

    def live_states(a):
        return min(P, m, a + 1)

    def stages(U, start):
        """The forward's stages a = 0..m-1 at the chunk's points; start(a,
        total) gives stage a's carry at the chunk's start from its chunk
        total. Returns the states E[a] and the prefixes Pre[a - 1]."""
        E, Pre = [[U[0]]], []
        for a in range(1, m):
            ex, total = _scan(sum(E[a - 1]))
            Pre.append(start(a - 1, total)[..., None, None] + ex)
            E.append([U[a] * Pre[a - 1]]
                     + [U[a] / (r + 1) * E[a - 1][r - 1]
                        for r in range(1, live_states(a))])
        return E, Pre

    # pass 1: the last chunk's start carries
    carry = {}
    for m in range(2, nl + 1):
        carry[m] = [torch.zeros(T, N, dtype=X.dtype) for _ in range(m - 1)]
        for c in range(nch - 1):
            U, _, _ = factors(c, m, False)
            sums = {}
            stages(U, lambda a, total: carry[m][a] + 0 * sums.setdefault(
                a, total))
            for a, total in sums.items():
                carry[m][a] = carry[m][a] + total
    # pass 2
    carry_r = {m: [torch.zeros(T, N, dtype=X.dtype) for _ in range(m)]
               for m in range(1, nl + 1)}
    ub_next = {m: torch.zeros(T, N, m, dtype=X.dtype)
               for m in range(1, nl + 1)}
    for c in range(nch - 1, -1, -1):
        j0, s = points(c)
        xpart = torch.zeros(T, N, S, R + 1, d, dtype=X.dtype)
        su = torch.zeros(T, N, S, R + 1, dtype=X.dtype)
        own = torch.zeros(S, R + 1, dtype=X.dtype)
        own[:, 1:] = (s[:, 1:] <= L - 1).to(X.dtype)
        if difference and c == 0:
            own[0, 0] = 1.0
        for m in range(1, nl + 1):
            U, dk, xs = factors(c, m, True)

            def start(a, total, m=m):
                if c == 0:
                    return torch.zeros_like(total)
                if c < nch - 1:
                    carry[m][a] = carry[m][a] - total
                return carry[m][a]

            E, Pre = stages(U, start)
            live = (j0[:, None] + torch.arange(R)[None] < rows).to(X.dtype)
            ub = [None] * m
            eb = [w[m - 1][..., None, None] * torch.ones_like(U[0])
                  for _ in range(live_states(m - 1))]
            for a in range(m - 1, 0, -1):
                ub[a] = eb[0] * Pre[a - 1] + sum(
                    (eb[r] * E[a - 1][r - 1] / (r + 1)
                     for r in range(1, live_states(a))),
                    torch.zeros_like(U[0]))
                ex, total = _suffix(U[a] * eb[0])
                q = carry_r[m][a][..., None, None] + ex
                carry_r[m][a] = carry_r[m][a] + total
                eb = [q + (U[a] / (r + 2) * eb[r + 1]
                           if r + 1 < live_states(a) else 0)
                      for r in range(live_states(a - 1))]
            ub[0] = eb[0]
            ub = torch.stack(ub, 2) * live  # [T, N, m, S, R]
            nxt = torch.cat([ub[..., 1:, :1], ub_next[m][..., None, None]],
                            -2)  # Ū of the point after each lane's last
            ext = torch.cat([ub, nxt], -1)  # [T, N, m, S, R + 1]
            gb = torch.zeros_like(ext)
            if difference:
                gb[..., 1:] = ext[..., :-1] - ext[..., 1:]
                gb[..., 0, 0] = -ext[..., 0, 0]
            else:
                gb[..., 1:] = ext[..., :-1]
            ub_next[m] = ub[..., 0, 0]
            off = m * (m - 1) // 2
            for fp, gr in dk:
                f = (fp // 2 if increments else fp) - off
                u = gb[:, :, f] * gr * own  # [T, N, S, R + 1]
                zcols[..., fp, :d] += torch.einsum("tnsq,nsqc->tnsc", u, xs)
                zcols[..., fp, d] += u.sum(-1)
                xpart += u[..., None] * zp[:, fp][:, None, None, None]
                su += u
        xb = xpart - (xs[None] * su[..., None] if norms else 0)
        for q in range(R + 1):
            for ln in range(S):
                if own[ln, q]:
                    Xbar[:, int(s[ln, q])] += xb[:, :, ln, q].sum(0)
    # the Z̄ reduction: each block thread's columns over its pairs, the
    # block's threads, then the items (atomics)
    bp = plan.kuf_bwd_plan(T, N, F2, d, 8)
    warps, ppw = bp["threads"] // S, bp["ppw"]
    per_item = warps * ppw
    Zbar = torch.zeros(T, F2, d, dtype=X.dtype)
    seen = torch.zeros(T, N, dtype=torch.long)
    for it in range(bp["items"]):
        t, nb = divmod(it, -(-N // per_item))
        block = torch.zeros(F2, d + 1, dtype=X.dtype)
        for wp in range(warps):
            for k in range(ppw):
                n = nb * per_item + k * warps + wp
                if n < N:
                    seen[t, n] += 1
                    block += zcols[t, n].sum(0)
        Zbar[t] += block[:, :d] - (zp[t] * block[:, d:] if norms else 0)
    assert bool((seen == 1).all())
    return Zbar.reshape(Z.shape), Xbar


SR = plan.KUF_LANES * plan.KUF_POINTS


@pytest.mark.parametrize("L", [2, SR, SR + 1, SR + 2, 150])
@pytest.mark.parametrize("difference", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_backward_schedule_model_matches_ref_and_jax(kind, difference, L):
    """The backward kernel's schedule (lanes over a pair's time axis, chunks
    with carries, the Z̄ reduction) against the plain version and
    ``jax.vjp`` of the JAX reference, float64, rtol 1e-10: every kind ×
    increments × difference × order 1-3, at lengths on both sides of a
    chunk's edge (S·R DP points)."""
    nl = 3
    for order in (1, 2, 3):
        for increments in (True, False):
            Z, X, g = _tens_inputs(100 * order + L, kind, nl, increments,
                                   T=2, N=3, L=L)
            X = X * np.sqrt(9 / L)  # steps shrink with L, as on the card
            tZ, tX, tg = map(torch.as_tensor, (Z, X, g))
            got = kuf_bwd_schedule_model(tZ, tX, tg, nl, order, kind,
                                         increments, difference)
            ref = ttsg.tens_seq_general_bwd_ref(tZ, tX, tg, nl, order, kind,
                                                increments, difference)
            _close(got, ref)
            _, vjp = jax.vjp(
                lambda z, x: jtsg._xla_reference_tens_seq_general(
                    z, x, nl, order, kind, increments, difference),
                jnp.asarray(Z), jnp.asarray(X))
            _close(got, vjp(jnp.asarray(g)))
