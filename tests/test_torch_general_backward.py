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
  ``test_torch_cuda_kernels.py``).
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
