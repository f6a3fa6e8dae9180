"""The port's backward entry points against the JAX package, and the wiring
of the ``torch.autograd.Function``s that put the backward kernels on the
card's path.

- ``fused_gram_levels_bwd_ref`` and ``tens_seq_bwd_ref`` (the plain
  versions the CUDA backward kernels are held against) against ``jax.vjp``
  of ``_xla_reference`` / ``_xla_reference_tens_seq``, float64, rtol 1e-10
  (the same function differentiated by two autodiff systems: rounding
  only);
- the same against the Pallas backward kernels in interpret mode, float32
  inputs on the JAX side, at the shapes and tolerances of
  ``tests/test_pallas_kernels.py`` (rtol 3e-4, atol 2e-5 / 3e-5: the
  Pallas kernels compute in float32);
- the Functions on the CPU, with their kernel launches replaced by the
  plain versions (the kernels themselves run only on the card; see
  ``test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu.ops.pallas import fused_gram as jfg
from gpsig_tpu.ops.pallas import tens_seq as jts
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import tens_seq as tts

torch.set_num_threads(1)


def _walks(rng, n, L, d):
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


def _close(got, want, rtol=1e-10, atol=1e-13):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


def _gram_inputs(seed, nl, N1=5, N2=9, L=7, d=2):
    rng = np.random.default_rng(seed)
    return (_walks(rng, N1, L, d), _walks(rng, N2, L, d),
            rng.standard_normal((nl + 1, N1, N2)))


def _tens_inputs(seed, nl, increments, T, N, L, d=2):
    rng = np.random.default_rng(seed)
    F = nl * (nl + 1) // 2
    shape = (T, F, 2, d) if increments else (T, F, d)
    return (0.4 * rng.standard_normal(shape),
            0.3 * rng.standard_normal((N, L, d)),
            rng.standard_normal((nl + 1, T, N)))


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 3, 5])
def test_gram_backward_ref_matches_jax_vjp(rbf, nl):
    X, Y, g = _gram_inputs(1, nl, L=9)
    _, vjp = jax.vjp(lambda x, y: jfg._xla_reference(x, y, nl, rbf),
                     jnp.asarray(X), jnp.asarray(Y))
    got = tfg.fused_gram_levels_bwd_ref(*map(torch.as_tensor, (X, Y, g)),
                                        nl, rbf)
    _close(got, vjp(jnp.asarray(g)))
    # the public entry takes the plain route for CPU tensors
    _close(tfg.fused_gram_levels_bwd(*map(torch.as_tensor, (X, Y, g)), nl,
                                     rbf), got)


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("increments", [True, False])
@pytest.mark.parametrize("nl", [1, 3, 5])
def test_tens_seq_backward_ref_matches_jax_vjp(rbf, increments, nl):
    Z, X, g = _tens_inputs(2, nl, increments, T=6, N=4, L=10)
    _, vjp = jax.vjp(
        lambda z, x: jts._xla_reference_tens_seq(z, x, nl, rbf, increments),
        jnp.asarray(Z), jnp.asarray(X))
    got = tts.tens_seq_bwd_ref(*map(torch.as_tensor, (Z, X, g)), nl, rbf,
                               increments)
    assert got[0].shape == Z.shape and got[1].shape == X.shape
    _close(got, vjp(jnp.asarray(g)))
    _close(tts.tens_seq_bwd(*map(torch.as_tensor, (Z, X, g)), nl, rbf,
                            increments), got)


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("nl", [1, 3, 5])
def test_gram_backward_ref_matches_pallas_interpret(rbf, nl):
    X, Y, g = _gram_inputs(8, nl)
    want = jfg.fused_gram_levels_bwd_pallas(
        *(jnp.asarray(a, jnp.float32) for a in (X, Y, g)), nl, rbf, True,
        bx=4)
    got = tfg.fused_gram_levels_bwd_ref(*map(torch.as_tensor, (X, Y, g)),
                                        nl, rbf)
    _close(got, want, rtol=3e-4, atol=2e-5)


@pytest.mark.parametrize("rbf", [True, False])
@pytest.mark.parametrize("increments", [True, False])
@pytest.mark.parametrize("nl", [1, 3, 5])
def test_tens_seq_backward_ref_matches_pallas_interpret(rbf, increments, nl):
    # T=140 spans two of the Pallas kernel's 128-tensor blocks
    Z, X, g = _tens_inputs(12, nl, increments, T=140, N=3, L=11)
    want = jts.tens_seq_bwd_pallas(
        *(jnp.asarray(a, jnp.float32) for a in (Z, X, g)), nl, rbf,
        increments, True)
    got = tts.tens_seq_bwd_ref(*map(torch.as_tensor, (Z, X, g)), nl, rbf,
                               increments)
    _close(got, want, rtol=3e-4, atol=3e-5)


# -- the autograd.Functions, with plain versions standing in for launches --


@pytest.fixture
def plain_launches(monkeypatch):
    """Route the Functions' launches to the plain versions and count the
    backward calls."""
    calls = {"gram_bwd": 0, "tens_bwd": 0}

    def gram_bwd(*args):
        calls["gram_bwd"] += 1
        return tfg.fused_gram_levels_bwd_ref(*args)

    def tens_bwd(*args):
        calls["tens_bwd"] += 1
        return tts.tens_seq_bwd_ref(*args)

    def diag(X, nl, rbf):
        with torch.no_grad():
            return tfg.fused_diag_levels_ref(X, nl, rbf)

    monkeypatch.setattr(tfg, "_launch_gram",
                        lambda X, Y, nl, rbf, symmetric:
                        tfg.fused_gram_levels_ref(X, Y, nl, rbf))
    monkeypatch.setattr(tfg, "_launch_diag", diag)
    monkeypatch.setattr(tfg, "fused_gram_levels_bwd", gram_bwd)
    monkeypatch.setattr(tts, "_launch", tts.fused_tens_seq_levels_ref)
    monkeypatch.setattr(tts, "tens_seq_bwd", tens_bwd)
    return calls


def test_gram_function_wiring(plain_launches):
    rng = np.random.default_rng(3)
    X = torch.tensor(_walks(rng, 4, 6, 2), requires_grad=True)
    Y = torch.tensor(_walks(rng, 3, 6, 2), requires_grad=True)
    # torch.sum hands the backward an expanded (stride-0) cotangent
    out = tfg._GramLevels.apply(X, Y, 3, True)
    assert out.grad_fn is not None
    gx, gy = torch.autograd.grad(out.sum(), (X, Y))
    assert plain_launches["gram_bwd"] == 1
    wx, wy = torch.autograd.grad(tfg.fused_gram_levels_ref(X, Y, 3).sum(),
                                 (X, Y))
    _close((gx, gy), (wx, wy), rtol=1e-12)
    # X is Y: both gradients reach the one tensor and add up
    (gxx,) = torch.autograd.grad(
        (tfg._GramLevels.apply(X, X, 3, True) ** 2).sum(), X)
    (wxx,) = torch.autograd.grad(
        (tfg.fused_gram_levels_ref(X, X, 3) ** 2).sum(), X)
    _close((gxx,), (wxx,), rtol=1e-12)
    # only the inputs that need a gradient get one
    Yc = Y.detach()
    out = tfg._GramLevels.apply(X, Yc, 3, False)
    (gx,) = torch.autograd.grad(out.sum(), X)
    assert gx.shape == X.shape and Yc.grad is None
    assert torch.autograd.gradcheck(
        lambda a, b: tfg._GramLevels.apply(a, b, 2, True), (X, Y))


def test_diag_function_wiring(plain_launches):
    rng = np.random.default_rng(4)
    X = torch.tensor(_walks(rng, 3, 5, 2), requires_grad=True)
    out = tfg._DiagLevels.apply(X, 3, True)
    (gx,) = torch.autograd.grad(out.sum(), X)
    (wx,) = torch.autograd.grad(tfg.fused_diag_levels_ref(X, 3).sum(), X)
    _close((gx,), (wx,), rtol=1e-12)
    assert torch.autograd.gradcheck(
        lambda a: tfg._DiagLevels.apply(a, 2, True), (X,))


@pytest.mark.parametrize("increments", [True, False])
def test_tens_seq_function_wiring(plain_launches, increments):
    Z, X, _ = _tens_inputs(5, 2, increments, T=3, N=2, L=5)
    Z = torch.tensor(Z, requires_grad=True)
    X = torch.tensor(X, requires_grad=True)
    out = tts._TensSeqLevels.apply(Z, X, 2, True, increments)
    gz, gx = torch.autograd.grad(out.sum(), (Z, X))
    assert plain_launches["tens_bwd"] == 1
    wz, wx = torch.autograd.grad(
        tts.fused_tens_seq_levels_ref(Z, X, 2, True, increments).sum(),
        (Z, X))
    _close((gz, gx), (wz, wx), rtol=1e-12)
    Xc = X.detach()
    (gz,) = torch.autograd.grad(
        tts._TensSeqLevels.apply(Z, Xc, 2, True, increments).sum(), Z)
    assert gz.shape == Z.shape
    assert torch.autograd.gradcheck(
        lambda z, x: tts._TensSeqLevels.apply(z, x, 2, True, increments),
        (Z, X))
