"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:randomly tests/test_torch_cuda_kernels.py

Tests marked ``cuda`` skip without a CUDA device. Tolerances (scaled error
max|kernel − plain| / max|plain|): forward kernels 1e-11 in float64, where
only the summation order differs, and 1e-4 in float32, for float32 exp and
DP sums over up to 99 columns taken in another order than the plain
version's; the general engines' forward kernels (any order, every base
kind) 1e-10 and 3e-4: at order p a cell sums up to p² run-length states,
and a degree-3 Poly base cubes the rounding of its dot product.
Backward kernels 1e-10 in float64 and 1e-3 in float32: they rebuild the
forward's DP states by subtraction in the reverse sweep (each rebuilt
state carries the rounding of every later column) and add their results
with atomics in an order that changes from run to run.
"""

import numpy as np
import pytest
import torch

from gpsig_tpu_torch.kernels.signature import (SignatureCosine,
                                               SignatureLinear,
                                               SignaturePoly, SignatureRBF)
from gpsig_tpu_torch.ops.cuda import _build
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho
from gpsig_tpu_torch.ops.cuda import sig_gram as tsg_
from gpsig_tpu_torch.ops.cuda import tens_seq as tts
from gpsig_tpu_torch.ops.cuda import tens_seq_general as ttsg

torch.set_num_threads(1)
TOLS = [(torch.float64, 1e-11), (torch.float32, 1e-4)]
GEN_TOLS = [(torch.float64, 1e-10), (torch.float32, 3e-4)]
BWD_TOLS = [(torch.float64, 1e-10), (torch.float32, 1e-3)]
KINDS = ["linear", "rbf", "poly2", "poly3", "cosine"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _walks(rng, n, L, d):
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


def _scaled_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _scaled_errs(got, want):
    return max(_scaled_err(a, b) for a, b in zip(got, want))


def test_kernel_inputs_must_be_cuda_tensors():
    X = torch.zeros(2, 5, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.check_inputs("k", (X,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.check_inputs("k", (torch.zeros(2, 5, 2, device="meta"),))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("rbf", [True, False])
def test_gram_and_diag_kernels_match_plain(cuda_device, dtype, tol, rbf):
    rng = np.random.default_rng(3)
    for L, nl in [(7, 3), (50, 4), (100, 7)]:
        X = torch.as_tensor(_walks(rng, 9, L, 2), dtype=dtype,
                            device=cuda_device)
        Y = torch.as_tensor(_walks(rng, 6, L, 2), dtype=dtype,
                            device=cuda_device)
        with torch.no_grad():
            n0 = (tfg.gram_launches, tfg.diag_launches)
            got = tfg.fused_gram_levels(X, Y, nl, rbf)
            dgot = tfg.fused_diag_levels(X, nl, rbf)
            assert (tfg.gram_launches, tfg.diag_launches) == (n0[0] + 1,
                                                              n0[1] + 1)
            assert got.shape == (nl + 1, 9, 6) and dgot.shape == (nl + 1, 9)
            assert _scaled_err(got, tfg.fused_gram_levels_ref(
                X, Y, nl, rbf)) < tol
            assert _scaled_err(dgot, tfg.fused_diag_levels_ref(
                X, nl, rbf)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("increments", [False, True])
def test_tens_seq_kernel_matches_plain(cuda_device, dtype, tol, increments):
    rng = np.random.default_rng(4)
    for T, N, L, nl, rbf in [(3, 5, 7, 2, True), (7, 130, 50, 5, True),
                             (4, 33, 20, 7, False)]:
        F = nl * (nl + 1) // 2
        shape = (T, F, 2, 3) if increments else (T, F, 3)
        Z = torch.as_tensor(0.4 * rng.standard_normal(shape), dtype=dtype,
                            device=cuda_device)
        X = torch.as_tensor(_walks(rng, N, L, 3), dtype=dtype,
                            device=cuda_device)
        with torch.no_grad():
            n0 = tts.launches
            got = tts.fused_tens_seq_levels(Z, X, nl, rbf, increments)
            assert tts.launches == n0 + 1
            want = tts.fused_tens_seq_levels_ref(Z, X, nl, rbf, increments)
        assert got.shape == (nl + 1, T, N)
        assert _scaled_err(got, want) < tol


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    X = torch.zeros(3, 8, 2, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tfg.fused_diag_levels(X.transpose(0, 1), 3)
    with pytest.raises(ValueError, match="compiled range"):
        tfg.fused_diag_levels(
            torch.zeros(2, tfg.MAX_LENGTH + 1, 2, device=cuda_device), 3)
    with pytest.raises(TypeError, match="float32 or float64"):
        tfg.fused_diag_levels(X.half(), 3)
    with pytest.raises(NotImplementedError, match="Queue 2 item 10"):
        SignatureRBF(2, 8, order=2, device=cuda_device).K(X)


@pytest.mark.cuda
@pytest.mark.parametrize("ctor", [SignatureRBF, SignatureLinear])
def test_signature_kernel_on_card_matches_cpu(cuda_device, ctor):
    rng = np.random.default_rng(5)
    X = torch.as_tensor(_walks(rng, 6, 12, 2))
    F = 3 * 4 // 2
    Z = torch.as_tensor(0.4 * rng.standard_normal((5, F, 2, 2)))
    kern = ctor(2, 3, lengthscales=[0.8, 1.3], num_lags=1, device="cpu")
    Z = torch.cat([Z, Z], dim=-1)  # lag-augmented factor space
    with torch.no_grad():
        want = (kern.K(X), kern.K_tens_vs_seq(Z, X, increments=True))
        kern.to(cuda_device)
        got = (kern.K(X.to(cuda_device)),
               kern.K_tens_vs_seq(Z.to(cuda_device), X.to(cuda_device),
                                  increments=True))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("rbf", [True, False])
def test_gram_backward_kernel_matches_plain(cuda_device, dtype, tol, rbf):
    rng = np.random.default_rng(6)
    for L, nl in [(7, 3), (50, 4), (100, 7)]:
        X = torch.as_tensor(_walks(rng, 9, L, 2), dtype=dtype,
                            device=cuda_device)
        Y = torch.as_tensor(_walks(rng, 6, L, 2), dtype=dtype,
                            device=cuda_device)
        g = torch.as_tensor(rng.standard_normal((nl + 1, 9, 6)), dtype=dtype,
                            device=cuda_device)
        n0 = tfg.gram_bwd_launches
        got = tfg.fused_gram_levels_bwd(X, Y, g, nl, rbf)
        assert tfg.gram_bwd_launches == n0 + 1
        want = tfg.fused_gram_levels_bwd_ref(X, Y, g, nl, rbf)
        assert [t.shape for t in got] == [X.shape, Y.shape]
        assert _scaled_errs(got, want) < tol
        # X is Y: both gradients, from distinct buffers
        xb, yb = tfg.fused_gram_levels_bwd(X, X, g[:, :, :1].expand(
            nl + 1, 9, 9).contiguous(), nl, rbf)
        assert xb.data_ptr() != yb.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("increments", [False, True])
def test_tens_seq_backward_kernel_matches_plain(cuda_device, dtype, tol,
                                                increments):
    rng = np.random.default_rng(7)
    for T, N, L, nl, rbf in [(3, 5, 7, 2, True), (7, 130, 50, 5, True),
                             (4, 33, 100, 7, False), (5, 20, 50, 1, True)]:
        F = nl * (nl + 1) // 2
        shape = (T, F, 2, 3) if increments else (T, F, 3)
        Z = torch.as_tensor(0.4 * rng.standard_normal(shape), dtype=dtype,
                            device=cuda_device)
        X = torch.as_tensor(_walks(rng, N, L, 3), dtype=dtype,
                            device=cuda_device)
        g = torch.as_tensor(rng.standard_normal((nl + 1, T, N)), dtype=dtype,
                            device=cuda_device)
        n0 = tts.bwd_launches
        got = tts.tens_seq_bwd(Z, X, g, nl, rbf, increments)
        assert tts.bwd_launches == n0 + 1
        want = tts.tens_seq_bwd_ref(Z, X, g, nl, rbf, increments)
        assert [t.shape for t in got] == [Z.shape, X.shape]
        assert _scaled_errs(got, want) < tol


@pytest.mark.cuda
def test_gradients_flow_through_the_backward_kernels(cuda_device):
    """K(X) and Kuf on the card: autograd reaches every input through the
    backward kernels (the counters rise) and matches the CPU."""
    rng = np.random.default_rng(8)
    X = torch.tensor(_walks(rng, 6, 12, 2), requires_grad=True)
    F = 3 * 4 // 2
    Z = torch.tensor(0.4 * rng.standard_normal((5, F, 2, 2)),
                     requires_grad=True)
    kern = SignatureRBF(2, 3, lengthscales=[0.8, 1.3], device="cpu")

    def grads(kern, X, Z):
        loss = (kern.K(X) ** 2).sum() + kern.K_tens_vs_seq(
            Z, X, increments=True).sum()
        return torch.autograd.grad(loss, [X, Z, *kern.parameters()])

    want = grads(kern, X, Z)
    kern.to(cuda_device)
    n0 = (tfg.gram_bwd_launches, tts.bwd_launches)
    got = grads(kern, X.detach().to(cuda_device).requires_grad_(),
                Z.detach().to(cuda_device).requires_grad_())
    assert tfg.gram_bwd_launches > n0[0] and tts.bwd_launches > n0[1]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu(cuda_device):
    """Two float64 natgrad + Adam steps of a small SVGP (inducing tensors
    with increments, MultiClass) on the card against the same steps on the
    CPU, rtol 1e-8; the backward kernels carry the Adam half."""
    import copy

    from gpsig_tpu_torch.inducing import InducingTensors
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    rng = np.random.default_rng(9)
    nl, M, C = 3, 8, 3
    F = nl * (nl + 1) // 2
    Z = torch.as_tensor(0.4 * rng.standard_normal((M, F, 2, 2)))
    model = SVGP.create(SignatureRBF(2, nl, lengthscales=[0.8, 1.2],
                                     device="cpu"),
                        MultiClass(C), InducingTensors.create(Z, nl, True),
                        C, device="cpu")
    X = torch.as_tensor(_walks(rng, 10, 9, 2))
    Y = torch.as_tensor(rng.integers(0, C, 10))
    card = copy.deepcopy(model).to(cuda_device)
    out = {}
    n0 = (tfg.diag_launches, tts.bwd_launches)
    for name, m, x, y in (("cpu", model, X, Y),
                          ("card", card, X.to(cuda_device),
                           Y.to(cuda_device))):
        step = make_step_fn(1e-2, num_data=40, gamma=0.1)
        state, elbos = step.init(m), []
        for _ in range(2):
            state, elbo = step(state, x, y)
            elbos.append(elbo.cpu())
        out[name] = elbos + [
            p.detach().cpu() for p in m.parameters()]
    assert tts.bwd_launches > n0[1] and tfg.diag_launches > n0[0]
    for g, w in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-12)


def _offset_channel(X, Y, kind, c=0.7):
    """The kernel layer's Poly offset channel (x_extra = 1, y_extra = c)."""
    if not kind.startswith("poly"):
        return X, Y
    return (torch.cat([X, torch.ones_like(X[..., :1])], -1),
            torch.cat([Y, torch.full_like(Y[..., :1], c)], -1))


def _gram_ho_inputs(kind):
    """The general Gram kernel's test cases: (L, nl, order, difference,
    X [9, L, 2], Y [6, L, 2], step scale). A raw (undifferenced) Poly Gram
    of these walks exceeds float32's range at 7 levels, so that kind takes
    steps 10× shorter there (test_raw_poly_gram_overflows_float32 checks
    the reason)."""
    rng = np.random.default_rng(10)
    for L, nl, order in [(7, 3, 2), (20, 4, 1), (50, 4, 3), (66, 5, 2),
                         (100, 7, 7)]:
        for difference in (True, False):
            scale = 0.1 if kind.startswith("poly") and not difference else 1
            yield (L, nl, order, difference, _walks(rng, 9, L, 2),
                   _walks(rng, 6, L, 2), scale)


@pytest.mark.parametrize("kind", ["poly2", "poly3"])
def test_raw_poly_gram_overflows_float32(kind):
    """At unit step scale the exact (float64) raw Poly Gram of the nl=7 case
    exceeds float32's largest value, so the plain float32 version is not
    finite there; at the test's scale it is well inside the range."""
    f32_max = torch.finfo(torch.float32).max
    *_, (L, nl, order, difference, X, Y, scale) = _gram_ho_inputs(kind)
    assert (L, nl, difference) == (100, 7, False)

    def plain(s, dtype):
        a, b = _offset_channel(torch.as_tensor(s * X, dtype=dtype),
                               torch.as_tensor(s * Y, dtype=dtype), kind)
        return tfgho.fused_gram_ho_levels_ref(a, b, nl, order, kind,
                                              difference)

    assert plain(1, torch.float64).abs().max() > f32_max
    assert not torch.isfinite(plain(1, torch.float32)).all()
    assert plain(scale, torch.float64).abs().max() < 1e-6 * f32_max


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_gram_ho_kernel_matches_plain(cuda_device, dtype, tol, kind):
    for L, nl, order, difference, Xn, Yn, scale in _gram_ho_inputs(kind):
        X = torch.as_tensor(scale * Xn, dtype=dtype, device=cuda_device)
        Y = torch.as_tensor(scale * Yn, dtype=dtype, device=cuda_device)
        X, Y = _offset_channel(X, Y, kind)
        with torch.no_grad():
            n0 = tfgho.launches
            got = tfgho.fused_gram_ho_levels(X, Y, nl, order, kind,
                                             difference)
            assert tfgho.launches == n0 + 1
            want = tfgho.fused_gram_ho_levels_ref(X, Y, nl, order, kind,
                                                  difference)
        assert got.shape == (nl + 1, 9, 6)
        assert _scaled_err(got, want) < tol, (L, nl, order, difference)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
@pytest.mark.parametrize("kind", KINDS)
def test_tens_seq_general_kernel_matches_plain(cuda_device, dtype, tol,
                                               kind):
    rng = np.random.default_rng(11)
    for T, N, L, nl, order in [(3, 5, 7, 2, 2), (7, 130, 50, 5, 2),
                               (4, 33, 20, 7, 3), (5, 20, 30, 4, 1),
                               (2, 9, 12, 7, 7)]:
        for increments in (False, True):
            for difference in (True, False):
                F = nl * (nl + 1) // 2
                shape = (T, F, 2, 3) if increments else (T, F, 3)
                Z = torch.as_tensor(0.4 * rng.standard_normal(shape),
                                    dtype=dtype, device=cuda_device)
                X = torch.as_tensor(_walks(rng, N, L, 3), dtype=dtype,
                                    device=cuda_device)
                X, Z = _offset_channel(X, Z, kind)
                with torch.no_grad():
                    n0 = ttsg.launches
                    got = ttsg.fused_tens_seq_general_levels(
                        Z, X, nl, order, kind, increments, difference)
                    assert ttsg.launches == n0 + 1
                    want = ttsg.fused_tens_seq_general_levels_ref(
                        Z, X, nl, order, kind, increments, difference)
                assert got.shape == (nl + 1, T, N)
                assert _scaled_err(got, want) < tol, (nl, order, increments,
                                                      difference)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
def test_sig_gram_kernels_match_plain(cuda_device, dtype, tol):
    rng = np.random.default_rng(12)
    with pytest.raises(ValueError, match="L2 must be <= 128"):
        tsg_.sig_gram_levels(torch.zeros(1, 5, 129, device=cuda_device), 3)
    for B, L1, L2, nl in [(5, 9, 12, 5), (9, 49, 49, 5), (3, 100, 70, 7),
                          (4, 140, 30, 3), (2, 1, 1, 2)]:
        M = torch.as_tensor(0.4 * rng.standard_normal((B, L1, L2)),
                            dtype=dtype, device=cuda_device)
        with torch.no_grad():
            n0 = (tsg_.launches, tsg_.ho_launches)
            got = tsg_.sig_gram_levels(M, nl)
            assert _scaled_err(got, tsg_.sig_gram_levels_ref(M, nl)) < tol
            for order in (2, 3, nl):
                got = tsg_.sig_gram_levels_ho(M, nl, max(order, 2))
                want = tsg_.sig_gram_levels_ho_ref(M, nl, max(order, 2))
                assert got.shape == (nl + 1, B)
                assert _scaled_err(got, want) < tol, (L1, L2, nl, order)
            assert (tsg_.launches, tsg_.ho_launches) == (n0[0] + 1,
                                                         n0[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("ctor,kw", [
    (SignatureRBF, dict(order=2)),
    (SignatureRBF, dict(order=1, difference=False)),
    (SignatureLinear, dict(order=3, num_lags=1)),
    (SignaturePoly, dict(order=2, offset=0.6, degree=3)),
    (SignatureCosine, dict(order=2, difference=False)),
])
def test_general_signature_kernel_on_card_matches_cpu(cuda_device, ctor,
                                                      kw):
    """K, Kdiag, Kuf through the general kernels on the card (counters
    rise, the tuned order-1 ones do not) against the CPU, float64."""
    rng = np.random.default_rng(13)
    X = torch.as_tensor(_walks(rng, 6, 12, 2))
    X2 = torch.as_tensor(_walks(rng, 4, 12, 2))
    width = 2 * (1 + kw.get("num_lags", 0))
    Z = torch.as_tensor(0.4 * rng.standard_normal((5, 10, 2, width)))
    kern = ctor(2, 4, lengthscales=[0.8, 1.3], device="cpu", **kw)

    def calls(X, X2, Z):
        return (kern.K(X), kern.K(X, X2), kern.K_tens_vs_seq(Z, X, True),
                kern.Kdiag(X, return_levels=True))

    with torch.no_grad():
        want = calls(X, X2, Z)
        kern.to(cuda_device)
        before = (tfg.gram_launches, tfg.diag_launches, tts.launches,
                  tfgho.launches, ttsg.launches,
                  tsg_.launches + tsg_.ho_launches)
        got = calls(*(t.to(cuda_device) for t in (X, X2, Z)))
        after = (tfg.gram_launches, tfg.diag_launches, tts.launches,
                 tfgho.launches, ttsg.launches,
                 tsg_.launches + tsg_.ho_launches)
    assert after[:3] == before[:3]
    assert all(a > b for a, b in zip(after[3:], before[3:]))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_gram_ho_backward_kernel_matches_plain(cuda_device, dtype, tol,
                                                     kind):
    rng = np.random.default_rng(15)
    for L, nl, order, difference, Xn, Yn, scale in _gram_ho_inputs(kind):
        X = torch.as_tensor(scale * Xn, dtype=dtype, device=cuda_device)
        Y = torch.as_tensor(scale * Yn, dtype=dtype, device=cuda_device)
        X, Y = _offset_channel(X, Y, kind)
        g = torch.as_tensor(rng.standard_normal((nl + 1, 9, 6)), dtype=dtype,
                            device=cuda_device)
        args = (nl, order, kind, difference)
        n0 = tfgho.bwd_launches
        got = tfgho.fused_gram_ho_levels_bwd(X, Y, g, *args)
        assert tfgho.bwd_launches == n0 + 1
        want = tfgho.fused_gram_ho_levels_bwd_ref(X, Y, g, *args)
        assert [t.shape for t in got] == [X.shape, Y.shape]
        assert _scaled_errs(got, want) < tol, (L, nl, order, difference)
        # X is Y: both gradients, from distinct buffers
        xb, yb = tfgho.fused_gram_ho_levels_bwd(
            X, X, g[:, :, :1].expand(nl + 1, 9, 9).contiguous(), *args)
        assert xb.data_ptr() != yb.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("kind", KINDS)
def test_tens_seq_general_backward_kernel_matches_plain(cuda_device, dtype,
                                                        tol, kind):
    rng = np.random.default_rng(16)
    for T, N, L, nl, order in [(3, 5, 7, 2, 2), (7, 130, 50, 5, 2),
                               (4, 33, 20, 7, 3), (5, 20, 30, 4, 1),
                               (2, 9, 12, 7, 7)]:
        for increments in (False, True):
            for difference in (True, False):
                F = nl * (nl + 1) // 2
                shape = (T, F, 2, 3) if increments else (T, F, 3)
                Z = torch.as_tensor(0.4 * rng.standard_normal(shape),
                                    dtype=dtype, device=cuda_device)
                X = torch.as_tensor(_walks(rng, N, L, 3), dtype=dtype,
                                    device=cuda_device)
                X, Z = _offset_channel(X, Z, kind)
                g = torch.as_tensor(rng.standard_normal((nl + 1, T, N)),
                                    dtype=dtype, device=cuda_device)
                args = (nl, order, kind, increments, difference)
                n0 = ttsg.bwd_launches
                got = ttsg.tens_seq_general_bwd(Z, X, g, *args)
                assert ttsg.bwd_launches == n0 + 1
                want = ttsg.tens_seq_general_bwd_ref(Z, X, g, *args)
                assert [t.shape for t in got] == [Z.shape, X.shape]
                assert _scaled_errs(got, want) < tol, (nl, order, increments,
                                                       difference)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
def test_sig_gram_backward_kernels_match_plain(cuda_device, dtype, tol):
    """Non-symmetric M with L1 != L2: M̄ must land on M's own entries."""
    rng = np.random.default_rng(17)
    for B, L1, L2, nl in [(5, 9, 12, 5), (9, 49, 49, 5), (3, 100, 70, 7),
                          (4, 140, 30, 3), (2, 1, 1, 2)]:
        M = torch.as_tensor(0.4 * rng.standard_normal((B, L1, L2)),
                            dtype=dtype, device=cuda_device)
        g = torch.as_tensor(rng.standard_normal((nl + 1, B)), dtype=dtype,
                            device=cuda_device)
        n0 = (tsg_.bwd_launches, tsg_.ho_bwd_launches)
        got = tsg_.sig_gram_levels_bwd(M, g, nl)
        assert got.shape == M.shape
        assert _scaled_err(got, tsg_.sig_gram_levels_bwd_ref(M, g, nl)) < tol
        for order in (2, 3, nl):
            got = tsg_.sig_gram_levels_ho_bwd(M, g, nl, max(order, 2))
            want = tsg_.sig_gram_levels_ho_bwd_ref(M, g, nl, max(order, 2))
            assert _scaled_err(got, want) < tol, (L1, L2, nl, order)
        assert (tsg_.bwd_launches, tsg_.ho_bwd_launches) == (n0[0] + 1,
                                                             n0[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("ctor,kw", [
    (SignatureRBF, dict(order=2)),
    (SignatureRBF, dict(order=1, difference=False)),
    (SignaturePoly, dict(order=1, offset=0.6)),
    (SignatureCosine, dict(order=3, difference=False)),
])
def test_general_gradients_flow_through_the_backward_kernels(cuda_device,
                                                             ctor, kw):
    """K(X), K(X, X2) and Kuf through the general kernels on the card:
    autograd reaches every input and parameter (a Poly base's offset too)
    through the backward kernels, whose counters rise while the tuned
    order-1 ones stay put, and matches the CPU, float64."""
    rng = np.random.default_rng(14)
    X = torch.tensor(_walks(rng, 6, 12, 2), requires_grad=True)
    X2 = torch.tensor(_walks(rng, 4, 12, 2), requires_grad=True)
    Z = torch.tensor(0.4 * rng.standard_normal((5, 10, 2, 2)),
                     requires_grad=True)
    kern = ctor(2, 4, lengthscales=[0.8, 1.3], device="cpu", **kw)

    def grads(X, X2, Z):
        loss = ((kern.K(X) ** 2).sum() + kern.K(X, X2).sum()
                + (kern.K_tens_vs_seq(Z, X, increments=True) ** 2).sum())
        return torch.autograd.grad(loss, [X, X2, Z, *kern.parameters()])

    def counts():
        return ((tfg.gram_bwd_launches, tts.bwd_launches),
                (tfgho.bwd_launches, ttsg.bwd_launches,
                 tsg_.bwd_launches + tsg_.ho_bwd_launches))

    want = grads(X, X2, Z)
    kern.to(cuda_device)
    tuned0, general0 = counts()
    got = grads(*(t.detach().to(cuda_device).requires_grad_()
                  for t in (X, X2, Z)))
    tuned1, general1 = counts()
    assert tuned1 == tuned0
    assert all(a > b for a, b in zip(general1, general0))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda_device):
    """Constructors given no device build on the card."""
    from gpsig_tpu_torch.convert import from_jax_arrays
    from gpsig_tpu_torch.inducing import InducingTensors
    from gpsig_tpu_torch.likelihoods import Gaussian, MultiClass
    from gpsig_tpu_torch.models.gpr import GPR
    from gpsig_tpu_torch.models.svgp import SVGP

    kern = SignaturePoly(2, 3, order=2)
    feat = InducingTensors.create(torch.zeros(4, 6, 2, device=cuda_device), 3)
    made = [kern.raw_sigma, kern.base.raw_offset,
            SVGP.create(kern, MultiClass(3), feat, 3).q_mu,
            GPR.create(SignatureCosine(2, 3)).likelihood.raw_variance,
            Gaussian.create().raw_variance,
            from_jax_arrays({"a": np.ones(2)})["a"]]
    assert {t.device.type for t in made} == {"cuda"}


# -- the Goursat (signature-PDE) kernels ------------------------------------

def _path_increments(rng, B, S, T):
    """B increment grids [S, T] of the PDE slice's data:
    ⟨δx_i, δy_j⟩ of ``classification_sequences`` paths of lengths S + 1
    and T + 1 at lengthscale 1.5."""
    from gpsig_tpu_torch.data.synthetic import classification_sequences

    seed = int(rng.integers(1 << 30))
    X, _ = classification_sequences(seed, B, S + 1, 2, 2)
    Y, _ = classification_sequences(seed + 1, B, T + 1, 2, 2)
    return np.einsum("bid,bjd->bij", np.diff(X, axis=1),
                     np.diff(Y, axis=1)) / 1.5**2


# (Su, Tu, dyadic order): chip_smoke.py's grids (the main path's joint
# Gram (49, 49) and Kuf (7, 49) pairs, tiny and uneven sides) at orders
# 0-2 and L=200 at orders 2-3 (1,592 refined rows over 512 threads), a
# length-1 sequence, and (199, 160) at order 0, whose float64 gradient
# keeps neither its u store nor its sums in shared memory
GOURSAT_CASES = [(Su, Tu, o) for Su, Tu in [(49, 49), (7, 49), (1, 1),
                                            (13, 5)] for o in (0, 1, 2)]
GOURSAT_CASES += [(199, 199, 2), (199, 199, 3), (0, 3, 1), (199, 160, 0)]
# (dtype, forward tol, gradient tol), scaled: the kernels repeat the plain
# sweep's arithmetic per cell, with fused multiply-adds, over up to 3,184
# dependent diagonals whose values cancel; the gradient adds its terms
# with atomics in an order that changes from run to run
GOURSAT_TOLS = [(torch.float64, 1e-10, 1e-10), (torch.float32, 1e-4, 1e-3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ftol,gtol", GOURSAT_TOLS)
def test_goursat_kernels_match_plain(cuda_device, dtype, ftol, gtol):
    from gpsig_tpu_torch.ops import goursat as tg
    from gpsig_tpu_torch.ops.cuda import goursat as tgs

    rng = np.random.default_rng(18)
    for Su, Tu, o in GOURSAT_CASES:
        inc = torch.as_tensor(_path_increments(rng, 5, Su, Tu), dtype=dtype,
                              device=cuda_device)
        gbar = torch.as_tensor(rng.standard_normal(5), dtype=dtype,
                               device=cuda_device)
        n0 = (tgs.launches, tgs.fused_launches, tgs.grad_launches)
        fast = tgs.goursat_corner_fast(tg.refine_increments(inc, o))
        refined = tgs.goursat_corner_refined(inc, o)
        grad = tgs.goursat_grad_refined(inc, o, gbar)
        assert (tgs.launches, tgs.fused_launches,
                tgs.grad_launches) == tuple(n + 1 for n in n0)
        want = tgs.goursat_corner_refined_ref(inc, o)
        want_g = tgs.goursat_grad_refined_ref(inc, o, gbar)
        assert grad.shape == inc.shape and refined.shape == (5,)
        if Su * Tu == 0:
            assert bool((refined == 1).all() and (fast == 1).all())
            assert not grad.any()
            continue
        assert _scaled_err(fast, want) < ftol, (Su, Tu, o)
        assert _scaled_err(refined, want) < ftol, (Su, Tu, o)
        assert _scaled_err(grad, want_g) < gtol, (Su, Tu, o)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "scan"])
def test_untruncated_kernel_on_card_matches_cpu(cuda_device, engine):
    """K(X), K(X, X2), K_sym_psd and their gradients through the Goursat
    kernels, float64, against the CPU: 'auto' launches the in-kernel
    refinement kernel, 'scan' the given-grid kernel on the refined grid,
    and both backwards the adjoint kernel."""
    from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel
    from gpsig_tpu_torch.ops.cuda import goursat as tgs

    rng = np.random.default_rng(19)
    X = torch.tensor(_walks(rng, 5, 9, 2), requires_grad=True)
    X2 = torch.tensor(_walks(rng, 3, 6, 2), requires_grad=True)
    kern = UntruncatedSignatureKernel.create(
        2, lengthscales=[0.9, 1.4], normalization=True, dyadic_order=2,
        engine=engine, device="cpu")

    def grads(X, X2):
        loss = ((kern.K(X) ** 2).sum() + kern.K(X, X2).sum()
                + kern.K_sym_psd(X2).trace())
        return torch.autograd.grad(loss, [X, X2, *kern.parameters()])

    want = grads(X, X2)
    kern.to(cuda_device)
    n0 = (tgs.launches, tgs.fused_launches, tgs.grad_launches)
    got = grads(*(t.detach().to(cuda_device).requires_grad_()
                  for t in (X, X2)))
    moved = [b > a for a, b in zip(n0, (tgs.launches, tgs.fused_launches,
                                        tgs.grad_launches))]
    assert moved == ([True, False, True] if engine == "scan"
                     else [False, True, True])
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_goursat_kernels_refuse_what_they_do_not_take(cuda_device):
    """A CUDA tensor the kernels do not take raises: it never runs the
    plain sweep."""
    from gpsig_tpu_torch.ops.cuda import goursat as tgs

    inc = torch.zeros(2, 3, 3, dtype=torch.float16, device=cuda_device)
    gbar = torch.zeros(2, dtype=torch.float16, device=cuda_device)
    n0 = (tgs.launches, tgs.fused_launches, tgs.grad_launches)
    with pytest.raises(TypeError, match="float32 or float64"):
        tgs.goursat_corner_fast(inc)
    with pytest.raises(TypeError, match="float32 or float64"):
        tgs.goursat_corner_refined(inc, 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        tgs.goursat_grad_refined(inc, 1, gbar)
    with pytest.raises(ValueError, match="dyadic_order"):
        tgs.goursat_corner_refined(inc.float(), tgs.MAX_ORDER + 1)
    with pytest.raises(ValueError, match="exceeds"):
        tgs.goursat_corner_refined(
            torch.zeros(1, 5000, 2, device=cuda_device), 3)
    assert (tgs.launches, tgs.fused_launches, tgs.grad_launches) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2])
def test_inducing_sequences_with_the_truncated_kernel_on_card(cuda_device,
                                                              order):
    """Kuf between inducing sequences and longer data sequences goes through
    increment matrices and the sig_gram kernels (forward and backward) on
    the card, and matches the CPU in float64, gradients included."""
    from gpsig_tpu_torch.inducing import InducingSequences

    rng = np.random.default_rng(20)
    X = torch.tensor(_walks(rng, 6, 12, 2), requires_grad=True)
    feat = InducingSequences.create(torch.tensor(_walks(rng, 4, 5, 2)))
    kern = SignatureRBF(2, 3, order=order, lengthscales=[0.8, 1.3],
                        device="cpu")

    def run(X):
        Kuu, Kuf = feat.covariances(kern, X)
        loss = (Kuf ** 2).sum() + Kuu.sum()
        return (Kuu, Kuf, *torch.autograd.grad(
            loss, [X, feat.raw_Z, *kern.parameters()]))

    want = run(X)
    kern.to(cuda_device)
    feat.to(cuda_device)
    n0 = (tsg_.launches + tsg_.ho_launches,
          tsg_.bwd_launches + tsg_.ho_bwd_launches)
    got = run(X.detach().to(cuda_device).requires_grad_())
    assert tsg_.launches + tsg_.ho_launches > n0[0]
    assert tsg_.bwd_launches + tsg_.ho_bwd_launches > n0[1]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-12)
