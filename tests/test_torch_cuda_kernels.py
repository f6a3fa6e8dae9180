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

import sys

import numpy as np
import pytest
import torch

from gpsig_tpu_torch.kernels.signature import (SignatureCosine,
                                               SignatureLinear,
                                               SignaturePoly, SignatureRBF)
from gpsig_tpu_torch.ops.cuda import _build
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho
from gpsig_tpu_torch.ops.cuda import plan
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


def test_build_compiles_one_per_core_and_names_real_sources(tmp_path):
    """The build's compile pool returns every command's exit code and time
    in the order given, and its slowest-first list names sources that
    exist."""
    names = {src.name for src in _build._sources()}
    assert set(_build.SLOWEST_FIRST) <= names
    cmds = [[sys.executable, "-c", f"import sys; sys.exit({code})"]
            for code in (0, 3, 0)]
    codes, seconds = _build._compile(
        cmds, [tmp_path / f"{i}.txt" for i in range(3)])
    assert codes == [0, 3, 0]
    assert all(s >= 0 for s in seconds)


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
    """The order-1 forward's plans (one sequence a thread, blocks of 32, 64,
    128 threads by N) at N = 1, 31, 33, 50, 2048, lengths across the
    backward's chunk edges, d = 1-3, and past it (d = 4, 5) the general
    kernel at order 1, against the plain version."""
    rng = np.random.default_rng(4)
    for T, N, L, nl, rbf, d in [
            (3, 5, 7, 2, True, 3), (7, 130, 50, 5, True, 3),
            (4, 33, 20, 7, False, 3), (5, 1, 2, 1, True, 1),
            (5, 31, 3, 3, True, 2), (5, 33, 65, 4, True, 3),
            (5, 50, 66, 5, True, 2), (5, 50, 129, 6, False, 1),
            (5, 50, 150, 4, True, 3), (3, 2048, 50, 5, True, 3),
            (4, 40, 30, 5, True, 4), (4, 40, 30, 3, False, 5)]:
        F = nl * (nl + 1) // 2
        shape = (T, F, 2, d) if increments else (T, F, d)
        Z = torch.as_tensor(0.4 * rng.standard_normal(shape), dtype=dtype,
                            device=cuda_device)
        X = torch.as_tensor(_walks(rng, N, L, d) * np.sqrt(min(1, 100 / L)),
                            dtype=dtype, device=cuda_device)
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
    # above the launch plan's bound: 1024 DP rows (plan.MAX_ROWS) on the
    # Gram kernels; the diagonal takes every length (its rows in bands)
    long = torch.zeros(2, plan.MAX_ROWS + 2, 2, device=cuda_device)
    with pytest.raises(ValueError, match="at most 1024"):
        tfg.fused_gram_levels(long, long, 3)
    diag = tfg.fused_diag_levels(long, 3)  # a constant path: levels 1..3 0
    assert bool((diag[0] == 1).all() and (diag[1:] == 0).all())
    with pytest.raises(TypeError, match="float32 or float64"):
        tfg.fused_diag_levels(X.half(), 3)
    # the sig_gram kernels take num_levels + 1 <= 128 and every order
    # (past p = min(order, num_levels) = 7 the run-time-order instance);
    # past 1024 rows the kernel layer's Gram takes them (the shorter side
    # on the rows); only a matrix whose rows' states (and, in the
    # backward, checkpoints) exceed the workspace is refused
    M = torch.zeros(2, 5, 6, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="num_levels must be 1..127"):
        tsg_.sig_gram_levels(M, 128)
    for order in (4, 7, 8):
        assert bool((tsg_.sig_gram_levels_ho(M, 8, order)[1:] == 0).all())
    Mr = torch.as_tensor(0.3 * np.random.default_rng(4).standard_normal(
        (2, 5, 6)), device=cuda_device)
    assert _scaled_err(tsg_.sig_gram_levels_ho(Mr, 8, 8),
                       tsg_.sig_gram_levels_ho_ref(Mr, 8, 8)) < 1e-11
    # p = nl = 127 keeps 715,516 values a row in the backward and 32,508
    # in its checkpoints at L1 = 5: float64 takes 179 rows in the workspace
    wide = torch.zeros(1, 5, 188, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="workspace for one matrix's rows"):
        tsg_.sig_gram_levels_ho_bwd(
            wide, torch.ones(128, 1, dtype=torch.float64,
                             device=cuda_device), 127, 127)
    assert torch.isfinite(SignatureRBF(2, 8, order=2,
                                       device=cuda_device).K(X)).all()
    K = SignatureRBF(2, 3, device=cuda_device).K(long.double())
    assert torch.isfinite(K).all() and K.shape == (2, 2)


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
    """The order-1 backward's plans (a warp a pair; 2 points a lane up to
    64 DP points, else 4 in chunks of 128; 1, 2, 4 warps and several pairs
    a warp) at N = 1, 31, 33, 50, lengths at the chunk edges, d = 1-3, and
    past it the general kernel at order 1 (d = 4, 5, and 54 / 55, where its
    float32 columns leave shared memory), against the plain version."""
    rng = np.random.default_rng(7)
    for T, N, L, nl, rbf, d in [
            (3, 5, 7, 2, True, 3), (7, 130, 50, 5, True, 3),
            (4, 33, 100, 7, False, 3), (5, 20, 50, 1, True, 3),
            (5, 1, 2, 3, True, 1), (5, 31, 3, 4, True, 2),
            (5, 33, 65, 5, True, 3), (5, 50, 66, 6, True, 2),
            (5, 50, 129, 7, True, 1), (5, 50, 130, 7, True, 3),
            (64, 50, 150, 4, True, 2), (300, 40, 50, 5, True, 3),
            (4, 20, 30, 5, True, 4), (4, 20, 30, 3, False, 5),
            (3, 6, 20, 5, True, 54), (3, 6, 20, 5, True, 55)]:
        F = nl * (nl + 1) // 2
        shape = (T, F, 2, d) if increments else (T, F, d)
        Z = torch.as_tensor(0.4 * rng.standard_normal(shape), dtype=dtype,
                            device=cuda_device)
        X = torch.as_tensor(_walks(rng, N, L, d) * np.sqrt(min(1, 100 / L)),
                            dtype=dtype, device=cuda_device)
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
    # past 1024 rows, in bands: a zero matrix has levels 1.. exactly 0
    past = tsg_.sig_gram_levels(torch.zeros(1, 5, plan.MAX_ROWS + 1,
                                            device=cuda_device), 3)
    assert bool((past[0] == 1).all() and (past[1:] == 0).all())
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
# dependent diagonals whose values cancel; the gradient sums its terms per
# unrefined cell in another order than the plain sweep
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_goursat_gradient_is_deterministic(cuda_device, dtype):
    """The gradient writes each unrefined cell once, with no atomics: two
    launches give the same bits, in the warp design (the joint Gram's grid
    at dyadic orders 0-2, Kuf's at 2, a small grid at 3) and the block
    design (past 256 refined rows, or 2^4 refined rows a unrefined one)."""
    from gpsig_tpu_torch.ops.cuda import goursat as tgs

    rng = np.random.default_rng(28)
    designs = set()
    for Su, Tu, o in [(49, 49, 1), (49, 49, 0), (49, 49, 2), (7, 49, 2),
                      (13, 5, 3), (70, 70, 2), (5, 7, 4)]:
        designs.add(tgs.warp_plan(Su, Tu, o, dtype.itemsize) is not None)
        inc = torch.as_tensor(_path_increments(rng, 64, Su, Tu), dtype=dtype,
                              device=cuda_device)
        gbar = torch.as_tensor(rng.standard_normal(64), dtype=dtype,
                               device=cuda_device)
        first = tgs.goursat_grad_refined(inc, o, gbar)
        second = tgs.goursat_grad_refined(inc, o, gbar)
        assert torch.equal(first, second), (Su, Tu, o)
    assert designs == {True, False}


@pytest.mark.cuda
def test_symmetric_pde_gram_solves_the_triangle_on_card(cuda_device):
    """K(X) solves the pairs i <= j and mirrors them: on the card, the
    solved entries are bitwise those of the full solve of every pair, the
    rest agree to rounding."""
    from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel

    rng = np.random.default_rng(29)
    X = torch.as_tensor(_walks(rng, 12, 20, 2), device=cuda_device)
    kern = UntruncatedSignatureKernel.create(
        2, lengthscales=[0.9, 1.4], dyadic_order=1, device=cuda_device)
    with torch.no_grad():
        Xs = kern._scaled(X)
        tri, full = kern._solve_pairs(Xs), kern._solve_pairs(Xs, Xs)
    iu, ju = torch.triu_indices(12, 12, device=cuda_device)
    assert torch.equal(tri[iu, ju], full[iu, ju])
    torch.testing.assert_close(tri, full, rtol=1e-12, atol=0)


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
    with pytest.raises(ValueError, match="sweep positions"):
        tgs.goursat_corner_refined(torch.zeros(1, 2, 2, device=cuda_device),
                                   30)
    assert (tgs.launches, tgs.fused_launches, tgs.grad_launches) == n0
    # past 2^15 refined points a side it runs: zero increments give u = 1
    u = tgs.goursat_corner_refined(
        torch.zeros(1, 5000, 2, device=cuda_device), 3)
    assert bool((u == 1).all())


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


# -- sequences longer than one warp's 128 rows ------------------------------

LONG = [130, 150, 300]


def _long_walks(rng, n, L, d):
    """Walks whose steps shrink like 1/√L, so that the unnormalised levels
    at L = 300 stay as far inside float32's range as L = 50's do."""
    return (0.3 * np.sqrt(50 / L) * rng.standard_normal((n, L, d))).cumsum(1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("L", LONG + [512])
def test_long_order1_kernels_match_plain(cuda_device, dtype, tol, L):
    """The order-1 Gram, diagonal and Gram backward past 129 steps (the
    rows over several warps of one block), RBF and Linear; L = 512 at
    d = 8, the stated range."""
    rng = np.random.default_rng(21)
    d = 8 if L == 512 else 2
    btol = dict(BWD_TOLS)[dtype]
    for rbf in (True, False):
        X = torch.as_tensor(_long_walks(rng, 5, L, d), dtype=dtype,
                            device=cuda_device)
        Y = torch.as_tensor(_long_walks(rng, 3, L, d), dtype=dtype,
                            device=cuda_device)
        g = torch.as_tensor(rng.standard_normal((5, 5, 3)), dtype=dtype,
                            device=cuda_device)
        with torch.no_grad():
            got = tfg.fused_gram_levels(X, Y, 4, rbf)
            dgot = tfg.fused_diag_levels(X, 4, rbf)
        assert _scaled_err(got, tfg.fused_gram_levels_ref(X, Y, 4, rbf)) \
            < tol, (L, rbf)
        assert _scaled_err(dgot, tfg.fused_diag_levels_ref(X, 4, rbf)) \
            < tol, (L, rbf)
        bgot = tfg.fused_gram_levels_bwd(X, Y, g, 4, rbf)
        bwant = tfg.fused_gram_levels_bwd_ref(X, Y, g, 4, rbf)
        assert _scaled_errs(bgot, bwant) < btol, (L, rbf)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
@pytest.mark.parametrize("L", LONG)
def test_long_general_gram_kernels_match_plain(cuda_device, dtype, tol, L):
    """The general Gram and its backward past 128 rows: orders 1-3, with
    and without difference, RBF and Poly."""
    rng = np.random.default_rng(22)
    btol = dict(BWD_TOLS)[dtype]
    for kind, order, difference in [("rbf", 2, True), ("rbf", 3, False),
                                    ("poly2", 1, True), ("poly2", 2, False)]:
        X = torch.as_tensor(_long_walks(rng, 4, L, 2), dtype=dtype,
                            device=cuda_device)
        Y = torch.as_tensor(_long_walks(rng, 3, L, 2), dtype=dtype,
                            device=cuda_device)
        X, Y = _offset_channel(X, Y, kind)
        g = torch.as_tensor(rng.standard_normal((5, 4, 3)), dtype=dtype,
                            device=cuda_device)
        args = (4, order, kind, difference)
        with torch.no_grad():
            got = tfgho.fused_gram_ho_levels(X, Y, *args)
        want = tfgho.fused_gram_ho_levels_ref(X, Y, *args)
        assert _scaled_err(got, want) < tol, (L, args)
        bgot = tfgho.fused_gram_ho_levels_bwd(X, Y, g, *args)
        bwant = tfgho.fused_gram_ho_levels_bwd_ref(X, Y, g, *args)
        assert _scaled_errs(bgot, bwant) < btol, (L, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
@pytest.mark.parametrize("shape", [(4, 130, 130), (4, 150, 150),
                                   (3, 300, 300), (6, 8, 150)])
def test_long_sig_gram_kernels_match_plain(cuda_device, dtype, tol, shape):
    """The sig_gram DP and its backward with L2 past 128 (over several
    warps), orders 1-3; (8, 150) is the inducing-sequence Kuf's shape."""
    rng = np.random.default_rng(23)
    B, L1, L2 = shape
    M = torch.as_tensor(rng.standard_normal(shape) / np.sqrt(L1 * L2) * 4,
                        dtype=dtype, device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((5, B)), dtype=dtype,
                        device=cuda_device)
    btol = dict(BWD_TOLS)[dtype]
    for order in (1, 2, 3):
        with torch.no_grad():
            got = (tsg_.sig_gram_levels(M, 4) if order == 1
                   else tsg_.sig_gram_levels_ho(M, 4, order))
        want = tsg_.sig_gram_levels_ho_ref(M, 4, order)
        assert _scaled_err(got, want) < tol, (shape, order)
        bgot = (tsg_.sig_gram_levels_bwd(M, g, 4) if order == 1
                else tsg_.sig_gram_levels_ho_bwd(M, g, 4, order))
        bwant = tsg_.sig_gram_levels_ho_bwd_ref(M, g, 4, order)
        assert _scaled_err(bgot, bwant) < btol, (shape, order)


@pytest.mark.cuda
@pytest.mark.parametrize("ctor,kw", [
    (SignatureRBF, dict()), (SignatureLinear, dict()),
    (SignatureRBF, dict(order=2)), (SignaturePoly, dict(offset=0.6)),
])
def test_long_signature_kernel_on_card_matches_cpu(cuda_device, ctor, kw):
    """K, Kdiag (unnormalised) and K_tens_vs_seq at L = 150 on the card
    against the CPU, float64, gradients included."""
    rng = np.random.default_rng(24)
    X = torch.tensor(_long_walks(rng, 5, 150, 2), requires_grad=True)
    Z = torch.tensor(0.4 * rng.standard_normal((4, 10, 2, 2)),
                     requires_grad=True)
    kern = ctor(2, 4, lengthscales=[0.8, 1.3], device="cpu", **kw)
    raw = ctor(2, 4, normalization=False, device="cpu", **kw)

    def calls(X, Z):
        out = (kern.K(X), raw.Kdiag(X), kern.K_tens_vs_seq(Z, X, True))
        loss = sum((o ** 2).sum() for o in out)
        return (*out, *torch.autograd.grad(loss, [X, Z]))

    want = calls(X, Z)
    kern.to(cuda_device)
    raw.to(cuda_device)
    got = calls(*(t.detach().to(cuda_device).requires_grad_()
                  for t in (X, Z)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
@pytest.mark.parametrize("nl", [8, 127])
def test_deep_sig_gram_kernels_match_plain(cuda_device, dtype, tol, nl):
    """The sig_gram DP and its backward past 7 levels (the per-level state
    in shared memory or, where the block's pairs do not fit, in the
    workspace), orders 1-3, one warp and several warps a pair."""
    rng = np.random.default_rng(25)
    btol = dict(BWD_TOLS)[dtype]
    for shape in [(5, 9, 12), (3, 20, 49), (2, 12, 140)]:
        B, L1, L2 = shape
        M = torch.as_tensor(rng.standard_normal(shape) / np.sqrt(L2) * 2,
                            dtype=dtype, device=cuda_device)
        g = torch.as_tensor(rng.standard_normal((nl + 1, B)), dtype=dtype,
                            device=cuda_device)
        for order in (1, 2, 3):
            with torch.no_grad():
                n0 = (tsg_.launches, tsg_.ho_launches)
                got = (tsg_.sig_gram_levels(M, nl) if order == 1
                       else tsg_.sig_gram_levels_ho(M, nl, order))
                assert sum((tsg_.launches, tsg_.ho_launches)) == sum(n0) + 1
            want = tsg_.sig_gram_levels_ho_ref(M, nl, order)
            assert got.shape == (nl + 1, B)
            assert _scaled_err(got, want) < tol, (shape, order)
            bgot = (tsg_.sig_gram_levels_bwd(M, g, nl) if order == 1
                    else tsg_.sig_gram_levels_ho_bwd(M, g, nl, order))
            bwant = tsg_.sig_gram_levels_ho_bwd_ref(M, g, nl, order)
            assert _scaled_err(bgot, bwant) < btol, (shape, order)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
def test_sig_gram_segments_and_bands(cuda_device, dtype, tol):
    """sig_gram on a segment of 8-32 lanes up to one warp's rows and in
    bands past them (the band carries in shared memory and, past it, in
    the workspace), forward and backward, orders 1-7 at 4, 7 and 10
    levels, against the plain versions."""
    rng = np.random.default_rng(28)
    for L2 in (7, 64, 65, 257, 700, 1300):
        M = torch.as_tensor(0.4 * rng.standard_normal((3, 9, L2))
                            / np.sqrt(L2 / 20), dtype=dtype,
                            device=cuda_device)
        for nl, order in ((4, 1), (4, 2), (7, 3), (7, 7), (10, 2), (10, 5)):
            g = torch.as_tensor(rng.standard_normal((nl + 1, 3)),
                                dtype=dtype, device=cuda_device)
            fwd = (tsg_.sig_gram_levels(M, nl) if order == 1
                   else tsg_.sig_gram_levels_ho(M, nl, order))
            bwd = (tsg_.sig_gram_levels_bwd(M, g, nl) if order == 1
                   else tsg_.sig_gram_levels_ho_bwd(M, g, nl, order))
            want = (tsg_.sig_gram_levels_ho_ref(M, nl, order),
                    tsg_.sig_gram_levels_ho_bwd_ref(M, g, nl, order))
            assert _scaled_err(fwd, want[0]) < tol, (L2, nl, order)
            assert _scaled_err(bwd, want[1]) < tol, (L2, nl, order)


@pytest.mark.cuda
def test_gram_past_1024_rows_on_card_matches_cpu(cuda_device):
    """K(X) at L = 1100 (past the fused Grams' rows: the pairs route and
    sig_gram's bands) and a two-length Gram against it, orders 1 and 2,
    on the card against the CPU in float64, gradients included."""
    rng = np.random.default_rng(29)
    X = torch.as_tensor(_walks(rng, 3, 1100, 2) * np.sqrt(50 / 1100))
    Z = torch.as_tensor(_walks(rng, 2, 8, 2))
    for order in (1, 2):
        kern = SignatureRBF(2, 3, order=order, device="cpu")

        def run(k, x, z):
            x, z = x.clone().requires_grad_(), z.clone().requires_grad_()
            out = (k.K(x), k.K(z, x))
            loss = sum(o.sum() for o in out)
            return (*out, *torch.autograd.grad(loss, (x, z)))

        want = run(kern, X, Z)
        got = run(kern.to(cuda_device), X.to(cuda_device),
                  Z.to(cuda_device))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_deep_sig_gram_takes_the_workspace(cuda_device):
    """Order 1 at 127 levels and L2 = 600 in float64: the forward's carries
    take about 650 KB a pair, so the state goes to the device workspace."""
    rng = np.random.default_rng(26)
    M = torch.as_tensor(rng.standard_normal((3, 8, 600)) / 30,
                        dtype=torch.float64, device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((128, 3)), dtype=torch.float64,
                        device=cuda_device)
    assert plan.sig_gram_plan(3, 8, 600, 127, 1, 8, False)["work"] > 0
    got = tsg_.sig_gram_levels(M, 127)
    assert _scaled_err(got, tsg_.sig_gram_levels_ref(M, 127)) < 1e-10
    got = tsg_.sig_gram_levels_bwd(M, g, 127)
    assert _scaled_err(got, tsg_.sig_gram_levels_bwd_ref(M, g, 127)) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2])
def test_deep_signature_kernel_on_card_matches_cpu(cuda_device, order):
    """num_levels = 10 through the kernel layer: K, Kdiag (unnormalised),
    the two-length Gram and K_tens_vs_seq on the card against the CPU,
    float64, gradients included."""
    rng = np.random.default_rng(27)
    X = torch.tensor(_walks(rng, 5, 14, 2), requires_grad=True)
    X2 = torch.as_tensor(_walks(rng, 3, 12, 2))
    Z = torch.tensor(0.4 * rng.standard_normal((4, 55, 2, 2)),
                     requires_grad=True)
    kern = SignatureRBF(2, 10, order=order, lengthscales=[0.8, 1.3],
                        device="cpu")
    raw = SignatureRBF(2, 10, order=order, normalization=False,
                       device="cpu")

    def calls(X, X2, Z):
        out = (kern.K(X), kern.K(X, X2), raw.Kdiag(X),
               kern.K_tens_vs_seq(Z, X, True))
        loss = sum((o ** 2).sum() for o in out)
        return (*out, *torch.autograd.grad(loss, [X, Z]))

    want = calls(X, X2, Z)
    kern.to(cuda_device)
    raw.to(cuda_device)
    got = calls(X.detach().to(cuda_device).requires_grad_(),
                X2.to(cuda_device),
                Z.detach().to(cuda_device).requires_grad_())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-12)


# -- the Gram forwards' segment plans ----------------------------------------

SEG_LENGTHS = [20, 50, 129, 150, 257, 300]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("L", SEG_LENGTHS)
def test_gram_segment_plans_match_plain(cuda_device, dtype, tol, L):
    """The order-1 Gram on the plans these lengths give (segments of 8, 16
    or 32 lanes at R rows a lane, both level bounds, the block design at
    L = 300), nl 1-7, RBF and Linear in turn: X [9] against Y [7] (pairs
    that fill no whole warp or block), and the symmetric Gram of X, its
    triangle against the full plain Gram and exactly symmetric."""
    rng = np.random.default_rng(L)
    for nl in range(1, 8):
        rbf = nl % 2 == 1
        X = torch.as_tensor(_long_walks(rng, 9, L, 2), dtype=dtype,
                            device=cuda_device)
        Y = torch.as_tensor(_long_walks(rng, 7, L, 2), dtype=dtype,
                            device=cuda_device)
        n0 = tfg.gram_launches
        with torch.no_grad():
            got = tfg.fused_gram_levels(X, Y, nl, rbf)
            sym = tfg.fused_gram_levels(X, X, nl, rbf, symmetric=True)
        assert tfg.gram_launches == n0 + 2
        assert _scaled_err(got, tfg.fused_gram_levels_ref(X, Y, nl, rbf)) \
            < tol, (L, nl)
        assert _scaled_err(sym, tfg.fused_gram_levels_ref(X, X, nl, rbf)) \
            < tol, (L, nl)
        assert torch.equal(sym, sym.transpose(1, 2))


def _segment_cases():
    """(nl, order, kind, difference): every kind, difference True and
    False and orders 1-3 at 4 levels; nl 1-7 at orders 2 and 7."""
    for kind in KINDS:
        for difference in (True, False):
            for order in (1, 2, 3):
                yield 4, order, kind, difference
    for nl in range(1, 8):
        yield nl, 2, "rbf", True
        yield nl, 7, "cosine", False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
@pytest.mark.parametrize("L", SEG_LENGTHS)
def test_general_gram_segment_plans_match_plain(cuda_device, dtype, tol,
                                                L):
    """The general Gram on the plans these lengths give (each order's rows
    a lane and level bound, lanes of 8, 16, 32 or the block design): X [9]
    against Y [7] and the symmetric Gram of X (with a Poly base X against
    X with its offset channel), the triangle against the full plain Gram
    and exactly symmetric. A raw Poly Gram takes steps 10x shorter (its
    high levels leave float32's range otherwise)."""
    rng = np.random.default_rng(L + 1)
    for nl, order, kind, difference in _segment_cases():
        scale = 0.1 if kind.startswith("poly") and not difference else 1
        X, Y = (torch.as_tensor(scale * _long_walks(rng, n, L, 2),
                                dtype=dtype, device=cuda_device)
                for n in (9, 7))
        Xq, Yq = _offset_channel(X, Y, kind)
        Xs, Ys = _offset_channel(X, X, kind)
        args = (nl, order, kind, difference)
        n0 = tfgho.launches
        with torch.no_grad():
            got = tfgho.fused_gram_ho_levels(Xq, Yq, *args)
            sym = tfgho.fused_gram_ho_levels(Xs, Ys, *args, symmetric=True)
        assert tfgho.launches == n0 + 2
        assert _scaled_err(got, tfgho.fused_gram_ho_levels_ref(
            Xq, Yq, *args)) < tol, (L, args)
        assert _scaled_err(sym, tfgho.fused_gram_ho_levels_ref(
            Xs, Ys, *args)) < tol, (L, args)
        assert torch.equal(sym, sym.transpose(1, 2)), (L, args)


@pytest.mark.cuda
@pytest.mark.parametrize("ctor,kw", [
    (SignatureRBF, dict()), (SignatureRBF, dict(order=2)),
    (SignaturePoly, dict(order=2, offset=0.6))])
def test_symmetric_gram_on_card_matches_the_plain_route(cuda_device, ctor,
                                                        kw):
    """K(X) on the card (its Gram solving the triangle) and its gradient,
    float64, against the same kernel on the CPU (the plain route)."""
    rng = np.random.default_rng(23)
    X = torch.as_tensor(_walks(rng, 11, 30, 2))
    W = torch.as_tensor(rng.standard_normal((11, 11)))
    kern = ctor(2, 4, lengthscales=[0.8, 1.3], device="cpu", **kw)
    out = {}
    for dev in ("cpu", cuda_device):
        kern.to(dev)
        x = X.to(dev).requires_grad_()
        K = kern.K(x)
        (gx,) = torch.autograd.grad((K * W.to(dev)).sum(), x)
        out[str(dev)] = (K.detach().cpu(), gx.cpu())
    for g, w in zip(out[str(cuda_device)], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)
    assert torch.equal(out[str(cuda_device)][0], out[str(cuda_device)][0].T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("L", [50, 150])
def test_gram_forwards_take_the_widest_sequences_they_took(cuda_device,
                                                          dtype, tol, L):
    """The widest d that the Gram forwards took before segments (231 / 115
    at L = 50 in float32 / float64, 192 / 95 at L = 150: lag-augmented or
    wide UEA data): one warp a pair where a segment covers the rows, its y
    read from global memory (the block's y do not fit its shared memory),
    else the block design: the order-1 Gram and the general one at orders
    2 and 3, X [3] against Y [5] and the triangle of X, against the plain
    versions (the steps scaled to d = 2's norm)."""
    d = {(50, 4): 231, (50, 8): 115, (150, 4): 192,
         (150, 8): 95}[L, dtype.itemsize]
    rng = np.random.default_rng(L + d)
    X, Y = (torch.as_tensor(np.sqrt(2 / d) * _long_walks(rng, n, L, d),
                            dtype=dtype, device=cuda_device)
            for n in (3, 5))
    assert tfg._forward_plan("k", X, False, 4)[2] == 1
    with torch.no_grad():
        for u, v, sym in ((X, Y, False), (X, X, True)):
            got = tfg.fused_gram_levels(u, v, 4, True, symmetric=sym)
            assert _scaled_err(got, tfg.fused_gram_levels_ref(u, v, 4)) \
                < tol, (L, d, sym)
            for order in (2, 3):
                args = (4, order, "rbf", True)
                got = tfgho.fused_gram_ho_levels(u, v, *args, symmetric=sym)
                assert _scaled_err(got, tfgho.fused_gram_ho_levels_ref(
                    u, v, *args)) < dict(GEN_TOLS)[dtype], (L, d, order,
                                                            sym)


# -- the Kuf kernels: chunk edges, long sequences, wide d -------------------

# the general backward's chunk: 32 lanes at 2 DP points a lane
KUF_CHUNK = plan.KUF_LANES * plan.KUF_POINTS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GEN_TOLS)
@pytest.mark.parametrize("L", [2, KUF_CHUNK, KUF_CHUNK + 1, KUF_CHUNK + 2,
                               150, 300])
def test_tens_seq_general_kernels_at_chunk_edges(cuda_device, dtype, tol, L):
    """The general Kuf and its backward on both sides of the backward's
    chunk edge (S·R DP points, with and without difference), at L = 150
    and 300, against their plain versions."""
    rng = np.random.default_rng(23)
    btol = dict(BWD_TOLS)[dtype]
    for kind, order, increments, difference in [
            ("rbf", 2, True, True), ("cosine", 3, False, False),
            ("poly2", 1, True, False), ("linear", 3, False, True)]:
        if difference and L < 2:
            continue
        nl = 4
        F = nl * (nl + 1) // 2
        shape = (3, F, 2, 2) if increments else (3, F, 2)
        Z = torch.as_tensor(0.4 * rng.standard_normal(shape), dtype=dtype,
                            device=cuda_device)
        X = torch.as_tensor(_long_walks(rng, 5, L, 2), dtype=dtype,
                            device=cuda_device)
        X, Z = _offset_channel(X, Z, kind)
        g = torch.as_tensor(rng.standard_normal((nl + 1, 3, 5)), dtype=dtype,
                            device=cuda_device)
        args = (nl, order, kind, increments, difference)
        with torch.no_grad():
            got = ttsg.fused_tens_seq_general_levels(Z, X, *args)
        want = ttsg.fused_tens_seq_general_levels_ref(Z, X, *args)
        assert _scaled_err(got, want) < tol, (L, kind, order)
        bgot = ttsg.tens_seq_general_bwd(Z, X, g, *args)
        bwant = ttsg.tens_seq_general_bwd_ref(Z, X, g, *args)
        assert _scaled_errs(bgot, bwant) < btol, (L, kind, order)


def _wide_inputs(rng, T, N, L, d, nl, dtype, device):
    """Walks at d whose steps keep the norms of d = 2, and inducing tensors
    with increments drawn from their increments (as the model's)."""
    X = _walks(rng, N, L, d) * np.sqrt(2 / d)
    inc = np.diff(X, axis=1).reshape(-1, d)
    F = nl * (nl + 1) // 2
    Z = inc[rng.integers(0, len(inc), T * F * 2)].reshape(T, F, 2, d)
    g = rng.standard_normal((nl + 1, T, N))
    return (torch.as_tensor(a, dtype=dtype, device=device) for a in (Z, X, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [64, 400, 1345])
def test_kuf_kernels_take_wide_d(cuda_device, dtype, d):
    """All four Kuf kernels at d = 64, 400 and 1345 (nl = 5, increments;
    MotorImagery's, past every kernel's shared memory, DuckDuckGeese's):
    each launches (its counter rises) and matches its plain version at
    the tolerances of the narrow cases."""
    rng = np.random.default_rng(24)
    Z, X, g = _wide_inputs(rng, 4, 6, 10, d, 5, dtype, cuda_device)
    ftol, gtol, btol = (dict(t)[dtype] for t in (TOLS, GEN_TOLS, BWD_TOLS))
    n0 = (tts.launches, tts.bwd_launches, ttsg.launches, ttsg.bwd_launches)
    with torch.no_grad():
        got = tts.fused_tens_seq_levels(Z, X, 5, True, True)
        assert _scaled_err(got, tts.fused_tens_seq_levels_ref(
            Z, X, 5, True, True)) < ftol
        got = ttsg.fused_tens_seq_general_levels(Z, X, 5, 2, "rbf", True,
                                                 True)
        assert _scaled_err(got, ttsg.fused_tens_seq_general_levels_ref(
            Z, X, 5, 2, "rbf", True, True)) < gtol
    got = tts.tens_seq_bwd(Z, X, g, 5, True, True)
    assert _scaled_errs(got, tts.tens_seq_bwd_ref(Z, X, g, 5, True,
                                                  True)) < btol
    got = ttsg.tens_seq_general_bwd(Z, X, g, 5, 2, "rbf", True, True)
    assert _scaled_errs(got, ttsg.tens_seq_general_bwd_ref(
        Z, X, g, 5, 2, "rbf", True, True)) < btol
    assert (tts.launches, tts.bwd_launches, ttsg.launches,
            ttsg.bwd_launches) == tuple(n + 1 for n in n0)


@pytest.mark.cuda
def test_order2_svgp_step_takes_wide_d(cuda_device):
    """Two float64 natgrad + Adam steps of an order-2 SVGP at d = 64 (nl =
    5, inducing tensors with increments) on the card, through the general
    Kuf and its backward (their columns in the workspace), against the
    same steps on the CPU, rtol 1e-8."""
    import copy

    from gpsig_tpu_torch.inducing import InducingTensors
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    rng = np.random.default_rng(25)
    nl, M, C, d = 5, 8, 3, 64
    Z, X, _ = _wide_inputs(rng, M, 10, 9, d, nl, torch.float64, "cpu")
    assert not plan.kuf_bwd_plan(M, 10, 2 * 15, d, 8)["staged"]
    model = SVGP.create(SignatureRBF(d, nl, order=2, device="cpu"),
                        MultiClass(C), InducingTensors.create(Z, nl, True),
                        C, device="cpu")
    Y = torch.as_tensor(rng.integers(0, C, 10))
    card = copy.deepcopy(model).to(cuda_device)
    out = {}
    n0 = (ttsg.launches, ttsg.bwd_launches)
    for name, m, x, y in (("cpu", model, X, Y),
                          ("card", card, X.to(cuda_device),
                           Y.to(cuda_device))):
        step = make_step_fn(1e-2, num_data=40, gamma=0.1)
        state, elbos = step.init(m), []
        for _ in range(2):
            state, elbo = step(state, x, y)
            elbos.append(elbo.cpu())
        out[name] = elbos + [p.detach().cpu() for p in m.parameters()]
    assert ttsg.launches > n0[0] and ttsg.bwd_launches > n0[1]
    for g, w in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
def test_order1_svgp_step_on_card_matches_cpu(cuda_device):
    """Two float64 natgrad + Adam steps of an order-1 SVGP at the flagship's
    widths (d = 3, nl = 5, inducing tensors with increments, L = 50,
    MultiClass(10); 8 tensors, 12 sequences) on the card, through the
    order-1 Kuf kernel and its backward (their counters rise, the general
    pair's do not), against the same steps on the CPU, rtol 1e-8."""
    import copy

    from gpsig_tpu_torch.inducing import InducingTensors
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    rng = np.random.default_rng(26)
    nl, M, C, d = 5, 8, 10, 3
    Z, X, _ = _wide_inputs(rng, M, 12, 50, d, nl, torch.float64, "cpu")
    model = SVGP.create(SignatureRBF(d, nl, device="cpu"), MultiClass(C),
                        InducingTensors.create(Z, nl, True), C, device="cpu")
    Y = torch.as_tensor(rng.integers(0, C, 12))
    card = copy.deepcopy(model).to(cuda_device)
    out = {}
    for name, m, x, y in (("cpu", model, X, Y),
                          ("card", card, X.to(cuda_device),
                           Y.to(cuda_device))):
        n0 = (tts.launches, tts.bwd_launches, ttsg.launches,
              ttsg.bwd_launches)
        step = make_step_fn(1e-2, num_data=40, gamma=0.1)
        state, elbos = step.init(m), []
        for _ in range(2):
            state, elbo = step(state, x, y)
            elbos.append(elbo.cpu())
        counts = [a - b for a, b in zip(
            (tts.launches, tts.bwd_launches, ttsg.launches,
             ttsg.bwd_launches), n0)]
        out[name] = elbos + [p.detach().cpu() for p in m.parameters()]
    # the card's steps: each a Kuf forward and backward on the order-1 pair
    assert counts[0] >= 2 and counts[1] >= 2 and counts[2:] == [0, 0]
    for g, w in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_order1_forward_where_its_shared_memory_ends(cuda_device, dtype,
                                                     tol):
    """The order-1 forward at the widest d whose records fit its shared
    memory (nl = 7 with increments: 1036 in float32, 516 in float64) and
    one past it, where the general kernel takes the shape at order 1: both
    launch (the order-1 counter rises) and match the plain version."""
    rng = np.random.default_rng(27)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    widest = {4: 1036, 8: 516}[itemsize]
    for d, route in ((widest, "tuned"), (widest + 1, "general")):
        assert plan.kuf_fwd_plan(5, 56, d, 7, itemsize,
                                 True)["route"] == route
        Z, X, _ = _wide_inputs(rng, 2, 5, 6, d, 7, dtype, cuda_device)
        n0 = tts.launches
        with torch.no_grad():
            got = tts.fused_tens_seq_levels(Z, X, 7, True, True)
        assert tts.launches == n0 + 1
        want = tts.fused_tens_seq_levels_ref(Z, X, 7, True, True)
        assert _scaled_err(got, want) < tol


# -- the Gram side at every d and the diagonal at every L --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("N,L,d", [(6, 50, 64), (4, 50, 400), (3, 20, 1345),
                                   (3, 1025, 2), (2, 1025, 64),
                                   (2, 3000, 3)])
def test_diagonal_takes_every_d_and_L(cuda_device, dtype, tol, N, L, d):
    """The order-1 diagonal at d = 64, 400, 1345 (MotorImagery's, past its
    staged sequence, DuckDuckGeese's) and at L = 1025 and 3000 (past the
    old 1024-row bound, in bands of 256 rows with their carries), nl = 4
    and 7, RBF and Linear: it launches (its counter rises) and matches its
    plain version."""
    rng = np.random.default_rng(30)
    X = torch.as_tensor(_walks(rng, N, L, d) * np.sqrt(2 / d) *
                        np.sqrt(50 / L), dtype=dtype, device=cuda_device)
    for nl in (4, 7):
        for rbf in (True, False):
            n0 = tfg.diag_launches
            got = tfg.fused_diag_levels(X, nl, rbf)
            assert tfg.diag_launches == n0 + 1
            want = tfg.fused_diag_levels_ref(X, nl, rbf)
            assert _scaled_err(got, want) < tol, (nl, rbf)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", BWD_TOLS)
@pytest.mark.parametrize("L,d", [(50, 64), (50, 400), (150, 64),
                                 (150, 400)])
def test_gram_backwards_take_wide_d(cuda_device, dtype, tol, L, d):
    """Both Gram backwards at d = 64 and 400, L = 50 and 150: where x, y
    and the X̄ sums pass the block's shared memory they read x and y from
    global memory and sum X̄ in the workspace; each launches and matches
    its plain version."""
    rng = np.random.default_rng(31)
    X = torch.as_tensor(_walks(rng, 3, L, d) * np.sqrt(2 / d), dtype=dtype,
                        device=cuda_device)
    Y = torch.as_tensor(_walks(rng, 5, L, d) * np.sqrt(2 / d), dtype=dtype,
                        device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((5, 3, 5)), dtype=dtype,
                        device=cuda_device)
    n0 = (tfg.gram_bwd_launches, tfgho.bwd_launches)
    got = tfg.fused_gram_levels_bwd(X, Y, g, 4, True)
    assert _scaled_errs(got, tfg.fused_gram_levels_bwd_ref(
        X, Y, g, 4, True)) < tol
    got = tfgho.fused_gram_ho_levels_bwd(X, Y, g, 4, 2, "rbf", True)
    assert _scaled_errs(got, tfgho.fused_gram_ho_levels_bwd_ref(
        X, Y, g, 4, 2, "rbf", True)) < tol
    assert (tfg.gram_bwd_launches, tfgho.bwd_launches) == (n0[0] + 1,
                                                           n0[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_gram_block_design_reads_wide_sequences(cuda_device, dtype, tol):
    """The Gram forwards' block design (L = 300) at d = 400, where x and y
    do not fit the block's shared memory, against their plain versions."""
    rng = np.random.default_rng(32)
    X = torch.as_tensor(_walks(rng, 2, 300, 400) * np.sqrt(2 / 400 / 6),
                        dtype=dtype, device=cuda_device)
    item = X.element_size()
    assert plan.gram_fwd_smem(300, 400, 32, 4, 3, item) < 300 * 400 * item
    got = tfg.fused_gram_levels(X, X, 4, True)
    assert _scaled_err(got, tfg.fused_gram_levels_ref(X, X, 4, True)) < tol
    got = tfgho.fused_gram_ho_levels(X, X, 4, 2, "rbf", True)
    assert _scaled_err(got, tfgho.fused_gram_ho_levels_ref(
        X, X, 4, 2, "rbf", True)) < dict(GEN_TOLS)[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_goursat_forward_crosses_bands(cuda_device, dtype):
    """The Goursat forward where the shorter refined side passes one
    warp's 256 rows: (300, 280) at dyadic order 1 (3 bands on 3 warps) and
    (60, 300) at order 3 (2 bands), both routes, bitwise equal to the plain
    sweep (each cell is its expression in its order)."""
    from gpsig_tpu_torch.ops import goursat as tg
    from gpsig_tpu_torch.ops.cuda import goursat as tgs

    rng = np.random.default_rng(33)
    for Su, Tu, o in ((300, 280, 1), (60, 300, 3)):
        assert plan.goursat_fwd_plan(Su, Tu, o, 8)["bands"] > 1
        inc = torch.as_tensor(_path_increments(rng, 3, Su, Tu) / 4,
                              dtype=dtype, device=cuda_device)
        want = tgs.goursat_corner_refined_ref(inc, o)
        assert torch.equal(tgs.goursat_corner_refined(inc, o), want)
        assert torch.equal(tgs.goursat_corner_fast(
            tg.refine_increments(inc, o)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_goursat_forward_reads_columns_in_vectors(cuda_device, dtype):
    """The given-grid forward on pairs past what GOURSAT_STAGE_BLOCKS
    staged blocks an SM take: a lane reads its cells from tiles of its
    next columns, which the warp copies in 16-byte vectors where the rows
    are 16-byte aligned (196 x 196, 250 x 252) and a value at a time where
    they are not (196 x 198, 250 x 250 in float32; a last block of fewer
    columns); the transposed orientation (252 x 196) staged where one
    block takes it, else a value a step through the cache; bitwise equal
    to the plain sweep."""
    from gpsig_tpu_torch.ops.cuda import goursat as tgs

    rng = np.random.default_rng(34)
    item = torch.tensor([], dtype=dtype).element_size()
    for B, Su, Tu in ((7, 196, 196), (3, 250, 252), (4, 196, 198),
                      (3, 250, 250), (3, 252, 196)):
        p = plan.goursat_fwd_plan(Su, Tu, 0, item)
        assert p["cols"] == (Su <= Tu)
        assert p["stage"] == (Su > Tu and Su * Tu * item <= plan.SMEM_BYTES)
        inc = torch.as_tensor(_path_increments(rng, B, Su, Tu) / 16,
                              dtype=dtype, device=cuda_device)
        n0 = tgs.launches
        got = tgs.goursat_corner_fast(inc)
        assert tgs.launches == n0 + 1
        assert torch.equal(got, tgs.goursat_corner_ref(inc))


@pytest.mark.cuda
def test_order1_svgp_step_takes_wide_d(cuda_device):
    """Two float64 natgrad + Adam steps of the main path's model, the
    order-1 normalised SignatureRBF SVGP with inducing tensors, at
    PEMS-SF's d = 963 (nl = 3, increments) on the card, through the
    diagonal (its sequences read from global memory) and the order-1 Kuf
    entry points (the backward on the general kernel at order 1 and its
    workspace), against the same steps on the CPU, rtol 1e-8."""
    import copy

    from gpsig_tpu_torch.inducing import InducingTensors
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    rng = np.random.default_rng(34)
    nl, M, C, d = 3, 6, 3, 963
    Z, X, _ = _wide_inputs(rng, M, 10, 8, d, nl, torch.float64, "cpu")
    assert plan.diag_plan(10, 8, d, nl, 8)["stage"] != plan.DIAG_STAGE_ALL
    model = SVGP.create(SignatureRBF(d, nl, normalization=True,
                                     device="cpu"), MultiClass(C),
                        InducingTensors.create(Z, nl, True), C,
                        device="cpu")
    Y = torch.as_tensor(rng.integers(0, C, 10))
    card = copy.deepcopy(model).to(cuda_device)
    out = {}
    n0 = (tfg.diag_launches, tts.launches, tts.bwd_launches)
    for name, m, x, y in (("cpu", model, X, Y),
                          ("card", card, X.to(cuda_device),
                           Y.to(cuda_device))):
        step = make_step_fn(1e-2, num_data=40, gamma=0.1)
        state, elbos = step.init(m), []
        for _ in range(2):
            state, elbo = step(state, x, y)
            elbos.append(elbo.cpu())
        out[name] = elbos + [p.detach().cpu() for p in m.parameters()]
    # the order-1 Kuf entry points: the forward's wide records fit its
    # shared memory, the backward past d = 3 runs the general kernel at
    # order 1 with its workspace
    assert plan.kuf_bwd_plan(M, 10, 12, d, 8, tuned=True)["work"] > 0
    assert tfg.diag_launches > n0[0] and tts.launches > n0[1] \
        and tts.bwd_launches > n0[2]
    for g, w in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L1,L2,nl,order", [
    (3, 7, 5, 8, 8), (5, 20, 49, 8, 8), (4, 20, 150, 10, 10),
    (3, 13, 33, 10, 9), (2, 6, 40, 12, 20), (9, 4, 3, 20, 20),
    (3, 1, 7, 8, 8), (4, 20, 150, 20, 20), (2, 149, 49, 20, 20)])
def test_sig_gram_past_order_7(cuda_device, dtype, tol, B, L1, L2, nl,
                               order):
    """The run-time-order instance (p = min(order, num_levels) > 7):
    forward and backward against the plain versions, each launch counted
    under ho_launches / ho_bwd_launches, at one column, at p = nl = 20 and
    at 149 columns (the backward's segments of 13 columns recomputed from
    their checkpoints). Tolerance: the deep path's."""
    rng = np.random.default_rng(B + L2 + nl)
    M = torch.as_tensor(0.4 * rng.standard_normal((B, L1, L2))
                        / np.sqrt(max(L1, L2) / 20), dtype=dtype,
                        device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((nl + 1, B)), dtype=dtype,
                        device=cuda_device)
    n0 = (tsg_.ho_launches, tsg_.ho_bwd_launches)
    got = (tsg_.sig_gram_levels_ho(M, nl, order),
           tsg_.sig_gram_levels_ho_bwd(M, g, nl, order))
    assert (tsg_.ho_launches, tsg_.ho_bwd_launches) == (n0[0] + 1, n0[1] + 1)
    want = (tsg_.sig_gram_levels_ho_ref(M, nl, order),
            tsg_.sig_gram_levels_ho_bwd_ref(M, g, nl, order))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _scaled_err(a, b) < tol


@pytest.mark.cuda
def test_order8_signature_kernel_on_card_matches_cpu(cuda_device):
    """SignatureRBF(2, 8, order=8): K(X), Kdiag(X) and K's gradient on the
    card (the Gram and the diagonal through the run-time-order instance)
    against the same kernel on the CPU, float64."""
    rng = np.random.default_rng(8)
    X = torch.as_tensor(_walks(rng, 5, 12, 2))
    out = {}
    for dev in ("cpu", cuda_device):
        k = SignatureRBF(2, 8, order=8, lengthscales=[0.8, 1.2], device=dev)
        Xd = X.to(dev).requires_grad_()
        K = k.K(Xd)
        (gx,) = torch.autograd.grad(K.sum(), Xd)
        out[str(dev)] = [t.detach().cpu() for t in (K, k.Kdiag(Xd), gx)]
    for a, b in zip(out[str(cuda_device)], out["cpu"]):
        assert _scaled_err(a, b) < 1e-10


def _vosf_model(dev, prior="explicit", likelihood=None, seed=30):
    """A float64 Kuu = I SVGP (q_diag, 4 classes) with q_mu and q_sqrt
    drawn: under ExplicitSignatureKernel(2, 4), or (``prior="pde"``) under
    the untruncated kernel (Linear base, ARD, normalised, dyadic order 1)
    with features of 3 levels; and 10 sequences of L = 12, d = 2."""
    from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel
    from gpsig_tpu_torch.kernels.vosf import (ExplicitSignatureKernel,
                                              OrthogonalSignatureFeatures)
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    rng = np.random.default_rng(seed)
    if prior == "explicit":
        kern = ExplicitSignatureKernel.create(2, 4, lengthscales=[0.8, 1.2],
                                              device=dev)
        feat = OrthogonalSignatureFeatures.for_kernel(kern)
    else:
        kern = UntruncatedSignatureKernel.create(
            2, lengthscales=[0.8, 1.2], normalization=True, dyadic_order=1,
            device=dev)
        feat = OrthogonalSignatureFeatures.for_kernel(kern, num_levels=3)
    M = feat.num_inducing
    model = SVGP.create(kern, likelihood or MultiClass(4), feat, 4,
                        q_diag=True, device=dev)
    with torch.no_grad():
        model.q_mu.copy_(torch.as_tensor(0.5 * rng.standard_normal((M, 4))))
        model.q_sqrt.copy_(torch.as_tensor(rng.uniform(0.3, 1.0, (M, 4))))
    X = torch.as_tensor(_walks(rng, 10, 12, 2), device=dev)
    Y = torch.as_tensor(rng.integers(0, 4, 10), device=dev)
    return model, X, Y


def _steps_and_predictions(model, X, Y, generator=None, steps=2):
    from gpsig_tpu_torch.training.loop import make_step_fn

    step = make_step_fn(1e-2, num_data=40, gamma=0.1)
    state, out = step.init(model), []
    for _ in range(steps):
        state, elbo = step(state, X, Y, generator)
        out.append(elbo.cpu())
    with torch.no_grad():
        out += [t.cpu() for t in model.posterior().predict_f(X)]
    return out + [p.detach().cpu() for p in model.parameters()]


def _elbo_gradients_natgrad(model, X, Y):
    """The ELBO, its gradients, the cached posterior's predict_f and one
    natgrad step's q_mu and q_sqrt, on the CPU."""
    from gpsig_tpu_torch.training.natgrad import natgrad_step

    elbo = model.elbo(X, Y, num_data=40)
    elbo.backward()
    grads = [p.grad.cpu() for p in model.parameters()]
    with torch.no_grad():
        pred = [t.cpu() for t in model.posterior().predict_f(X)]
    natgrad_step(model, 0.1, X, Y, num_data=40)
    return ([elbo.detach().cpu()] + pred
            + [model.q_mu.detach().cpu(), model.q_sqrt.detach().cpu()],
            grads)


@pytest.mark.cuda
@pytest.mark.parametrize("prior", ["explicit", "pde"])
def test_vosf_svgp_on_card_matches_cpu(cuda_device, prior):
    """A float64 Kuu = I SVGP on the card against the CPU, scaled 1e-10:
    the ELBO, its gradients (scaled by the largest: under RobustMax the
    ELBO is invariant to σ, whose gradient is rounding noise), the cached
    posterior's predictions and a natgrad step. No Adam step: it moves a
    noise-level gradient's parameter by up to lr·g/(|g| + 1e-8). Under the
    untruncated prior the features' normalisation launches the refined
    Goursat kernel and the ELBO's backward its adjoint."""
    import copy

    from gpsig_tpu_torch.ops.cuda import goursat as tgs

    model, X, Y = _vosf_model("cpu", prior)
    card = copy.deepcopy(model).to(cuda_device)
    want, want_g = _elbo_gradients_natgrad(model, X, Y)
    n0 = (tgs.fused_launches, tgs.grad_launches)
    got, got_g = _elbo_gradients_natgrad(card, X.to(cuda_device),
                                         Y.to(cuda_device))
    if prior == "pde":
        assert tgs.fused_launches > n0[0] and tgs.grad_launches > n0[1]
    for g, w in zip(got, want):
        assert _scaled_err(g, w) <= 1e-10
    scale = max(w.abs().max().item() for w in want_g)
    for g, w in zip(got_g, want_g):
        assert (g - w).abs().max().item() / scale <= 1e-10


@pytest.mark.cuda
def test_low_rank_svgp_on_card_matches_cpu(cuda_device):
    """The @lowrank window's model in float64 at a small size (c = 8,
    every level sketched, 6 inducing sequences of length 4): K, Kdiag and
    the ELBO on the card, with the CPU model's landmarks and pair indices,
    against the CPU, scaled 1e-10 (the Grams are invariant to eigh's sign
    and rotation choices, which differ between cuSOLVER and LAPACK)."""
    import copy

    from gpsig_tpu_torch.inducing import make_inducing_sequences_from_data
    from gpsig_tpu_torch.kernels.low_rank import LowRankSignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    rng = np.random.default_rng(31)
    X = torch.as_tensor(_walks(rng, 12, 15, 3))
    Y = torch.as_tensor(rng.integers(0, 5, 12))
    gen = torch.Generator().manual_seed(0)
    kern = LowRankSignatureRBF(gen, X, 3, 4, num_components=8,
                               lengthscales=3**0.5, device="cpu")
    feat = make_inducing_sequences_from_data(gen, X, 6, 4, 3)
    model = SVGP.create(kern, MultiClass(5), feat, 5, device="cpu")
    card = copy.deepcopy(model).to(cuda_device)
    out = {}
    for name, m, x, y in (("cpu", model, X, Y),
                          ("card", card, X.to(cuda_device),
                           Y.to(cuda_device))):
        with torch.no_grad():
            out[name] = [m.kernel.K(x), m.kernel.Kdiag(x),
                         m.elbo(x, y, num_data=40)]
    for g, w in zip(out["card"], out["cpu"]):
        assert _scaled_err(g.cpu(), w) <= 1e-10


@pytest.mark.cuda
def test_softmax_steps_on_card_repeat_bitwise(cuda_device):
    """Two natgrad + Adam steps of a VOSF SVGP with the Monte-Carlo
    Softmax, drawn on the card from a generator seeded alike, twice:
    bitwise equal; a third run from another seed differs."""
    from gpsig_tpu_torch.likelihoods import Softmax

    def run(seed):
        model, X, Y = _vosf_model(cuda_device, likelihood=Softmax(4))
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        return _steps_and_predictions(model, X, Y, gen)

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,bwd_tol,gap_tol",
                         [(torch.float64, 1e-11, 1e-10, 1e-14),
                          (torch.float32, 1e-4, 1e-3, 1e-6)])
def test_chain_axis_kernels_match_plain_and_unbatched(cuda_device, dtype,
                                                       tol, bwd_tol,
                                                       gap_tol):
    """The order-1 Gram (symmetric and not), its diagonal and the Gram's
    backward with a chain axis [C, N, L, d]: one launch each, against the
    plain versions, and against one unbatched launch a chain (the forward
    and the diagonal bitwise; the backward's atomics add the same terms in
    a run-dependent order: scaled gap 1e-14 / 1e-6)."""
    rng = np.random.default_rng(40)
    C, n, L, nl = 5, 9, 20, 3
    kw = dict(dtype=dtype, device=cuda_device)
    X = torch.as_tensor(_walks(rng, n, L, 2)[None]
                        / rng.uniform(0.5, 2.0, (C, 1, 1, 2)), **kw)
    Y = torch.as_tensor(np.stack([_walks(rng, n + 3, L, 2)
                                  for _ in range(C)]), **kw)
    g = torch.as_tensor(rng.standard_normal((C, nl + 1, n, n)), **kw)
    n0 = (tfg.gram_launches, tfg.diag_launches, tfg.gram_bwd_launches)
    sym = tfg.fused_gram_levels(X, X, nl, True, True)
    cross = tfg.fused_gram_levels(X, Y, nl, True)
    diag = tfg.fused_diag_levels(X, nl, True)
    bwd = tfg.fused_gram_levels_bwd(X, X, g, nl, True)
    assert (tfg.gram_launches, tfg.diag_launches,
            tfg.gram_bwd_launches) == (n0[0] + 2, n0[1] + 1, n0[2] + 1)
    assert sym.shape == (C, nl + 1, n, n)
    assert cross.shape == (C, nl + 1, n, n + 3)
    assert diag.shape == (C, nl + 1, n)
    assert _scaled_err(sym, tfg.fused_gram_levels_ref(X, X, nl)) < tol
    assert _scaled_err(cross, tfg.fused_gram_levels_ref(X, Y, nl)) < tol
    assert _scaled_err(diag, tfg.fused_diag_levels_ref(X, nl)) < tol
    assert _scaled_errs(bwd, tfg.fused_gram_levels_bwd_ref(X, X, g, nl)) \
        < bwd_tol
    for c in range(C):
        assert torch.equal(sym[c], tfg.fused_gram_levels(X[c], X[c], nl,
                                                         True, True))
        assert torch.equal(cross[c], tfg.fused_gram_levels(X[c], Y[c], nl))
        assert torch.equal(diag[c], tfg.fused_diag_levels(X[c], nl))
        assert _scaled_errs([b[c] for b in bwd], tfg.fused_gram_levels_bwd(
            X[c], X[c], g[c], nl)) <= gap_tol


@pytest.mark.cuda
def test_chain_axis_gpr_target_on_card_matches_cpu(cuda_device):
    """BASELINE config 5's target (``mcmc/targets.py``) with 6 chains,
    float64: log p and its gradient on the card against the CPU, and one
    launch of each order-1 kernel for all chains."""
    from gpsig_tpu_torch.mcmc import nuts
    from gpsig_tpu_torch.mcmc.targets import signature_gpr_logp

    rng = np.random.default_rng(41)
    X = _walks(rng, 10, 12, 2)
    y = rng.standard_normal((10, 1))
    theta = 0.3 * rng.standard_normal((6, 7))
    out = {}
    for where in ("cpu", cuda_device):
        kw = dict(dtype=torch.float64, device=where)
        logp = signature_gpr_logp(torch.as_tensor(X, **kw),
                                  torch.as_tensor(y, **kw), 3)
        n0 = (tfg.gram_launches, tfg.diag_launches, tfg.gram_bwd_launches)
        out[str(where)] = nuts.value_and_grad(logp)(
            torch.as_tensor(theta, **kw))
        n1 = (tfg.gram_launches, tfg.diag_launches, tfg.gram_bwd_launches)
        assert n1 == tuple(a + (where != "cpu") for a in n0)
    for g, w in zip(out[str(cuda_device)], out["cpu"]):
        assert _scaled_err(g.cpu(), w) <= 1e-10


@pytest.mark.cuda
def test_compat_compute_k_is_the_core_gram_on_card(cuda_device):
    """The facade's numpy-out Grams are the core's on the card, bitwise."""
    from gpsig_tpu_torch import compat as gpsig

    X = _walks(np.random.default_rng(0), 64, 20, 2).reshape(64, 40)
    kern = gpsig.kernels.SignatureRBF(40, 2, 4, dtype=torch.float32,
                                      device=cuda_device)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=cuda_device)
    core = kern.to_functional()
    with torch.no_grad():
        want = [core.K(Xd), core.K(Xd[:20], Xd[20:]), core.Kdiag(Xd)]
    got = [kern.compute_K_symm(X), kern.compute_K(X[:20], X[20:]),
           kern.compute_Kdiag(X)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.cpu().numpy())


@pytest.mark.cuda
def test_compat_svgp_on_card_matches_cpu(cuda_device):
    """A float64 facade SVGP (order-1 inducing tensors, MultiClass(3)):
    3 alternations of NatGrad(0.2) and frozen Adam(1e-2) on the card and
    on the CPU from the same numpy inputs, the same batches; ELBO,
    parameters and predict_y within 1e-10 scaled."""
    from gpsig_tpu_torch import compat as gpsig

    rng = np.random.default_rng(0)
    X = 0.4 * rng.standard_normal((20, 20))
    y = rng.integers(0, 3, 20)
    Z = 0.3 * np.random.default_rng(2).standard_normal((5, 6, 2))
    out = []
    for where in ("cpu", cuda_device):
        kern = gpsig.kernels.SignatureRBF(20, 2, 3, device=where)
        feat = gpsig.inducing_variables.InducingTensors(Z, 3, device=where)
        m = gpsig.models.SVGP(X, y, kern, gpsig.likelihoods.MultiClass(3),
                              feat=feat, num_latent=3, minibatch_size=8)
        nat = gpsig.training.NatGradOptimizer(0.2)
        adam = gpsig.training.AdamOptimizer(1e-2)
        for _ in range(3):
            nat.minimize(m, maxiter=1)
            adam.minimize(m, maxiter=1, freeze_variational=True)
        out.append([torch.tensor(m.compute_log_likelihood_full()),
                    torch.as_tensor(m.predict_y(X[:4])[0]),
                    *(p.detach().cpu()
                      for p in m.to_functional().parameters())])
    for a, b in zip(*out):
        assert _scaled_err(b, a) <= 1e-10
