"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:randomly tests/test_torch_cuda_kernels.py

Tests marked ``cuda`` skip without a CUDA device. Tolerances (scaled error
max|kernel − plain| / max|plain|): forward kernels 1e-11 in float64, where
only the summation order differs, and 1e-4 in float32, for float32 exp and
DP sums over up to 99 columns taken in another order than the plain
version's. Backward kernels 1e-10 in float64 and 1e-3 in float32: they
rebuild the forward's DP states by subtraction in the reverse sweep (each
rebuilt state carries the rounding of every later column) and add their
results with atomics in an order that changes from run to run.
"""

import numpy as np
import pytest
import torch

from gpsig_tpu_torch.kernels.signature import SignatureLinear, SignatureRBF
from gpsig_tpu_torch.ops.cuda import _build
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import tens_seq as tts

torch.set_num_threads(1)
TOLS = [(torch.float64, 1e-11), (torch.float32, 1e-4)]
BWD_TOLS = [(torch.float64, 1e-10), (torch.float32, 1e-3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _walks(rng, n, L, d):
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


def _scaled_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


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
    with pytest.raises(NotImplementedError, match="Queue 2 items 6 and 8"):
        SignatureRBF(2, 3, order=2, device=cuda_device).K(X)


@pytest.mark.cuda
@pytest.mark.parametrize("ctor", [SignatureRBF, SignatureLinear])
def test_signature_kernel_on_card_matches_cpu(cuda_device, ctor):
    rng = np.random.default_rng(5)
    X = torch.as_tensor(_walks(rng, 6, 12, 2))
    F = 3 * 4 // 2
    Z = torch.as_tensor(0.4 * rng.standard_normal((5, F, 2, 2)))
    kern = ctor(2, 3, lengthscales=[0.8, 1.3], num_lags=1)
    Z = torch.cat([Z, Z], dim=-1)  # lag-augmented factor space
    with torch.no_grad():
        want = (kern.K(X), kern.K_tens_vs_seq(Z, X, increments=True))
        kern.to(cuda_device)
        got = (kern.K(X.to(cuda_device)),
               kern.K_tens_vs_seq(Z.to(cuda_device), X.to(cuda_device),
                                  increments=True))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-10, atol=1e-12)


def _scaled_errs(got, want):
    return max(_scaled_err(a, b) for a, b in zip(got, want))


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
    kern = SignatureRBF(2, 3, lengthscales=[0.8, 1.3])

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
    model = SVGP.create(SignatureRBF(2, nl, lengthscales=[0.8, 1.2]),
                        MultiClass(C), InducingTensors.create(Z, nl, True),
                        C)
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
