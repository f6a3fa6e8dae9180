"""The chain axis (C samplers' chains as one batch) against ``jax.vmap`` in
``gpsig_tpu``, float64 on the CPU.

- The order-1 Gram, its diagonal and the Gram's backward with X, Y
  [C, N, L, d]: the plain versions (the CPU route of the wrappers) against
  ``jax.vmap`` of the JAX package's ``fused_gram_levels`` /
  ``fused_diag_levels`` in interpret mode, whose in-kernel products
  accumulate in float32 (scaled error 1e-5, as ``test_torch_fused_gram.py``);
  the backward against ``jax.vjp`` of that ``vmap`` (JAX differentiates its
  plain reference on the CPU: 1e-10); and against a loop over chains,
  bitwise.
- A GPR's log marginal likelihood and gradient with the hyperparameters
  on a chain axis (BASELINE config 5's target, ``mcmc/targets.py``)
  against ``jax.vmap(jax.value_and_grad(logp))`` of ``tests/test_nuts.py``'s
  target with the XLA engine: 1e-10 scaled.
- ``gauss.stable_cholesky`` on a batch chooses the jitter per matrix as
  ``jax.vmap`` does (1e-12), gives a matrix no level factors NaN and
  leaves the others bitwise unchanged; an unbatched K is unchanged.
- Every route but the tuned order-1 one refuses a chain axis, and a CUDA
  path never runs the plain version in the kernels' place.

The kernels' chain axis on the card is in ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import gauss as jgauss
from gpsig_tpu import params as jpr
from gpsig_tpu.kernels.signature import SignatureRBF as JSignatureRBF
from gpsig_tpu.models.gpr import GPR as JGPR
from gpsig_tpu.ops.pallas import fused_gram as jfg
from gpsig_tpu_torch import gauss as tgauss
from gpsig_tpu_torch import params as tpr
from gpsig_tpu_torch.kernels.low_rank import LowRankSignatureRBF
from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel
from gpsig_tpu_torch.kernels.signature import (SignaturePoly,
                                               SignatureRBF)
from gpsig_tpu_torch.kernels.vosf import ExplicitSignatureKernel
from gpsig_tpu_torch.mcmc import nuts as tnuts
from gpsig_tpu_torch.mcmc.targets import signature_gpr_logp
from gpsig_tpu_torch.models.gpr import GPR
from gpsig_tpu_torch.ops.cuda import _build
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import plan

torch.set_num_threads(1)
INTERPRET_TOL, VALUE_TOL, DET_TOL = 1e-5, 1e-10, 1e-12
C, N, L, D = 3, 5, 6, 2


def walks(rng, *shape):
    return (0.3 * rng.standard_normal(shape)).cumsum(-2)


def scaled_err(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


# -- the order-1 Gram side -----------------------------------------------------

@pytest.mark.parametrize("rbf", [True, False])
def test_chain_gram_and_diag_match_vmapped_pallas(rbf):
    rng = np.random.default_rng(0)
    X, Y = walks(rng, C, N, L, D), walks(rng, C, N + 1, L, D)
    nl = 3
    want = jax.vmap(lambda x, y: jfg.fused_gram_levels(x, y, nl, rbf, True))(
        jnp.asarray(X), jnp.asarray(Y))
    got = tfg.fused_gram_levels(torch.as_tensor(X), torch.as_tensor(Y), nl,
                                rbf)
    assert got.shape == (C, nl + 1, N, N + 1)
    assert scaled_err(got, want) < INTERPRET_TOL
    want_d = jax.vmap(lambda x: jfg.fused_diag_levels(x, nl, rbf, True))(
        jnp.asarray(X))
    got_d = tfg.fused_diag_levels(torch.as_tensor(X), nl, rbf)
    assert got_d.shape == (C, nl + 1, N)
    assert scaled_err(got_d, want_d) < INTERPRET_TOL
    # one chain at a time, bitwise
    for c in range(C):
        assert torch.equal(got[c], tfg.fused_gram_levels(
            torch.as_tensor(X[c]), torch.as_tensor(Y[c]), nl, rbf))
        assert torch.equal(got_d[c], tfg.fused_diag_levels(
            torch.as_tensor(X[c]), nl, rbf))


@pytest.mark.parametrize("rbf", [True, False])
def test_chain_gram_backward_matches_vmapped_vjp(rbf):
    rng = np.random.default_rng(1)
    X, Y = walks(rng, C, N, L, D), walks(rng, C, N, L, D)
    nl = 2
    g = rng.standard_normal((C, nl + 1, N, N))
    _, vjp = jax.vjp(jax.vmap(
        lambda x, y: jfg.fused_gram_levels(x, y, nl, rbf, True)),
        jnp.asarray(X), jnp.asarray(Y))
    want = vjp(jnp.asarray(g))
    got = tfg.fused_gram_levels_bwd(*map(torch.as_tensor, (X, Y, g)), nl,
                                    rbf)
    for a, b in zip(got, want):
        assert scaled_err(a, b) < VALUE_TOL
    for c in range(C):
        loop = tfg.fused_gram_levels_bwd(
            *map(torch.as_tensor, (X[c], Y[c], g[c])), nl, rbf)
        assert all(torch.equal(a[c], b) for a, b in zip(got, loop))


def test_chain_shapes_and_workspace_are_checked():
    X = torch.zeros(2, 3, 5, 2, dtype=torch.float64)
    assert tfg._check_shapes("k", 3, X, X) == 2
    with pytest.raises(ValueError, match="one C"):
        tfg._check_shapes("k", 3, X, X[:1])
    with pytest.raises(ValueError, match="chains"):
        tfg._check_shapes("k", 3, X[:0])
    # the wide-d backward's X̄ workspace counts every chain: at PEMS-SF's
    # width the grid shrinks to keep 16 chains' slots within 1 GiB; 4000
    # chains' single slots do not fit
    W = torch.empty((150, 144, 963), device="meta")
    one, p = (tfg._backward_plan("k", W, 150, c) for c in (1, 16))
    assert not p["staged"] and p["blocks"] < one["blocks"]
    assert 4 * p["work"] <= plan.WORKSPACE_BYTES
    with pytest.raises(ValueError, match="fewer chains"):
        tfg._backward_plan("k", W, 150, 4000)


# -- BASELINE config 5's target ------------------------------------------------

def jax_logp(X, y, d, nl):
    """tests/test_nuts.py's target (lines 270-282), the XLA engine."""

    def logp(theta):
        ell = jnp.exp(theta[:d])
        var = jnp.exp(theta[d:d + nl + 1])
        noise = jnp.exp(theta[-1])
        kern = JSignatureRBF(d, nl, lengthscales=1.0, order=1,
                             normalization=True, engine="xla")
        kern = kern.replace(raw_lengthscales=jpr.inv_positive(ell),
                            raw_variances=jpr.inv_positive(var))
        m = JGPR.create(kern, noise_variance=noise)
        return m.log_marginal_likelihood(X, y) - 0.125 * jnp.sum(theta**2)

    return logp


def test_chain_gpr_logp_and_gradient_match_vmapped_jax():
    rng = np.random.default_rng(5)
    n, length, d, nl = 6, 8, 2, 2
    X = walks(rng, n, length, d)
    y = rng.standard_normal((n, 1))
    thetas = 0.3 * rng.standard_normal((4, d + nl + 2))
    want_l, want_g = jax.vmap(jax.value_and_grad(jax_logp(
        jnp.asarray(X), jnp.asarray(y), d, nl)))(jnp.asarray(thetas))
    logp = signature_gpr_logp(torch.as_tensor(X), torch.as_tensor(y), nl)
    before = (tfg.gram_launches, tfg.diag_launches, tfg.gram_bwd_launches)
    got_l, got_g = tnuts.value_and_grad(logp)(torch.as_tensor(thetas))
    assert got_l.shape == (4,)
    assert scaled_err(got_l, want_l) < VALUE_TOL
    assert scaled_err(got_g, want_g) < VALUE_TOL
    # the CPU route launches nothing
    assert (tfg.gram_launches, tfg.diag_launches,
            tfg.gram_bwd_launches) == before


def test_chain_kernel_entry_points():
    """K with and without a second argument, Kdiag, lengthscales alone on
    the chain axis, and every chain equal to the kernel at its setting."""
    rng = np.random.default_rng(6)
    X = torch.as_tensor(walks(rng, N, L, D))
    X2 = torch.as_tensor(walks(rng, N + 2, L, D))
    k = SignatureRBF(D, 3, lengthscales=1.0, device="cpu")
    ell = torch.as_tensor(rng.uniform(0.5, 2.0, (C, D)))
    var = torch.as_tensor(rng.uniform(0.5, 2.0, (C, 4)))
    sub = {"raw_lengthscales": tpr.inv_positive(ell),
           "raw_variances": tpr.inv_positive(var)}
    with tpr.substituted(k, sub):
        K, K2, Kd = k.K(X), k.K(X, X2), k.Kdiag(X)
    with tpr.substituted(k, {"raw_lengthscales": sub["raw_lengthscales"]}):
        Kl = k.Kdiag(X)
    # the kernel's own parameters are back
    assert isinstance(k.raw_lengthscales, torch.nn.Parameter)
    assert k.raw_lengthscales.shape == (D,) and tpr.chain_count(k) is None
    assert (K.shape, K2.shape, Kd.shape, Kl.shape) == (
        (C, N, N), (C, N, N + 2), (C, N), (C, N))
    for c in range(C):
        with tpr.substituted(k, {n: v[c] for n, v in sub.items()}):
            torch.testing.assert_close(K[c], k.K(X), rtol=0, atol=0)
            torch.testing.assert_close(K2[c], k.K(X, X2), rtol=0, atol=0)
            torch.testing.assert_close(Kd[c], k.Kdiag(X), rtol=0, atol=0)


# -- stable_cholesky a chain at a time ------------------------------------------

def spd(rng, n, shift=0.5):
    A = rng.standard_normal((n, n))
    return A @ A.T / n + shift * np.eye(n)


def test_stable_cholesky_chooses_jitter_per_chain():
    """Chain 1's smallest eigenvalue is −5e-6: level 0 fails, 10·jitter
    (1e-5) factors it; the others factor at level 0."""
    rng = np.random.default_rng(7)
    n = 6
    K = np.stack([spd(rng, n) for _ in range(3)])
    w, V = np.linalg.eigh(K[1])
    w[0] = -5e-6
    K[1] = (V * w) @ V.T
    want = jax.vmap(jgauss.stable_cholesky)(jnp.asarray(K))
    got = tgauss.stable_cholesky(torch.as_tensor(K))
    assert scaled_err(got, want) < DET_TOL
    jitter = 1e-5 * torch.eye(n, dtype=torch.float64)
    assert torch.equal(got[1], torch.linalg.cholesky(
        torch.as_tensor(K[1]) + jitter))
    assert torch.equal(got[0], torch.linalg.cholesky(torch.as_tensor(K[0])))


def test_stable_cholesky_isolates_a_matrix_no_level_factors():
    rng = np.random.default_rng(8)
    n = 5
    K = torch.as_tensor(np.stack([spd(rng, n), -np.eye(n), spd(rng, n)]))
    K.requires_grad_()
    got = tgauss.stable_cholesky(K)
    assert torch.isnan(torch.diagonal(got[1])).all()
    healthy = K.detach()[[0, 2]].requires_grad_()
    ref = tgauss.stable_cholesky(healthy)
    assert torch.equal(got[[0, 2]].detach(), ref.detach())
    # gradients of the healthy chains are theirs alone
    (g,) = torch.autograd.grad(torch.log(torch.diagonal(
        got[[0, 2]], dim1=-2, dim2=-1)).sum(), K)
    (gref,) = torch.autograd.grad(torch.log(torch.diagonal(
        ref, dim1=-2, dim2=-1)).sum(), healthy)
    assert torch.equal(g[[0, 2]], gref)
    # JAX's vmap gives that chain the same factor: NaN on and below the
    # diagonal, 0 above
    np.testing.assert_array_equal(got[1].detach().numpy(), np.asarray(
        jax.vmap(jgauss.stable_cholesky)(jnp.asarray(K.detach().numpy()))[1]))


def test_stable_cholesky_unbatched_unchanged():
    rng = np.random.default_rng(9)
    K = torch.as_tensor(spd(rng, 7))
    assert torch.equal(tgauss.stable_cholesky(K), torch.linalg.cholesky(K))
    assert scaled_err(tgauss.stable_cholesky(K),
                      jgauss.stable_cholesky(jnp.asarray(K.numpy()))) \
        < DET_TOL
    with pytest.raises(torch.linalg.LinAlgError):  # as before: it raises
        tgauss.stable_cholesky(-K)


# -- refusals --------------------------------------------------------------------

def chains_of(module, names, C=2):
    return {n: getattr(module, n).detach().expand(
        (C,) + getattr(module, n).shape).clone() for n in names}


def test_other_routes_refuse_a_chain_axis():
    rng = np.random.default_rng(10)
    X = torch.as_tensor(walks(rng, 4, L, D))
    Z = torch.as_tensor(rng.standard_normal((3, 3, 2, D)))
    cases = [
        (SignaturePoly(D, 2, order=1, device="cpu"), "K", (X,)),
        (SignatureRBF(D, 2, order=2, device="cpu"), "K", (X,)),
        (SignatureRBF(D, 8, device="cpu"), "K", (X,)),
        (SignatureRBF(D, 2, num_lags=1, device="cpu"), "K", (X,)),
        (SignatureRBF(D, 2, device="cpu"), "K", (X, X[:, :4])),
        (SignatureRBF(D, 2, device="cpu"), "K_tens_vs_seq", (Z, X, True)),
        (SignatureRBF(D, 2, device="cpu"), "K_tens", (Z, True)),
        (SignatureRBF(D, 2, device="cpu"), "seq_covariances", (X, X)),
    ]
    for kern, entry, args in cases:
        with tpr.substituted(kern, chains_of(kern, ["raw_variances"])):
            with pytest.raises(ValueError, match="chain axis"):
                getattr(kern, entry)(*args)
    others = [
        (UntruncatedSignatureKernel.create(D, lengthscales=[1.0, 1.0],
                                           device="cpu"), ("K", "Kdiag")),
        (ExplicitSignatureKernel.create(D, 2, lengthscales=[1.0, 1.0],
                                        device="cpu"), ("K", "Kdiag")),
        (LowRankSignatureRBF(torch.Generator().manual_seed(0), X, D, 2,
                             num_components=4, device="cpu"),
         ("K", "Kdiag")),
    ]
    for kern, entries in others:
        with tpr.substituted(kern, chains_of(kern, ["raw_lengthscales"])):
            for entry in entries:
                with pytest.raises(ValueError, match="chain axis"):
                    getattr(kern, entry)(X)
    gpr = GPR.create(SignatureRBF(D, 2, device="cpu"), device="cpu")
    noise = {"likelihood.raw_variance": torch.zeros(2, dtype=torch.float64)}
    with tpr.substituted(gpr, noise):
        with pytest.raises(ValueError, match="chain axis"):
            gpr.predict_f(X, torch.zeros(4, 1, dtype=torch.float64), X)


def test_a_cuda_path_raises_and_never_runs_the_plain_version(monkeypatch):
    """With the kernels unavailable (no library), the target on tensors
    the wrappers take for CUDA ones raises from the launch; the plain
    versions are never called."""
    def no_library():
        raise RuntimeError("nvcc not found")

    def plain(*args, **kw):
        raise AssertionError("the plain version ran in a kernel's place")

    monkeypatch.setattr(tfg, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(_build, "check_inputs", lambda name, tensors: None)
    monkeypatch.setattr(_build, "library", no_library)
    for name in ("fused_gram_levels_ref", "fused_diag_levels_ref",
                 "fused_gram_levels_bwd_ref"):
        monkeypatch.setattr(tfg, name, plain)
    rng = np.random.default_rng(11)
    X = torch.as_tensor(walks(rng, 4, L, D))
    logp = signature_gpr_logp(X, torch.as_tensor(rng.standard_normal(4)), 2)
    with pytest.raises(RuntimeError, match="nvcc"):
        tnuts.value_and_grad(logp)(torch.zeros(3, D + 4,
                                               dtype=torch.float64))
