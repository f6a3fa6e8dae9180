"""Parity of the port's signature kernel and inducing tensors
(``kernels/signature.py``, ``inducing.py``) with ``gpsig_tpu``'s XLA
engine, float64 on the CPU, parameters loaded through
``convert.load_jax_arrays``; every base (RBF, Linear, Poly, Cosine) at
orders 1-3 with and without differencing, and against the JAX package's
Pallas engine run in interpret mode.

Tolerance rtol 1e-8 against the XLA engine: it clamps the RBF squared
distance at 0 (``static_kernels.py``) while the port's covered
configurations run the fused kernels' plain versions, which (as the
Pallas kernels) do not clamp. The two differ only where two points
coincide, where the unclamped distance is a rounding-level negative
number; elsewhere they agree to summation-order rounding. Against the
Pallas engine, scaled error 1e-5: its in-kernel matrix products
accumulate in float32 even on float64 inputs.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unittest import mock

from gpsig_tpu import inducing as jind
from gpsig_tpu.kernels import signature as jsk
from gpsig_tpu_torch import config as tcfg
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch.kernels import signature as tsk
from gpsig_tpu_torch.ops.cuda import fused_gram as tfg
from gpsig_tpu_torch.ops.cuda import fused_gram_ho as tfgho
from gpsig_tpu_torch.ops.cuda import sig_gram as tsg
from gpsig_tpu_torch.ops.cuda import tens_seq_general as ttsg

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-12
D, NL = 2, 3

CONFIGS = {
    "rbf_ard": ("SignatureRBF", dict(lengthscales=[0.7, 1.3])),
    "rbf_lags": ("SignatureRBF", dict(lengthscales=[0.8, 1.1], num_lags=2)),
    "linear": ("SignatureLinear", dict(num_levels=4)),
    "rbf_unnormalized": ("SignatureRBF", dict(normalization=False)),
    "rbf_no_difference": ("SignatureRBF", dict(difference=False)),
    "linear_no_lengthscales": ("SignatureLinear",
                               dict(lengthscales=None, num_levels=2)),
    "rbf_order2": ("SignatureRBF", dict(lengthscales=[0.7, 1.3], order=2)),
    "rbf_order3_lags": ("SignatureRBF", dict(lengthscales=[0.8, 1.1],
                                             num_lags=1, order=3)),
    "poly_order2": ("SignaturePoly", dict(offset=0.6, order=2)),
    "poly3_no_difference": ("SignaturePoly",
                            dict(offset=1.4, degree=3, difference=False)),
    "cosine_order2_unnormalized": ("SignatureCosine",
                                   dict(order=2, normalization=False)),
    "rbf_levels8": ("SignatureRBF", dict(num_levels=8, order=2)),
}


def leaves(tree):
    """JAX pytree → {dotted field path: numpy array} (None leaves vanish)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def kernel_pair(name, seed=0):
    ctor, kw = CONFIGS[name]
    kw = dict(kw)
    nl = kw.pop("num_levels", NL)
    jk = getattr(jsk, ctor)(D, nl, engine="xla", **kw)
    rng = np.random.default_rng(seed)
    jk = jk.replace(
        raw_sigma=jnp.asarray(rng.normal(0.5, 0.3)),
        raw_variances=jnp.asarray(rng.normal(0.0, 0.5, nl + 1)),
    )
    if ctor == "SignaturePoly":
        jk = jk.replace(base=jk.base.replace(
            raw_offset=jnp.asarray(rng.normal(0.3, 0.2))))
    tk = getattr(tsk, ctor)(D, nl, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


def walks(rng, n, L=8):
    return (0.3 * rng.standard_normal((n, L, D))).cumsum(1)


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_converted_parameters_match_names_and_values():
    jk, tk = kernel_pair("rbf_lags")
    want = leaves(jk)
    got = {k: v.detach().numpy() for k, v in tk.state_dict().items()}
    assert set(got) == set(want) == {
        "raw_sigma", "raw_variances", "raw_lengthscales", "raw_lags",
        "raw_gamma"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    _, tk2 = kernel_pair("linear_no_lengthscales")
    assert tk2.raw_lengthscales is None
    assert "raw_lengthscales" not in tk2.state_dict()
    jk3, tk3 = kernel_pair("poly_order2")
    assert "base.raw_offset" in leaves(jk3)
    np.testing.assert_array_equal(
        tk3.state_dict()["base.raw_offset"].numpy(),
        leaves(jk3)["base.raw_offset"])


@pytest.mark.parametrize("source,target", [
    ("SignatureRBF", "SignatureLinear"), ("SignatureLinear", "SignatureRBF"),
    ("SignaturePoly", "SignatureCosine"), ("SignatureCosine", "SignaturePoly"),
])
def test_load_is_strict_across_bases(source, target):
    """A Poly kernel's offset has no home in another base, and a Poly
    kernel needs one; bases without parameters load into each other."""
    jk = getattr(jsk, source)(D, NL, engine="xla")
    tk = getattr(tsk, target)(D, NL, device="cpu")
    if "SignaturePoly" in (source, target):
        with pytest.raises(RuntimeError, match="raw_offset"):
            convert.load_jax_arrays(tk, leaves(jk))
    else:
        convert.load_jax_arrays(tk, leaves(jk))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sequence_grams_match_jax(name):
    jk, tk = kernel_pair(name)
    rng = np.random.default_rng(1)
    X, Y = walks(rng, 5), walks(rng, 4)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    close(tk.K(tX), jk.K(X))
    close(tk.K(tX, tY), jk.K(X, Y))
    close(tk.K(tX, tY, return_levels=True), jk.K(X, Y, return_levels=True))
    close(tk.Kdiag(tX), jk.Kdiag(X))
    close(tk.K(tX.reshape(5, -1)), jk.K(X.reshape(5, -1)))
    for got, want in zip(tk.seq_covariances(tY, tX),
                         jk.seq_covariances(Y, X)):
        close(got, want)


@pytest.mark.parametrize("increments", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tensor_grams_match_jax(name, increments):
    jk, tk = kernel_pair(name)
    rng = np.random.default_rng(2)
    F = tk.num_levels * (tk.num_levels + 1) // 2
    width = D * (1 + tk.num_lags)
    Z = 0.4 * rng.standard_normal((6, F, 2, width) if increments
                                  else (6, F, width))
    X = walks(rng, 5)
    tZ, tX = torch.as_tensor(Z), torch.as_tensor(X)
    close(tk.K_tens(tZ, increments), jk.K_tens(Z, increments))
    close(tk.K_tens_diag(tZ, increments), jk.K_tens_diag(Z, increments))
    close(tk.K_tens_vs_seq(tZ, tX, increments),
          jk.K_tens_vs_seq(Z, X, increments))
    close(tk.K_tens_vs_seq(tZ, tX, increments, return_levels=True),
          jk.K_tens_vs_seq(Z, X, increments, return_levels=True))


@pytest.mark.parametrize("increments,learn_weights",
                         [(False, False), (True, False), (True, True)])
def test_inducing_tensors_match_jax(increments, learn_weights):
    jk, tk = kernel_pair("rbf_ard")
    rng = np.random.default_rng(3)
    F = NL * (NL + 1) // 2
    Z = 0.4 * rng.standard_normal((6, F, 2, D) if increments else (6, F, D))
    X = walks(rng, 5)
    jf = jind.InducingTensors.create(jnp.asarray(Z), NL, increments,
                                     learn_weights)
    if learn_weights:
        jf = jf.replace(raw_W=jnp.asarray(rng.uniform(0.5, 1.5, (6, NL))))
    tf = tind.InducingTensors.create(torch.as_tensor(Z), NL, increments,
                                     learn_weights)
    convert.load_jax_arrays(tf, leaves(jf))
    assert tf.num_inducing == jf.num_inducing == 6
    close(tf.Kuu(tk), jf.Kuu(jk))
    close(tf.Kuf(tk, torch.as_tensor(X)), jf.Kuf(jk, X))


@pytest.mark.parametrize("increments", [False, True])
def test_make_inducing_tensors_draws_data_increments(increments):
    X = torch.as_tensor(walks(np.random.default_rng(4), 4, L=6))
    gen = torch.Generator().manual_seed(0)
    feat = tind.make_inducing_tensors_from_data(
        gen, X, num_tensors=5, num_levels=NL, num_features=D,
        increments=increments, scale=2.0)
    F = NL * (NL + 1) // 2
    assert tuple(feat.raw_Z.shape) == ((5, F, 2, D) if increments
                                       else (5, F, D))
    incs = 2.0 * torch.diff(X, dim=1).reshape(-1, D)
    rows = feat.raw_Z.detach().reshape(-1, D)
    dist = (rows[:, None] - incs[None]).abs().sum(-1).min(dim=1).values
    assert torch.all(dist == 0)


@pytest.mark.parametrize("kw,route", [
    (dict(num_levels=8), "pairs"),
    (dict(num_levels=8, order=2), "pairs"),
    (dict(num_levels=9, difference=False), "pairs"),
])
def test_cuda_dispatch_raises_for_uncovered_configurations(kw, route):
    """Past 7 levels nothing is uncovered any more: both devices take the
    JAX package's route, increment matrices reduced by sig_gram (whose
    kernels take num_levels + 1 <= 128)."""
    kw = dict(kw)
    kern = tsk.SignatureRBF(D, kw.pop("num_levels", NL), device="cpu", **kw)
    assert kern._route(torch.device("cuda")) == route
    assert kern._route(torch.device("cpu")) == route


@pytest.mark.parametrize("ctor", ["SignatureRBF", "SignatureLinear"])
def test_cuda_dispatch_takes_kernels_for_the_main_path(ctor):
    kern = getattr(tsk, ctor)(D, 7, device="cpu")
    assert kern._route(torch.device("cuda")) == "tuned"
    assert kern._route(torch.device("cpu")) == "tuned"
    assert kern._rbf() is (ctor == "SignatureRBF")


@pytest.mark.parametrize("ctor,kw", [
    ("SignatureRBF", dict(order=2)), ("SignatureRBF", dict(difference=False)),
    ("SignatureLinear", dict(order=3)), ("SignaturePoly", dict()),
    ("SignatureCosine", dict()), ("SignaturePoly", dict(degree=3, order=7)),
])
def test_dispatch_takes_general_kernels_elsewhere(ctor, kw):
    kern = getattr(tsk, ctor)(D, 7, device="cpu", **kw)
    assert kern._route(torch.device("cuda")) == "general"
    assert kern._route(torch.device("cpu")) == "general"
    assert kern._kind() == {"SignatureRBF": "rbf", "SignatureLinear": "linear",
                            "SignatureCosine": "cosine"}.get(
        ctor, f"poly{kw.get('degree', 2)}")


def test_cpu_general_path_goes_through_the_wrappers():
    """Order 2 on the CPU: the general wrappers' plain versions compute K
    and Kuf (the Poly offset channel included) and launch nothing."""
    jk, tk = kernel_pair("poly_order2")
    rng = np.random.default_rng(6)
    X = torch.as_tensor(walks(rng, 4))
    Z = torch.as_tensor(0.4 * rng.standard_normal((3, 6, 2, D)))
    seen = []

    def spy(fn):
        def wrapped(*args):
            seen.append((fn.__name__, tuple(tuple(a.shape) for a in args
                                            if torch.is_tensor(a))))
            return fn(*args)
        return wrapped

    before = (tfgho.launches, ttsg.launches, tsg.ho_launches)
    with mock.patch.object(tfgho, "fused_gram_ho_levels_ref",
                           spy(tfgho.fused_gram_ho_levels_ref)), \
            mock.patch.object(ttsg, "fused_tens_seq_general_levels_ref",
                              spy(ttsg.fused_tens_seq_general_levels_ref)), \
            mock.patch.object(tsg, "sig_gram_levels_ho_ref",
                              spy(tsg.sig_gram_levels_ho_ref)):
        close(tk.K(X), jk.K(X.numpy()))
        close(tk.K_tens_vs_seq(Z, X, True), jk.K_tens_vs_seq(Z.numpy(),
                                                            X.numpy(), True))
    names = [n for n, _ in seen]
    assert names.count("fused_gram_ho_levels_ref") == 1
    assert names.count("fused_tens_seq_general_levels_ref") == 1
    assert names.count("sig_gram_levels_ho_ref") == 2
    # the offset channel: D + 1 columns on both sides of the Gram and Kuf
    assert ("fused_gram_ho_levels_ref", ((4, 8, D + 1),) * 2) in seen
    assert ("fused_tens_seq_general_levels_ref",
            ((3, 6, 2, D + 1), (4, 8, D + 1))) in seen
    assert (tfgho.launches, ttsg.launches, tsg.ho_launches) == before


GENERAL = [(ctor, order, difference)
           for ctor in ("SignatureRBF", "SignatureLinear", "SignaturePoly",
                        "SignatureCosine")
           for order in (1, 2, 3) for difference in (True, False)]


def general_pair(ctor, order, difference, engine="xla"):
    """Both packages' kernel with ARD, and for the Linear base a lag and no
    normalisation; a Poly offset of 0.6 and random variances."""
    kw = dict(order=order, difference=difference, lengthscales=[0.7, 1.3])
    if ctor == "SignatureLinear":
        kw.update(num_lags=1, normalization=False)
    if ctor == "SignaturePoly":
        kw.update(offset=0.6)
    jk = getattr(jsk, ctor)(D, NL, engine=engine, **kw)
    rng = np.random.default_rng(order + 3 * difference)
    jk = jk.replace(raw_variances=jnp.asarray(rng.normal(0.0, 0.5, NL + 1)))
    tk = getattr(tsk, ctor)(D, NL, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


def general_calls(k, X, X2, Z):
    return [k.K(X), k.K(X, X2), k.Kdiag(X), *k.seq_covariances(X2, X),
            k.K_tens_vs_seq(Z, X, True, return_levels=True)]


@pytest.mark.parametrize("ctor,order,difference", GENERAL)
def test_general_configurations_match_jax(ctor, order, difference):
    jk, tk = general_pair(ctor, order, difference)
    rng = np.random.default_rng(7)
    X, X2 = walks(rng, 5), walks(rng, 3)
    width = D * (1 + tk.num_lags)
    Z = 0.4 * rng.standard_normal((4, 6, 2, width))
    got = general_calls(tk, *map(torch.as_tensor, (X, X2, Z)))
    for g, w in zip(got, general_calls(jk, X, X2, Z)):
        close(g, w)


@pytest.mark.parametrize("ctor,order,difference", [
    ("SignatureRBF", 2, True), ("SignatureLinear", 1, False),
    ("SignaturePoly", 3, True), ("SignatureCosine", 2, False),
])
def test_general_configurations_match_jax_pallas_engine(ctor, order,
                                                        difference):
    jk, tk = general_pair(ctor, order, difference, engine="pallas")
    rng = np.random.default_rng(8)
    X, X2 = walks(rng, 4), walks(rng, 3)
    width = D * (1 + tk.num_lags)
    Z = 0.4 * rng.standard_normal((3, 6, 2, width))
    got = general_calls(tk, *map(torch.as_tensor, (X, X2, Z)))
    for g, w in zip(got, general_calls(jk, X, X2, Z)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))


def test_entry_points_default_to_the_card():
    """device=None resolves through config.default_device() (the card);
    device="cpu" builds on the CPU."""
    from gpsig_tpu_torch import likelihoods
    from gpsig_tpu_torch.models import gpr, svgp

    assert tcfg.default_device() == torch.device("cuda")
    Z = torch.zeros(3, 6, D, dtype=torch.float64)
    feat = tind.InducingTensors.create(Z, NL)

    def build(**dev):
        kern = tsk.SignaturePoly(D, NL, **dev)
        cos = tsk.SignatureCosine(D, NL, **dev)
        model = svgp.SVGP.create(kern, likelihoods.MultiClass(3), feat, 3,
                                 **dev)
        reg = gpr.GPR.create(cos, **dev)
        lik = likelihoods.Gaussian.create(0.5, **dev)
        state = convert.from_jax_arrays({"a": np.ones(2)}, **dev)
        return [kern.raw_sigma, kern.base.raw_offset, cos.raw_variances,
                model.q_mu, reg.likelihood.raw_variance, lik.raw_variance,
                state["a"]]

    with mock.patch.object(tcfg, "default_device",
                           lambda: torch.device("meta")):
        assert {t.device.type for t in build()} == {"meta"}
    assert {t.device.type for t in build(device="cpu")} == {"cpu"}
    # the inducing features follow their input's device
    assert feat.raw_Z.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tsk.SignatureRBF(D, NL)


# ---------------------------------------------------------------------------
# Past 7 levels: K, Kdiag, the two-length Gram and the normalisation
# diagonal through increment matrices and sig_gram, K_tens_vs_seq through
# the plain recursion, values and gradients against the JAX package's XLA
# route (rtol 1e-10: the same recursions, other summation order only), on
# sequences of at least num_levels increments.
# ---------------------------------------------------------------------------

DEEP_RTOL = 1e-10


def deep_pair(nl, order, normalization, ctor="SignatureRBF"):
    kw = dict(order=order, lengthscales=[0.7, 1.3],
              normalization=normalization)
    if ctor == "SignaturePoly":
        kw.update(offset=0.6)
    jk = getattr(jsk, ctor)(D, nl, engine="xla", **kw)
    rng = np.random.default_rng(nl + 10 * order)
    jk = jk.replace(raw_variances=jnp.asarray(rng.normal(0.0, 0.5, nl + 1)))
    tk = getattr(tsk, ctor)(D, nl, device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


def deep_calls(k, X, X2, Z):
    return [k.K(X), k.K(X, X2), k.Kdiag(X),
            k.K_tens_vs_seq(Z, X, True, return_levels=True)]


@pytest.mark.parametrize("normalization", [True, False])
@pytest.mark.parametrize("nl,order", [(8, 1), (8, 2), (10, 1), (10, 2)])
def test_deep_levels_match_jax(nl, order, normalization):
    jk, tk = deep_pair(nl, order, normalization)
    rng = np.random.default_rng(11)
    X, X2 = walks(rng, 4, L=12), walks(rng, 3, L=11)
    Z = 0.4 * rng.standard_normal((3, nl * (nl + 1) // 2, 2, D))
    seen = []
    ref = tsg.sig_gram_levels_ref if order == 1 else tsg.sig_gram_levels_ho_ref
    with mock.patch.object(
            tsg, ref.__name__,
            lambda *a: seen.append(a[0].shape) or ref(*a)):
        got = deep_calls(tk, *map(torch.as_tensor, (X, X2, Z)))
    # K (its triangle of pairs: 10 of 4 sequences), the two-length Gram,
    # and the diagonals behind the normalisation (or the unnormalised
    # Kdiag) all reach sig_gram
    assert {(10, 11, 11), (12, 11, 10), (4, 11, 11)} <= set(seen)
    for g, w in zip(got, deep_calls(jk, X, X2, Z)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=DEEP_RTOL, atol=1e-14)


@pytest.mark.parametrize("ctor,normalization", [("SignatureLinear", True),
                                                ("SignaturePoly", False)])
@pytest.mark.parametrize("nl,order", [(8, 1), (8, 2), (10, 1), (10, 2)])
def test_deep_levels_gradients_match_jax(nl, order, ctor, normalization):
    """Autograd through sig_gram's backward (its plain VJP on the CPU) and
    the plain Kuf recursion against ``jax.grad``: the inputs' and every
    kernel parameter's gradient of a weighted sum of K, the two-length
    Gram, Kdiag and Kuf. Linear and Poly bases: the RBF base's clamp of
    the squared distance at 0 splits the gradient at a tie in JAX
    (``jnp.maximum``) and not in PyTorch (``torch.clamp``), and the
    self-Grams behind the normalisation and Kdiag have ties on their
    diagonals. Every sequence has at least num_levels increments: past
    that an order-1 level is identically zero, and normalising it divides
    rounding noise by the clamp's 1e-30."""
    jk, tk = deep_pair(nl, order, normalization, ctor)
    rng = np.random.default_rng(12)
    X, X2 = walks(rng, 4, L=12), walks(rng, 3, L=11)
    Z = 0.4 * rng.standard_normal((3, nl * (nl + 1) // 2, 2, D))
    W = [rng.standard_normal(s) for s in ((4, 4), (4, 3), (4,), (3, 4))]

    def loss(k, X, X2, Z, W, lib):
        return (lib.sum(W[0] * k.K(X)) + lib.sum(W[1] * k.K(X, X2))
                + lib.sum(W[2] * k.Kdiag(X))
                + lib.sum(W[3] * k.K_tens_vs_seq(Z, X, True)))

    jg_k, jg_x, jg_z = jax.grad(
        lambda k, x, z: loss(k, x, X2, z, W, jnp), argnums=(0, 1, 2))(
            jk, jnp.asarray(X), jnp.asarray(Z))
    tX = torch.as_tensor(X).requires_grad_()
    tZ = torch.as_tensor(Z).requires_grad_()
    loss(tk, tX, torch.as_tensor(X2), tZ, [torch.as_tensor(w) for w in W],
         torch).backward()
    np.testing.assert_allclose(tX.grad.numpy(), np.asarray(jg_x),
                               rtol=DEEP_RTOL, atol=1e-12)
    np.testing.assert_allclose(tZ.grad.numpy(), np.asarray(jg_z),
                               rtol=DEEP_RTOL, atol=1e-12)
    want = leaves(jg_k)
    got = {k: v.grad.numpy() for k, v in tk.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=DEEP_RTOL,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("ctor,kw", [
    ("SignatureRBF", dict()), ("SignatureRBF", dict(order=2)),
    ("SignaturePoly", dict(offset=0.6, order=2))])
def test_symmetric_gram_flag_reaches_the_fused_grams(ctor, kw):
    """``K(X)`` and ``seq_covariances``' K(Z, Z) ask the fused Gram for its
    triangle (``symmetric=True``: the kernels on the card then solve the
    pairs on and above the diagonal only), ``K(X, X2)`` and K(Z, X) for
    every pair; the Poly offset channel makes the two sides differ while
    the flag holds. On the CPU the flag changes nothing: K(X) and X.grad
    against ``jax.grad``, float64, rtol 1e-8."""
    jk = getattr(jsk, ctor)(D, NL, engine="xla", lengthscales=[0.7, 1.3],
                            **kw)
    tk = getattr(tsk, ctor)(D, NL, device="cpu", lengthscales=[0.7, 1.3],
                            **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    rng = np.random.default_rng(21)
    X, X2, Z = walks(rng, 5), walks(rng, 4), walks(rng, 3)
    W = rng.standard_normal((5, 5))
    mod, name = ((tfg, "fused_gram_levels") if tk._route(
        torch.device("cuda")) == "tuned" else
        (tfgho, "fused_gram_ho_levels"))
    real, flags = getattr(mod, name), []

    def spy(*args, **kwargs):
        bound = inspect.signature(real).bind(*args, **kwargs)
        flags.append(bound.arguments.get("symmetric", False))
        return real(*args, **kwargs)

    Xt = torch.tensor(X, requires_grad=True)
    with mock.patch.object(mod, name, spy):
        got = tk.K(Xt)
        assert flags == [True]
        tk.K(torch.as_tensor(X), torch.as_tensor(X2))
        tk.seq_covariances(torch.as_tensor(Z), torch.as_tensor(X))
    assert flags == [True, False, True, False]
    close(got, jk.K(X))
    (gx,) = torch.autograd.grad((got * torch.as_tensor(W)).sum(), Xt)
    close(gx, jax.grad(lambda x: jnp.sum(jk.K(x) * W))(jnp.asarray(X)))
