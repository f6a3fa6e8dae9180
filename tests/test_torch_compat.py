"""Parity of the port's GPSig facade (``gpsig_tpu_torch.compat``) with
``gpsig_tpu.compat``, float64 on the CPU: the same numpy inputs, made from
a seed, go through both facades (the port's given ``device="cpu"``).

Tolerances: values rtol 1e-10 (the same arithmetic in another summation
order), with atol 1e-15 for entries near zero, where a few ulp of the
O(1) entries are all there is; trajectories of up to 10 training steps
rtol 1e-8, atol 1e-12, as ``test_torch_training.py`` (each step carries the Cholesky factorisations'
and quadratures' rounding, amplified mildly by Adam). The two facades draw
the same minibatches (``np.random.default_rng(seed).choice``), so their
training runs can be compared step for step. JAX jit dominates the cost:
each JAX facade model is built and trained once, in a module-scoped
fixture, and many quantities are compared against it.
"""

import weakref
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import compat as jgpsig
from gpsig_tpu.data import preprocessing as jprep
from gpsig_tpu.ops.signature import tensor_factor_count
from gpsig_tpu_torch import compat as gpsig
from gpsig_tpu_torch import config as tcfg
from gpsig_tpu_torch import convert
from gpsig_tpu_torch.data import preprocessing as tprep
from gpsig_tpu_torch.training.natgrad import natgrad_step

torch.set_num_threads(1)
VALUE_RTOL, VALUE_ATOL = 1e-10, 1e-15
RTOL, ATOL = 1e-8, 1e-12
N, L, D, C, NL = 20, 10, 2, 3, 3
F = tensor_factor_count(NL)
CPU = dict(device="cpu")
MODULES = ("inducing_variables", "kernels", "likelihoods", "models",
           "preprocessing", "training")


def leaves(tree):
    """{dotted path: array} of a JAX pytree; a tuple element's segment is
    its index (``kernel.pair_indices.0``)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)

    def seg(k):
        return str(k.idx) if hasattr(k, "idx") else k.name

    return {".".join(seg(k) for k in path): np.asarray(v)
            for path, v in flat}


def numpy(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, rtol=VALUE_RTOL, atol=VALUE_ATOL):
    np.testing.assert_allclose(numpy(got), numpy(want), rtol=rtol, atol=atol)


def jitted(fn, *args):
    """``fn(*args)`` under one ``jax.jit``, as numpy. The JAX facade's
    ``compute_*`` methods and its SVGP's ``compute_log_likelihood_full``
    and ``predict_*`` run eagerly, and eager JAX compiles every primitive
    at its first use, seconds a call; the facade's graph-style methods and
    its model's functional calls are traced here instead."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def jax_elbo_full(jm):
    """The JAX facade's ``compute_log_likelihood_full()`` (its likelihoods
    here draw nothing)."""
    return float(jitted(lambda m: m.elbo(jm.X, jm.Y, num_data=jm.num_data),
                        jm.to_functional()))


def jax_predict(jm, method, *args, **kw):
    """The JAX facade's ``predict_*`` (``posterior()`` then the call)."""
    return jitted(lambda m, *a: getattr(m.posterior(), method)(*a, **kw),
                  jm.to_functional(), *args)


def close_models(pm, jm, rtol=RTOL, atol=ATOL, skip=()):
    """Every parameter of the port's compat model against the JAX one's
    leaves (q_sqrt's lower triangle, the only part used)."""
    want = leaves(jm.to_functional())
    got = dict(pm.to_functional().named_parameters())
    assert set(got) <= set(want)
    for name, value in got.items():
        if name in skip:
            continue
        if name == "q_sqrt" and value.ndim == 3:
            value, want[name] = torch.tril(value), np.tril(want[name])
        close(value, want[name], rtol, atol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = 0.4 * rng.standard_normal((N, L * D))
    y = rng.integers(0, C, N)
    return X, y


def tensors(seed=1, increments=True, T=6):
    rng = np.random.default_rng(seed)
    shape = (T, F, 2, D) if increments else (T, F, D)
    return 0.3 * rng.standard_normal(shape)


def sequences(seed=3, M=4, Lz=5):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal((M, Lz, D)).cumsum(1)


# ---------------------------------------------------------------------------
# Module layout, constructors, kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", MODULES)
def test_public_names_match_jax(module):
    """Each submodule has the JAX facade's public names."""
    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and getattr(v, "__module__", "")
                .startswith(("gpsig_tpu.", "gpsig_tpu_torch."))}

    assert public(getattr(jgpsig, module)) <= public(getattr(gpsig, module))
    assert hasattr(gpsig, module)


@pytest.mark.parametrize("ctor,kw", [
    ("SignatureRBF", {}), ("SignatureLinear", {}),
    ("SignaturePoly", dict(offset=0.7, degree=3)), ("SignatureCosine", {}),
])
def test_kernel_computes_match_jax(data, ctor, kw):
    """compute_K_symm, compute_K, compute_Kdiag and the three inducing-
    tensor twins (with and without increments), numpy out, and the
    parameter views."""
    X, _ = data
    args = dict(input_dim=L * D, num_features=D, num_levels=NL,
                lengthscales=[0.8, 1.2], **kw)
    jk = getattr(jgpsig.kernels, ctor)(**args)
    tk = getattr(gpsig.kernels, ctor)(**args, **CPU)
    Zs = [tensors(increments=inc) for inc in (True, False)]

    def grams(k, X, Zs):
        out = [k.K(X), k.K(X[:5], X[5:9]), k.Kdiag(X)]
        for Z, inc in zip(Zs, (True, False)):
            out += [k.K_tens(Z, increments=inc),
                    k.K_tens_vs_seq(Z, X, increments=inc),
                    k.K_tens_diag(Z, increments=inc)]
        return out

    want = jitted(lambda X, Zs: grams(jk, X, Zs), X, Zs)
    K = tk.compute_K_symm(X)
    assert isinstance(K, np.ndarray) and K.dtype == np.float64
    got = [K, tk.compute_K(X[:5], X[5:9]), tk.compute_Kdiag(X)]
    for Z, inc in zip(Zs, (True, False)):
        got += [tk.compute_K_tens(Z, increments=inc),
                tk.compute_K_tens_vs_seq(Z, X, increments=inc),
                tk.compute_K_tens_diag(Z, increments=inc)]
    for g, w in zip(got, want):
        close(g, w)
    for view in ("lengthscales", "variances", "sigma"):
        assert isinstance(getattr(tk, view), np.ndarray)
        close(getattr(tk, view), getattr(jk, view))
    assert tk.lags is None and tk.gamma is None
    # the graph-style methods return tensors on the kernel's device
    assert isinstance(tk.K(X), torch.Tensor) and tk.K(X).device.type == "cpu"


def test_kernel_with_lags_views_match_jax(data):
    X, _ = data
    args = dict(input_dim=L * D, num_features=D, num_levels=NL, num_lags=2)
    jk = jgpsig.kernels.SignatureRBF(**args)
    tk = gpsig.kernels.SignatureRBF(**args, **CPU)
    close(tk.lags, jk.lags)
    close(tk.gamma, jk.gamma)
    close(tk.compute_K_symm(X[:6]), jitted(jk.K, X[:6]))


@pytest.mark.parametrize("ctor,keyword", [
    ("SignatureRBF", "engine"), ("SignatureRBF", "row_block"),
    ("SignaturePoly", "engine"), ("UntruncSignatureKernel", "row_block"),
])
def test_tpu_only_keywords_are_refused_by_name(ctor, keyword):
    with pytest.raises(TypeError, match=keyword):
        getattr(gpsig.kernels, ctor)(L * D, D, **(
            {"num_levels": NL} if ctor != "UntruncSignatureKernel" else {}),
            **{keyword: "xla" if keyword == "engine" else 4}, **CPU)


def test_input_dim_checks_and_casting(data):
    """input_dim is checked as in the JAX facade; inputs are cast to the
    kernel's dtype (a float32 kernel computes in float32 on float64
    input, where JAX would promote)."""
    X, _ = data
    tk = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                    num_levels=NL, **CPU)
    with pytest.raises(ValueError):
        tk.K(X[:, :-2])
    with pytest.raises(ValueError):
        gpsig.kernels.SignatureRBF(input_dim=21, num_features=2,
                                   num_levels=NL, **CPU)
    with pytest.raises(ValueError):
        gpsig.kernels.UntruncSignatureKernel(input_dim=21, num_features=2,
                                             **CPU)
    k32 = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                     num_levels=NL, dtype=torch.float32,
                                     **CPU)
    K32 = k32.compute_K_symm(X)
    assert K32.dtype == np.float32
    core = k32.to_functional()
    with torch.no_grad():
        want = core.K(torch.as_tensor(X, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(K32, want)
    # a [N, L, d] array is taken as it is
    close(tk.compute_K_symm(X.reshape(N, L, D)), tk.compute_K_symm(X),
          rtol=0)


def test_constructors_default_to_the_card(data):
    """device=None resolves through config.default_device(); without a
    card such a call fails with PyTorch's own error."""
    X, y = data
    with mock.patch.object(tcfg, "default_device",
                           lambda: torch.device("meta")):
        kern = gpsig.kernels.SignatureRBF(L * D, D, NL)
        pde = gpsig.kernels.UntruncSignatureKernel(L * D, D)
        feat = gpsig.inducing_variables.InducingTensors(tensors(), NL, True)
        seqs = gpsig.inducing_variables.InducingSequences(sequences())
        lik = gpsig.likelihoods.Gaussian(0.5)
        got = [kern.to_functional().raw_sigma, pde.to_functional().raw_sigma,
               feat.to_functional().raw_Z, seqs.to_functional().raw_Z,
               lik.raw_variance]
    assert {t.device.type for t in got} == {"meta"}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            gpsig.kernels.SignatureRBF(L * D, D, NL)
        with pytest.raises((RuntimeError, AssertionError)):
            gpsig.inducing_variables.InducingSequences(sequences())


def test_likelihood_constructors_match_jax():
    assert gpsig.likelihoods.Softmax is gpsig.likelihoods.SoftMax
    sm, jsm = gpsig.likelihoods.SoftMax(C), jgpsig.likelihoods.SoftMax(C)
    assert sm.num_samples == jsm.num_samples == 100
    mc = gpsig.likelihoods.MultiClass(C, epsilon=1e-2)
    assert (mc.num_classes, mc.epsilon) == (C, 1e-2)
    g = gpsig.likelihoods.Gaussian(0.3, **CPU)
    close(g.variance, jgpsig.likelihoods.Gaussian(0.3).variance)
    assert g.raw_variance.dtype == torch.float64
    assert isinstance(gpsig.likelihoods.Bernoulli(), torch.nn.Module)


def test_untrunc_kernel_matches_jax(data):
    X, _ = data
    Xs = 0.2 * X.reshape(N, L, D).cumsum(1)[:6].reshape(6, L * D)
    args = dict(input_dim=L * D, num_features=D, dyadic_order=1,
                lengthscales=[0.9, 1.1], sigma=1.3, normalization=True)
    jk = jgpsig.kernels.UntruncSignatureKernel(**args)
    tk = gpsig.kernels.UntruncSignatureKernel(**args, **CPU)
    want = jitted(lambda X: (jk.K(X), jk.K(X[:2], X[2:]), jk.Kdiag(X)), Xs)
    got = (tk.compute_K_symm(Xs), tk.compute_K(Xs[:2], Xs[2:]),
           tk.compute_Kdiag(Xs))
    for g, w in zip(got, want):
        close(g, w)
    close(tk.lengthscales, jk.lengthscales)
    close(tk.sigma, jk.sigma)


# ---------------------------------------------------------------------------
# Inducing variables.
# ---------------------------------------------------------------------------

def _feature_pair(kind):
    args = dict(input_dim=L * D, num_features=D, num_levels=NL)
    if kind == "orthogonal":
        kw = dict(input_dim=L * D, num_features=D, dyadic_order=1,
                  normalization=True)
        jk = jgpsig.kernels.UntruncSignatureKernel(**kw)
        tk = gpsig.kernels.UntruncSignatureKernel(**kw, **CPU)
        return (jk, jgpsig.inducing_variables.OrthogonalFeatures(jk, NL),
                tk, gpsig.inducing_variables.OrthogonalFeatures(tk, NL))
    jk = jgpsig.kernels.SignatureRBF(**args)
    tk = gpsig.kernels.SignatureRBF(**args, **CPU)
    if kind == "tensors":
        Z = tensors()
        return (jk, jgpsig.inducing_variables.InducingTensors(Z, NL, True),
                tk, gpsig.inducing_variables.InducingTensors(Z, NL, True,
                                                             **CPU))
    Z = sequences()
    return (jk, jgpsig.inducing_variables.InducingSequences(Z), tk,
            gpsig.inducing_variables.InducingSequences(Z, **CPU))


@pytest.mark.parametrize("kind", ["tensors", "sequences", "orthogonal"])
def test_inducing_wrappers_match_jax(data, kind):
    """len, Z, Kuu and Kuf (numpy inputs, compat kernels unwrapped)."""
    X, _ = data
    jk, jf, tk, tf = _feature_pair(kind)
    assert len(tf) == len(jf)
    if kind == "orthogonal":
        assert len(tf) == 1 + D + D**2 + D**3
    else:
        close(tf.Z, jf.Z, rtol=0)
        # Z is a copy: training never writes into the caller's array
        assert not np.shares_memory(tf.Z, jf.Z)
    Kuu, Kuf = jitted(lambda X: (jf.Kuu(jk), jf.Kuf(jk, X)), X)
    close(tf.Kuu(tk), Kuu)
    close(tf.Kuf(tk, X), Kuf)
    # the core kernel is accepted too
    close(tf.Kuf(tk.to_functional(), torch.as_tensor(X)), Kuf)


# ---------------------------------------------------------------------------
# Low rank.
# ---------------------------------------------------------------------------

def _low_rank(api, X=None, **kw):
    return api.kernels.SignatureRBF(
        input_dim=L * D, num_features=D, num_levels=NL, low_rank=True,
        num_components=16, X_example=X, **kw)


def test_low_rank_matches_jax_with_carried_landmarks(data):
    """JAX's landmarks and pairs carried into the wrapper's module: K,
    K(X, X2), Kdiag and the feature map agree, the feature map up to a
    sign a column (LAPACK's and JAX's eigenvectors of the landmarks' Gram
    may differ in sign; K = ΦΦᵀ does not see it), scaled by its largest
    entry (a column of the eigenvectors' basis carries the rounding of the
    eigen-solver, about 1e-13 here, into entries of any size)."""
    X, _ = data
    jk = _low_rank(jgpsig, X)
    tk = _low_rank(gpsig, X, **CPU)
    convert.load_jax_arrays(tk.to_functional(), leaves(jk.to_functional()))
    *grams, want = jitted(lambda X: (jk.K(X), jk.K(X[:4], X[4:]),
                                     jk.Kdiag(X), jk.feature(X)), X)
    for g, w in zip((tk.compute_K_symm(X), tk.compute_K(X[:4], X[4:]),
                     tk.compute_Kdiag(X)), grams):
        close(g, w)
    got = numpy(tk.feature(X))
    signs = np.sign(np.sum(got * want, axis=0))
    assert np.all(signs != 0)
    close(got * signs, want, rtol=0, atol=VALUE_RTOL * np.abs(want).max())
    with pytest.raises(AttributeError):
        gpsig.kernels.SignatureRBF(L * D, D, NL, **CPU).feature(X)
    with pytest.raises(NotImplementedError):
        gpsig.kernels.SignatureLinear(L * D, D, NL, low_rank=True, **CPU)


def test_low_rank_landmarks_deterministic(data):
    """The Gram does not depend on which array touches the kernel first:
    X_example pins the landmarks, and a fresh kernel handed to a compat
    SVGP takes them from the training data."""
    X, y = data
    Xtest = X + 0.5
    K_ref = _low_rank(gpsig, X, **CPU).compute_K_symm(X)
    k2 = _low_rank(gpsig, X, **CPU)
    k2.compute_K_symm(Xtest)
    np.testing.assert_array_equal(k2.compute_K_symm(X), K_ref)
    k3 = _low_rank(gpsig, **CPU)
    with pytest.raises(RuntimeError):
        k3.to_functional()
    model = gpsig.models.SVGP(
        X, y, k3, gpsig.likelihoods.MultiClass(C),
        gpsig.inducing_variables.InducingSequences(sequences(), **CPU),
        num_latent=C)
    np.testing.assert_array_equal(k3.compute_K_symm(X), K_ref)
    assert np.isfinite(model.compute_log_likelihood_full())
    # first touch, where no other source exists
    k4 = _low_rank(gpsig, **CPU)
    np.testing.assert_array_equal(k4.compute_K_symm(X), K_ref)


def test_low_rank_adam_trains_where_the_reference_raises(data):
    """A defect of the reference facade: ``gpsig_tpu.compat.training.
    AdamOptimizer.minimize`` takes ``jax.value_and_grad`` over every leaf
    of the model, the low-rank sketch's integer ``pair_indices`` included,
    and raises ``TypeError`` on any model whose kernel has
    ``low_rank=True``. The port keeps those indices as buffers, so its
    Adam trains the model. It is held against JAX's
    ``compat.training.fit(use_natgrad=False)``, the same optax Adam over
    the float leaves only, on the same batches, from the same q drawn away
    from the prior (see ``adam_phases``)."""
    X, y = data
    steps, lr = 4, 1e-2

    def build(api, **kw):
        kern = _low_rank(api, **kw)
        feat = api.inducing_variables.InducingSequences(sequences(), **kw)
        return api.models.SVGP(X, y, kern, api.likelihoods.MultiClass(C),
                               feat=feat, num_latent=C, minibatch_size=8,
                               seed=5)

    with pytest.raises(TypeError):
        jgpsig.training.AdamOptimizer(lr).minimize(build(jgpsig), 1)
    jm, tm = build(jgpsig), build(gpsig, **CPU)
    jm.update_functional(away_from_prior(jm.to_functional()))
    start = leaves(jm.to_functional())
    convert.load_jax_arrays(tm.to_functional(), start)
    jelbo = jgpsig.training.fit(jm, maxiter=steps, learning_rate=lr,
                                use_natgrad=False)
    telbo = gpsig.training.AdamOptimizer(lr).minimize(tm, maxiter=steps)
    close(telbo, jelbo, RTOL)
    close_models(tm, jm)
    landmarks = tm.to_functional().kernel.landmarks
    assert np.abs(numpy(landmarks) - start["kernel.landmarks"]).min() > 0


# ---------------------------------------------------------------------------
# The data-holding SVGP and the optimizers.
# ---------------------------------------------------------------------------

def tiny_svgp(api, data, seed=7, minibatch=8, Z_seed=2, **kw):
    """test_compat.py's order-1 inducing-tensor model."""
    X, y = data
    Z = 0.3 * np.random.default_rng(Z_seed).standard_normal((5, F, D))
    kern = api.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                    num_levels=NL, **kw)
    feat = api.inducing_variables.InducingTensors(Z, NL, **kw)
    return api.models.SVGP(X, y, kern, api.likelihoods.MultiClass(C),
                           feat=feat, num_latent=C, minibatch_size=minibatch,
                           seed=seed)


def away_from_prior(jm, seed=9):
    """A JAX core SVGP with q_mu and q_sqrt drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    M, C_ = jm.q_mu.shape
    q_sqrt = np.tril(0.1 * rng.standard_normal((C_, M, M))) + 0.8 * np.eye(M)
    return jm.replace(q_mu=jnp.asarray(0.3 * rng.standard_normal((M, C_))),
                      q_sqrt=jnp.asarray(q_sqrt))


def elbo_full(m):
    if isinstance(m, jgpsig.models.SVGP):
        return jax_elbo_full(m)
    return m.compute_log_likelihood_full()


@pytest.fixture(scope="module")
def trained(data):
    """10 alternations of NatGrad(0.2) and frozen Adam(1e-2) in both
    facades, with the ELBOs before and after."""
    out = {}
    for name, api, kw in (("jax", jgpsig, {}), ("port", gpsig, CPU)):
        m = tiny_svgp(api, data, **kw)
        e0 = elbo_full(m)
        nat = api.training.NatGradOptimizer(0.2)
        adam = api.training.AdamOptimizer(1e-2)
        for _ in range(10):
            nat.minimize(m, maxiter=1)
            adam.minimize(m, maxiter=1, freeze_variational=True)
        out[name] = dict(model=m, e0=e0, e1=elbo_full(m))
    return out


def test_svgp_batches_and_full_elbo_match_jax(data):
    jm = tiny_svgp(jgpsig, data, seed=3)
    tm = tiny_svgp(gpsig, data, seed=3, **CPU)
    for _ in range(3):
        jx, jy = jm.next_batch()
        tx, ty = tm.next_batch()
        np.testing.assert_array_equal(tx.numpy(), jx)
        np.testing.assert_array_equal(ty.numpy(), jy)
    close(tm.compute_log_likelihood_full(), jax_elbo_full(jm))
    assert tm.X.dtype == torch.float64 and tm.Y.dtype == torch.int64
    close(tm.q_mu, jm.q_mu, rtol=0)
    close(tm.q_sqrt, jm.q_sqrt, rtol=0)
    # the wrappers hold the core model's own modules
    core = tm.to_functional()
    assert core.kernel is tm.kern.to_functional()
    assert core.inducing is tm.feat.to_functional()
    assert tm.likelihood is core.likelihood


@pytest.mark.parametrize("what", ["elbo", "parameters", "views", "predict_f",
                                  "predict_y", "predict_density"])
def test_svgp_training_matches_jax(trained, data, what):
    """After 10 alternations of NatGrad(0.2) and frozen Adam(1e-2): the
    ELBOs, every parameter, the kernel's views and the predictions."""
    X, y = data
    jm, tm = trained["jax"]["model"], trained["port"]["model"]
    if what == "elbo":
        for k in ("e0", "e1"):
            close(trained["port"][k], trained["jax"][k], RTOL)
        assert trained["port"]["e1"] > trained["port"]["e0"]
    elif what == "parameters":
        close_models(tm, jm)
    elif what == "views":
        assert not np.allclose(tm.kern.lengthscales, 1.0)
        close(tm.kern.lengthscales, jm.kern.lengthscales, RTOL, ATOL)
        close(tm.kern.lengthscales,
              tm.to_functional().kernel.lengthscales, rtol=0)
        close(tm.feat.Z, jm.feat.Z, RTOL, ATOL)
    elif what == "predict_f":
        for full_cov in (False, True):
            for g, w in zip(tm.predict_f(X[:4], full_cov=full_cov),
                            jax_predict(jm, "predict_f", X[:4],
                                        full_cov=full_cov)):
                close(g, w, RTOL, ATOL)
    elif what == "predict_y":
        m, v = tm.predict_y(X[:4])
        assert m.shape == (4, C) and v.shape == (4, C)
        np.testing.assert_allclose(m.sum(1), 1.0, atol=1e-6)
        for g, w in zip((m, v), jax_predict(jm, "predict_y", X[:4])):
            close(g, w, RTOL, ATOL)
    else:
        den = tm.predict_density(X[:4], y[:4])
        assert den.shape == (4,)
        close(den, jax_predict(jm, "predict_log_density", X[:4], y[:4]),
              RTOL, ATOL)


def test_fit_with_inducing_sequences_matches_jax(data):
    X, y = data
    Yb = (y == 1).astype(np.float64)[:, None]
    models = []
    for api, kw in ((jgpsig, {}), (gpsig, CPU)):
        kern = api.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                        num_levels=NL, **kw)
        feat = api.inducing_variables.InducingSequences(sequences(), **kw)
        m = api.models.SVGP(X, Yb, kern, api.likelihoods.Bernoulli(),
                            feat=feat, num_latent=1, minibatch_size=10,
                            seed=1)
        e0 = elbo_full(m)
        calls = []
        e1 = api.training.fit(m, maxiter=10, learning_rate=1e-2, gamma=0.2,
                              callback=lambda it, e: calls.append(e))
        models.append((m, e0, e1, calls))
    (jm, je0, je1, jcalls), (tm, te0, te1, tcalls) = models
    close(te0, je0)
    close(te1, je1, RTOL)
    close(tcalls, jcalls, RTOL)
    assert te1 > te0 and len(tcalls) == 10
    close_models(tm, jm)


def test_natgrad_gamma_is_live(data):
    """Mutating nat.gamma between calls takes effect."""
    m_a = tiny_svgp(gpsig, data, seed=11, **CPU)
    m_b = tiny_svgp(gpsig, data, seed=11, **CPU)
    gpsig.training.NatGradOptimizer(0.3).minimize(m_a, maxiter=1)
    nat_b = gpsig.training.NatGradOptimizer(0.001)
    nat_b.gamma = 0.3
    nat_b.minimize(m_b, maxiter=1, var_list=["ignored"])
    np.testing.assert_array_equal(m_a.q_mu, m_b.q_mu)
    m_c = tiny_svgp(gpsig, data, seed=11, **CPU)
    nat_c = gpsig.training.NatGradOptimizer(0.3)
    nat_c.gamma = 0.05
    nat_c.minimize(m_c, maxiter=1)
    assert not np.allclose(m_a.q_mu, m_c.q_mu)


def test_adam_learning_rate_is_live(data):
    m_a = tiny_svgp(gpsig, data, seed=12, **CPU)
    m_b = tiny_svgp(gpsig, data, seed=12, **CPU)
    gpsig.training.AdamOptimizer(1e-2).minimize(m_a, maxiter=2)
    adam_b = gpsig.training.AdamOptimizer(1e-5)
    adam_b.learning_rate = 1e-2
    adam_b.minimize(m_b, maxiter=2)
    np.testing.assert_array_equal(m_a.kern.lengthscales,
                                  m_b.kern.lengthscales)
    # one state a wrapper, released with the wrapper
    assert len(adam_b._state) == 1
    ref = weakref.ref(m_b)
    del m_b
    assert ref() is None and len(adam_b._state) == 0


@pytest.fixture(scope="module")
def adam_phases(data):
    """2 unfrozen, 3 frozen and 1 unfrozen Adam(1e-2) steps on one
    optimizer, in both facades, with the port's state after each phase,
    after one NatGrad(0.2) step: at q = prior (q_mu = 0, S = I, whitened)
    the ELBO's gradient in the lengthscales and Z is zero analytically,
    and Adam's g / (|g| + 1e-8) would turn its rounding into steps of
    1e-11 that differ between the packages."""
    jm = tiny_svgp(jgpsig, data, seed=14)
    tm = tiny_svgp(gpsig, data, seed=14, **CPU)
    jgpsig.training.NatGradOptimizer(0.2).minimize(jm, maxiter=1)
    gpsig.training.NatGradOptimizer(0.2).minimize(tm, maxiter=1)
    jadam = jgpsig.training.AdamOptimizer(1e-2)
    tadam = gpsig.training.AdamOptimizer(1e-2)
    snaps = []
    for steps, frozen in ((2, False), (3, True), (1, False)):
        jadam.minimize(jm, maxiter=steps, freeze_variational=frozen)
        tadam.minimize(tm, maxiter=steps, freeze_variational=frozen)
        opt = tadam._state[tm]
        core = tm.to_functional()
        snaps.append({
            name: dict(value=p.detach().clone(),
                       **{k: v.clone() for k, v in opt.state[p].items()})
            for name, p in core.named_parameters()})
        snaps[-1]["params"] = {n: leaves(jm.to_functional())[n]
                               for n in snaps[-1]}
    return snaps


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_adam_phases_match_jax(adam_phases, phase):
    """optax's one step count for every leaf: after 2 unfrozen, 3 frozen
    and 1 unfrozen steps, q's bias correction uses count 6, as in JAX;
    every parameter against JAX at 1e-10 after each phase."""
    snap = adam_phases[phase]
    want = snap["params"]
    for name, s in snap.items():
        if name == "params":
            continue
        value, w = s["value"], want[name]
        if name == "q_sqrt":
            value, w = torch.tril(value), np.tril(w)
        close(value, w, 1e-10, ATOL)
        assert float(s["step"]) == (2, 5, 6)[phase]


def test_adam_frozen_phase_pins_q_and_its_moments(adam_phases):
    """The frozen phase leaves q_mu, q_sqrt and their moments
    bit-identical, while the hyperparameters' moments advance in the same
    state; the unfrozen step after it moves q's moments again."""
    before, frozen, after = adam_phases
    for name in ("q_mu", "q_sqrt"):
        for k in ("value", "exp_avg", "exp_avg_sq"):
            assert torch.equal(frozen[name][k], before[name][k]), (name, k)
        assert not torch.equal(after[name]["exp_avg"],
                               frozen[name]["exp_avg"])
    hyper = "kernel.raw_lengthscales"
    assert torch.any(before[hyper]["exp_avg"] != 0)
    assert not torch.equal(frozen[hyper]["exp_avg"], before[hyper]["exp_avg"])


def test_adam_frozen_before_q_has_a_gradient_matches_jax(data):
    """2 frozen then 1 unfrozen Adam(1e-2) steps on a fresh optimizer: q
    has no Adam state until the facade makes it on the first frozen step
    (zero moments, torch's scalar dtype), and the unfrozen step corrects
    q with count 3, as optax's shared count does; every parameter against
    JAX at 1e-10."""
    from torch.optim.optimizer import _get_scalar_dtype

    jm = tiny_svgp(jgpsig, data, seed=15)
    tm = tiny_svgp(gpsig, data, seed=15, **CPU)
    jgpsig.training.NatGradOptimizer(0.2).minimize(jm, maxiter=1)
    gpsig.training.NatGradOptimizer(0.2).minimize(tm, maxiter=1)
    jadam = jgpsig.training.AdamOptimizer(1e-2)
    tadam = gpsig.training.AdamOptimizer(1e-2)
    for steps, frozen in ((2, True), (1, False)):
        jadam.minimize(jm, maxiter=steps, freeze_variational=frozen)
        tadam.minimize(tm, maxiter=steps, freeze_variational=frozen)
        if frozen:
            q = tadam._state[tm].state[tm.to_functional().q_mu]
            assert not torch.any(q["exp_avg"]) and not torch.any(
                q["exp_avg_sq"])
    want = leaves(jm.to_functional())
    opt = tadam._state[tm]
    for name, p in tm.to_functional().named_parameters():
        value, w = p.detach(), want[name]
        if name == "q_sqrt":
            value, w = torch.tril(value), np.tril(w)
        close(value, w, 1e-10, ATOL)
        step = opt.state[p]["step"]
        assert float(step) == 3 and step.dtype == _get_scalar_dtype(), name


def test_posterior_cache_reused_and_invalidated_in_place(data):
    """Predictions reuse one cached Posterior; a step taken through
    ``to_functional()`` in place (no optimizer of the facade involved)
    invalidates it, and the new predictions equal a fresh posterior()'s."""
    X, _ = data
    m = tiny_svgp(gpsig, data, seed=13, **CPU)
    m1, _ = m.predict_f(X[:5])
    post1 = m._post_cache[1]
    m.predict_y(X[:5])
    assert m._post_cache[1] is post1
    tX = torch.as_tensor(X[:5])
    with torch.no_grad():
        want = m.to_functional().posterior().predict_f(tX)[0]
    np.testing.assert_array_equal(m1, want.numpy())

    core = m.to_functional()
    xb, yb = m.next_batch()
    natgrad_step(core, 0.2, xb, yb, num_data=m.num_data)
    m2, v2 = m.predict_f(X[:5])
    post2 = m._post_cache[1]
    assert post2 is not post1
    with torch.no_grad():
        fresh = core.posterior().predict_f(tX)
    np.testing.assert_array_equal(m2, fresh[0].numpy())
    np.testing.assert_array_equal(v2, fresh[1].numpy())
    assert not np.allclose(m1, m2)

    # an in-place change of a hyperparameter alone invalidates it too
    with torch.no_grad():
        core.kernel.raw_lengthscales.add_(0.1)
    m.predict_f(X[:5])
    assert m._post_cache[1] is not post2
    # and every optimizer of the facade drops it
    post3 = m._post_cache[1]
    gpsig.training.NatGradOptimizer(0.1).minimize(m, maxiter=1)
    assert m._post_cache is None
    m.predict_f(X[:5])
    assert m._post_cache[1] is not post3


@pytest.fixture(scope="module")
def siggpde(data):
    """The fork's SigGPDE model through the call surface: the untruncated
    kernel, OrthogonalFeatures(num_levels=3), SVGP(q_diag), 6 alternations
    of NatGrad(0.1) and frozen Adam(5e-3), in both facades."""
    X, y = data
    out = {}
    for name, api, kw in (("jax", jgpsig, {}), ("port", gpsig, CPU)):
        kern = api.kernels.UntruncSignatureKernel(
            input_dim=L * D, num_features=D, dyadic_order=1,
            normalization=True, **kw)
        feat = api.inducing_variables.OrthogonalFeatures(kern, num_levels=3)
        m = api.models.SVGP(X, y, kern, api.likelihoods.MultiClass(C),
                            feat=feat, num_latent=C, q_diag=True)
        e0 = elbo_full(m)
        nat = api.training.NatGradOptimizer(0.1)
        adam = api.training.AdamOptimizer(5e-3)
        for _ in range(6):
            nat.minimize(m, maxiter=1)
            adam.minimize(m, maxiter=1, freeze_variational=True)
        out[name] = dict(model=m, e0=e0, e1=elbo_full(m))
    return out


@pytest.mark.parametrize("what", ["elbo", "parameters", "predict_y"])
def test_siggpde_vosf_model_matches_jax(siggpde, data, what):
    X, _ = data
    jm, tm = siggpde["jax"]["model"], siggpde["port"]["model"]
    if what == "elbo":
        for k in ("e0", "e1"):
            close(siggpde["port"][k], siggpde["jax"][k], RTOL)
        assert siggpde["port"]["e1"] > siggpde["port"]["e0"]
    elif what == "parameters":
        close_models(tm, jm)
    else:
        m, v = tm.predict_y(X[:4])
        assert np.all(np.isfinite(m)) and np.all(v >= 0)
        for g, w in zip((m, v), jax_predict(jm, "predict_y", X[:4])):
            close(g, w, RTOL, ATOL)


# ---------------------------------------------------------------------------
# Preprocessing and the Monte-Carlo Softmax.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["add_time_to_list",
                                  "tabulate_list_of_sequences",
                                  "add_time_to_table", "flatten_sequences",
                                  "SequenceScaler"])
def test_preprocessing_reexports_bitwise(name):
    assert getattr(gpsig.preprocessing, name) is getattr(tprep, name)
    rng = np.random.default_rng(4)
    seqs = [rng.standard_normal((n, D)) for n in (5, 8, 6)]
    table = jprep.tabulate_list_of_sequences(seqs)

    def run(mod):
        if name == "add_time_to_list":
            return mod.add_time_to_list(seqs)
        if name == "tabulate_list_of_sequences":
            return [mod.tabulate_list_of_sequences(seqs),
                    mod.tabulate_list_of_sequences(seqs, max_len=6)]
        if name == "add_time_to_table":
            return [mod.add_time_to_table(table)]
        if name == "flatten_sequences":
            return [mod.flatten_sequences(table)]
        sc = mod.SequenceScaler().fit(table)
        return [sc.transform(table)]

    for g, w in zip(run(gpsig.preprocessing), run(jgpsig.preprocessing)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_softmax_draws_100_and_seeded_runs_are_bitwise_equal(data):
    """The facade's SoftMax draws 100 samples (the core's default is 20).
    JAX's draws cannot be reproduced, so two runs of the port from one
    seed are held bitwise equal instead."""
    X, y = data

    def run():
        kern = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                          num_levels=NL, **CPU)
        Z = 0.3 * np.random.default_rng(2).standard_normal((5, F, D))
        feat = gpsig.inducing_variables.InducingTensors(Z, NL, **CPU)
        m = gpsig.models.SVGP(X, y, kern, gpsig.likelihoods.SoftMax(C),
                              feat=feat, num_latent=C, minibatch_size=8,
                              seed=21)
        assert m.likelihood.num_samples == 100
        nat = gpsig.training.NatGradOptimizer(0.1)
        adam = gpsig.training.AdamOptimizer(1e-2)
        elbos = []
        for _ in range(2):
            nat.minimize(m, maxiter=1)
            elbos.append(adam.minimize(m, maxiter=1,
                                       freeze_variational=True))
        return (elbos, m.compute_log_likelihood(), *m.predict_y(X[:4]),
                m.predict_density(X[:4], y[:4]),
                *(p.detach().clone() for p in m.to_functional().parameters()))

    a, b = run(), run()
    assert a[0] == b[0] and a[1] == b[1]
    for x, z in zip(a[2:], b[2:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(z))
    assert np.all(np.isfinite(a[2])) and np.allclose(a[2].sum(1), 1.0)
