"""Parity of the port's low-rank signature kernel with ``gpsig_tpu``,
float64 on the CPU: the Nyström and sketch operations (``ops/low_rank.py``),
``LowRankSignatureKernel``'s K and Kdiag (``kernels/low_rank.py``) and the
``@lowrank`` accuracy window's SVGP (inducing sequences, MultiClass): its
ELBO, its gradient against ``jax.grad`` with the landmarks among the
parameters, and one natgrad + Adam step against JAX's ``make_step_fn``.

JAX's draws cannot be reproduced by a ``torch.Generator``: the landmarks
and the sketch's pair indices are carried across by
``convert.load_jax_arrays``, a level without a sketch included. The port's
own draws are held to their shapes, distinctness and determinism.
Eigenvectors are fixed only up to sign, so the Nyström factors are
compared through their products, which are invariant.

Tolerances (scaled, as ``test_torch_vosf.py``): values 1e-10, gradients
and one step's parameters 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_vosf import GRAD_TOL, close, close_grads

from gpsig_tpu import inducing as jind
from gpsig_tpu import likelihoods as jlik
from gpsig_tpu.kernels import low_rank as jlrk
from gpsig_tpu.kernels import static_kernels as jst
from gpsig_tpu.models import svgp as jsvgp
from gpsig_tpu.ops import low_rank as jlr
from gpsig_tpu.training import loop as jloop
from gpsig_tpu_torch import convert
from gpsig_tpu_torch import inducing as tind
from gpsig_tpu_torch import likelihoods as tlik
from gpsig_tpu_torch.kernels import low_rank as tlrk
from gpsig_tpu_torch.kernels import static_kernels as tst
from gpsig_tpu_torch.models import svgp as tsvgp
from gpsig_tpu_torch.ops import low_rank as tlr
from gpsig_tpu_torch.training import loop as tloop

torch.set_num_threads(1)
D, C = 3, 3
KEY = jax.random.PRNGKey(4)


def leaves(tree):
    """{dotted path: array} of a JAX pytree; a tuple element's segment is
    its index (``kernel.pair_indices.0``)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)

    def seg(k):
        return str(k.idx) if hasattr(k, "idx") else k.name

    return {".".join(seg(k) for k in path): np.asarray(v)
            for path, v in flat}


def walks(rng, n, L=8, d=D):
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


def test_nystrom_ops_match_jax():
    """W^{-1/2} (through P Pᵀ, sign-free) and φ (through φ φᵀ) at a rank
    below the landmarks', both bases, and the 10·jitter cutoff: a
    rank-deficient W (repeated landmarks) gets zeros past its rank."""
    rng = np.random.default_rng(0)
    Z = rng.standard_normal((10, D))
    pts = rng.standard_normal((4, 5, D))
    for jbase, tbase in ((jst.RBFBase(), tst.RBFBase()),
                         (jst.LinearBase(), tst.LinearBase())):
        W = np.array(jbase.gram(Z, Z))
        jP = np.asarray(jlr.nystrom_sqrt_inv(jnp.asarray(W), 6))
        tP = tlr.nystrom_sqrt_inv(torch.as_tensor(W), 6)
        close(tP @ tP.T, jP @ jP.T)
        jphi = np.asarray(jlr.nystrom_map(pts, Z, jbase, 6)).reshape(-1, 6)
        tphi = tlr.nystrom_map(torch.as_tensor(pts), torch.as_tensor(Z),
                               tbase, 6)
        assert tphi.shape == (4, 5, 6)
        tphi = tphi.reshape(-1, 6)
        close(tphi @ tphi.T, jphi @ jphi.T)
    # Linear base on d = 3: W has rank 3, so 3 of 6 components are cut
    W = Z @ Z.T
    tP = tlr.nystrom_sqrt_inv(torch.as_tensor(W), 6)
    assert int((tP.abs().sum(0) > 0).sum()) == 3
    jP = np.asarray(jlr.nystrom_sqrt_inv(jnp.asarray(W), 6))
    close(tP @ tP.T, jP @ jP.T)


def test_sketch_ops_match_jax():
    """lr_hadamard_prod full and sketched, and signature_features exact,
    fully sketched and with a level left exact, on the same indices."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 5, 4))
    B = rng.standard_normal((3, 5, 6))
    idx = np.stack([rng.integers(0, 4, 7), rng.integers(0, 6, 7)])
    close(tlr.lr_hadamard_prod(torch.as_tensor(A), torch.as_tensor(B)),
          jlr.lr_hadamard_prod(A, B))
    close(tlr.lr_hadamard_prod(torch.as_tensor(A), torch.as_tensor(B),
                               torch.as_tensor(idx)),
          jlr.lr_hadamard_prod(A, B, jnp.asarray(idx)))
    dphi = rng.standard_normal((3, 6, 4))
    i2 = np.stack([rng.integers(0, 4, 5), rng.integers(0, 4, 5)])
    i3 = np.stack([rng.integers(0, 4, 5), rng.integers(0, 16, 5)])
    for pairs in (None, (i2, i2[:, ::-1].copy()), (None, i3)):
        want = jlr.signature_features(
            dphi, 3, None if pairs is None else tuple(
                None if p is None else jnp.asarray(p) for p in pairs))
        got = tlr.signature_features(
            torch.as_tensor(dphi), 3, None if pairs is None else tuple(
                None if p is None else torch.as_tensor(p) for p in pairs))
        assert len(got) == 3
        for g, w in zip(got, want):
            close(g, w)


def test_draw_pair_indices():
    g = torch.Generator().manual_seed(2)
    idx = tlr.draw_pair_indices(g, 5, 9, 40)
    assert idx.shape == (2, 40) and idx.dtype == torch.int64
    assert int(idx[0].min()) >= 0 and int(idx[0].max()) < 5
    assert int(idx[1].min()) >= 0 and int(idx[1].max()) < 9
    again = tlr.draw_pair_indices(torch.Generator().manual_seed(2), 5, 9, 40)
    assert torch.equal(idx, again)


def kern_pair(X, num_components=4, rank_bound=None, num_levels=3, **kw):
    """The same low-rank RBF kernel in both packages, JAX's landmarks and
    pair indices carried across."""
    kw = dict(dict(lengthscales=[0.8, 1.2, 1.0], sigma=1.3,
                   variances=[0.5, 1.2, 0.9, 0.7][:num_levels + 1]), **kw)
    jk = jlrk.LowRankSignatureRBF(KEY, X, D, num_levels, num_components,
                                  rank_bound=rank_bound, **kw)
    tk = tlrk.LowRankSignatureRBF(torch.Generator().manual_seed(0),
                                  torch.as_tensor(X), D, num_levels,
                                  num_components, rank_bound=rank_bound,
                                  device="cpu", **kw)
    convert.load_jax_arrays(tk, leaves(jk))
    return jk, tk


# rank_bound None: every level sketched (c = 4 of 16 pairs); 16: level 2
# exact (its 16 columns fit), level 3 sketched; 1000: every level exact
@pytest.mark.parametrize("rank_bound,normalization,difference", [
    (None, True, True), (16, True, True), (1000, False, False)])
def test_low_rank_kernel_matches_jax(rank_bound, normalization, difference):
    rng = np.random.default_rng(3)
    X, X2 = walks(rng, 6), walks(rng, 3, L=5)
    jk, tk = kern_pair(X, rank_bound=rank_bound, normalization=normalization,
                       difference=difference)
    sketched = [p is not None for p in tk.pair_indices.as_tuple()]
    assert sketched == {None: [True, True], 16: [False, True],
                        1000: [False, False]}[rank_bound]
    assert len(jk.pair_indices) == len(sketched)
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    want = jax.jit(lambda k: (k.K(X), k.K(X, X2), k.Kdiag(X2),
                              k.K(X.reshape(6, -1))))(jk)
    got = (tk.K(tX), tk.K(tX, tX2), tk.Kdiag(tX2), tk.K(tX.reshape(6, -1)))
    for g, w in zip(got, want):
        close(g, w)


def test_load_is_strict_and_keeps_integer_indices():
    X = walks(np.random.default_rng(4), 6)
    jk, tk = kern_pair(X, rank_bound=16)
    tree = leaves(jk)
    assert set(tree) == set(tk.state_dict())
    assert "kernel.pair_indices.0" not in tree and "pair_indices.0" not in tree
    sd = convert.from_jax_arrays(tree, dtype=torch.float32, device="cpu")
    assert sd["pair_indices.1"].dtype in (torch.int32, torch.int64)
    assert sd["landmarks"].dtype == torch.float32
    assert torch.equal(tk.pair_indices[1],
                       torch.as_tensor(np.array(tree["pair_indices.1"])).long())
    del tree["pair_indices.1"]
    with pytest.raises(RuntimeError, match="pair_indices.1"):
        convert.load_jax_arrays(tk, tree)


def test_low_rank_rbf_own_draws():
    """Landmarks: n_landmarks distinct steps of the data (drawn without
    replacement), the same under the same seed; pair indices in range."""
    X = walks(np.random.default_rng(5), 6)
    steps = torch.as_tensor(X).reshape(-1, D)
    kw = dict(num_components=4, device="cpu")
    k1 = tlrk.LowRankSignatureRBF(torch.Generator().manual_seed(1),
                                  torch.as_tensor(X), D, 3, **kw)
    k2 = tlrk.LowRankSignatureRBF(torch.Generator().manual_seed(1),
                                  torch.as_tensor(X), D, 3, **kw)
    k3 = tlrk.LowRankSignatureRBF(torch.Generator().manual_seed(2),
                                  torch.as_tensor(X), D, 3, **kw)
    assert k1.landmarks.shape == (8, D) and k1.landmarks.requires_grad
    rows = [int(torch.where((steps == z).all(1))[0][0]) for z in k1.landmarks]
    assert len(set(rows)) == 8
    assert torch.equal(k1.landmarks, k2.landmarks)
    assert not torch.equal(k1.landmarks, k3.landmarks)
    for a, b in zip(k1.pair_indices.as_tuple(), k2.pair_indices.as_tuple()):
        assert torch.equal(a, b) and a.shape == (2, 4)
        assert int(a.max()) < 4
    # every step drawn when n_landmarks exceeds them: a permutation
    few = torch.as_tensor(X[:1, :5])
    k4 = tlrk.LowRankSignatureRBF(None, few, D, 2, num_components=4,
                                  device="cpu")
    assert sorted(map(tuple, k4.landmarks.tolist())) == sorted(
        map(tuple, few.reshape(-1, D).tolist()))


def lowrank_svgp_pair(seed=0):
    """The ``@lowrank`` window's SVGP at a small size in both packages:
    the low-rank RBF kernel (c = 4, every level sketched), 5 inducing
    sequences of length 4, MultiClass(3), q_mu and q_sqrt drawn."""
    rng = np.random.default_rng(seed)
    X = walks(rng, 9)
    Y = rng.integers(0, C, 9)
    jk, tk = kern_pair(X, normalization=True)
    Z = walks(rng, 5, L=4)
    jf = jind.InducingSequences.create(jnp.asarray(Z))
    tf = tind.InducingSequences.create(torch.as_tensor(Z))
    jm = jsvgp.SVGP.create(jk, jlik.MultiClass(C), jf, C)
    jm = jm.replace(q_mu=jnp.asarray(0.5 * rng.standard_normal((5, C))),
                    q_sqrt=jnp.asarray(np.tril(0.1 * rng.standard_normal(
                        (C, 5, 5))) + 0.8 * np.eye(5)))
    tm = tsvgp.SVGP.create(tk, tlik.MultiClass(C), tf, C, device="cpu")
    convert.load_jax_arrays(tm, leaves(jm))
    return jm, tm, X, Y


def test_lowrank_svgp_elbo_and_gradients_match_jax():
    jm, tm, X, Y = lowrank_svgp_pair()
    # JAX's own gradient over the float leaves (the pair indices get zeros)
    jelbo, jgrad = jax.jit(lambda m: jloop._value_and_grad_floats(
        lambda m_: m_.elbo(X, Y, num_data=40), m))(jm)
    want = {k: v for k, v in leaves(jgrad).items() if "pair_indices" not in k}
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    telbo = tm.elbo(tX, tY, num_data=40)
    close(telbo, jelbo)
    telbo.backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert "kernel.landmarks" in got
    close_grads(got, want)
    with torch.no_grad():
        for g, w in zip(tm.posterior().predict_y(tX),
                        jax.jit(lambda m: m.posterior().predict_y(X))(jm)):
            close(g, w)


def test_lowrank_step_matches_jax_landmarks_included():
    """One natgrad + Adam step: JAX's optimizer trains every float leaf
    (``float_only_optimizer``), the landmarks among them; the port's Adam
    reaches them as parameters, and the pair indices, buffers, stay."""
    jm, tm, X, Y = lowrank_svgp_pair(seed=1)
    before = tm.kernel.landmarks.detach().clone()
    pairs = [p.clone() for p in tm.kernel.pair_indices.as_tuple()]
    opt = jloop.float_only_optimizer(optax.adam(1e-2), jm)
    jstate, jelbo = jloop.make_step_fn(opt, num_data=40, gamma=0.1)(
        jloop.init_state(jm, opt), X, Y, KEY)
    step = tloop.make_step_fn(1e-2, num_data=40, gamma=0.1)
    tstate, telbo = step(step.init(tm), torch.as_tensor(X),
                         torch.as_tensor(Y))
    close(telbo, jelbo, GRAD_TOL)
    want = leaves(jstate.model)
    for n, p in tstate.model.named_parameters():
        close(p, want[n], GRAD_TOL)
    assert not torch.equal(tm.kernel.landmarks, before)
    for a, b in zip(tm.kernel.pair_indices.as_tuple(), pairs):
        assert torch.equal(a, b)
