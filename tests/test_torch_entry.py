"""The port's entry twin (``gpsig_tpu_torch/entry.py``) against
``__graft_entry__.py``: the same data recipe bitwise, and in float64 on the
CPU, with the JAX model's parameters carried across by ``convert``, the
same ELBO, ``fmean`` and ``fvar`` within 1e-10 (rtol; the JAX XLA engine
and the port's plain path differ only in summation order).

Both entries start at q_mu = 0 and q_sqrt = I, where the whitened
conditional gives fmean = 0 and fvar = Knn and the KL is 0: none of the
three outputs depends on Kuf there. So the comparison sets q_mu and q_sqrt
to the same seeded values on both sides first, and holds the outputs
against JAX at the inducing tensors the entry draws and at the same
tensors shifted, which must move every output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as graft
from gpsig_tpu_torch import config, convert, entry

torch.set_num_threads(1)


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def with_seeded_q(jm, rng):
    """The JAX model with q_mu and q_sqrt off their starting point."""
    M, C = jm.q_mu.shape
    return jm.replace(
        q_mu=jnp.asarray(rng.standard_normal((M, C))),
        q_sqrt=jnp.asarray(np.tril(0.2 * rng.standard_normal((C, M, M)))
                           + 0.8 * np.eye(M)))


def test_entry_matches_the_jax_entry_in_float64():
    jm, jX, jY = graft._build(jnp.float64)
    tm, tX, tY = entry.build(torch.float64, device="cpu")
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))
    rng = np.random.default_rng(1)
    jm = with_seeded_q(jm, rng)
    shift = 0.1 * rng.standard_normal(jm.inducing.raw_Z.shape)
    jfn, _ = graft.entry()
    jfn = jax.jit(jfn)
    outs = []
    for dz in (0.0, shift):
        jz = jm.replace(inducing=jm.inducing.replace(
            raw_Z=jm.inducing.raw_Z + dz))
        convert.load_jax_arrays(tm, leaves(jz))
        want = jfn(jz, jX, jY)
        got = entry.forward(tm, tX, tY)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-10, atol=1e-12)
        outs.append([g.detach().numpy() for g in got])
    # the outputs depend on Kuf: shifting the inducing tensors moves each
    # of them by far more than the tolerance
    for a, b in zip(*outs):
        assert np.abs(a - b).max() > 1e-3 * np.abs(a).max()


def test_entry_is_float32_on_the_card_by_default():
    """entry() builds on config.default_device() (the card) unless told
    otherwise; on the CPU it gives finite float32 outputs of the JAX
    entry's shapes."""
    assert config.default_device() == torch.device("cuda")
    fn, (model, X, Y) = entry.entry(device="cpu")
    assert X.dtype == torch.float32 and X.shape == (16, 10, 2)
    assert Y.shape == (16,)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    elbo, fmean, fvar = fn(model, X, Y)
    assert elbo.shape == () and fmean.shape == fvar.shape == (16, 2)
    for t in (elbo, fmean, fvar):
        assert bool(torch.isfinite(t).all())
    assert bool((fvar >= 0).all())
