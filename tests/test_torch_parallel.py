"""The port's parallel layer (``gpsig_tpu_torch/parallel/``) on gloo ranks,
float64, against the JAX package and the port's one-process paths.

The ranks are spawned once per world size (module-scoped fixtures, gloo,
a ``file://`` store under a temporary directory); they run every
scenario of ``torch_parallel_ranks.py`` and each test reads its
scenario's results. The bounds are the JAX tests' own
(``tests/test_parallel.py``, ``tests/test_data_utils.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from test_torch_nuts import RUN_TOL, close
from gpsig_tpu.parallel import chains as jchains
from gpsig_tpu.parallel import mesh as jmesh
from gpsig_tpu.parallel.goursat_sp import goursat_tile as jax_goursat_tile
from gpsig_tpu.parallel.loader import ShardedLoader as JaxShardedLoader
from gpsig_tpu_torch import config, entry
from gpsig_tpu_torch.ops import goursat
from gpsig_tpu_torch.parallel.chains import make_chunked_sampler
from gpsig_tpu_torch.parallel.goursat_sp import goursat_tile
from gpsig_tpu_torch.parallel.loader import ShardedLoader
from gpsig_tpu_torch.parallel.mesh import Mesh, make_mesh
from gpsig_tpu_torch.parallel.train import make_sharded_step_fn

torch.set_num_threads(1)


def jax_draw_tables(key, C, dim, num_warmup, num_samples, max_depth):
    """Every draw the JAX sampler's C chains can take under ``key``, per
    chain and phase (``ranks.TableStream``'s tables), its keys split as
    ``test_torch_nuts.JaxKeyStream`` splits them: per chain ``samp, warm =
    split(key)``; per transition ``key, sub = split(key)``, ``k_mom,
    k_dir, _ = split(sub, 3)``; per doubling ``loop, k_dir, k_sub, k_merge
    = split(loop, 4)``; per leaf ``k_sub, k_prop = split(k_sub)``. The keys
    of a doubling and of its leaves do not depend on how far the tree
    grew, so the tables answer for any trajectory."""
    split, uniform = jax.random.split, jax.random.uniform

    def leaf(k_leaf, _):
        k_leaf, k_prop = split(k_leaf)
        return k_leaf, uniform(k_prop)

    def doubling(loop, _):
        loop, k_dir, k_leaf, k_merge = split(loop, 4)
        leaves = jax.lax.scan(leaf, k_leaf, None,
                              length=2 ** (max_depth - 1))[1]
        return loop, (jax.random.bernoulli(k_dir), uniform(k_merge), leaves)

    def transition(k, _):
        k, sub = split(k)
        k_mom, loop, _ = split(sub, 3)
        go, merge, leaves = jax.lax.scan(doubling, loop, None,
                                         length=max_depth)[1]
        return k, {"momentum": jax.random.normal(k_mom, (dim,)),
                   "go_right": go, "merge": merge, "leaf": leaves}

    @jax.jit
    def chain(k):
        samp, warm = split(k)
        return {phase: jax.lax.scan(transition, pk, None, length=T)[1]
                for phase, pk, T in (("warmup", warm, num_warmup),
                                     ("sampling", samp, num_samples))}

    return [jax.tree.map(np.asarray, chain(k))
            for k in jax.random.split(key, C)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    torch.save(jax_draw_tables(jax.random.PRNGKey(ranks.JAX_CHAIN_SEED),
                               ranks.JAX_CHAINS, 3, **ranks.JAX_CHAIN_KW),
               tmp / "jax_draws.pt")
    return ranks.spawn(2, tmp, ["gram", "goursat", "step", "joint_psd",
                                "chains", "jax_chains"])


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return ranks.spawn(4, tmp_path_factory.mktemp("four"),
                       ["gram", "goursat"])


# -- in one process ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_loader_stream_equals_jax_bitwise(shape):
    """The global index stream is the JAX loader's, batch 19 rounded down to
    a multiple of the data size; each rank holds its contiguous block
    (ranks sharing a data index the same block), with prefetch or not."""
    data, tile = shape
    N = 64
    X = np.arange(N, dtype=np.float64)[:, None, None] * np.ones((1, 5, 2))
    y = np.arange(N)
    jl = JaxShardedLoader(jmesh.make_mesh(data=data, tile=tile), X, y,
                          batch_size=19, seed=0)
    loaders = [ShardedLoader(Mesh(data, tile, rank=r), X, y, batch_size=19,
                             seed=0, prefetch=r % 2 == 0, device="cpu")
               for r in range(data * tile)]
    for _ in range(3):
        jx, jy = next(jl)
        want = np.asarray(jy)
        b = want.shape[0] // data
        assert want.shape[0] == 16
        for r, loader in enumerate(loaders):
            xb, yb = next(loader)
            block = want[(r // tile) * b:(r // tile + 1) * b]
            np.testing.assert_array_equal(yb.numpy(), block)
            np.testing.assert_array_equal(xb[:, 0, 0].numpy(), block)
            np.testing.assert_array_equal(loader.indices, want)
            assert xb.dtype == torch.float64


def test_loader_defaults_to_the_card_and_the_data_dtype():
    """Like the port's other entry points, the loader puts its batches on
    the card unless the caller names a device; X keeps its own dtype
    unless the caller names one."""
    X = np.zeros((8, 5, 2), np.float32)
    loader = ShardedLoader(Mesh(1, 1), X, np.arange(8), batch_size=4)
    assert loader.device == config.default_device()
    assert loader.dtype is None
    xb, _ = next(ShardedLoader(Mesh(1, 1), X, np.arange(8), batch_size=4,
                               device="cpu"))
    assert xb.dtype == torch.float32


def test_goursat_tile_matches_jax():
    rng = np.random.default_rng(10)
    inc = 0.4 * rng.standard_normal((2, 6, 7))
    full = np.asarray(goursat.goursat_grid(torch.as_tensor(inc)))
    args = (inc[:, 2:6, 1:7], full[:, 2, 2:8], full[:, 3:7, 1],
            full[:, 2, 1])
    want = jax_goursat_tile(*map(jnp.asarray, args))
    got = goursat_tile(*map(torch.as_tensor, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)
    np.testing.assert_allclose(got[0].numpy(), full[:, 3:7, 2:8],
                               rtol=1e-10)


def test_goursat_tile_takes_zero_and_negative_coefficients():
    """c = 1 + a/2 is 0 at a = −2 and negative below: the doubling scan
    divides by nothing, so the column is the sequential recurrence's."""
    inc = torch.tensor([-2.0, -3.0, 0.5, -2.0],
                       dtype=torch.float64)[None, :, None]
    top, left, corner = (torch.full((1, 1), 1.5, dtype=torch.float64),
                         torch.tensor([[1.0, 0.5, -1.0, 2.0]],
                                      dtype=torch.float64),
                         torch.ones(1, dtype=torch.float64))
    tile, _ = goursat_tile(inc, top, left, corner)
    u, t = [], top[0, 0]
    for i in range(4):
        c = 1 + 0.5 * inc[0, i, 0]
        t = c * t + left[0, i] * c - (corner[0] if i == 0 else left[0, i - 1])
        u.append(t)
    np.testing.assert_allclose(tile[0, :, 0].numpy(), torch.stack(u).numpy(),
                               rtol=1e-12)


def test_one_rank_mesh_is_the_one_process_path():
    """With no process group the mesh is one rank and every collective
    returns its input: the sharded step is ``make_step_fn``'s bitwise."""
    mesh = make_mesh()
    assert (mesh.data, mesh.tile, mesh.rank) == (1, 1, 0)
    model, X, Y = ranks.step_problem()
    step = make_sharded_step_fn(ranks.LR, num_data=16, mesh=mesh,
                                gamma=ranks.GAMMA)
    got = ranks.steps(model, X, Y, step, ranks.STEPS)
    want = ranks.one_process(*ranks.step_problem(),
                             dict(learning_rate=ranks.LR, num_data=16,
                                  gamma=ranks.GAMMA))
    for (ge, gp), (we, wp) in zip(got, want):
        assert ge == we
        for k in wp:
            assert torch.equal(gp[k], wp[k]), k


def test_make_mesh_refuses_a_layout_of_other_size():
    with pytest.raises(ValueError, match="data\\*tile"):
        make_mesh(data=2, tile=1)


# -- on gloo ranks -------------------------------------------------------------

@pytest.mark.parametrize("world,shape", [(2, (2, 1)), (2, (1, 2)),
                                         (4, (2, 2))])
def test_sharded_gram_matches_K(two, four, world, shape):
    kern, X, X2 = ranks.gram_inputs()
    with torch.no_grad():
        want = (kern.K(X, X2).numpy(), kern.K(X).numpy())
    for rank in (two if world == 2 else four):
        for g, w in zip(rank["gram"][shape], want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("col_block", ranks.COL_BLOCKS)
def test_goursat_seq_sharded_matches_serial(two, four, world, col_block):
    want = goursat.goursat_corner(ranks.goursat_inputs()).numpy()
    for rank in (two if world == 2 else four):
        np.testing.assert_allclose(rank["goursat"][col_block].numpy(), want,
                                   rtol=1e-9)


@pytest.mark.parametrize("use_natgrad", [False, True])
def test_sharded_step_matches_one_process(two, use_natgrad):
    """Two ranks' steps against ``make_step_fn`` on the whole batch (ELBO
    rtol 1e-8, parameters atol 1e-10), and the ranks' parameters bitwise
    equal after every step."""
    want = ranks.one_process(*ranks.step_problem(),
                             dict(learning_rate=ranks.LR, num_data=16,
                                  gamma=ranks.GAMMA,
                                  use_natgrad=use_natgrad))
    r0, r1 = (rank["step"][use_natgrad] for rank in two)
    for (e0, p0), (e1, p1), (we, wp) in zip(r0, r1, want):
        assert e0 == e1
        np.testing.assert_allclose(e0, we, rtol=1e-8)
        for k in wp:
            assert torch.equal(p0[k], p1[k]), k
            np.testing.assert_allclose(p0[k].numpy(), wp[k].numpy(),
                                       atol=1e-10, err_msg=k)


def test_joint_psd_under_sharding(two):
    """``covariances_full`` projects [Z; X_local] on each rank. At one rank
    the sharded step's ELBO (Adam only: the ELBO at the starting point) is
    ``model.elbo``; at two it is finite but not the one-process ELBO, and
    Kuu differs between the ranks. The replicas stay bitwise equal, with
    natgrad too: the updates read only summed statistics."""
    model, X, Y = ranks.joint_psd_problem()
    with torch.no_grad():
        want = float(model.elbo(X, Y, num_data=8))
    step = make_sharded_step_fn(ranks.LR, num_data=8, mesh=make_mesh(),
                                gamma=ranks.GAMMA, use_natgrad=False)
    assert ranks.steps(model, X, Y, step, 1)[0][0] == want
    (e0, _), (e1, _) = (rank["joint_psd"][False][0] for rank in two)
    assert e0 == e1 and np.isfinite(e0)
    # each rank projected its own half of the batch: the two-rank ELBO is
    # not the one-process one
    assert abs(e0 - want) > 1e-6 * abs(want), (e0, want)
    Kuu0, Kuu1 = (rank["joint_psd"]["Kuu"] for rank in two)
    assert not torch.equal(Kuu0, Kuu1)
    for natgrad in (False, True):
        (_, p0), (_, p1) = (rank["joint_psd"][natgrad][0] for rank in two)
        for k in p0:
            assert torch.equal(p0[k], p1[k]), (natgrad, k)


def test_two_ranks_of_one_chain_equal_one_process_of_two(two):
    """2 ranks × 1 chain with a shared step size against one process × 2
    chains (the pooled mean of two values is exact in any order): draws,
    step sizes and accept statistics at 1e-12, leaves equal at every
    sampling transition, every rank holding every chain."""
    want_theta, want = make_chunked_sampler(ranks.gaussian_logp,
                                            **ranks.CHAIN_KW)(
        3, ranks.chain_theta0(2))
    for rank in two:
        theta, info = rank["chains"]["whole"]
        assert theta.shape == want_theta.shape
        np.testing.assert_allclose(theta, want_theta, rtol=1e-12, atol=0)
        for k in ("step_size", "inv_mass", "warmup_accept", "accept_prob",
                  "logp"):
            np.testing.assert_allclose(info[k], want[k], rtol=1e-12,
                                       atol=0, err_msg=k)
        np.testing.assert_array_equal(info["num_leaves"], want["num_leaves"])
        np.testing.assert_array_equal(info["diverging"], want["diverging"])
    assert np.array_equal(two[0]["chains"]["whole"][1]["step_size"],
                          two[1]["chains"]["whole"][1]["step_size"])


def jax_gaussian_logp(x):
    return -0.5 * jnp.sum((x / jnp.asarray([0.5, 1.0, 2.0])) ** 2)


def test_sharded_chains_match_jax_run_chains_sharded(two):
    """2 ranks × 2 chains of ``run_chains_sharded`` with a shared step size
    against the JAX package's on a 2-device mesh, on the JAX run's own
    draws: the accept statistic pooled over a rank's chains then averaged
    over the ranks is JAX's ``pmean`` over "chain" then over ``data``.
    Draws, step sizes and accept statistics within ``RUN_TOL`` scaled
    (``test_torch_nuts``'s bound for whole runs against JAX: XLA's and
    torch's last bits differ, and 60 transitions compound them; 1.9e-12
    here), leaves and divergences exactly; one step size on every chain,
    and every rank holding every chain."""
    C = ranks.JAX_CHAINS
    mesh = jmesh.make_mesh(data=2, tile=1, devices=jax.devices()[:2])
    jtheta, jinfo = jchains.run_chains_sharded(
        jax.random.PRNGKey(ranks.JAX_CHAIN_SEED), jax_gaussian_logp,
        jnp.asarray(ranks.chain_theta0(C).numpy()), mesh,
        shared_step_size=True, draws_per_dispatch=None,
        **ranks.JAX_CHAIN_KW)
    for rank in two:
        theta, info = rank["jax_chains"]
        close(theta, jtheta, RUN_TOL, "theta")
        for k in ("step_size", "inv_mass", "warmup_accept", "accept_prob",
                  "logp"):
            close(info[k], jinfo[k], RUN_TOL, k)
        for k in ("num_leaves", "diverging"):
            np.testing.assert_array_equal(info[k], np.asarray(jinfo[k]),
                                          err_msg=k)
        assert len(np.unique(info["step_size"])) == 1
    # the pooling is not vacuous: the chains' own statistics differ
    assert len(np.unique(np.asarray(jinfo["warmup_accept"])[:, -1])) > 1
    assert np.unique(np.asarray(jinfo["step_size"])).tolist() != [1.0]


def test_sharded_checkpoint_resume_is_bitwise(two):
    """Stopped after 2 chunks and resumed, on two ranks: bitwise the
    uninterrupted run; each rank saved under rank<r>/."""
    for rank in two:
        got = rank["chains"]
        assert got["stopped"] is None
        assert got["saved"] == ["rank0", "rank1"]
        np.testing.assert_array_equal(got["resumed"][0], got["whole"][0])
        for k, v in got["whole"][1].items():
            np.testing.assert_array_equal(got["resumed"][1][k], v,
                                          err_msg=k)


def test_sharded_checkpoint_refuses_another_world_size(tmp_path):
    """A one-process checkpoint does not resume under a mesh: the saved
    settings carry the world size."""
    kw = ranks.CHAIN_KW
    theta0 = ranks.chain_theta0(2)
    cdir = str(tmp_path / "c")
    make_chunked_sampler(ranks.gaussian_logp, **kw)(
        3, theta0, checkpoint_dir=cdir + "/rank0", max_chunks=1)
    with pytest.raises(ValueError, match="world_size"):
        make_chunked_sampler(ranks.gaussian_logp, mesh=Mesh(2, 1),
                             **kw)(3, theta0, checkpoint_dir=cdir)


def test_dryrun_multichip_on_two_cpu_ranks():
    entry.dryrun_multichip(2, "gloo", "cpu")
