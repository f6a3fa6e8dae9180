"""The ranks of the port's multi-process CPU tests (no JAX in here: the
spawned processes import only this module, torch and the port).

:func:`spawn` starts ``world`` processes under gloo with a ``file://`` store,
each runs every scenario of :data:`SCENARIOS` that it is asked for, and
each rank's results come back as a dict (saved with ``torch.save``). The
scenarios' inputs come from fixed seeds through the functions below, so a
test can rebuild them in its own process for the one-process reference.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from gpsig_tpu_torch.inducing import (InducingSequences,
                                      make_inducing_tensors_from_data)
from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel
from gpsig_tpu_torch.kernels.signature import SignatureRBF
from gpsig_tpu_torch.likelihoods import MultiClass
from gpsig_tpu_torch.mcmc.draws import DrawSource
from gpsig_tpu_torch.models.svgp import SVGP
from gpsig_tpu_torch.parallel.chains import (make_chunked_sampler,
                                             run_chains_sharded)
from gpsig_tpu_torch.parallel.goursat_sp import goursat_corner_seq_sharded
from gpsig_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                           shard_batch)
from gpsig_tpu_torch.parallel.train import (make_sharded_step_fn,
                                            sharded_gram)

COL_BLOCKS = (3, 5, 16)
STEPS, LR, GAMMA = 2, 1e-2, 0.1
CHAIN_KW = dict(num_warmup=10, num_samples=8, max_depth=4,
                draws_per_dispatch=4)
#: the sharded sampler against the JAX package's: 2 chains a rank, and 50
#: warmup draws, so that the step size is adapted (at 10 the single
#: window's restart leaves every chain at exactly 1, and at 20 it leaves a
#: step size at which every sampling transition diverges on its first leaf)
JAX_CHAINS, JAX_CHAIN_SEED = 4, 23
JAX_CHAIN_KW = dict(num_warmup=50, num_samples=10, max_depth=4)


def walks(rng, n, L, d=2, scale=0.5):
    return (scale * rng.standard_normal((n, L, d))).cumsum(axis=1)


def gram_inputs():
    """(kernel, X [8, 6, 2], X2 [8, 5, 2]): an order-2 RBF signature kernel
    (two lengths: the increment-matrix route)."""
    rng = np.random.default_rng(0)
    X, X2 = walks(rng, 8, 6), walks(rng, 8, 5)
    kern = SignatureRBF(2, 3, lengthscales=1.0, order=2, device="cpu")
    return kern, torch.as_tensor(X), torch.as_tensor(X2)


def goursat_inputs():
    rng = np.random.default_rng(11)
    return torch.as_tensor(0.3 * rng.standard_normal((3, 16, 13)))


def step_problem():
    """(model, X [16, 6, 2], Y [16]): order-1 RBF, 4 inducing tensors,
    MultiClass(2), q off its starting point."""
    rng = np.random.default_rng(1)
    X = torch.as_tensor(walks(rng, 16, 6))
    Y = torch.as_tensor(rng.integers(0, 2, 16))
    kern = SignatureRBF(2, 2, lengthscales=1.0, order=1, device="cpu")
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(1), X, num_tensors=4, num_levels=2,
        num_features=2)
    model = SVGP.create(kern, MultiClass(num_classes=2), feat, num_latent=2,
                        device="cpu")
    return with_q(model, rng), X, Y


def with_q(model, rng):
    """``model`` with q_mu and q_sqrt off their starting point (where a
    whitened ELBO does not read Kuu)."""
    M, C = model.q_mu.shape
    with torch.no_grad():
        model.q_mu.copy_(torch.as_tensor(rng.standard_normal((M, C))))
        model.q_sqrt.copy_(torch.as_tensor(
            np.tril(0.2 * rng.standard_normal((C, M, M))) + 0.8 * np.eye(M)))
    return model


def joint_psd_problem():
    """(model, X [8, 4, 2], Y [8]): the untruncated (PDE) kernel at dyadic
    order 0 on rough paths, where the finite-difference Gram is
    indefinite, and inducing sequences with ``joint_psd``."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(1.5 * walks(rng, 8, 4))
    Y = torch.as_tensor(rng.integers(0, 2, 8))
    Z = torch.as_tensor(1.5 * walks(rng, 3, 4))
    kern = UntruncatedSignatureKernel.create(2, lengthscales=[0.8, 1.3],
                                             sigma=1.3, dyadic_order=0,
                                             device="cpu")
    feat = InducingSequences.create(Z, joint_psd=True)
    model = SVGP.create(kern, MultiClass(num_classes=2), feat, num_latent=2,
                        device="cpu")
    return with_q(model, rng), X, Y


def gaussian_logp(x):
    """A diagonal Gaussian in elementwise ops (no matrix product of θ,
    whose last bits would depend on the batch's row count)."""
    scales = torch.tensor([0.5, 1.0, 2.0], dtype=x.dtype)
    return -0.5 * torch.sum((x / scales) ** 2, dim=-1)


class TableStream:
    """One chain's draws read from tables of the JAX sampler's draws (the
    test makes them from ``jax.random`` keys, split in its order, so the
    ranks import no JAX): ``table[phase]`` holds, a transition, the
    momentum [dim], a direction and a merge uniform a doubling
    [max_depth], and the proposal uniforms of that doubling's leaves
    [max_depth, 2^(max_depth−1)]."""

    def __init__(self, table):
        self.table = table
        self.next = {"warmup": 0, "sampling": 0}
        self.row, self.depth, self.at = None, -1, 0

    def momentum(self, phase, dim):
        t = self.next[phase]
        self.next[phase] += 1
        self.row = {k: v[t] for k, v in self.table[phase].items()}
        self.depth = -1
        return self.row["momentum"]

    def doubling(self):
        self.depth += 1
        self.at = 0
        return (bool(self.row["go_right"][self.depth]),
                float(self.row["merge"][self.depth]))

    def leaf(self):
        self.at += 1
        return float(self.row["leaf"][self.depth, self.at - 1])

    def state(self):
        return {"next": dict(self.next)}

    def load_state(self, state):
        self.next = dict(state["next"])


def chain_theta0(C):
    return 0.3 * torch.randn(C, 3, dtype=torch.float64,
                             generator=torch.Generator().manual_seed(4))


def steps(model, X, Y, step, n):
    """``n`` steps from ``step.init(model)``: each step's ELBO and the
    parameters after it."""
    state = step.init(model)
    out = []
    for _ in range(n):
        state, elbo = step(state, X, Y)
        out.append((float(elbo), {k: v.detach().clone()
                                  for k, v in model.state_dict().items()}))
    return out


# -- scenarios, run on every rank ------------------------------------------

def scenario_gram(world):
    kern, X, X2 = gram_inputs()
    out = {}
    shapes = [(2, 1), (1, 2)] if world == 2 else [(2, 2)]
    for shape in shapes:
        mesh = make_mesh(*shape)
        out[shape] = (sharded_gram(kern, mesh, X, X2),
                      sharded_gram(kern, mesh, X))
    return out


def scenario_goursat(world):
    inc = goursat_inputs()
    mesh = make_mesh(world, 1)
    return {cb: goursat_corner_seq_sharded(inc, mesh, col_block=cb)
            for cb in COL_BLOCKS}


def scenario_step(world):
    mesh = make_mesh(world, 1)
    out = {}
    for natgrad in (False, True):
        model, X, Y = step_problem()
        step = make_sharded_step_fn(LR, num_data=X.shape[0], mesh=mesh,
                                    gamma=GAMMA, use_natgrad=natgrad)
        Xl, Yl = shard_batch(mesh, X, Y)
        out[natgrad] = steps(model, Xl, Yl, step, STEPS)
    return out


def scenario_joint_psd(world):
    mesh = make_mesh(world, 1)
    out = {}
    for natgrad in (False, True):
        model, X, Y = joint_psd_problem()
        Xl, Yl = shard_batch(mesh, X, Y)
        step = make_sharded_step_fn(LR, num_data=X.shape[0], mesh=mesh,
                                    gamma=GAMMA, use_natgrad=natgrad)
        out["Kuu"] = model.inducing.covariances_full(model.kernel,
                                                     Xl)[0].detach()
        out[natgrad] = steps(model, Xl, Yl, step, 1)
    return out


def scenario_chains(world, tmp):
    mesh = make_mesh(world, 1)
    theta0 = chain_theta0(world)
    sampler = make_chunked_sampler(gaussian_logp, mesh=mesh, **CHAIN_KW)
    whole = sampler(3, theta0)
    cdir = os.path.join(tmp, "chains")
    stopped = make_chunked_sampler(gaussian_logp, mesh=mesh, **CHAIN_KW)(
        3, theta0, checkpoint_dir=cdir, max_chunks=2)
    resumed = make_chunked_sampler(gaussian_logp, mesh=mesh, **CHAIN_KW)(
        3, theta0, checkpoint_dir=cdir)
    return {"whole": whole, "stopped": stopped, "resumed": resumed,
            "saved": sorted(os.listdir(cdir))}


def scenario_jax_chains(world, tmp):
    """``run_chains_sharded`` with a shared step size on the JAX sampler's
    draws (``jax_draws.pt``, written by the test before the spawn)."""
    tables = torch.load(os.path.join(tmp, "jax_draws.pt"),
                        weights_only=False)
    draws = DrawSource(TableStream(t) for t in tables)
    return run_chains_sharded(draws, gaussian_logp, chain_theta0(JAX_CHAINS),
                              make_mesh(world, 1), draws_per_dispatch=4,
                              **JAX_CHAIN_KW)


SCENARIOS = {
    "gram": scenario_gram,
    "goursat": scenario_goursat,
    "step": scenario_step,
    "joint_psd": scenario_joint_psd,
    "chains": scenario_chains,
    "jax_chains": scenario_jax_chains,
}


def run_rank(rank, world, init_method, out_dir, names):
    torch.set_num_threads(1)
    init_distributed("gloo", init_method, world, rank)
    try:
        results = {}
        for name in names:
            fn = SCENARIOS[name]
            args = ((world, out_dir) if name in ("chains", "jax_chains")
                    else (world,))
            results[name] = fn(*args)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world, out_dir, names):
    """Run scenarios ``names`` on ``world`` gloo ranks; each rank's
    results, in rank order."""
    import torch.multiprocessing as mp

    init = "file://" + os.path.join(out_dir, "store")
    mp.spawn(run_rank, args=(world, init, str(out_dir), list(names)),
             nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def one_process(model, X, Y, step_fn_kw, n=STEPS):
    """The one-process reference: ``training.loop.make_step_fn``'s steps
    on the whole batch, from a copy of ``model``."""
    from gpsig_tpu_torch.training.loop import make_step_fn

    step = make_step_fn(**step_fn_kw)
    return steps(copy.deepcopy(model), X, Y, step, n)
