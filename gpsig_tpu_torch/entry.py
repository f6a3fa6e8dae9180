"""The flagship forward as one callable, and the multi-process dry run: the
port's counterpart of ``__graft_entry__.py``'s ``_build``, ``entry`` and
``dryrun_multichip``.

:func:`build` makes the same data from ``np.random.default_rng(0)`` and the
same model: an order-1 normalised ``SignatureRBF``, inducing tensors drawn
from the data's increments, and an ``SVGP`` with ``MultiClass(2)`` and two
latent functions. :func:`entry` returns ``(fn, (model, X, Y))`` with
``fn(model, X, Y) = (elbo, fmean, fvar)``, in float32 on the card.

The inducing tensors are drawn with a ``torch.Generator`` seeded 0, whose
draws differ from ``jax.random``'s: to compare with the JAX package, carry
its model's parameters across with :mod:`gpsig_tpu_torch.convert`.

    python -c "from gpsig_tpu_torch import entry; fn, args = entry.entry(); print(fn(*args))"

:func:`dryrun_multichip` spawns ranks that run the parallel layer
(``parallel/``) once on tiny shapes:

    python -c "from gpsig_tpu_torch import entry; entry.dryrun_multichip(2, 'gloo', 'cpu')"
"""

from __future__ import annotations

import copy
import os
import tempfile

import numpy as np
import torch

from gpsig_tpu_torch import config
from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
from gpsig_tpu_torch.kernels.signature import SignatureRBF
from gpsig_tpu_torch.likelihoods import MultiClass
from gpsig_tpu_torch.models.svgp import SVGP


def build(dtype, N=16, L=10, d=2, num_tensors=8, num_levels=3, device=None):
    """(model, X [N, L, d], Y [N]) on ``device`` (default: the card)."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(0)
    X = torch.as_tensor((0.3 * rng.standard_normal((N, L, d))).cumsum(1),
                        dtype=dtype, device=device)
    Y = torch.as_tensor(rng.integers(0, 2, N), device=device)
    kern = SignatureRBF(d, num_levels, lengthscales=1.0, order=1,
                        normalization=True, dtype=dtype, device=device)
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(0), X, num_tensors=num_tensors,
        num_levels=num_levels, num_features=d)
    model = SVGP.create(kern, MultiClass(num_classes=2), feat, num_latent=2,
                        dtype=dtype, device=device)
    return model, X, Y


def forward(model, X, Y):
    """The SVGP ELBO and the posterior predictive of the batch."""
    elbo = model.elbo(X, Y, num_data=X.shape[0])
    fmean, fvar = model.predict_f(X)
    return elbo, fmean, fvar


def entry(device=None):
    """(fn, example_args): the flagship forward, SVGP ELBO + posterior
    predictive on a batch of sequences, in float32."""
    return forward, build(torch.float32, device=device)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(rank, n_ranks, backend, device, init_method):
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    from gpsig_tpu_torch.parallel.chains import run_chains_sharded
    from gpsig_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                               shard_batch)
    from gpsig_tpu_torch.parallel.train import (make_sharded_step_fn,
                                                sharded_gram)

    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    init_distributed(backend, init_method, n_ranks, rank)
    try:
        tile = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
        mesh = make_mesh(data=n_ranks // tile, tile=tile)
        N = max(2 * n_ranks, 8)
        model, X, Y = build(torch.float32, N=N, L=8, d=2, num_tensors=4,
                            num_levels=2, device=dev)
        # the same model at order 2: the general Kuf and Gram kernels
        kern2 = SignatureRBF(2, 2, lengthscales=1.0, order=2,
                             normalization=True, dtype=torch.float32,
                             device=dev)
        kern2.load_state_dict(model.kernel.state_dict())
        model2 = copy.deepcopy(model)
        model2.kernel = kern2
        Xs, Ys = shard_batch(mesh, X, Y)
        for label, m in (("order 1", model), ("order 2", model2)):
            step = make_sharded_step_fn(1e-3, num_data=N, mesh=mesh,
                                        gamma=0.1)
            _, elbo = step(step.init(m), Xs, Ys)
            _check(bool(torch.isfinite(elbo)),
                   f"sharded {label} ELBO not finite")
        # Gram tiles over the whole (data, tile) mesh, orders 1 and 2, of
        # the trained kernels
        for label, kern in (("order 1", model.kernel), ("order 2", kern2)):
            K = sharded_gram(kern, mesh, X)
            with torch.no_grad():
                want = kern.K(X)
            _check(bool(torch.allclose(K, want, rtol=1e-4, atol=1e-6)),
                   f"sharded {label} Gram differs from K")
        # NUTS chains over the data axis: chunks and chain blocks
        theta0 = 0.1 * torch.randn(2 * mesh.data, 3,
                                   generator=torch.Generator().manual_seed(2))
        draws, info = run_chains_sharded(
            3, lambda th: -0.5 * torch.sum(th**2, dim=-1),
            theta0.to(dev), mesh, num_warmup=4, num_samples=3, max_depth=3,
            draws_per_dispatch=2, chain_blocks=2)
        _check(draws.shape == (2 * mesh.data, 3, 3),
               f"chains' draws {draws.shape}")
        _check(np.all(np.isfinite(draws)), "chains' draws not finite")
        _check(np.all(np.isfinite(info["step_size"])),
               "chains' step sizes not finite")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks, backend, device=None):
    """Spawn ``n_ranks`` processes joined under ``backend`` (explicit:
    "gloo" or "nccl") and run the parallel layer once on tiny shapes, in
    float32 on ``device`` (default: the card; "cuda" gives rank r card
    r mod the card count, and two ranks share a card under gloo only): one
    sharded natgrad + Adam step, the Gram tiled over a (data, tile) mesh at
    orders 1 and 2, the sharded step with the order-2 (general) Kuf, and
    NUTS with 2 chains a rank in chunks of 2 and two chain blocks. A rank
    that fails raises here. On a card the kernels are built here first, so
    the ranks load one library."""
    import torch.multiprocessing as mp

    dev = config.resolve_device(device)
    if dev.type == "cuda":
        from gpsig_tpu_torch.ops.cuda import _build

        _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.spawn(_dryrun_rank, args=(n_ranks, backend, str(dev), init),
                 nprocs=n_ranks, join=True)
