"""A deterministic problem and step runner for multi-process checks.

Counterpart of ``gpsig_tpu/parallel/distributed_check.py``: one small SVGP
training problem (the same constants, X and Y from the same numpy draws)
that the multi-process worker (``parallel/worker.py``) and a one-process
run both execute, so the cross-rank path is checked for numerical equality
with one process, not only for finishing.

The JAX package draws the inducing tensors from ``jax.random.PRNGKey(1)``,
which the port cannot replay: :func:`build_problem` takes the JAX model's
leaves as numpy arrays (``convert.load_jax_arrays``) when given them, and
draws from a ``torch.Generator`` seeded 1 otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from gpsig_tpu_torch import config, convert
from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
from gpsig_tpu_torch.kernels.signature import SignatureRBF
from gpsig_tpu_torch.likelihoods import MultiClass
from gpsig_tpu_torch.models.svgp import SVGP
from gpsig_tpu_torch.parallel.mesh import shard_batch
from gpsig_tpu_torch.parallel.train import make_sharded_step_fn

N, L, D, C, M, NL = 64, 12, 2, 2, 6, 2
SEED = 7


def build_problem(arrays=None, dtype=torch.float64, device=None):
    """(model, X [N, L, D], Y [N]) on ``device`` (default: the card);
    ``arrays``: {dotted path: numpy array}, the JAX model's leaves."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(SEED)
    X = torch.as_tensor((0.4 * rng.standard_normal((N, L, D))).cumsum(1),
                        dtype=dtype, device=device)
    Y = torch.as_tensor(rng.integers(0, C, N), device=X.device)
    kern = SignatureRBF(D, NL, lengthscales=1.0, order=1, dtype=dtype,
                        device=X.device)
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(1), X, num_tensors=M, num_levels=NL,
        num_features=D)
    model = SVGP.create(kern, MultiClass(num_classes=C), feat, num_latent=C,
                        dtype=dtype, device=X.device)
    if arrays is not None:
        convert.load_jax_arrays(model, arrays)
    return model, X, Y


def checksum(model):
    """Σ |leaf| over the model's floating-point parameters and buffers, in
    float64 (the JAX package's sum over its float leaves)."""
    return sum(float(t.detach().double().abs().sum())
               for t in model.state_dict().values()
               if t.is_floating_point())


def run_steps(mesh, num_iters=5, dtype=torch.float64, device=None,
              arrays=None):
    """``num_iters`` sharded natgrad + Adam steps (Adam 1e-2, γ = 0.1) on
    the whole data set; returns (final ELBO, checksum) as Python floats,
    equal on every rank."""
    model, X, Y = build_problem(arrays, dtype, device)
    step = make_sharded_step_fn(1e-2, num_data=N, mesh=mesh, gamma=0.1)
    state = step.init(model)
    Xl, Yl = shard_batch(mesh, X, Y)
    elbo = None
    for i in range(num_iters):
        gen = torch.Generator(device=X.device).manual_seed(100 + i)
        state, elbo = step(state, Xl, Yl, gen)
    return float(elbo), checksum(state.model)
