"""Sharded SVI: the data-parallel natgrad + Adam step, and Gram tiles.

Counterpart of ``gpsig_tpu/parallel/train.py``. The minibatch is split
over the mesh's ``data`` axis; each rank computes its block's share of the
ELBO and its gradients, and the shares are summed with one ``all_reduce``
each. The model (kernel hyperparameters, inducing variables, q) is
replicated: every rank applies the same update to the same sums, so the
replicas stay equal bitwise. The step is ``training.loop.make_step_fn``'s
own, given the mesh.

- The local objective is ``model.elbo(X_local, Y_local, num_data) / n``
  over n data ranks: (num_data / b) Σ var_exp − KL, over n, is the JAX
  package's ``scale · Σ var_exp − KL / n`` with scale = num_data / (b n),
  so the shares sum to the ELBO and their gradients to its gradient. It is
  the model's own ELBO, so the Kuu = I path and ``covariances_full`` are
  kept. Under ``joint_psd`` each rank projects [Z; X_local], not [Z;
  X_global], so past one rank the sharded ELBO is not the one-process ELBO
  (Kuu then differs between ranks); the JAX package's sharded step calls
  ``covariances`` there and bypasses the projection altogether.
- The natural-gradient statistics (∂L/∂μ, ∂L/∂S) are summed over the data
  group before the update (``natgrad_step``'s ``reduce``); the loss and
  its gradients are summed in one flat ``all_reduce``.
- A Monte-Carlo likelihood draws from the step's generator. Every rank is
  handed a generator seeded alike, so every rank draws what JAX's one key
  gives every shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gpsig_tpu_torch.training.loop import make_step_fn


def make_sharded_step_fn(learning_rate, num_data, mesh, gamma=0.1,
                         use_natgrad=True):
    """``training.loop.make_step_fn``'s step on ``mesh``: ``step(state,
    X_local, Y_local, generator=None) -> (state, elbo)``, X_local and
    Y_local this rank's block of the global batch (``mesh.shard_batch``),
    the ELBO the global post-natgrad one; ``step.init(model)`` broadcasts
    every parameter and buffer from rank 0, then makes the state."""
    return make_step_fn(learning_rate, num_data, gamma, use_natgrad,
                        mesh=mesh)


def sharded_gram(kernel, mesh, X, X2=None):
    """The [N1, N2] Gram ``kernel.K(X, X2)`` tiled over the whole mesh: rows
    split over ``data``, columns over ``tile``; each rank computes its
    block, and one ``all_reduce`` of zero-filled [N1, N2] buffers hands
    every rank the whole matrix. N1 must divide by the data size and N2 by
    the tile size. Values only: no gradient flows through the
    ``all_reduce``."""
    X2v = X if X2 is None else X2
    N1, N2 = X.shape[0], X2v.shape[0]
    if N1 % mesh.data or N2 % mesh.tile:
        raise ValueError(f"a [{N1}, {N2}] Gram does not split over a "
                         f"({mesh.data}, {mesh.tile}) mesh")
    r, c = N1 // mesh.data, N2 // mesh.tile
    rows = slice(mesh.data_index * r, (mesh.data_index + 1) * r)
    cols = slice(mesh.tile_index * c, (mesh.tile_index + 1) * c)
    with torch.no_grad():
        # off the diagonal a block is not symmetric: K(Xr, Xc), never the
        # symmetric route
        block = kernel.K(X[rows], X2v[cols])
        if not dist.is_initialized():
            return block
        full = block.new_zeros((N1, N2))
        full[rows, cols] = block
        dist.all_reduce(full)
    return full
