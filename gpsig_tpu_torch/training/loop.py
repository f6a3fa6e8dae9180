"""Training loops: natural gradients on q(u) alternating with Adam on the
hyperparameters (the reference's benchmark protocol).

Counterpart of ``gpsig_tpu/training/loop.py``. A step is, in this order:
the natgrad step on (q_mu, q_sqrt) when ``use_natgrad``; the loss −ELBO
(minus ``log_prior_fn(model)`` for MAP) on the post-natgrad model; its
gradient; q_mu and q_sqrt left out of Adam when
``freeze_variational_in_adam`` (default: ``use_natgrad``); one
``torch.optim.Adam`` update. ``torch.optim.Adam`` and ``optax.adam`` are
the same update (β 0.9/0.999, eps 1e-8 outside the square root, the same
bias correction), and a parameter Adam skips is one JAX hands zero
gradients forever.

The JAX package's ``_value_and_grad_floats`` and ``float_only_optimizer``
exist because its pytrees carry integer leaves (the low-rank kernel's
sketch indices); the port keeps those as buffers, not parameters, so
neither is needed. The model is trained in place.

Random draws: where the JAX step takes a PRNG key, the port's takes a
``torch.Generator``. JAX's step hands one key to both the natgrad ELBO and
the loss, so both see the same Monte-Carlo draws; the port's step does the
same by taking one seed from the generator and seeding a fresh generator
with it, on the model's device, for each of the two evaluations. A step
whose likelihood draws nothing (``needs_generator`` false) leaves the
generator untouched.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple

import numpy as np
import torch

from gpsig_tpu_torch.config import precise_linalg
from gpsig_tpu_torch.parallel.mesh import broadcast_module, psum
from gpsig_tpu_torch.training.natgrad import natgrad_step


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def init_state(model, learning_rate):
    """A fresh state: ``torch.optim.Adam(learning_rate)`` over every
    parameter of ``model``."""
    return TrainState(model, torch.optim.Adam(model.parameters(),
                                              lr=learning_rate), 0)


def _step_draws(model, generator):
    """A function giving, at each call, a fresh generator seeded with one
    seed taken from ``generator`` (the default generator when None) for
    this step, so that every evaluation of the step draws the same values;
    None throughout when the likelihood draws nothing."""
    if not getattr(model.likelihood, "needs_generator", False):
        return lambda: None
    device = "cpu" if generator is None else generator.device
    seed = int(torch.randint(0, 2**62, (), generator=generator,
                             device=device))
    where = model.q_mu.device
    return lambda: torch.Generator(device=where).manual_seed(seed)


def make_step_fn(learning_rate, num_data, gamma=0.1, use_natgrad=True,
                 freeze_variational_in_adam=None,
                 log_prior_fn: Callable | None = None, mesh=None):
    """Build a ``(state, X, Y, generator=None) -> (state, elbo)`` training
    step; the ELBO returned is the post-natgrad, pre-Adam one (plus the
    log-prior under MAP). ``generator`` (a ``torch.Generator``) feeds a
    Monte-Carlo likelihood's draws, the same in the step's natgrad ELBO and
    its loss. ``step.init(model)`` makes its state with Adam at
    ``learning_rate``. log_prior_fn(model) -> scalar log-prior over
    hyperparameters enables MAP training.

    mesh: a ``parallel.mesh.Mesh`` makes the step data-parallel: X and Y
    are this rank's block of the global batch (``shard_batch``), the rank's
    objective is its share, the ELBO (and log-prior) over the data size n,
    the natgrad statistics are summed over the data group before the
    update, the loss and its gradients are summed in one ``all_reduce``
    before Adam, and ``step.init`` first broadcasts every parameter and
    buffer from rank 0, so the replicas start and stay equal. The ELBO
    returned is then the global one. With no process group each of these
    is the identity."""
    if freeze_variational_in_adam is None:
        freeze_variational_in_adam = use_natgrad
    reduce = None
    if mesh is not None:
        n, group = mesh.data, mesh.data_group

        def reduce(g_mu, g_S):
            return tuple(psum((g_mu / n, g_S / n), group))

    def step(state, X, Y, generator=None):
        model, opt = state.model, state.optimizer
        draws = _step_draws(model, generator)
        if use_natgrad:
            natgrad_step(model, gamma, X, Y, num_data=num_data,
                         generator=draws(), reduce=reduce)
        opt.zero_grad(set_to_none=True)
        # the backward runs inside precise_linalg too: the forward's
        # decorator has returned by then, and TF32 would cut its products
        with precise_linalg():
            loss = -model.elbo(X, Y, num_data=num_data, generator=draws())
            if log_prior_fn is not None:
                loss = loss - log_prior_fn(model)
            if mesh is not None:
                loss = loss / n
            loss.backward()
        if freeze_variational_in_adam:
            model.q_mu.grad = None
            model.q_sqrt.grad = None
        loss = loss.detach()
        if mesh is not None:
            params = [p for p in model.parameters() if p.grad is not None]
            loss, *grads = psum([loss, *(p.grad for p in params)], group)
            for p, g in zip(params, grads):
                p.grad = g
        opt.step()
        return TrainState(model, opt, state.step + 1), -loss

    def init(model):
        if mesh is not None:
            broadcast_module(model)
        return init_state(model, learning_rate)

    step.init = init
    return step


def make_multi_step_fn(learning_rate, num_data, gamma=0.1, use_natgrad=True,
                       freeze_variational_in_adam=None,
                       log_prior_fn: Callable | None = None):
    """``(state, Xb [k, B, ...], Yb [k, B], generator=None) -> (state,
    elbos [k])``: k minibatch steps in a Python loop, the same math as k
    calls of :func:`make_step_fn`'s step with the same batches and the same
    generator."""
    step = make_step_fn(learning_rate, num_data, gamma, use_natgrad,
                        freeze_variational_in_adam, log_prior_fn)

    def multi(state, Xb, Yb, generator=None):
        elbos = []
        for X, Y in zip(Xb, Yb):
            state, elbo = step(state, X, Y, generator)
            elbos.append(elbo)
        return state, torch.stack(elbos)

    multi.init = step.init
    return multi


def default_val_metric(model, Xv, yv):
    """Validation accuracy (classification): the reference benchmarks'
    early-stopping criterion."""
    with torch.no_grad():
        p, _ = model.predict_y(Xv)
    return float((p.argmax(1).cpu().numpy() == np.asarray(yv.cpu())).mean())


def fit(model, X, Y, num_iters=500, batch_size=None, learning_rate=1e-3,
        gamma=0.1, use_natgrad=True, seed=0, callback: Callable | None = None,
        log_every=100, val_data=None, val_every=50, patience=10,
        val_metric: Callable | None = None):
    """Full-data or minibatch fitting loop (host-side batching, drawn with
    ``np.random.default_rng(seed).choice`` as in JAX, so a run can be held
    against it exactly). A Monte-Carlo likelihood draws from a
    ``torch.Generator`` seeded ``seed`` on X's device, where JAX splits
    ``PRNGKey(seed)``.

    val_data=(Xv, yv) enables validation early stopping: evaluate
    ``val_metric`` (default: accuracy) every ``val_every`` iterations, keep
    a copy of the best model, stop after ``patience`` evaluations without
    improvement. Returns (model, history [(iteration, elbo)])."""
    N = X.shape[0]
    step_fn = make_step_fn(learning_rate, N, gamma, use_natgrad)
    state = step_fn.init(model)
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=X.device).manual_seed(seed)
    history = []
    metric = val_metric if val_metric is not None else default_val_metric
    best_score, best_model, stale = -np.inf, None, 0
    for it in range(num_iters):
        if batch_size is None or batch_size >= N:
            xb, yb = X, Y
        else:
            idx = torch.as_tensor(rng.choice(N, batch_size, replace=False),
                                  device=X.device)
            xb, yb = X[idx], Y[idx]
        state, elbo = step_fn(state, xb, yb, generator)
        if it % log_every == 0 or it == num_iters - 1:
            history.append((it, float(elbo)))
            if callback is not None:
                callback(it, state.model, float(elbo))
        if val_data is not None and (
            (it + 1) % val_every == 0 or it == num_iters - 1
        ):
            score = metric(state.model, val_data[0], val_data[1])
            if score > best_score:
                best_score, stale = score, 0
                best_model = copy.deepcopy(state.model)
            else:
                stale += 1
                if stale >= patience:
                    break
    if val_data is not None and best_model is not None:
        return best_model, history
    return state.model, history
