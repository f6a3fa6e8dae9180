"""GPflow-1.x-style optimizer objects over the port's training functions.

Counterpart of ``gpsig_tpu/compat/training.py``. The reference's protocol
is a ``NatGradOptimizer(gamma)`` on (q_mu, q_sqrt) alternating with an
``AdamOptimizer(lr)`` on the hyperparameters::

    adam = gpsig.training.AdamOptimizer(1e-3)
    nat  = gpsig.training.NatGradOptimizer(0.1)
    for _ in range(iters):
        nat.minimize(model, maxiter=1)
        adam.minimize(model, maxiter=1, freeze_variational=True)

or in one call ``gpsig.training.fit(model, maxiter=500)``. Each draws its
batches from the model (``model.next_batch()``) and trains its module in
place. ``gamma`` and ``learning_rate`` are read at every ``minimize``, so
they can be annealed between calls.

The Adam state is the JAX facade's single ``optax.adam`` state: one
``torch.optim.Adam`` a model, shared across ``freeze_variational`` phases,
whose step count is one for all parameters. ``torch.optim.Adam`` keeps a
step count a parameter and skips a parameter with no gradient; so a frozen
step here advances q_mu's and q_sqrt's counts by hand and leaves their
values and moments as they were, as optax's shared count and the JAX
facade's pinned moments do. Without that, q's bias correction after 2
unfrozen, 3 frozen and 1 unfrozen steps would use count 3 where optax uses
6. The JAX facade's Adam differentiates every leaf, the low-rank kernel's
integer sketch indices included, and raises on such a model; here those
indices are buffers and the model trains.
"""

from __future__ import annotations

import weakref

import torch

from gpsig_tpu_torch.training import loop
from gpsig_tpu_torch.training.natgrad import natgrad_step


def _count_frozen_step(opt, params):
    """Advance by one the Adam step count of each of ``params``, which
    ``opt.step()`` just skipped, leaving its value and moments as they
    were: optax's one shared count. This relies on ``torch.optim.Adam``'s
    per-parameter state, which ``Adam._init_group`` makes lazily when a
    parameter first has a gradient: ``step`` (a scalar tensor of
    ``torch.optim.optimizer._get_scalar_dtype()``, on the CPU for an Adam
    that is neither fused nor capturable, as the facade's is),
    ``exp_avg`` and ``exp_avg_sq``. A parameter frozen before it ever had
    a gradient gets that state here, with zero moments, as torch would
    make it."""
    from torch.optim.optimizer import _get_scalar_dtype

    for p in params:
        state = opt.state[p]
        if not state:
            state["step"] = torch.tensor(0.0, dtype=_get_scalar_dtype())
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        state["step"] += 1


class AdamOptimizer:
    """Adam over the model's parameters (reference protocol: grouped with a
    NatGrad op), one ``training/loop.py::make_step_fn`` step (natgrad off)
    an iteration. One ``torch.optim.Adam`` a model wrapper, held in a
    ``WeakKeyDictionary`` so that a collected wrapper takes its moments
    with it; the learning rate is read at each ``minimize``."""

    def __init__(self, learning_rate=1e-3):
        self.learning_rate = learning_rate
        self._state = weakref.WeakKeyDictionary()  # wrapper -> Adam

    def minimize(self, wrapper, maxiter=100, freeze_variational=False,
                 callback=None):
        model = wrapper.to_functional()
        if wrapper not in self._state:
            self._state[wrapper] = torch.optim.Adam(model.parameters(),
                                                    lr=self.learning_rate)
        opt = self._state[wrapper]
        for group in opt.param_groups:
            group["lr"] = self.learning_rate
        step = loop.make_step_fn(self.learning_rate, wrapper.num_data,
                                 use_natgrad=False,
                                 freeze_variational_in_adam=freeze_variational)
        state = loop.TrainState(model, opt, 0)
        elbo = None
        for it in range(maxiter):
            state, elbo = step(state, *wrapper.next_batch(), wrapper._draws())
            if freeze_variational:
                _count_frozen_step(opt, (model.q_mu, model.q_sqrt))
            if callback is not None:
                callback(it, float(elbo))
        wrapper.update_functional(model)
        return None if elbo is None else float(elbo)


class NatGradOptimizer:
    """Natural-gradient steps on (q_mu, q_sqrt) (reference:
    ``gpflow.training.NatGradOptimizer``), through
    ``training/natgrad.py::natgrad_step``; ``gamma`` is read at each
    ``minimize``."""

    def __init__(self, gamma=0.1):
        self.gamma = gamma

    def minimize(self, wrapper, maxiter=1, var_list=None):
        # var_list accepted for signature parity: the update always targets
        # (q_mu, q_sqrt), the only variational pair in the model
        del var_list
        model = wrapper.to_functional()
        for _ in range(maxiter):
            xb, yb = wrapper.next_batch()
            natgrad_step(model, float(self.gamma), xb, yb,
                         num_data=wrapper.num_data, generator=wrapper._draws())
        wrapper.update_functional(model)


def fit(wrapper, maxiter=500, learning_rate=1e-3, gamma=0.1,
        use_natgrad=True, callback=None):
    """Alternating natgrad + Adam, one ``training/loop.py`` step an
    iteration (the reference benchmarks' protocol); returns the last
    ELBO."""
    step_fn = loop.make_step_fn(learning_rate, wrapper.num_data, gamma,
                                use_natgrad)
    state = step_fn.init(wrapper.to_functional())
    elbo = None
    for it in range(maxiter):
        xb, yb = wrapper.next_batch()
        state, elbo = step_fn(state, xb, yb, wrapper._draws())
        if callback is not None:
            callback(it, float(elbo))
    wrapper.update_functional(state.model)
    return None if elbo is None else float(elbo)
