"""Where a NUTS transition's randomness comes from: draw sources.

The JAX package draws each chain's randomness from its own key, split in a
fixed order (``gpsig_tpu/mcmc/nuts.py``): a transition's momentum, then per
doubling of the tree a direction and a merge uniform, then per leaf a
proposal uniform. ``torch.Generator`` cannot reproduce ``jax.random``, so
the port keeps the draws apart from the transition: the transition asks a
draw source, and the source answers for every chain from that chain's own
stream. A chain draws only while its tree grows, so its draws depend on
its own trajectory alone: not on how many chains run beside it, nor on how
they are grouped into blocks (``parallel/chains.py``'s ``chain_blocks``).

A source holds one stream a chain and answers, on the host, in float64
numpy (the transition casts to its dtype and device):

- ``momentum(phase, dim)``: [C, dim] standard normals, every chain (a
  transition starts on every chain); ``phase`` is "warmup" or "sampling";
- ``doubling(active)``: (go_right [C] bool, u [C]) for the chains where
  ``active`` (a host bool array), neutral values elsewhere;
- ``leaf(active)``: the proposal uniform [C] likewise.

The default stream, :class:`GeneratorStream`, is a CPU ``torch.Generator``
seeded from (seed, chain index), so chain c draws the same whatever C is.
The tests add a stream that replays the JAX package's own keys, split in
its order, which is how the port's transitions are held to JAX's.
``state_dict`` / ``load_state_dict`` carry the streams' states through a
checkpoint, so a resumed run draws exactly what an uninterrupted one
would; the generators live on the CPU whatever device the target is on,
so a state taken before a transition replays its draws on another device.
"""

from __future__ import annotations

import numpy as np
import torch


def chain_seed(seed, chain):
    """The 64-bit seed of chain ``chain``'s generator under ``seed``."""
    state = np.random.SeedSequence([int(seed), int(chain)]).generate_state(
        1, np.uint64)
    return int(state[0])


class GeneratorStream:
    """One chain's draws from its own CPU ``torch.Generator``."""

    def __init__(self, seed, chain):
        self.gen = torch.Generator().manual_seed(chain_seed(seed, chain))

    def momentum(self, phase, dim):
        return torch.randn(dim, generator=self.gen,
                           dtype=torch.float64).numpy()

    def doubling(self):
        u = torch.rand(2, generator=self.gen, dtype=torch.float64).numpy()
        return bool(u[0] < 0.5), float(u[1])

    def leaf(self):
        return float(torch.rand(1, generator=self.gen,
                                dtype=torch.float64)[0])

    def state(self):
        return {"generator": self.gen.get_state()}

    def load_state(self, state):
        self.gen.set_state(state["generator"])


class DrawSource:
    """The draws of C chains, one stream a chain."""

    def __init__(self, streams):
        self.streams = list(streams)

    @classmethod
    def from_seed(cls, seed, num_chains):
        """C chains, chain c drawing from a generator seeded from (seed,
        c)."""
        return cls(GeneratorStream(seed, c) for c in range(num_chains))

    def __len__(self):
        return len(self.streams)

    def momentum(self, phase, dim):
        return np.stack([s.momentum(phase, dim) for s in self.streams])

    def doubling(self, active):
        go = np.zeros(len(self.streams), bool)
        u = np.full(len(self.streams), 0.5)
        for c in np.flatnonzero(active):
            go[c], u[c] = self.streams[c].doubling()
        return go, u

    def leaf(self, active):
        u = np.full(len(self.streams), 0.5)
        for c in np.flatnonzero(active):
            u[c] = self.streams[c].leaf()
        return u

    def subset(self, chains):
        """The source of the chains ``chains`` (sharing their streams)."""
        return DrawSource(self.streams[c] for c in chains)

    def state_dict(self):
        return [s.state() for s in self.streams]

    def load_state_dict(self, states):
        if len(states) != len(self.streams):
            raise ValueError(f"{len(states)} stream states for "
                             f"{len(self.streams)} chains")
        for s, st in zip(self.streams, states):
            s.load_state(st)


def as_draw_source(key, num_chains):
    """A draw source from an int seed (:meth:`DrawSource.from_seed`), or
    ``key`` itself when it is one (checked against ``num_chains``)."""
    if isinstance(key, DrawSource):
        if len(key) != num_chains:
            raise ValueError(f"a draw source of {len(key)} chains for "
                             f"{num_chains} chains")
        return key
    return DrawSource.from_seed(int(key), num_chains)
