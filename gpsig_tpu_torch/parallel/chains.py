"""The chunked NUTS sampler on one device: chunks of transitions, chain
blocks, checkpoints and resume.

Counterpart of ``gpsig_tpu/parallel/chains.py``'s ``make_chunked_sampler``
on one device. The host loops over chunks of at most
``draws_per_dispatch`` transitions, carrying the whole adaptation state
(NUTS state, dual averaging, Welford mass, the chains' draw streams)
between them; the chunk is the progress (``on_chunk``) and checkpoint
unit. The chunked path equals the monolithic one, since the mass-matrix
window keys on the absolute warmup index and each chain's draws come from
its own stream. ``chain_blocks`` runs the chains as that many blocks one
after another (each block one batch, a smaller batch whose deepest tree
sets fewer leapfrogs a transition); for independent chains any grouping
gives the same draws, and with ``shared_step_size`` the accept statistic
is pooled within a block.

Under a mesh (``parallel/mesh.py``) the chains are split over the ranks of
its ``data`` axis, as the JAX package's ``shard_map`` splits them over
devices: each rank runs its block of the C chains, the accept statistic
is pooled within a chain block and then averaged over the data group (the
JAX package's ``pmean`` over "chain", then over ``data``), so every rank
adapts the same step size, and every chain's draws and info come back on
every rank. Chain c draws from the stream of global chain c whatever rank
runs it, so a sharded run draws what one process running all C chains
draws. :func:`run_chains_sharded` is the JAX package's entry point.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from gpsig_tpu_torch.mcmc.draws import as_draw_source
from gpsig_tpu_torch.mcmc.nuts import NutsState, nuts_kernel
from gpsig_tpu_torch.mcmc.sample import (
    DAState,
    WelfordState,
    init_carry,
    make_samp_step,
    make_warm_step,
)
from gpsig_tpu_torch.parallel.mesh import gather, pmean
from gpsig_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)


def _pooled(acc):
    """The accept statistic pooled over a block's chains."""
    return acc.mean().expand_as(acc)


def _take(carry, chains):
    """The chains ``chains`` (a slice) of a carry of NamedTuples and
    tensors."""
    return tuple(type(x)(*(t[chains] for t in x)) if isinstance(x, tuple)
                 else x[chains] for x in carry)


def _join(parts):
    """Carries of consecutive blocks → one carry."""
    return tuple(
        type(xs[0])(*(torch.cat(ts) for ts in zip(*xs)))
        if isinstance(xs[0], tuple) else torch.cat(xs)
        for xs in zip(*parts))


def _pooled_over(mesh):
    """The accept statistic pooled over a block's chains, then averaged
    over the mesh's data group."""
    def reduce(acc):
        return pmean([acc.mean()], mesh.data_group)[0].expand_as(acc)

    return reduce


def run_chains_sharded(
    seed, logp_fn, theta0s, mesh, num_warmup=500, num_samples=500,
    max_depth=8, target_accept=0.8, init_step_size=0.1,
    shared_step_size=True, draws_per_dispatch=None, chain_blocks=1,
):
    """All C chains of θ0s [C, D] (every rank passes them all), split over
    the mesh's ``data`` axis; C must divide by its size. Each rank runs its
    block through the chunked sampler (one chunk a phase unless
    ``draws_per_dispatch`` says otherwise); returns (samples [C,
    num_samples, D], info) on every rank."""
    sampler = make_chunked_sampler(
        logp_fn, num_warmup=num_warmup, num_samples=num_samples,
        max_depth=max_depth, target_accept=target_accept,
        init_step_size=init_step_size, shared_step_size=shared_step_size,
        draws_per_dispatch=(draws_per_dispatch or
                            max(num_warmup, num_samples, 1)),
        chain_blocks=chain_blocks, mesh=mesh)
    return sampler(seed, theta0s)


def make_chunked_sampler(
    logp_fn, num_warmup=500, num_samples=500, max_depth=8,
    target_accept=0.8, init_step_size=0.1, shared_step_size=True,
    draws_per_dispatch=100, chain_blocks=1, mesh=None,
):
    """Build ``sample(key, theta0s) -> (samples, info)``, which loops on the
    host over chunks of at most ``draws_per_dispatch`` transitions.

    chain_blocks: run the chains as this many blocks in turn, each a batch
    (the lockstep of a batch makes a transition cost its deepest tree's
    leapfrogs). Per-chain results do not depend on the grouping; with
    ``shared_step_size`` dual averaging pools the accept statistic within a
    block (and, under ``mesh``, over the data group).

    mesh: split the chains over its ``data`` axis (module docstring);
    ``theta0s`` then holds all C chains on every rank, and each rank's
    chain blocks divide its C / data chains."""
    blk_max = int(draws_per_dispatch)
    chain_blocks = int(chain_blocks)
    kernel = nuts_kernel(logp_fn, max_depth=max_depth)
    mass_start = int(0.1 * num_warmup)
    mass_end = int(0.9 * num_warmup)
    reduce = (None if not shared_step_size else
              _pooled if mesh is None else _pooled_over(mesh))
    n_data = 1 if mesh is None else mesh.data
    warm_step = make_warm_step(kernel, target_accept, mass_start,
                               mass_end, reduce)
    samp_step = make_samp_step(kernel)

    def _config(num_chains):
        """Sampler settings a checkpoint must match to be resumable:
        resuming under others would mix incompatible adaptation state
        (for instance a shifted mass-matrix window)."""
        return {
            "num_warmup": int(num_warmup),
            "num_samples": int(num_samples),
            "num_chains": int(num_chains),
            "max_depth": int(max_depth),
            "target_accept_milli": int(round(1000 * target_accept)),
            "draws_per_dispatch": blk_max,
            "chain_blocks": chain_blocks,
            "world_size": 1 if mesh is None else mesh.size,
        }

    def _blocks(C):
        G = C // chain_blocks
        return [slice(b * G, (b + 1) * G) for b in range(chain_blocks)]

    def _run_chunk(step, carry, draws, C, blk, t0=None):
        """``blk`` transitions of every block in turn; returns the carry
        and each output [C, blk, ...]."""
        parts, outs = [], []
        for chains in _blocks(C):
            c, sub = _take(carry, chains), draws.subset(
                range(C)[chains])
            got = []
            for k in range(blk):
                if t0 is None:
                    c, out = step(c, sub)
                else:
                    c, out = step(c, t0 + k, sub)
                got.append(out)
            parts.append(c)
            outs.append(got)
        carry = _join(parts)
        if t0 is not None:
            return carry, {"warmup_accept": torch.cat(
                [torch.stack(g, dim=1) for g in outs])}
        return carry, {k: torch.cat([torch.stack([o[k] for o in g], dim=1)
                                     for g in outs]) for k in outs[0][0]}

    def _pack(phase, pos, chunk, carry, bufs, draws, num_chains):
        tree = {"phase": phase, "pos": pos, "chunk": chunk, "bufs": bufs,
                "draws": draws.state_dict(), "config": _config(num_chains)}
        if phase == 0:
            st, da, wf, im = carry
            tree["warm"] = {"state": st._asdict(), "da": da._asdict(),
                            "wf": wf._asdict(), "inv_mass": im}
        else:
            st, eps, im = carry
            tree["samp"] = {"state": st._asdict(), "eps": eps,
                            "inv_mass": im}
        return tree

    def _unpack(tree, device):
        def dev(d):
            return {k: v.to(device) for k, v in d.items()}

        phase = int(tree["phase"])
        if phase == 0:
            w = tree["warm"]
            carry = (NutsState(**dev(w["state"])), DAState(**dev(w["da"])),
                     WelfordState(**dev(w["wf"])), w["inv_mass"].to(device))
        else:
            s = tree["samp"]
            carry = (NutsState(**dev(s["state"])), s["eps"].to(device),
                     s["inv_mass"].to(device))
        bufs = {k: v.numpy() for k, v in tree["bufs"].items()}
        return (phase, int(tree["pos"]), int(tree["chunk"]), carry, bufs,
                tree["draws"])

    def _load_latest(cdir, expect_config, device):
        if not os.path.isdir(cdir):
            return None
        steps = sorted((d for d in os.listdir(cdir)
                        if d.startswith("chunk_")), reverse=True)
        errors = []
        for d in steps:
            try:
                tree = restore_checkpoint(os.path.join(cdir, d))
            except (OSError, EOFError, RuntimeError,
                    pickle.UnpicklingError) as e:  # unreadable: the previous
                errors.append((d, e))
                continue
            saved = {k: int(v) for k, v in tree.get("config", {}).items()}
            # checkpoints written before chain_blocks (or the world size)
            # existed carry no such key; one block on one process is the
            # old behaviour, so default it rather than reject them
            if saved:
                saved.setdefault("chain_blocks", 1)
                saved.setdefault("world_size", 1)
            if saved and saved != expect_config:
                raise ValueError(
                    f"checkpoint {cdir}/{d} was written under a different "
                    f"sampler config {saved} (this sampler: "
                    f"{expect_config}); resuming would silently mix "
                    "incompatible adaptation state. Point checkpoint_dir "
                    "elsewhere or rebuild the sampler with the original "
                    "settings.")
            return _unpack(tree, device)
        if errors:
            # saves exist but none restored: starting afresh would discard
            # (and then delete) a long run's state
            raise RuntimeError(
                f"{len(errors)} checkpoint(s) in {cdir} exist but none "
                f"could be restored (last error on {errors[0][0]}: "
                f"{errors[0][1]!r}). Refusing to restart from scratch; "
                "move or delete the directory to start afresh.")
        return None

    def _save(cdir, chunk, tree):
        name = f"chunk_{chunk:06d}"
        save_checkpoint(os.path.join(cdir, name), tree)
        for d in os.listdir(cdir):  # keep only the save that just landed
            if d.startswith("chunk_") and d != name:
                os.remove(os.path.join(cdir, d))

    def sample(key, theta0s, checkpoint_dir=None, max_chunks=None,
               on_chunk=None):
        """Run (or resume) the chunked sampler on θ0s [C, D].

        key: an int seed or a draw source (``mcmc/draws.py``).
        checkpoint_dir: if set, the whole sampler state (NUTS state,
        adaptation, the chains' draw streams, the draws so far) is saved
        after every chunk, and a later call with the same directory
        resumes from the last completed chunk (``key`` and ``theta0s`` then
        give only the shapes, the device and the streams' kind).
        max_chunks: run at most this many chunks in this call and return
        None if unfinished (the state is on disk). on_chunk: ``fn(phase,
        pos, total)`` called after every chunk, phase "warmup" or
        "sampling". Checkpointing never changes the draws.

        Under a mesh, θ0s holds all C chains; each rank runs its block,
        saves it under ``checkpoint_dir/rank<r>/``, and returns every
        chain's draws and info."""
        C_all, D = theta0s.shape
        if C_all % n_data:
            raise ValueError(f"chains {C_all} not divisible by the data "
                             f"axis's {n_data} ranks")
        C = C_all // n_data
        if C % chain_blocks:
            raise ValueError(f"chains {C} not divisible by chain_blocks "
                             f"{chain_blocks}")
        if max_chunks is not None and checkpoint_dir is None:
            raise ValueError(
                "max_chunks without checkpoint_dir would return None with "
                "all progress discarded (the state lives only in local "
                "variables); pass checkpoint_dir so the slice persists.")
        # each chain draws from its global index's stream
        lo = 0 if mesh is None else mesh.data_index * C
        draws = as_draw_source(key, C_all).subset(range(lo, lo + C))
        theta0s = theta0s[lo:lo + C]
        cdir = checkpoint_dir
        if cdir and mesh is not None:
            cdir = os.path.join(cdir, f"rank{mesh.rank}")
        resumed = (_load_latest(cdir, _config(C_all), theta0s.device)
                   if cdir else None)
        if resumed is None:
            carry = init_carry(logp_fn, theta0s, init_step_size)
            phase, pos, chunk, bufs = 0, 0, 0, {}
        else:
            phase, pos, chunk, carry, bufs, states = resumed
            draws.load_state_dict(states)
        if mesh is not None and dist.is_initialized():
            _same_chunk(mesh, chunk)
        done_here = 0

        def checkpoint():
            if cdir:
                _save(cdir, chunk,
                      _pack(phase, pos, chunk, carry, bufs, draws, C_all))

        while phase == 0:
            if pos >= num_warmup:
                state, da, _, inv_mass = carry
                carry = (state, torch.exp(da.log_eps_bar), inv_mass)
                phase, pos = 1, 0
                break
            if max_chunks is not None and done_here >= max_chunks:
                return None
            blk = min(blk_max, num_warmup - pos)
            carry, out = _run_chunk(warm_step, carry, draws, C, blk, pos)
            acc = out["warmup_accept"].cpu().numpy()
            bufs.setdefault("warmup_accept", np.zeros(
                (C, num_warmup), acc.dtype))[:, pos:pos + blk] = acc
            pos += blk
            chunk += 1
            done_here += 1
            checkpoint()
            if on_chunk is not None:
                on_chunk("warmup", pos, num_warmup)

        while pos < num_samples:
            if max_chunks is not None and done_here >= max_chunks:
                checkpoint()  # persists the warmup-to-sampling switch too
                return None
            blk = min(blk_max, num_samples - pos)
            carry, out = _run_chunk(samp_step, carry, draws, C, blk)
            for k, v in out.items():
                v = v.cpu().numpy()
                bufs.setdefault(k, np.zeros((C, num_samples) + v.shape[2:],
                                            v.dtype))[:, pos:pos + blk] = v
            pos += blk
            chunk += 1
            done_here += 1
            checkpoint()
            if on_chunk is not None:
                on_chunk("sampling", pos, num_samples)

        eps, inv_mass = carry[1], carry[2]
        dt = torch.empty((), dtype=theta0s.dtype).numpy().dtype
        # num_samples = 0 never enters the sampling loop: empty buffers of
        # the right shapes, as the monolithic run gives
        result = {
            "step_size": eps.cpu().numpy(),
            "inv_mass": inv_mass.cpu().numpy(),
            "warmup_accept": bufs.get("warmup_accept", np.zeros((C, 0), dt)),
            "accept_prob": bufs.get("accept_prob",
                                    np.zeros((C, num_samples), dt)),
            "diverging": bufs.get("diverging",
                                  np.zeros((C, num_samples), bool)),
            "num_leaves": bufs.get("num_leaves",
                                   np.zeros((C, num_samples), dt)),
            "logp": bufs.get("logp", np.zeros((C, num_samples), dt)),
            "theta": bufs.get("theta", np.zeros((C, num_samples, D), dt)),
        }
        if mesh is not None:
            result = {k: gather(mesh, v) for k, v in result.items()}
        return result.pop("theta"), result

    return sample


def _same_chunk(mesh, chunk):
    """Raise unless every rank resumes at the same chunk (a run stopped
    between two ranks' saves cannot resume): one ``all_reduce`` of
    (chunk, −chunk) under MAX."""
    t = torch.tensor([chunk, -chunk], dtype=torch.float64,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if t[0] != -t[1]:
        raise RuntimeError(
            f"the ranks' checkpoints are at chunks {int(-t[1])} to "
            f"{int(t[0])}; a sharded run resumes only from one chunk on "
            "every rank")
