"""The rank mesh and its collectives on ``torch.distributed``.

Counterpart of ``gpsig_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a (data, tile) ``Mesh`` and lets GSPMD place collectives;
here every process is one rank on one device, the ranks are laid out the
same way, and the collectives are called by hand:

- ``data``: minibatch and chain parallelism. ELBO terms, natural-gradient
  statistics, the loss's gradients and NUTS's accept statistic are summed
  over it.
- ``tile``: Gram-block parallelism; ``parallel/train.py``'s
  ``sharded_gram`` splits a Gram's columns over it.

Rank r sits at (r // tile, r % tile), as ``np.reshape`` lays JAX's devices
out. Each axis has its sub-groups (``dist.new_group``): the data group of
a rank holds the ranks that share its tile index, the tile group those
that share its data index.

Every collective is an ``all_reduce`` (or a ``broadcast``): gloo takes
CUDA tensors for those two only, so one code path serves gloo on the CPU,
gloo with ranks sharing a card, and NCCL. The backend is always the
caller's: nothing here chooses it. With no process group started (one
process), the collectives return their input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TILE_AXIS = "tile"


def init_distributed(backend, init_method, world_size, rank):
    """Join the process group: ``backend`` ("gloo" or "nccl"), its
    ``init_method`` (``tcp://host:port`` or ``file:///path``), the world
    size and this process's rank, all given by the caller."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, tile) layout of the ranks, seen from one rank.

    ``data_group`` / ``tile_group``: this rank's sub-groups (None with no
    process group); ``device``: where :func:`gather` stages its buffers
    (NCCL reduces only CUDA tensors)."""

    data: int
    tile: int
    rank: int = 0
    data_group: object = None
    tile_group: object = None
    device: torch.device = torch.device("cpu")

    @property
    def shape(self):
        return {DATA_AXIS: self.data, TILE_AXIS: self.tile}

    @property
    def size(self):
        return self.data * self.tile

    @property
    def data_index(self):
        return self.rank // self.tile

    @property
    def tile_index(self):
        return self.rank % self.tile


def make_mesh(data=None, tile=1):
    """This rank's (data, tile) mesh over the process group (one rank when
    none is started). Defaults: every rank on ``data``. Every rank must
    call it, with the same arguments: each sub-group is made by every rank,
    in the same order. :func:`gather` stages its buffers on this rank's
    CUDA device under NCCL, on the CPU otherwise."""
    started = dist.is_initialized()
    world = dist.get_world_size() if started else 1
    rank = dist.get_rank() if started else 0
    if data is None:
        data = world // tile
    if data * tile != world:
        raise ValueError(f"data*tile = {data * tile} != {world} ranks")
    nccl = started and dist.get_backend() == "nccl"
    device = (torch.device("cuda", torch.cuda.current_device()) if nccl
              else torch.device("cpu"))
    groups = {}
    if started:
        # the same calls in the same order on every rank, members or not
        for j in range(tile):
            g = dist.new_group([i * tile + j for i in range(data)])
            if rank % tile == j:
                groups["data"] = g
        for i in range(data):
            g = dist.new_group([i * tile + j for j in range(tile)])
            if rank // tile == i:
                groups["tile"] = g
    return Mesh(data, tile, rank, groups.get("data"), groups.get("tile"),
                device)


def shard_batch(mesh, *tensors):
    """This rank's block of each tensor's leading axis: contiguous blocks
    over ``data`` (ranks that share a data index hold the same block), as
    ``NamedSharding(P("data"))`` splits it. The axis must divide by the
    data size."""
    out = []
    for t in tensors:
        n = t.shape[0]
        if n % mesh.data:
            raise ValueError(f"leading axis {n} not divisible by the data "
                             f"axis's {mesh.data} ranks")
        b = n // mesh.data
        out.append(t[mesh.data_index * b:(mesh.data_index + 1) * b])
    return tuple(out) if len(out) > 1 else out[0]


def psum(tensors, group):
    """The sums of ``tensors`` (one dtype and device) over ``group``, by ONE
    ``all_reduce`` of their concatenation; the inputs unchanged with no
    process group."""
    tensors = list(tensors)
    if not dist.is_initialized() or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def broadcast_module(module, src=0):
    """Overwrite every parameter and buffer of ``module`` with rank
    ``src``'s (one ``broadcast`` each); nothing with no process group."""
    if not dist.is_initialized():
        return module
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            buf = t.data.contiguous()
            dist.broadcast(buf, src=src)
            if buf.data_ptr() != t.data.data_ptr():
                t.data.copy_(buf)
    return module


def group_size(group):
    """Ranks in ``group`` (1 with no process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def pmean(tensors, group):
    """The means of ``tensors`` over ``group`` (:func:`psum` over its
    size)."""
    n = group_size(group)
    return [t / n for t in psum(tensors, group)]


def gather(mesh, block):
    """Every data index's ``block`` (a numpy array, the same shape on every
    rank) stacked along the leading axis in data-index order, on every
    rank: one ``all_reduce`` over the data group of zero-filled buffers,
    staged on ``mesh.device``. Bool and integer arrays travel as float64
    and come back in their dtype."""
    block = np.asarray(block)
    if not dist.is_initialized():
        return block
    rows = block.shape[0]
    if block.size == 0:
        return np.zeros((rows * mesh.data,) + block.shape[1:], block.dtype)
    full = torch.zeros((rows * mesh.data,) + block.shape[1:],
                       dtype=torch.float64, device=mesh.device)
    at = mesh.data_index * rows
    full[at:at + rows] = torch.as_tensor(block.astype(np.float64),
                                         device=mesh.device)
    dist.all_reduce(full, group=mesh.data_group)
    return full.cpu().numpy().astype(block.dtype)
