"""Sequence-parallel Goursat solve with a halo exchange.

Counterpart of ``gpsig_tpu/parallel/goursat_sp.py``. For sequences too long
for one device, the (s, t) PDE grid is split along s over the mesh's
``data`` axis and solved as a wavefront of ranks: rank p owns a block of
rows, the solve goes in column blocks (supersteps), and after each
superstep rank p hands its bottom row to rank p + 1, whose top boundary it
is for the next superstep. P ranks and Q column blocks take P + Q − 1
supersteps.

The halo is an ``all_reduce`` over the data group of a zero-filled
[P, ..., bt] buffer in which each rank fills its own slot and reads slot
p − 1 (the JAX package's ``ppermute``), so the same code runs under gloo
and NCCL. The result, held by the last rank, reaches every rank by one
more ``all_reduce``. The tile solve is plain PyTorch, as the JAX one is
plain XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _linear_scan(c, d):
    """(C, D) with C_i = c_0 ⋯ c_i and D_i = c_i D_{i−1} + d_i over the last
    axis: the prefix composition of the maps u ↦ c u + d by doubling
    (log-depth, as ``lax.associative_scan``), with no division (c may be 0
    or negative)."""
    C, D = c, d
    n = c.shape[-1]
    k = 1
    while k < n:
        C_prev = torch.cat([torch.ones_like(C[..., :k]), C[..., :-k]], -1)
        D_prev = torch.cat([torch.zeros_like(D[..., :k]), D[..., :-k]], -1)
        C, D = C_prev * C, C * D_prev + D
        k *= 2
    return C, D


def goursat_tile(inc, top, left, corner):
    """Solve a Goursat tile with given boundaries.

    inc: [..., bs, bt] increments for u-rows r_1..r_bs × u-cols c_1..c_bt;
    top: [..., bt] = u[r_0, c_1..c_bt]; left: [..., bs] = u[r_1..r_bs, c_0];
    corner: [...] = u[r_0, c_0].

    Returns (tile [..., bs, bt], bottom [..., bt]) where tile[i, j] =
    u[r_{i+1}, c_{j+1}] and bottom is its last row. Column by column, the
    column is the recurrence u[i] = c_i u[i−1] + d_i from u[−1] = top[j],
    solved by :func:`_linear_scan`."""
    prev, prev_top = left, corner
    cols = []
    for j in range(inc.shape[-1]):
        c = 1.0 + 0.5 * inc[..., j]
        shifted = torch.cat([prev_top[..., None], prev[..., :-1]], dim=-1)
        C, D = _linear_scan(c, prev * c - shifted)
        t = top[..., j]
        prev, prev_top = C * t[..., None] + D, t
        cols.append(prev)
    tile = torch.stack(cols, dim=-1)
    return tile, tile[..., -1, :]


def goursat_corner_seq_sharded(inc, mesh, col_block=None):
    """u(S, T) with the s axis split over the mesh's ``data`` axis.

    inc: [..., S, T], the whole grid on every rank, S divisible by the data
    size (each rank reads its rows). Returns [...] on every rank. Values
    only: no gradient flows through the collectives."""
    P = mesh.data
    S, T = inc.shape[-2], inc.shape[-1]
    if S % P:
        raise ValueError(f"S={S} not divisible by {P} ranks")
    bs = S // P
    bt = col_block or max(1, T // P)
    # pad T to a multiple of bt with zero increments (an exact no-op)
    Tp = -(-T // bt) * bt
    if Tp != T:
        inc = torch.nn.functional.pad(inc, (0, Tp - T))
    Q = Tp // bt
    p = mesh.data_index
    batch = inc.shape[:-2]
    started = dist.is_initialized()
    with torch.no_grad():
        mine = inc[..., p * bs:(p + 1) * bs, :]
        ones_bt = inc.new_ones(batch + (bt,))
        left, corner = inc.new_ones(batch + (bs,)), inc.new_ones(batch)
        halo, bottom = ones_bt, ones_bt
        result = inc.new_zeros(batch)
        for k in range(P + Q - 1):
            q = k - p  # my column block this superstep
            if 0 <= q < Q:
                # rank 0's top is the u ≡ 1 boundary; the others' the halo
                top = ones_bt if p == 0 else halo
                tile, bottom = goursat_tile(
                    mine[..., q * bt:(q + 1) * bt], top, left, corner)
                left, corner = tile[..., :, -1], top[..., -1]
                if p == P - 1 and q == Q - 1:
                    result = tile[..., -1, -1].clone()
            if started and P > 1:
                # my bottom row to rank p + 1: my slot, theirs is p − 1's
                slots = inc.new_zeros((P,) + batch + (bt,))
                slots[p] = bottom
                dist.all_reduce(slots, group=mesh.data_group)
                halo = slots[p - 1] if p > 0 else ones_bt
        if started:
            # every rank holds 0 but the last
            dist.all_reduce(result, group=mesh.data_group)
    return result
