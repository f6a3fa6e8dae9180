"""Launch plans of the truncated-kernel DPs: how a pair's rows are spread
over threads, and the shared memory each launch takes.

Every truncated kernel (``csrc/fused_gram*.cu``, ``csrc/sig_gram*.cu*``)
sweeps the columns of one pair's increment matrix with the rows spread
over a group of threads, R consecutive rows per thread. Up to 128 rows one
warp takes a pair (four pairs to a block), as the kernels always did;
above, a block of W warps takes one pair and the exclusive row scans cross
the warps through shared memory (``csrc/common.cuh``, ``BlockGroup``). The
order-1 Gram backward also puts two pairs on one warp, 16 lanes each, up
to 64 rows (``csrc/fused_gram_bwd.cu``). A block of warps takes 4 rows a
lane: fewer warps, fewer barriers.

The two Gram forwards (``csrc/fused_gram.cu``'s Gram, ``csrc/
fused_gram_ho.cu``) take segments instead (:func:`gram_fwd_plan`): S = 8,
16 or 32 lanes a pair, 32 / S pairs a warp, R = 8, 4 or 2 rows a lane as
the DP state fits the registers, so one warp takes up to 256 rows with no
barrier (at wide d the y read from global memory where a block's staged y
would not fit); past what one warp takes, the block design, which reads x
and y from global memory where staging them would not fit.

The Gram-side kernels take every d: where a sequence's values (or the
backwards' X̄ sums) do not fit a block's shared memory, the Gram forwards'
block design and both Gram backwards read x and y from global memory
(only half norms and tiles stay in shared memory), and the backwards sum
X̄ in a device workspace of at most ``WORKSPACE_BYTES`` with a
grid-strided launch (:func:`gram_bwd_launch`, :func:`gram_ho_bwd_launch`).
The order-1 diagonal (:func:`diag_plan`) takes every L and every d: its
segments hold one sequence each, and past one segment's rows the
sequence's rows go in bands, each column's carries passed from band to
band in shared memory or a workspace.
The Goursat forwards (:func:`goursat_fwd_plan`) take a pair on a segment
of lanes, and past one warp's rows in bands on a block of warps.

The Kuf kernels (``csrc/tens_seq*.cu*``) take any L and every d: their
plans (:func:`kuf_fwd_plan`, :func:`kuf_bwd_plan`) say which kernel runs
(the order-1 pair, whose factor points are 16-byte records, the forward
where they fit the shared memory and the backward up to d = 3; past that
the general pair at order 1), how its work is spread (threads a block,
sequences a thread, pairs a warp), and where the general kernels'
per-thread arrays live, in shared memory where they fit, else in global
memory and a device workspace.

The sig_gram kernels (:func:`sig_gram_plan`) take a matrix on a segment
of lanes up to what one warp holds and in bands of rows on a wavefront of
warps past it, so every L2: the kernel layer sends them every Gram past
``MAX_ROWS`` rows. Past order 7 a block takes a matrix with its rows'
state in shared memory, or in a workspace where it does not fit
(:func:`sig_gram_order_plan`).

The wrappers compute the plan and the bytes here, pass the plan to the
kernel, and raise ``ValueError`` above what a launch can take: more than
``MAX_ROWS`` rows on the fused Gram kernels themselves, more workspace
than ``WORKSPACE_BYTES`` for one matrix's band carries or, past order 7,
its rows' states (sig_gram) or one block's partial sums (a Kuf
backward). Nothing here needs a card.
"""

from __future__ import annotations

import functools
import math

#: most warps one pair's block takes (256 threads: registers stay uncapped)
MAX_WARPS = 8
#: most rows a pair may have: MAX_WARPS warps of 32 lanes at 4 rows a lane
MAX_ROWS = 32 * MAX_WARPS * 4
#: shared memory one block may use on Hopper (opt-in above 48 KB)
SMEM_BYTES = 227 * 1024
#: most bytes of device workspace a launch takes (the Gram backwards' X̄
#: sums, the diagonal's carries, the deep path's states, the Kuf
#: backwards' columns); the grid strides over what one pass does not take
WORKSPACE_BYTES = 1 << 30
#: warps per block when one warp takes a pair
PAIRS_PER_BLOCK = 4


def row_plan(rows):
    """(W, R) for ``rows`` DP rows: one warp (W = 1) at the fewest rows
    per lane of 2 and 4 that covers them up to 128 rows; above,
    W = ceil(rows / 128) warps at 4 rows a lane. None above
    ``MAX_ROWS``."""
    if rows <= 128:
        return 1, (2 if rows <= 64 else 4)
    if rows > MAX_ROWS:
        return None
    return -(-rows // 128), 4


#: 32-bit registers a lane of a segment plan may give to its rows' DP
#: state (``csrc/common.cuh``'s kSegStateRegs and seg_rows)
SEG_STATE_REGS = 128
#: lanes a pair on the segment plan
SEG_LANES = (8, 16, 32)


def gram_fwd_levels(P, nl, tuned=False):
    """The level bound NLM of the Gram forwards' DP state: 4 up to 4 levels
    for the order-1 kernel and for the run-length kernel at order 2, else
    7."""
    return 4 if nl <= 4 and (tuned or P == 2) else 7


def gram_fwd_rows_per_lane(P, nl, itemsize, tuned=False):
    """Rows a lane of a Gram forward's segment: the most of 8, 4, 2 whose
    DP state fits ``SEG_STATE_REGS`` 32-bit registers. The state a row is
    NLM carries for the order-1 kernel (``tuned``), and p² + NLM +
    (NLM - 1)(p - 1) values for the run-length DP at order p = ``P``."""
    nlm = gram_fwd_levels(P, nl, tuned)
    per_row = nlm if tuned else P * P + nlm + (nlm - 1) * (P - 1)
    regs = per_row * itemsize // 4
    return next((R for R in (8, 4) if R * regs <= SEG_STATE_REGS), 2)


def gram_fwd_plan(rows, L, d, P, nl, itemsize, tuned=False):
    """(S, R, W) of the Gram forwards for ``rows`` DP rows of sequences
    [L, d] at order p = ``P`` (``tuned``: the order-1 kernel) and ``nl``
    levels. One warp (W = 1) where a segment plan covers the rows and its
    shared memory (:func:`gram_fwd_smem`) fits: R =
    :func:`gram_fwd_rows_per_lane` rows a lane and the fewest lanes S of 8,
    16, 32 (32 only past order 3) with S·R >= rows, else a wider S (less
    x staged lane major); where the state takes only 2 rows a lane, 32
    lanes at 4 rows up to 128 rows. Otherwise the block design, W >= 2
    warps at 4 rows a lane. None above ``MAX_ROWS``."""
    R = gram_fwd_rows_per_lane(P, nl, itemsize, tuned)
    lanes = SEG_LANES if tuned or P <= 3 else (32,)
    plans = [(S, R) for S in lanes if S * R >= rows]
    if R == 2 and rows <= 32 * 4:
        plans.append((32, 4))
    for S, R in plans:
        if gram_fwd_smem(L, d, S, R, 1, itemsize) <= SMEM_BYTES:
            return S, R, 1
    if rows > MAX_ROWS:
        return None
    return 32, 4, max(2, -(-rows // 128))


def gram_fwd_smem(L, d, S, R, W, itemsize):
    """Shared memory of the Gram forwards: on the segment plan x staged lane
    major ((R + 1) points a lane) and each of the block's 128 / S pairs' y
    and half norms at an odd stride, or where those y do not fit only their
    half norms (the y then read from global memory; common.cuh's
    SegBlock::stages_y); on the block design x and y with their half norms
    and the exchange buffer, or where those do not fit only the half norms
    and the buffer (x and y then read from global memory)."""
    if W > 1:
        staged = itemsize * L * (d + 1) * 2 + exchange_bytes(W, itemsize)
        return (staged if staged <= SMEM_BYTES
                else itemsize * 2 * L + exchange_bytes(W, itemsize))
    x = (R + 1) * d * S
    staged = itemsize * (x + 128 // S * ((L * (d + 1)) | 1))
    return (staged if staged <= SMEM_BYTES
            else itemsize * (x + 128 // S * (L | 1)))


def exchange_bytes(W, itemsize):
    """The cross-warp exchange buffer of a W-warp group: two halves of one
    value a warp (common.cuh's BlockGroup)."""
    return itemsize * 2 * W if W > 1 else 0


def gram_ho_bwd_smem(L, d, W, chunk, itemsize, staged=True):
    """fused_gram_ho_bwd.cuh: x staged once; per pair y, X̄ sums [L][d + 1],
    the k and dk/dacc tiles of ``chunk`` + 1 columns and the u tile of
    ``chunk`` columns at an odd row stride. Unstaged (wide d): x's and each
    pair's y's half norms [L] and the tiles only (x and y read from global
    memory, the X̄ sums in the workspace)."""
    pairs = PAIRS_PER_BLOCK if W == 1 else 1
    seq = L * (d + 1) if staged else L
    per_pair = ((2 * seq if staged else L) + 2 * (chunk + 1) * L
                + chunk * (L | 1))
    return itemsize * (seq + pairs * per_pair) + exchange_bytes(W, itemsize)


def gram_ho_bwd_chunk(L, d, W, itemsize, staged=True):
    """Columns per tile of the general Gram backward: 8 when a warp takes
    a pair, else the most of 8, 4, 2 that fits the block's shared
    memory."""
    if W == 1:
        return 8
    for chunk in (8, 4, 2):
        if gram_ho_bwd_smem(L, d, W, chunk, itemsize, staged) <= SMEM_BYTES:
            return chunk
    return 2


def gram_ho_bwd_launch(N1, N2, rows, L, d, itemsize):
    """The general Gram backward's launch for ``rows`` DP rows of sequences
    [L, d]: a dict of the row plan (``W``, ``R``), ``chunk``, ``staged``,
    ``smem``, ``items`` (an x against a block's y), ``blocks`` and ``work``
    (X̄ sums' workspace elements, 0 when staged). None above
    ``MAX_ROWS``."""
    wr = row_plan(rows)
    if wr is None:
        return None
    W, R = wr
    pairs = PAIRS_PER_BLOCK if W == 1 else 1
    for staged in (True, False):
        chunk = gram_ho_bwd_chunk(L, d, W, itemsize, staged)
        smem = gram_ho_bwd_smem(L, d, W, chunk, itemsize, staged)
        if smem <= SMEM_BYTES:
            break
    return _gram_bwd_grid(dict(W=W, R=R, chunk=chunk, staged=staged,
                               smem=smem), N1, N2, pairs, L, d, itemsize)


#: the Gram backwards' X̄ workspace where their sums do not fit shared
#: memory: at most this many bytes (the grid strides over the rest)


def _gram_bwd_grid(plan, N1, N2, pairs, L, d, itemsize, chains=1):
    """Add the grid to a Gram backward's plan: one block an item (an x
    against ``pairs`` y) where staged; else as many blocks as the
    workspace of ``pairs`` X̄ sums [L][d + 1] a block takes within
    WORKSPACE_BYTES (at least one), striding over the items. With
    ``chains`` (the order-1 backward's chain axis) the grid is repeated a
    chain, ``blocks`` counts one chain's and ``work`` all chains' slots,
    within WORKSPACE_BYTES together."""
    items = N1 * -(-N2 // pairs)
    plan.update(items=items, blocks=items, work=0)
    if not plan["staged"]:
        per_block = pairs * L * (d + 1)
        blocks = max(1, min(items, WORKSPACE_BYTES
                            // (chains * per_block * itemsize)))
        plan.update(blocks=blocks, work=chains * blocks * per_block)
    return plan


def gram_bwd_plan(L):
    """(S, W) of fused_gram_bwd.cu for L - 1 rows at 4 rows a lane:
    segments of S = 16 lanes (two pairs to a warp) up to 64 rows, one warp
    to 128, W warps above. None above ``MAX_ROWS``."""
    rows = L - 1
    if rows <= 64:
        return 16, 1
    plan = row_plan(rows)
    return None if plan is None else (32, plan[0])


def gram_bwd_smem(L, d, S, W, chunk, itemsize, staged=True):
    """fused_gram_bwd.cu: x staged once; per pair y, X̄ sums [L][d + 1] and
    a tile of u = K̄ ⊙ ∂k for ``chunk`` columns at an odd row stride.
    Unstaged (wide d): x's and each pair's y's half norms [L] and the u
    tiles only (x and y read from global memory, the X̄ sums in the
    workspace)."""
    pairs = 128 // S if W == 1 else 1
    seq = L * (d + 1) if staged else L
    per_pair = (2 * seq if staged else L) + chunk * (L | 1)
    return itemsize * (seq + pairs * per_pair) + exchange_bytes(W, itemsize)


def gram_bwd_chunk(L, d, S, W, itemsize, staged=True):
    """Columns per u tile: 8 when a warp or less takes a pair (the smaller
    tile leaves room for more blocks an SM), else the most of 32, 16, 8
    that fits the block's shared memory."""
    if W == 1:
        return 8
    for chunk in (32, 16, 8):
        if gram_bwd_smem(L, d, S, W, chunk, itemsize, staged) <= SMEM_BYTES:
            return chunk
    return 8


def gram_bwd_launch(N1, N2, L, d, itemsize, chains=1):
    """The order-1 Gram backward's launch for sequences [L, d], for each of
    ``chains`` chains: a dict of ``S``, ``W`` (:func:`gram_bwd_plan`),
    ``chunk``, ``staged`` (x, y and the X̄ sums in shared memory; else read
    from global memory and summed in the workspace), ``smem``, ``items``,
    ``blocks`` (a chain) and ``work`` elements (all chains). None above
    ``MAX_ROWS``."""
    p = gram_bwd_plan(L)
    if p is None:
        return None
    S, W = p
    for staged in (True, False):
        chunk = gram_bwd_chunk(L, d, S, W, itemsize, staged)
        smem = gram_bwd_smem(L, d, S, W, chunk, itemsize, staged)
        if smem <= SMEM_BYTES:
            break
    return _gram_bwd_grid(dict(S=S, W=W, chunk=chunk, staged=staged,
                               smem=smem), N1, N2,
                          128 // S if W == 1 else 1, L, d, itemsize, chains)


# ---------------------------------------------------------------------------
# The order-1 diagonal (csrc/fused_diag.cuh). The segment design: a segment
# of S lanes at R rows a lane takes one sequence, 32 / S sequences a
# one-warp block, everything staged. The band design, past 256 rows or
# past the segment design's shared memory: 32 lanes at 8 rows a lane, the
# sequence's rows in bands of 256 on a block of W warps, a wavefront whose
# bands pass each column's carries (the running sums of the levels above,
# nl - 1 values a column) to the next.
# ---------------------------------------------------------------------------

#: warps a block of the band design at most (csrc/fused_diag.cuh's
#: kDiagBandWarps; the segment design's blocks are one warp, kDiagWarps)
DIAG_BAND_WARPS = 8
#: warps the segment design aims to launch before it takes fewer rows a
#: lane (16 a Hopper SM)
DIAG_TARGET_WARPS = 16 * 132
#: its rows a lane (float32; float64 takes 8 only) and the lanes each is
#: instantiated at (csrc/fused_diag.cuh's diag_by_plan)
DIAG_ROWS = {8: (8, 16, 32), 4: (16, 32), 2: (32,)}
#: what the band design stages (csrc/fused_diag.cuh's DiagStage): the
#: sequence and each warp's lanes' points, the lanes' points only,
#: nothing; the segment design stages all
DIAG_STAGE_ALL, DIAG_STAGE_OWN, DIAG_STAGE_NONE = 2, 1, 0


@functools.lru_cache(maxsize=256)
def diag_plan(N, L, d, nl, itemsize):
    """The order-1 diagonal's launch for N sequences [L, d]: a dict of
    ``S`` lanes and ``R`` rows a lane, ``W`` (0: the segment design; else
    the band design's warps a sequence), ``bands`` of 256 rows, ``stage``,
    ``carry_smem`` (the band design's ring of W carry buffers in shared
    memory; else in the workspace), ``smem`` bytes, ``blocks`` (the grid
    strides over the rest) and ``work`` (workspace elements).

    Up to 256 rows where the segment design's staging fits: at each R of
    DIAG_ROWS (float64: 8) the fewest lanes S that cover the rows, then the
    most rows a lane whose N S / 32 warps reach DIAG_TARGET_WARPS, else the
    fewest (the most warps). Otherwise the band design: the most staging
    (DIAG_STAGE_ALL, OWN, NONE), then the most warps up to min(bands,
    DIAG_BAND_WARPS), whose marks, staging, ring and level sums fit the
    shared memory; where none does, nothing staged and the ring in the
    workspace. Every L >= 2 and d >= 1 gets one. Cached a shape: the
    wrapper asks on every call."""
    rows = L - 1
    if rows <= 256:
        fits = [(next(S for S in lanes if S * R >= rows), R)
                for R, lanes in DIAG_ROWS.items()
                if lanes[-1] * R >= rows and (itemsize == 4 or R == 8)]
        S, R = next((sr for sr in fits
                     if N * sr[0] >= 32 * DIAG_TARGET_WARPS), fits[-1])
        smem = itemsize * 32 // S * (
            ((L * (d + 1)) | 1) + (R + 1) * d * S)
        if smem <= SMEM_BYTES:
            return dict(S=S, R=R, W=0, bands=1, stage=DIAG_STAGE_ALL,
                        carry_smem=False, smem=smem,
                        blocks=-(-N // (32 // S)), work=0)
    bands = -(-rows // 256)
    ring = (nl - 1) * rows if bands > 1 else 0
    marks = 16 * -(-bands // 4)

    def smem_of(stage, W, carry_smem):
        seq = ((L * (d + 1)) | 1) if stage == DIAG_STAGE_ALL else 0
        own = 9 * d * 32 if stage != DIAG_STAGE_NONE else 0
        return marks + itemsize * (seq + W * (own + carry_smem * ring + 7))

    most = min(bands, DIAG_BAND_WARPS)
    plan = next((dict(stage=stage, W=W, carry_smem=True,
                      smem=smem_of(stage, W, True))
                 for stage in (DIAG_STAGE_ALL, DIAG_STAGE_OWN,
                               DIAG_STAGE_NONE)
                 for W in range(most, 0, -1)
                 if smem_of(stage, W, True) <= SMEM_BYTES),
                dict(stage=DIAG_STAGE_NONE, W=most, carry_smem=False,
                     smem=smem_of(DIAG_STAGE_NONE, most, False)))
    plan.update(S=32, R=8, bands=bands, blocks=N, work=0)
    plan["carry_smem"] = plan["carry_smem"] and bands > 1
    if bands > 1 and not plan["carry_smem"]:
        per_block = plan["W"] * ring
        blocks = max(1, min(N, WORKSPACE_BYTES // (per_block * itemsize)))
        plan.update(blocks=blocks, work=blocks * per_block)
    return plan



# ---------------------------------------------------------------------------
# The Goursat forwards (csrc/goursat.cu): a segment of S lanes at RL refined
# rows a lane takes one pair, 32 / S pairs a one-warp block; past 256
# refined rows the rows go in bands of 256 on a block of up to
# GOURSAT_BAND_WARPS warps a pair.
# ---------------------------------------------------------------------------

#: lanes a pair of the segment design, and warps a banded pair at most
#: (csrc/goursat.cu's kFwdBandWarps)
GOURSAT_LANES = (4, 8, 16, 32)
GOURSAT_BAND_WARPS = 8
#: where a lane may read its cells from column tiles, the segment design
#: stages its warp's pairs instead only where this many of its one-warp
#: blocks fit an SM's shared memory (fewer warps an SM cannot hide the
#: sweep's latency; the tiles take less shared memory): 8 where the tiles
#: fill in 16-byte copies (rows of whole 16-byte vectors), 4 where in 8- or
#: 4-byte ones
GOURSAT_STAGE_BLOCKS = {16: 8, 8: 4, 4: 4}
#: steps a lane's tile spans where the segment design reads its cells in
#: 16-byte vectors of columns (csrc/goursat.cu's kColSteps)
GOURSAT_COL_STEPS = 4


def goursat_copy_width(Tu, itemsize):
    """Bytes a copy of the column tiles takes on rows of Tu values
    (csrc/goursat.cu's goursat_cols, for data aligned as allocated): 16
    where the rows are whole 16-byte vectors, else 8 where they are whole
    8-byte ones, else a value."""
    row = Tu * itemsize
    return 16 if row % 16 == 0 else 8 if row % 8 == 0 else itemsize


@functools.lru_cache(maxsize=256)
def goursat_fwd_plan(Su, Tu, dyadic_order, itemsize):
    """The Goursat forwards' launch for a [Su, Tu] pair at dyadic order o:
    a dict of the refined rows a lane (``RL``: 2, 4 or 8, at least 2^o up
    to 8), the lanes a pair (``S``), ``bands``, warps a block (``W``),
    ``stage`` (the increments in shared memory), ``cols`` (unstaged, read
    in 16-byte vectors of columns), ``bnd_smem`` (the bands' bottom rows in
    shared memory, else in a workspace of W (C + 1) values a pair) and
    ``smem`` bytes. Up to 256 refined rows (R, the shorter side) one
    segment: the fewest RL, then the fewest S of GOURSAT_LANES with
    S·RL >= R, 32 / S pairs a one-warp block. On a given grid (o = 0)
    whose rows lie along memory (Su <= Tu), ``cols`` (two tiles a lane of
    RL rows x GOURSAT_COL_STEPS 16-byte vectors of columns in shared
    memory, which the warp fills with coalesced copies) unless
    GOURSAT_STAGE_BLOCKS staged blocks fit the shared memory at the rows'
    copy width; otherwise staged where one fits, else a value a lane a step
    through the cache.
    Past that S = 32, RL = 8, bands of 256
    rows and a block of W = min(bands, GOURSAT_BAND_WARPS) warps a pair,
    its W bottom rows and 16-byte steps of progress marks in shared memory
    where they fit, the increments staged where they still fit."""
    R, C = sorted((Su << dyadic_order, Tu << dyadic_order))
    cells = Su * Tu
    least = min(8, max(2, 1 << dyadic_order))
    for RL in (r for r in (2, 4, 8) if r >= least):
        S = next((s for s in GOURSAT_LANES if s * RL >= R), None)
        if S:
            block = 32 // S * cells * itemsize
            cols = (dyadic_order == 0 and Su <= Tu
                    and GOURSAT_STAGE_BLOCKS[goursat_copy_width(Tu, itemsize)]
                    * block > SMEM_BYTES)
            stage = not cols and block <= SMEM_BYTES
            tiles = 2 * 32 * (RL * GOURSAT_COL_STEPS + 1) * 16
            return dict(RL=RL, S=S, bands=1, W=1, stage=stage, cols=cols,
                        bnd_smem=False,
                        smem=block if stage else tiles if cols else 0)
    bands = -(-R // 256)
    W = min(bands, GOURSAT_BAND_WARPS)
    marks = 16 * -(-bands // 4)
    bnd = W * (C + 1) * itemsize
    bnd_smem = marks + bnd <= SMEM_BYTES
    smem = marks + (bnd if bnd_smem else 0)
    stage = smem + cells * itemsize <= SMEM_BYTES
    return dict(RL=8, S=32, bands=bands, W=W, stage=stage, cols=False,
                bnd_smem=bnd_smem,
                smem=smem + (cells * itemsize if stage else 0))

# ---------------------------------------------------------------------------
# sig_gram (csrc/sig_gram.cuh, csrc/sig_gram_bwd.cuh): a segment of S lanes
# at R rows a lane takes one matrix, 32 / S matrices a warp, four warps a
# block, up to what one warp holds (S R >= L2); past it the rows go in
# bands of 32 R on a wavefront of up to SIG_GRAM_BAND_WARPS warps, a block
# a matrix, the bands passing each column's scan carries through shared
# memory or a device workspace.
# ---------------------------------------------------------------------------

#: the sig_gram kernels' level bound (num_levels + 1 <= 128, as the JAX
#: sig_gram kernels take) and the templated paths' order bound (p =
#: min(order, num_levels) <= 7, csrc/deep_levels.cuh's kDeepOrder); past it
#: the run-time-order instance (:func:`sig_gram_order_plan`)
SIG_GRAM_MAX_LEVELS = 127
SIG_GRAM_MAX_ORDER = 7
REGISTER_LEVELS = 7
#: warps a banded matrix at most, and the deep path's rows a lane
#: (csrc/sig_gram.cuh's kSgBandWarps, kSgDeepRows)
SIG_GRAM_BAND_WARPS = 8
SIG_GRAM_DEEP_ROWS = 2
#: blocks in flight at most where the states go to the workspace (the grid
#: strides over the remaining matrices)
SIG_GRAM_MAX_BLOCKS = 4 * 132
#: warps the sig_gram forward's segments aim to launch before they take
#: fewer rows a lane on more lanes (16 a Hopper SM, as DIAG_TARGET_WARPS)
SIG_GRAM_TARGET_WARPS = 16 * 132
#: 32-bit registers a lane of the sig_gram kernels gives to its rows' DP
#: state (csrc/sig_gram.cuh's kSgStateRegs: above SEG_STATE_REGS, so that
#: order 3 at 4 levels takes 8 rows a lane and L' = 149 one warp)
SIG_GRAM_STATE_REGS = 160


def deep_slots(nl, p, backward):
    """Values a DP row keeps in memory on the deep path
    (``csrc/deep_levels.cuh``): the forward's carries nl + (nl-1)(p-1),
    and for the backward the rebuilt states, scans and reverse carries,
    (nl-1)(p² + 2p) more."""
    fwd = nl + (nl - 1) * (p - 1)
    return fwd + (nl - 1) * (p * p + 2 * p) if backward else fwd


def sig_gram_levels_bound(nl):
    """The register path's level bound NLM: 4 up to 4 levels, else 7."""
    return 4 if nl <= 4 else 7


def sig_gram_rows_per_lane(p, nl, itemsize, backward):
    """Rows a lane of the sig_gram kernels: past REGISTER_LEVELS levels
    SIG_GRAM_DEEP_ROWS; else the most of 8, 4, 2 whose DP state fits
    SIG_GRAM_STATE_REGS 32-bit registers at the level bound NLM: p² + NLM +
    (NLM - 1)(p - 1) values a row, and for the backward (NLM - 1)(p² + 2p)
    + p² + p more (``csrc/sig_gram.cuh``'s sg_rows)."""
    if nl > REGISTER_LEVELS:
        return SIG_GRAM_DEEP_ROWS
    nlm = sig_gram_levels_bound(nl)
    per_row = p * p + nlm + (nlm - 1) * (p - 1)
    if backward:
        per_row += (nlm - 1) * (p * p + 2 * p) + p * p + p
    regs = per_row * itemsize // 4
    return next((R for R in (8, 4) if R * regs <= SIG_GRAM_STATE_REGS), 2)


def sig_gram_carries(nl, p):
    """Row scans a column takes (level m >= 2 takes min(p, m)): the carries
    a band leaves a column in each pass (``csrc/sig_gram.cuh``'s
    sg_carries)."""
    return sum(min(p, m) for m in range(2, nl + 1))


#: warps a block of the run-time-order instance at most
#: (csrc/sig_gram_order.cuh's kOrderWarps)
SIG_GRAM_ORDER_WARPS = 8
#: the H100's L2 cache: the run-time-order instance's workspace route keeps
#: the regions of the blocks in flight within it where one region fits
ORDER_L2_BYTES = 50 * 1024 * 1024
#: SMs of an H100: a block an SM where one workspace region exceeds the L2
ORDER_SMS = 132
#: the order of the run-time-order instance's register route
#: (csrc/sig_gram_order.cuh's kOrderRegP)
ORDER_REGISTER_P = 8
#: an H100 SM's limits on resident blocks: blocks, warps, shared memory
#: (bytes) and the shared memory the card reserves a block
ORDER_SM_BLOCKS = 32
ORDER_SM_WARPS = 64
ORDER_SM_SMEM = 228 * 1024
ORDER_BLOCK_SMEM_RESERVED = 1024
#: the most bytes a matrix's checkpoints of every column may take in the
#: backward (csrc/sig_gram_order.cuh's kOrderCkptAllBytes): up to it no
#: column is recomputed
ORDER_CKPT_ALL_BYTES = 1 << 20


def order_warps(L2):
    """Warps a block of the run-time-order instance: one DP row a thread up
    to SIG_GRAM_ORDER_WARPS warps, the rows past them in chunks
    (``csrc/sig_gram_order.cuh``'s order_warps)."""
    return min(-(-L2 // 32), SIG_GRAM_ORDER_WARPS)


def _order_rsum(p, m):
    """Σ_{m'=2}^{m-1} (min(p, m') - 1): the packed carries of levels 2 ..
    m - 1."""
    if m - 1 <= p:
        return (m - 2) * (m - 1) // 2
    return (p - 1) * p // 2 + (m - 1 - p) * (p - 1)


def _order_gsum(p, m):
    """Σ_{m'=1}^{m-1} min(p, m')²: the packed grids of levels 1 .. m - 1."""
    if m - 1 <= p:
        return (m - 1) * m * (2 * m - 1) // 6
    return p * (p + 1) * (2 * p + 1) // 6 + (m - 1 - p) * p * p


def order_slots(nl, p, backward, register=False):
    """Values a DP row keeps on the run-time-order instance, packed
    (``csrc/sig_gram_order.cuh``'s OrderLayout): level m's carries take
    min(p, m) - 1 slots, its grid min(p, m)². Forward: M's value, T_m's
    carries (nl - 1), the RA carries, p scan slots and one p x p grid
    updated in place. Backward: M's value and M̄'s sum, T_m's and the RA
    carries, E_m and CP_m, the grids of levels 1 .. nl - 1, the adjoint's
    carries Rtot (nl - 1) and Rrow, the diagonal pieces (p - 1)² in place,
    and two sets of the total, column and row pieces, 2p + 2(p - 1). The
    register route keeps only the carries over columns in memory, and in
    the backward E_m, CP_m and the grids."""
    R = _order_rsum(p, nl + 1)
    if register:
        return (nl - 1 + R if not backward else
                3 * (nl - 1) + 3 * R + _order_gsum(p, nl))
    if backward:
        return (2 + 3 * (nl - 1) + 3 * R + _order_gsum(p, nl)
                + (p - 1) ** 2 + 4 * p - 2)
    return 1 + (nl - 1) + R + p + p * p


def order_small(nl, p, W, register=False):
    """Values of the run-time-order block's small shared arrays: 1 / n,
    the warps' scan totals, the chunk carries and the level sums; the
    register route's scan totals and level sums
    (``csrc/sig_gram_order.cuh``'s order_small, order_reg_small)."""
    if register:
        return 2 * ORDER_REGISTER_P * W + nl * W
    return p + 2 + 2 * p * W + 2 * p + nl * W


def order_carries(nl, p):
    """A row's carries over columns: T_m's (nl - 1) and the RA carries."""
    return nl - 1 + _order_rsum(p, nl + 1)


def order_segments(L1, nl, p, L2, itemsize):
    """(K, segments): the backward's reverse sweep takes M's L1 columns in
    segments of K columns, the last one shorter where K does not divide L1:
    K = 1 (no column recomputed) where the carries before every column
    (:func:`order_carries` a row, L2 rows) take at most
    ORDER_CKPT_ALL_BYTES, else ceil(sqrt(L1)) (``csrc/sig_gram_order.cuh``'s
    order_seg_len)."""
    if L1 * order_carries(nl, p) * L2 * itemsize <= ORDER_CKPT_ALL_BYTES:
        return 1, L1
    K = math.isqrt(L1 - 1) + 1
    return K, -(-L1 // K)


def order_checkpoints(L1, nl, p, L2, itemsize):
    """Values a DP row keeps in the backward's checkpoint region: sets of
    its carries over columns (:func:`order_carries`), one a segment (the
    carries before its first column) and K - 1 for a segment's recomputed
    columns past its first (:func:`order_segments`;
    ``csrc/sig_gram_order.cuh``'s OrderCkpt)."""
    K, segments = order_segments(L1, nl, p, L2, itemsize)
    return (segments + K - 1) * order_carries(nl, p)


def order_resident(W, smem):
    """The most blocks of ``W`` warps and ``smem`` bytes of shared memory
    that ORDER_SMS SMs keep resident by warps, blocks and shared memory
    (registers may allow fewer: the kernel's launch takes the least of this
    and what the card reports)."""
    per_sm = min(ORDER_SM_BLOCKS, ORDER_SM_WARPS // W,
                 ORDER_SM_SMEM // (smem + ORDER_BLOCK_SMEM_RESERVED))
    return ORDER_SMS * max(per_sm, 1)


def sig_gram_order_plan(B, L1, L2, nl, p, itemsize, backward):
    """The run-time-order instance's launch (p > SIG_GRAM_MAX_ORDER): a
    block of ``W`` = :func:`order_warps` warps a matrix, a DP row a thread
    (rows past 32 W in chunks), its rows' slots (:func:`order_slots` a row,
    ``area`` elements a matrix). ``route`` "register" (``area_smem`` 2): p
    = ORDER_REGISTER_P and a row a thread, the grid and the adjoint's
    pieces in registers, the carries in shared memory, where they fit
    SMEM_BYTES. Else "smem": every slot in the block's shared memory after
    its small arrays, where they fit. Else "workspace": a region of
    ``area`` a block in the workspace. The forward's register and smem
    routes take a block a matrix; its workspace route as many blocks as
    the L2 holds regions (ORDER_L2_BYTES), where one region exceeds it
    ORDER_SMS, at most B and what WORKSPACE_BYTES holds, the grid striding
    over the rest.

    The backward on every route also keeps its checkpoints
    (:func:`order_checkpoints` a row, ``ckpt`` elements a matrix) in the
    workspace: a region a block of ``ckpt`` elements, after ``area`` on the
    workspace route; ``blocks`` at most what stays resident
    (:func:`order_resident`), what WORKSPACE_BYTES holds, and on the
    workspace route what the L2 holds as above. None where one matrix's
    region exceeds WORKSPACE_BYTES."""
    W = order_warps(L2)
    ckpt = (order_checkpoints(L1, nl, p, L2, itemsize) * L2 if backward
            else 0)

    def bounded(plan, region, blocks):
        if region * itemsize > WORKSPACE_BYTES:
            return None
        if backward:
            blocks = min(blocks, order_resident(W, plan["smem"]),
                         WORKSPACE_BYTES // (region * itemsize))
        blocks = min(B, blocks)
        plan.update(blocks=blocks, ckpt=ckpt, work=blocks * region)
        return plan

    if p == ORDER_REGISTER_P and L2 <= 32 * SIG_GRAM_ORDER_WARPS:
        area = order_slots(nl, p, backward, True) * L2
        smem = itemsize * (order_small(nl, p, W, True) + area)
        if smem <= SMEM_BYTES:
            return bounded(dict(S=32, R=1, bands=1, W=W, area=area,
                                area_smem=2, smem=smem, route="register"),
                           ckpt, B)
    area = order_slots(nl, p, backward) * L2
    small = order_small(nl, p, W) * itemsize
    plan = dict(S=32, R=1, bands=1, W=W, area=area, area_smem=True,
                smem=small + area * itemsize, route="smem")
    if plan["smem"] <= SMEM_BYTES:
        return bounded(plan, ckpt, B)
    region = (area + ckpt) * itemsize
    blocks = ORDER_L2_BYTES // region or min(ORDER_SMS,
                                             WORKSPACE_BYTES // region)
    plan.update(area_smem=False, smem=small, route="workspace")
    return bounded(plan, area + ckpt, blocks)


@functools.lru_cache(maxsize=512)
def sig_gram_plan(B, L1, L2, nl, p, itemsize, backward):
    """The sig_gram kernels' launch for B matrices [L1, L2] (L1 columns,
    L2 rows) at ``nl`` levels and order p = min(order, nl): a dict of ``S``
    lanes and ``R`` rows a lane (:func:`sig_gram_rows_per_lane`), ``bands``
    (1: the segment design) on ``W`` warps, ``area`` (elements: the band
    design's carries and states a matrix, the deep segments' states a
    segment), ``area_smem`` (the area in shared memory; else ``work``
    workspace elements), ``smem`` bytes and ``blocks``.

    Segments: the fewest S of 8, 16, 32 with S·R >= L2, four warps a
    block; the register path's forward may take fewer rows a lane (4, 2)
    on more lanes: the most rows a lane, then the fewest lanes, whose B S /
    32 warps reach SIG_GRAM_TARGET_WARPS, else the (S, R) that launches the
    most warps at the fewest rows a lane. Deep, each segment's slots
    (:func:`deep_slots`) in shared memory where the block's fit, else in
    the workspace, the grid bounded by it.
    Bands: ceil(L2 / 32 R) of them on W = min(bands, SIG_GRAM_BAND_WARPS)
    warps, the area (each boundary's prefix carries for every column, for
    the backward also its suffix carries, and each band's state slots) in
    shared memory after the marks (and the forward's level sums) where it
    fits, else in the workspace. None where one matrix's area exceeds
    WORKSPACE_BYTES. Past order SIG_GRAM_MAX_ORDER the run-time-order
    instance's plan (:func:`sig_gram_order_plan`). Cached a shape: the
    wrapper asks on every call."""
    if p > SIG_GRAM_MAX_ORDER:
        return sig_gram_order_plan(B, L1, L2, nl, p, itemsize, backward)
    R = sig_gram_rows_per_lane(p, nl, itemsize, backward)
    deep = nl > REGISTER_LEVELS
    S = next((S for S in SEG_LANES if S * R >= L2), None)
    if S is not None and not (deep or backward):
        fits = [(S, r) for r in (8, 4, 2) if r <= R for S in SEG_LANES
                if S * r >= L2]
        S, R = next((sr for sr in fits
                     if B * sr[0] >= 32 * SIG_GRAM_TARGET_WARPS),
                    max(fits, key=lambda sr: (sr[0], -sr[1])))
    if S is not None:
        segs = 32 * PAIRS_PER_BLOCK // S
        area = deep_slots(nl, p, backward) * S * R if deep else 0
        blocks = -(-B // segs)
        plan = dict(S=S, R=R, bands=1, W=1, area=area, area_smem=True,
                    smem=itemsize * segs * area, blocks=blocks, work=0)
        if plan["smem"] > SMEM_BYTES:
            blocks = max(1, min(blocks, SIG_GRAM_MAX_BLOCKS,
                                WORKSPACE_BYTES // (segs * area * itemsize)))
            plan.update(area_smem=False, smem=0, blocks=blocks,
                        work=blocks * segs * area)
        return plan
    bands = -(-L2 // (32 * R))
    W = min(bands, SIG_GRAM_BAND_WARPS)
    K = sig_gram_carries(nl, p)
    if deep:
        slots = deep_slots(nl, p, backward)
    elif backward:  # the end carries a band keeps between its passes
        nlm = sig_gram_levels_bound(nl)
        slots = nlm + (nlm - 1) * max(p - 1, 1)
    else:
        slots = 0
    area = ((2 if backward else 1) * (bands - 1) * L1 * K
            + bands * slots * R * 32)
    if area * itemsize > WORKSPACE_BYTES:
        return None
    fixed = 16 * -(-2 * bands // 4) + (0 if backward else W * nl * itemsize)
    plan = dict(S=32, R=R, bands=bands, W=W, area=area, area_smem=True,
                smem=fixed + area * itemsize, blocks=B, work=0)
    if plan["smem"] > SMEM_BYTES:
        blocks = max(1, min(B, SIG_GRAM_MAX_BLOCKS,
                            WORKSPACE_BYTES // (area * itemsize)))
        plan.update(area_smem=False, smem=fixed, blocks=blocks,
                    work=blocks * area)
    return plan


# ---------------------------------------------------------------------------
# Kuf: the inducing-tensor-vs-sequence kernels (csrc/tens_seq*.cu*). The
# order-1 forward (tens_seq.cuh) stages its factor points as 16-byte
# records, one with the half norm up to d = 3, and takes every d whose
# records fit the shared memory; the order-1 backward (tens_seq_bwd.cuh)
# takes d <= 3, x in registers. Past those the order-1 Kuf, which is the
# general one at order 1 (RBF or Linear, difference), runs on the general
# kernels. Where their per-thread arrays fit the block's shared memory they
# live there; past that the general kernels take them out of it (z read
# from global memory with warp-uniform loads, x from the global layout, the
# backward's Z̄ / X̄ partial sums in a device workspace whose size bounds a
# grid-strided launch). So every d that device memory holds gets a plan.
# ---------------------------------------------------------------------------

#: the Kuf backwards' blocks in flight at most, where their columns go to
#: the workspace (the grid strides over the remaining work items)
KUF_MAX_BLOCKS = 4 * 132
#: 32-bit registers a thread of the general Kuf forward gives to its
#: sequences' DP state (``csrc/tens_seq_general.cuh``'s kStateRegs)
KUF_STATE_REGS = 128
#: the general Kuf backward: lanes a pair (one warp) and DP points a lane,
#: so a chunk of the pair's time axis is KUF_LANES * KUF_POINTS points
KUF_LANES = 32
KUF_POINTS = 2
#: blocks the general backward aims to launch before a warp takes more than
#: one pair (8 a Hopper SM)
KUF_BWD_TARGET_BLOCKS = 8 * 132
#: the widest d whose (z, -|z|^2/2) is one 4-vector record
#: (``csrc/common.cuh``'s Rec4): the order-1 backward's widest
KUF_TUNED_MAX_D = 3
#: the order-1 backward's block: two warps (``csrc/tens_seq_bwd.cuh``'s
#: kThreads), and the blocks it aims to launch before a warp takes more
#: than one pair (32 a Hopper SM)
KUF_TUNED_BWD_THREADS = 64
KUF_TUNED_BWD_TARGET_BLOCKS = 32 * 132


def factor_count(nl, increments):
    """F2: the factor points of a tensor stack, F = nl(nl+1)/2 factors,
    each a pair of points with ``increments``."""
    F = nl * (nl + 1) // 2
    return 2 * F if increments else F


def kuf_fwd_seqs(nl, itemsize):
    """Sequences a thread of the general Kuf forward takes: the most of 4,
    2, 1 whose DP state (F previous factor values, F - nl running sums, nl
    level sums and the half norm, per sequence) fits ``KUF_STATE_REGS``
    32-bit registers (``csrc/tens_seq_general.cuh``'s tsg_seqs)."""
    F = nl * (nl + 1) // 2
    regs = (F + max(F - nl, 1) + nl + 1) * itemsize // 4
    return next((R for R in (4, 2) if R * regs <= KUF_STATE_REGS), 1)


def _fwd_threads(N, seqs):
    """The fewest threads of 32, 64, 128 whose ``seqs`` sequences each
    cover N (else 128)."""
    return next((t for t in (32, 64) if t * seqs >= N), 128)


def kuf_fwd_plan(N, F2, d, nl, itemsize, tuned=False):
    """The Kuf forwards' launch: a dict of the ``route`` ("tuned": the
    order-1 kernel; "general"), ``threads`` a block, ``seqs`` a thread,
    ``staged`` (the tensor's factors in shared memory; else read from
    global memory) and ``smem`` bytes. The order-1 kernel (``tuned``)
    stages the factors as 4-vector records (up to d = KUF_TUNED_MAX_D one
    a factor point with its half norm, past it ceil(d / 4) and the half
    norm: ``csrc/tens_seq.cuh``'s ts_smem), one sequence a thread, the
    fewest threads of 32, 64, 128 that cover N; where the records do not
    fit the shared memory it takes the general kernel's plan. The general
    one stages z alone, R = :func:`kuf_fwd_seqs` sequences a thread and the
    fewest threads that cover N; unstaged, only the factors' half norms
    stay in shared memory."""
    if tuned:
        smem = itemsize * F2 * (4 if d <= KUF_TUNED_MAX_D
                                else 4 * -(-d // 4) + 1)
        if smem <= SMEM_BYTES:
            return dict(route="tuned", threads=_fwd_threads(N, 1), seqs=1,
                        staged=True, smem=smem)
    seqs = kuf_fwd_seqs(nl, itemsize)
    threads = _fwd_threads(N, seqs)
    staged = itemsize * F2 * (d + 1) <= SMEM_BYTES
    return dict(route="general", threads=threads, seqs=seqs, staged=staged,
                smem=itemsize * F2 * ((d + 1) if staged else 1))


def kuf_bwd_columns(F2, d):
    """Values of one lane's partial sums in the general Kuf backward: the
    Z̄ sums F2 (d + 1) (each factor point's Σ u x and Σ u) and X̄ of its
    KUF_POINTS + 1 points, summed over the levels."""
    return F2 * (d + 1) + (KUF_POINTS + 1) * d


def _pairs_a_warp(T, N, warps, target):
    """Pairs a warp of a Kuf backward with ``warps`` warps a block: more
    than one only where the grid would otherwise exceed ``target``
    blocks."""
    per_t = -(-N // warps)
    return max(1, min(per_t, T * per_t // target))


def kuf_bwd_plan(T, N, F2, d, itemsize, tuned=False):
    """The Kuf backwards' launch: a dict of the ``route``, ``threads`` a
    block, ``ppw`` pairs a warp, ``staged``, ``smem`` bytes, ``items``
    (work items: a tensor against a block's sequences), ``blocks``
    launched and ``work`` workspace elements.

    Both kernels take a warp a pair. The order-1 kernel (``tuned``, d <=
    KUF_TUNED_MAX_D) takes blocks of two warps (KUF_TUNED_BWD_THREADS) and
    a 4-vector column a factor point a lane, ``ppw`` pairs a warp where the
    grid would otherwise exceed KUF_TUNED_BWD_TARGET_BLOCKS blocks; past
    that d it takes the general kernel's plan. The general kernel takes the
    most of 4, 2, 1 warps that the sequences fill and whose lanes' columns
    fit the shared memory, ``ppw`` past KUF_BWD_TARGET_BLOCKS blocks. Where
    no block's columns fit, they go to a workspace of at most
    WORKSPACE_BYTES, 4 warps a block (fewer below 4 sequences: a
    block's warps are a power of two), and the grid of at most
    KUF_MAX_BLOCKS blocks strides over the items. None where one block's
    columns exceed the workspace."""
    if tuned and d <= KUF_TUNED_MAX_D:
        nt = KUF_TUNED_BWD_THREADS
        ppw = _pairs_a_warp(T, N, nt // KUF_LANES,
                            KUF_TUNED_BWD_TARGET_BLOCKS)
        items = T * -(-N // (nt // KUF_LANES * ppw))
        return dict(route="tuned", threads=nt, ppw=ppw, staged=True,
                    smem=4 * itemsize * F2 * (1 + nt), items=items,
                    blocks=items, work=0)
    C = kuf_bwd_columns(F2, d)

    def smem(w):
        return itemsize * (F2 + C * KUF_LANES * w)

    fits = [w for w in (4, 2, 1) if w <= max(N, 1) and smem(w) <= SMEM_BYTES]
    warps = fits[0] if fits else next(w for w in (4, 2, 1) if w <= max(N, 1))
    ppw = _pairs_a_warp(T, N, warps, KUF_BWD_TARGET_BLOCKS)
    items = T * -(-N // (warps * ppw))
    plan = dict(route="general", threads=KUF_LANES * warps, ppw=ppw,
                staged=True, smem=smem(warps), items=items, blocks=items,
                work=0)
    if not fits:
        per_block = C * KUF_LANES * warps
        if per_block * itemsize > WORKSPACE_BYTES:
            return None
        blocks = max(1, min(items, KUF_MAX_BLOCKS,
                            WORKSPACE_BYTES // (per_block * itemsize)))
        plan.update(staged=False, blocks=blocks, work=blocks * per_block,
                    smem=itemsize * F2)
    return plan


def check_kuf(name, plan, what):
    """Raise ValueError where a Kuf backward has no plan: one block's
    columns would exceed the workspace bound."""
    if plan is None:
        raise ValueError(
            f"{name}: {what} needs more than {WORKSPACE_BYTES} bytes of "
            "workspace for one block's partial sums; the kernels take at most "
            "that")


def check_fits(name, rows, plan, smem, what):
    """Raise ValueError when a launch cannot take the shape: no plan for
    ``rows`` rows, or ``smem`` bytes of shared memory above the block's
    budget (no plan of this module gives that: each reads from global
    memory where staging would not fit). ``what`` names the shape in the
    message."""
    if plan is None:
        raise ValueError(
            f"{name}: {what} gives {rows} DP rows; the kernels take at most "
            f"{MAX_ROWS} ({MAX_WARPS} warps of 32 lanes at 4 rows a lane)")
    if smem > SMEM_BYTES:
        raise ValueError(
            f"{name}: {what} needs {smem} bytes of shared memory per block; "
            f"the kernels take at most {SMEM_BYTES}")
