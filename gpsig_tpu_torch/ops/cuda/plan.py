"""Launch plans of the truncated-kernel DPs: how a pair's rows are spread
over threads, and the shared memory each launch takes.

Every truncated kernel (``csrc/fused_gram*.cu``, ``csrc/sig_gram*.cu``)
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
would not fit); past what one warp takes, the block design.

The Kuf kernels (``csrc/tens_seq*.cu*``) take any L and every d: their
plans (:func:`kuf_fwd_plan`, :func:`kuf_bwd_plan`) say which kernel runs
(the order-1 pair, whose factor points are 16-byte records, the forward
where they fit the shared memory and the backward up to d = 3; past that
the general pair at order 1), how its work is spread (threads a block,
sequences a thread, pairs a warp), and where the general kernels'
per-thread arrays live, in shared memory where they fit, else in global
memory and a device workspace.

The wrappers compute the plan and the bytes here, pass the plan to the
kernel, and raise ``ValueError`` above what a launch can take: more than
``MAX_ROWS`` rows, or more shared memory than a block may use (a Kuf
backward: more workspace than ``KUF_WORKSPACE_BYTES`` for one block).
Nothing here needs a card.
"""

from __future__ import annotations

#: most warps one pair's block takes (256 threads: registers stay uncapped)
MAX_WARPS = 8
#: most rows a pair may have: MAX_WARPS warps of 32 lanes at 4 rows a lane
MAX_ROWS = 32 * MAX_WARPS * 4
#: shared memory one block may use on Hopper (opt-in above 48 KB)
SMEM_BYTES = 227 * 1024
#: warps per block when one warp takes a pair
PAIRS_PER_BLOCK = 4


def row_plan(rows, rows_per_lane=(2, 4)):
    """(W, R) for ``rows`` DP rows: one warp (W = 1) at the fewest rows
    per lane of ``rows_per_lane`` that covers them up to 128 rows; above,
    W = ceil(rows / 128) warps at 4 rows a lane. None above
    ``MAX_ROWS``."""
    if rows <= 128:
        return 1, min(r for r in rows_per_lane if 32 * r >= rows)
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
    and the exchange buffer."""
    if W > 1:
        return itemsize * L * (d + 1) * 2 + exchange_bytes(W, itemsize)
    x = (R + 1) * d * S
    staged = itemsize * (x + 128 // S * ((L * (d + 1)) | 1))
    return (staged if staged <= SMEM_BYTES
            else itemsize * (x + 128 // S * (L | 1)))


def exchange_bytes(W, itemsize):
    """The cross-warp exchange buffer of a W-warp group: two halves of one
    value a warp (common.cuh's BlockGroup)."""
    return itemsize * 2 * W if W > 1 else 0


def diag_smem(L, d, W, itemsize):
    """fused_gram.cu's diagonal: one sequence per pair."""
    pairs = PAIRS_PER_BLOCK if W == 1 else 1
    return itemsize * L * (d + 1) * pairs + exchange_bytes(W, itemsize)


def gram_ho_bwd_smem(L, d, W, chunk, itemsize):
    """fused_gram_ho_bwd.cuh: x staged once; per pair y, X̄ sums [L][d + 1],
    the k and dk/dacc tiles of ``chunk`` + 1 columns and the u tile of
    ``chunk`` columns at an odd row stride."""
    pairs = PAIRS_PER_BLOCK if W == 1 else 1
    per_pair = 2 * L * (d + 1) + 2 * (chunk + 1) * L + chunk * (L | 1)
    return (itemsize * (L * (d + 1) + pairs * per_pair)
            + exchange_bytes(W, itemsize))


def gram_ho_bwd_chunk(L, d, W, itemsize):
    """Columns per tile of the general Gram backward: 8 when a warp takes
    a pair, else the most of 8, 4, 2 that fits the block's shared
    memory."""
    if W == 1:
        return 8
    for chunk in (8, 4, 2):
        if gram_ho_bwd_smem(L, d, W, chunk, itemsize) <= SMEM_BYTES:
            return chunk
    return 2


def sig_gram_smem(W, itemsize):
    """sig_gram.cu, sig_gram_bwd.cu: nothing staged."""
    return exchange_bytes(W, itemsize)


def gram_bwd_plan(L):
    """(S, W) of fused_gram_bwd.cu for L - 1 rows at 4 rows a lane:
    segments of S = 16 lanes (two pairs to a warp) up to 64 rows, one warp
    to 128, W warps above. None above ``MAX_ROWS``."""
    rows = L - 1
    if rows <= 64:
        return 16, 1
    plan = row_plan(rows)
    return None if plan is None else (32, plan[0])


def gram_bwd_smem(L, d, S, W, chunk, itemsize):
    """fused_gram_bwd.cu: x staged once; per pair y, X̄ sums [L][d + 1] and
    a tile of u = K̄ ⊙ ∂k for ``chunk`` columns at an odd row stride."""
    pairs = 128 // S if W == 1 else 1
    stride = L | 1
    per_pair = 2 * L * (d + 1) + chunk * stride
    return (itemsize * (L * (d + 1) + pairs * per_pair)
            + exchange_bytes(W, itemsize))


def gram_bwd_chunk(L, d, S, W, itemsize):
    """Columns per u tile: 8 when a warp or less takes a pair (the smaller
    tile leaves room for more blocks an SM), else the most of 32, 16, 8
    that fits the block's shared memory."""
    if W == 1:
        return 8
    for chunk in (32, 16, 8):
        if gram_bwd_smem(L, d, S, W, chunk, itemsize) <= SMEM_BYTES:
            return chunk
    return 8


#: the sig_gram kernels' level bound (num_levels + 1 <= 128, as the JAX
#: sig_gram kernels take) and, past the register path's 7 levels, their
#: order bound: p = min(order, num_levels) <= 3
SIG_GRAM_MAX_LEVELS = 127
REGISTER_LEVELS = 7
DEEP_MAX_ORDER = 3
#: the deep path's workspace: at most this many bytes, and at most this many
#: blocks in flight (the grid strides over the remaining pairs)
DEEP_WORKSPACE_BYTES = 1 << 30
DEEP_MAX_BLOCKS = 4 * 132


def deep_slots(nl, p, backward):
    """Values a DP row keeps in memory on the deep path
    (``csrc/deep_levels.cuh``): the forward's carries nl + (nl-1)(p-1),
    and for the backward the rebuilt states, scans and reverse carries,
    (nl-1)(p² + 2p) more."""
    fwd = nl + (nl - 1) * (p - 1)
    return fwd + (nl - 1) * (p * p + 2 * p) if backward else fwd


def deep_plan(B, rows, nl, p, itemsize, backward):
    """The deep path's launch for B matrices of ``rows`` DP rows: a dict
    of the row plan (W, R), the per-pair state elements, the grid
    (``blocks``) and ``work`` elements of device workspace (0 when the
    block's pairs fit shared memory, ``smem`` bytes). None above
    ``MAX_ROWS``."""
    wr = row_plan(rows)
    if wr is None:
        return None
    W, R = wr
    pairs = PAIRS_PER_BLOCK if W == 1 else 1
    per_pair = deep_slots(nl, p, backward) * R * 32 * W
    smem = exchange_bytes(W, itemsize) + pairs * per_pair * itemsize
    blocks = -(-B // pairs)
    plan = dict(W=W, R=R, per_pair=per_pair, blocks=blocks, work=0,
                smem=smem)
    if smem > SMEM_BYTES:
        blocks = max(1, min(blocks, DEEP_MAX_BLOCKS, DEEP_WORKSPACE_BYTES
                            // (pairs * per_pair * itemsize)))
        plan.update(blocks=blocks, work=blocks * pairs * per_pair,
                    smem=exchange_bytes(W, itemsize))
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

#: the Kuf backwards' workspace: at most this many bytes, at most this many
#: blocks in flight (the grid strides over the remaining work items)
KUF_WORKSPACE_BYTES = 1 << 30
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
    KUF_WORKSPACE_BYTES, 4 warps a block (fewer below 4 sequences: a
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
        if per_block * itemsize > KUF_WORKSPACE_BYTES:
            return None
        blocks = max(1, min(items, KUF_MAX_BLOCKS,
                            KUF_WORKSPACE_BYTES // (per_block * itemsize)))
        plan.update(staged=False, blocks=blocks, work=blocks * per_block,
                    smem=itemsize * F2)
    return plan


def check_kuf(name, plan, what):
    """Raise ValueError where a Kuf backward has no plan: one block's
    columns would exceed the workspace bound."""
    if plan is None:
        raise ValueError(
            f"{name}: {what} needs more than {KUF_WORKSPACE_BYTES} bytes of "
            "workspace for one block's partial sums; the kernels take at most "
            "that")


def check_fits(name, rows, plan, smem, what):
    """Raise ValueError when a launch cannot take the shape: no plan for
    ``rows`` rows, or ``smem`` bytes of shared memory above the block's
    budget. ``what`` names the shape in the message."""
    if plan is None:
        raise ValueError(
            f"{name}: {what} gives {rows} DP rows; the kernels take at most "
            f"{MAX_ROWS} ({MAX_WARPS} warps of 32 lanes at 4 rows a lane)")
    if smem > SMEM_BYTES:
        raise ValueError(
            f"{name}: {what} needs {smem} bytes of shared memory per block; "
            f"the kernels take at most {SMEM_BYTES}")
