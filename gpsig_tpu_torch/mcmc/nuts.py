"""Multinomial NUTS by iterative tree doubling, C chains as one batch.

Counterpart of ``gpsig_tpu/mcmc/nuts.py`` (see its docstring): multinomial
NUTS with the numpyro-style iterative tree doubling, checkpoint-based
U-turn detection (the stack ``ck_r`` / ``ck_csum`` and ``_ctz``) and a
fixed ``max_depth``, on flat parameter vectors.

The JAX package runs chains under ``jax.vmap``, whose ``while_loop`` keeps
running while any chain's condition holds and keeps a finished chain's
carry by a select. The port runs the C chains as one batch the same way:
every tensor here has the chain axis first (θ [C, D], log p [C]), each
leapfrog evaluates all C chains (so a target's kernels launch once a leaf,
at one shape), and a chain whose tree has stopped (turning, diverging, or
its subtree full) keeps its carry through ``torch.where``. The loops need
to know on the host whether any chain is still going: one read of the
chains' [C] mask a doubling and a leaf, counted in :data:`host_reads`.
Because chains that are still going sit at the same depth and leaf, the
checkpoint stack's indices, ``_ctz`` and the leaf parity are host integers
shared by them.

``logp_fn`` maps θ [C, D] to [C]; the gradient is one
``torch.autograd.grad`` of the sum, the chains being independent.
Evaluations are counted in :data:`evaluations`. Randomness comes from a
draw source (``mcmc/draws.py``): the momentum, per doubling the direction
and the merge uniform, per leaf the proposal uniform, drawn only for the
chains that are still going.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

#: host reads of the chains' "still going" mask, in doublings and leaves
host_reads = 0
#: logp-and-gradient evaluations (one a leaf, plus a sampler's first)
evaluations = 0


class NutsState(NamedTuple):
    theta: torch.Tensor  # [C, D]
    logp: torch.Tensor  # [C]
    grad: torch.Tensor  # [C, D]


class _TreeState(NamedTuple):
    # trajectory endpoints (left/right): position, momentum, grad
    theta_l: torch.Tensor
    r_l: torch.Tensor
    grad_l: torch.Tensor
    theta_r: torch.Tensor
    r_r: torch.Tensor
    grad_r: torch.Tensor
    # multinomial proposal
    theta_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_weight: torch.Tensor  # logsumexp of -energies in the tree
    # momentum sums for U-turn checks
    r_sum: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    # acceptance statistics (for dual averaging)
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor


def value_and_grad(logp_fn):
    """θ [C, D] → (log p [C], ∇ log p [C, D]), both detached."""

    def fn(theta):
        global evaluations
        with torch.enable_grad():
            th = theta.detach().requires_grad_()
            logp = logp_fn(th)
            (grad,) = torch.autograd.grad(logp.sum(), th)
        evaluations += 1
        return logp.detach(), grad

    return fn


def _read(mask):
    """The [C] bool mask on the host (one counted read)."""
    global host_reads
    host_reads += 1
    return mask.cpu().numpy()


def _select(mask, new, old):
    """Per chain: ``new`` where ``mask`` [C], else ``old`` (tuples of
    [C] and [C, D] tensors of one NamedTuple type)."""
    col = mask[:, None]
    return type(new)(*(torch.where(mask if a.ndim == 1 else col, a, b)
                       for a, b in zip(new, old)))


def _column(x):
    """[C] → [C, 1], to scale [C, D] rows."""
    return x[:, None]


def _leapfrog(logp_grad_fn, theta, r, grad, eps, inv_mass):
    """eps: [C, 1]; the rest [C, D] (log p [C])."""
    r_half = r + 0.5 * eps * grad
    theta_new = theta + eps * inv_mass * r_half
    logp_new, grad_new = logp_grad_fn(theta_new)
    r_new = r_half + 0.5 * eps * grad_new
    return theta_new, r_new, logp_new, grad_new


def _kinetic(r, inv_mass):
    return 0.5 * torch.sum(r * r * inv_mass, dim=-1)


def _is_turning(r_sum, r_first, r_last, inv_mass):
    """Generalised U-turn criterion on a trajectory segment, per chain."""
    v = inv_mass * r_sum
    return ((torch.sum(v * r_first, dim=-1) <= 0)
            | (torch.sum(v * r_last, dim=-1) <= 0))


def nuts_kernel(
    logp_fn: Callable,
    max_depth: int = 8,
    max_delta_energy: float = 1000.0,
):
    """Returns step(draws, state, step_size [C], inv_mass [C, D],
    phase="sampling") -> (state, info), every entry of info [C]."""
    logp_grad_fn = value_and_grad(logp_fn)

    def step(draws, state: NutsState, eps, inv_mass, phase="sampling"):
        theta = state.theta
        C, dim = theta.shape
        kw = dict(dtype=theta.dtype, device=theta.device)
        eps = _column(eps)
        z = torch.as_tensor(draws.momentum(phase, dim), **kw)
        r0 = z / torch.sqrt(inv_mass)
        energy0 = -state.logp + _kinetic(r0, inv_mass)
        zeros = torch.zeros(C, **kw)
        no = torch.zeros(C, dtype=torch.bool, device=theta.device)
        tree = _TreeState(
            theta_l=theta, r_l=r0, grad_l=state.grad,
            theta_r=theta, r_r=r0, grad_r=state.grad,
            theta_prop=theta, logp_prop=state.logp, grad_prop=state.grad,
            log_weight=zeros, r_sum=r0, turning=no, diverging=no,
            sum_accept=zeros, num_leaves=zeros,
        )
        for depth in range(max_depth):
            going = ~tree.turning & ~tree.diverging
            going_host = _read(going)
            if not going_host.any():
                break
            go_right, u_merge = draws.doubling(going_host)
            go_right = torch.as_tensor(go_right, device=theta.device)
            u_merge = torch.as_tensor(u_merge, **kw)
            sub = _build_subtree(
                logp_grad_fn, tree, depth, go_right, eps, inv_mass,
                energy0, max_depth, max_delta_energy, draws, going,
                going_host,
            )
            # multinomial merge of proposals (biased progressive sampling)
            accept_logp = sub.log_weight - torch.logaddexp(
                tree.log_weight, sub.log_weight)
            take_new = ((torch.log(u_merge) < accept_logp) & ~sub.turning
                        & ~sub.diverging)
            tn = _column(take_new)
            right = _column(go_right)
            theta_l = torch.where(right, tree.theta_l, sub.theta_l)
            r_l = torch.where(right, tree.r_l, sub.r_l)
            theta_r = torch.where(right, sub.theta_r, tree.theta_r)
            r_r = torch.where(right, sub.r_r, tree.r_r)
            r_sum = tree.r_sum + sub.r_sum
            turning_now = _is_turning(r_sum, r_l, r_r, inv_mass)
            valid_sub = ~sub.turning & ~sub.diverging
            new_tree = _TreeState(
                theta_l=theta_l, r_l=r_l,
                grad_l=torch.where(right, tree.grad_l, sub.grad_l),
                theta_r=theta_r, r_r=r_r,
                grad_r=torch.where(right, sub.grad_r, tree.grad_r),
                theta_prop=torch.where(tn, sub.theta_prop, tree.theta_prop),
                logp_prop=torch.where(take_new, sub.logp_prop,
                                      tree.logp_prop),
                grad_prop=torch.where(tn, sub.grad_prop, tree.grad_prop),
                log_weight=torch.logaddexp(
                    tree.log_weight,
                    torch.where(valid_sub, sub.log_weight,
                                torch.full_like(sub.log_weight,
                                                -float("inf")))),
                r_sum=r_sum,
                turning=sub.turning | turning_now,
                diverging=sub.diverging,
                sum_accept=tree.sum_accept + sub.sum_accept,
                num_leaves=tree.num_leaves + sub.num_leaves,
            )
            tree = _select(going, new_tree, tree)

        new_state = NutsState(tree.theta_prop, tree.logp_prop,
                              tree.grad_prop)
        accept_prob = tree.sum_accept / torch.clamp(tree.num_leaves, min=1.0)
        info = {
            "accept_prob": accept_prob,
            "diverging": tree.diverging,
            "num_leaves": tree.num_leaves,
            "energy": energy0,
        }
        return new_state, info

    return step


class _Carry(NamedTuple):
    theta: torch.Tensor
    r: torch.Tensor
    grad: torch.Tensor
    theta_first: torch.Tensor
    r_first: torch.Tensor
    grad_first: torch.Tensor
    theta_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_weight: torch.Tensor
    r_sum: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor


def _build_subtree(
    logp_grad_fn, tree, depth, go_right, eps, inv_mass, energy0,
    max_depth, max_delta_energy, draws, going, going_host,
):
    """Build a subtree of 2^depth leaves by sequential leapfrogs with
    checkpoint-based U-turn detection (numpyro-style iterative scheme),
    for the chains where ``going`` [C] (its host copy ``going_host``).

    Checkpoint stacks for even-leaf states. Even leaf i pushes (its
    momentum, the cumulative momentum sum *before* it); odd leaf i
    completes ctz(i+1) aligned subtrees whose leftmost leaves are the top
    ctz(i+1) stack entries: check the generalised U-turn criterion on each
    segment, then pop ctz(i+1) − 1 entries (the largest completed
    subtree's checkpoint stays as the open-prefix representative). The
    leaf index i and the stack's top are those of every chain still going,
    so they are host integers. The stack is written for every chain: a
    chain's is read only while it is going, and it is not part of the
    carry a stopped chain keeps."""
    num_leaves = 2 ** depth
    right = _column(go_right)
    direction = torch.where(right, 1.0, -1.0).to(tree.r_l.dtype)
    theta0 = torch.where(right, tree.theta_r, tree.theta_l)
    r0 = torch.where(right, tree.r_r, tree.r_l)
    grad0 = torch.where(right, tree.grad_r, tree.grad_l)
    C, dim = theta0.shape
    kw = dict(dtype=theta0.dtype, device=theta0.device)
    ck_r = torch.zeros((C, max_depth + 1, dim), **kw)
    ck_csum = torch.zeros_like(ck_r)
    no = torch.zeros(C, dtype=torch.bool, device=theta0.device)
    c = _Carry(
        theta=theta0, r=r0, grad=grad0,
        theta_first=theta0, r_first=r0, grad_first=grad0,
        theta_prop=theta0,
        logp_prop=torch.full((C,), -float("inf"), **kw),
        grad_prop=grad0,
        log_weight=torch.full((C,), -float("inf"), **kw),
        r_sum=torch.zeros_like(r0), turning=no, diverging=no, sum_accept=torch.zeros(C, **kw),
        num_leaves=torch.zeros(C, **kw),
    )
    ck_top = -1
    alive, alive_host = going, going_host
    for i in range(num_leaves):
        if i > 0:
            alive_host = _read(alive)
            if not alive_host.any():
                break
        u = torch.as_tensor(draws.leaf(alive_host), **kw)
        # going left = flip momentum, integrate forward, flip back
        theta, r, logp, grad = _leapfrog(
            logp_grad_fn, c.theta, direction * c.r, c.grad, eps, inv_mass)
        r = direction * r  # canonical orientation
        energy = -logp + _kinetic(r, inv_mass)
        delta = energy - energy0
        delta = torch.where(torch.isnan(delta),
                            torch.full_like(delta, float("inf")), delta)
        diverging = delta > max_delta_energy
        log_w = -delta
        accept = torch.minimum(torch.ones_like(delta), torch.exp(-delta))

        new_log_weight = torch.logaddexp(c.log_weight, log_w)
        take = torch.log(u) < (log_w - new_log_weight)
        tk = _column(take)

        first = i == 0
        csum_before = c.r_sum
        r_sum = c.r_sum + r

        if i % 2 == 0:  # even leaf: push
            ck_top += 1
            slot = min(max(ck_top, 0), max_depth)
            ck_r[:, slot] = r
            ck_csum[:, slot] = csum_before
            num_sub = 0
        else:
            num_sub = _ctz(i + 1, max_depth + 1)
        turning = c.turning
        for k in range(num_sub):
            idx = min(max(ck_top - k, 0), max_depth)
            seg_sum = r_sum - ck_csum[:, idx]
            turning = turning | _is_turning(seg_sum, ck_r[:, idx], r,
                                            inv_mass)
        ck_top -= max(num_sub - 1, 0)

        new = _Carry(
            theta=theta, r=r, grad=grad,
            theta_first=theta if first else c.theta_first,
            r_first=r if first else c.r_first,
            grad_first=grad if first else c.grad_first,
            theta_prop=torch.where(tk, theta, c.theta_prop),
            logp_prop=torch.where(take, logp, c.logp_prop),
            grad_prop=torch.where(tk, grad, c.grad_prop),
            log_weight=new_log_weight, r_sum=r_sum, turning=turning, diverging=c.diverging | diverging,
            sum_accept=c.sum_accept + accept,
            num_leaves=c.num_leaves + 1.0,
        )
        c = _select(alive, new, c)
        alive = alive & ~c.turning & ~c.diverging

    # endpoints in left/right orientation
    theta_l = torch.where(right, c.theta_first, c.theta)
    r_l = torch.where(right, c.r_first, c.r)
    grad_l = torch.where(right, c.grad_first, c.grad)
    theta_r = torch.where(right, c.theta, c.theta_first)
    r_r = torch.where(right, c.r, c.r_first)
    grad_r = torch.where(right, c.grad, c.grad_first)
    turning_total = c.turning | _is_turning(c.r_sum, r_l, r_r, inv_mass)
    return _TreeState(
        theta_l=theta_l, r_l=r_l, grad_l=grad_l,
        theta_r=theta_r, r_r=r_r, grad_r=grad_r,
        theta_prop=c.theta_prop, logp_prop=c.logp_prop,
        grad_prop=c.grad_prop,
        log_weight=c.log_weight, r_sum=c.r_sum,
        turning=turning_total, diverging=c.diverging,
        sum_accept=c.sum_accept, num_leaves=c.num_leaves,
    )


def _ctz(n, maxbits):
    """Count trailing zeros of a positive integer, looking at no more than
    ``maxbits`` bits (the JAX package's ``fori_loop`` over ``maxbits``)."""
    c, val = 0, int(n)
    for _ in range(maxbits):
        if val % 2 == 0:
            c, val = c + 1, val // 2
    return c
