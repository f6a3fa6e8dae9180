#!/usr/bin/env python3
"""Drive the PyTorch port (``gpsig_tpu_torch``) on one NVIDIA GPU and check
it end to end: slice 0 (the order-1 model, serving and training) and slice
1 (the general engines: order-2 SVGP and GPR, serving and training).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which ends the run with a non-zero exit on failure:

1. build: compile ``gpsig_tpu_torch/csrc/*.cu`` for sm_90a into
   ``gpsig_tpu_torch/.build/`` and load it;
2. kernels: each hand-written kernel (forward and backward) against its
   plain PyTorch version on the card, at the main path's shapes, in
   float32 and float64, with the tolerance and its reason printed; kernel
   and plain version timed with CUDA events (warm-up, then the median of
   7);
3. slice: the order-1 SVGP serving path at its flagship width (M=500
   inducing tensors with increments, nl=5, d=3, L=50, C=10 classes):
   ELBO on a batch of 50 out of 840, ``posterior()`` and ``predict_y`` on
   2048 test sequences, then exact GPR at the Gram benchmark's
   configuration (N=256, L=50, d=2, nl=4); the three kernels' launch
   counters must all rise; outputs must be finite, class probabilities
   sum to 1, variances >= 0; Kuf, the predictive means and the GPR
   outputs must agree with the same calls routed through the plain
   functions on the card; a small float64 model must agree with the CPU;
4. training: natgrad + Adam steps of the same flagship SVGP (B=50 of 840,
   Adam 1e-3, γ=0.1) and Adam steps on the GPR log marginal likelihood at
   BASELINE config 1 (N=150 of 200, L=50, d=2, nl=4, noise 0.05, Adam
   5e-2), float32; ELBO and lml finite at every step; all five kernels'
   launch counters must rise; the first step's gradients and parameters
   must agree with the same step routed through the plain functions on the
   card; ms per step by host clock; small float64 models' three steps must
   agree with the CPU;
5. slice 1: each general-engine kernel (``_ho_kernel``, ``_tsg_kernel``,
   the sig_gram ``_fwd_kernel`` and ``_fwd_kernel_ho``) against its plain
   version at the main path's shapes in float32 and float64, timed; a
   coverage sweep at small sizes over every base kind × ``difference`` ×
   order 1-3 (× ``increments`` for Kuf, plus num_levels 7, and lags with
   ARD through the kernel layer); the order-2 flagship SVGP serving path
   (M=500 inducing tensors with increments, nl=5, order 2, d=2, L=50,
   C=10, N_train=500: ELBO on 50, ``posterior()`` + ``predict_y`` on 2048,
   ``predict_y`` on the cached posterior) and exact GPR at BASELINE config
   1's width at order 2 (and at order 1 with a Poly base), each with its
   launch counters (the general kernels' must rise, the tuned order-1
   kernels' must not) and against the plain route; a small order-2 float64
   model on the card against the CPU;
6. slice 1 training: the four general backward kernels (``_ho_bwd_kernel``,
   ``_tsg_bwd_kernel``, the sig_gram ``_bwd_kernel`` and ``_bwd_kernel_ho``)
   against their plain versions at the training paths' shapes in float32
   and float64, timed; natgrad + Adam steps of the order-2 flagship SVGP
   (B=50 of 500, Adam 1e-3, γ=0.05) and Adam steps on the log marginal
   likelihood of the order-2 GPR and the order-1 Poly GPR (its offset
   trained) at BASELINE config 1's width, float32, each path with its
   launch counters (the general kernels and their backwards must rise,
   the tuned order-1 kernels must not), ELBO and lml finite at every step,
   the first step against the plain route, ms per step and a profiler
   split of the SVGP step; small order-2 float64 models' three steps
   against the CPU;
7. PDE kernels: the three Goursat routes (the given-grid wavefront
   ``_kernel``, ``_fused_kernel``'s forward with in-kernel refinement and
   its adjoint gradient) against their plain versions in float32 and
   float64 at (Su, Tu) in {(49, 49), (7, 49), (1, 1), (13, 5)} x dyadic
   order 0-2 and (199, 199) at orders 2 and 3, timed, with Gcell/s
   (refined cells per second) and bounds;
8. PDE serving: the SigGPDE SVGP of ``job_pde_train``
   (``scripts/validate_tpu.py``: untruncated Linear-base kernel,
   lengthscale 1.5, normalised, dyadic order 1, M=32 inducing sequences of
   length 8 with ``joint_psd``, MultiClass C=2, N=200 training sequences of
   L=50, d=2, float32): the ELBO on 50 under both ``joint_psd`` settings,
   ``posterior()`` + ``predict_y`` on 2048 test sequences, ``predict_y`` on
   the cached posterior, and one ``engine="scan"`` Kuf held against
   ``engine="auto"``; outputs finite, probabilities sum to 1, variances
   >= 0, against the plain route; the Goursat counters rise, no truncated
   kernel's does;
9. PDE training: 6 natgrad + Adam steps of the same model (B=50, Adam
   2e-3, γ=0.05), ELBO finite at every step, the adjoint counter rises, the
   first step against the plain route, ms per step and a profiler split;
   a small float64 SigGPDE model's three steps against the CPU;
10. report: one JSON line with every kernel's launches, error, times and
   bound, then the device line.

It imports nothing of JAX. Without a CUDA device, or without the package
beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# report key: kernel name, source, TPU kernel it replaces
KERNELS = {
    "gram": ("_fused_kernel", "gpsig_tpu_torch/csrc/fused_gram.cu",
             "gpsig_tpu/ops/pallas/fused_gram.py:146"),
    "diag": ("_diag_kernel", "gpsig_tpu_torch/csrc/fused_gram.cu",
             "gpsig_tpu/ops/pallas/fused_gram.py:330"),
    "tens_seq": ("_tens_seq_kernel", "gpsig_tpu_torch/csrc/tens_seq.cu",
                 "gpsig_tpu/ops/pallas/tens_seq.py:66"),
    "gram_bwd": ("_bwd_fused_kernel", "gpsig_tpu_torch/csrc/fused_gram_bwd.cu",
                 "gpsig_tpu/ops/pallas/fused_gram.py:631"),
    "tens_seq_bwd": ("_tens_seq_bwd_kernel",
                     "gpsig_tpu_torch/csrc/tens_seq_bwd.cu",
                     "gpsig_tpu/ops/pallas/tens_seq.py:281"),
    "gram_ho": ("_ho_kernel", "gpsig_tpu_torch/csrc/fused_gram_ho.cu",
                "gpsig_tpu/ops/pallas/fused_gram_ho.py:133"),
    "tsg": ("_tsg_kernel", "gpsig_tpu_torch/csrc/tens_seq_general.cu",
            "gpsig_tpu/ops/pallas/tens_seq_general.py:200"),
    "sig_gram": ("_fwd_kernel", "gpsig_tpu_torch/csrc/sig_gram.cu",
                 "gpsig_tpu/ops/pallas/sig_gram.py:80"),
    "sig_gram_ho": ("_fwd_kernel_ho", "gpsig_tpu_torch/csrc/sig_gram.cu",
                    "gpsig_tpu/ops/pallas/sig_gram.py:126"),
    "gram_ho_bwd": ("_ho_bwd_kernel",
                    "gpsig_tpu_torch/csrc/fused_gram_ho_bwd.cu",
                    "gpsig_tpu/ops/pallas/fused_gram_ho_bwd.py:61"),
    "tsg_bwd": ("_tsg_bwd_kernel",
                "gpsig_tpu_torch/csrc/tens_seq_general_bwd.cu",
                "gpsig_tpu/ops/pallas/tens_seq_general.py:364"),
    "sig_gram_bwd": ("_bwd_kernel", "gpsig_tpu_torch/csrc/sig_gram_bwd.cu",
                     "gpsig_tpu/ops/pallas/sig_gram.py:98"),
    "sig_gram_ho_bwd": ("_bwd_kernel_ho",
                        "gpsig_tpu_torch/csrc/sig_gram_bwd.cu",
                        "gpsig_tpu/ops/pallas/sig_gram.py:229"),
    "goursat": ("_kernel", "gpsig_tpu_torch/csrc/goursat.cu",
                "gpsig_tpu/ops/pallas/goursat_pallas.py:42"),
    "goursat_fused": ("_fused_kernel (forward)",
                      "gpsig_tpu_torch/csrc/goursat.cu",
                      "gpsig_tpu/ops/pallas/goursat_pallas.py:227"),
    "goursat_grad": ("_fused_kernel (with_grad)",
                     "gpsig_tpu_torch/csrc/goursat_bwd.cu",
                     "gpsig_tpu/ops/pallas/goursat_pallas.py:227"),
}
GOURSAT = ("goursat", "goursat_fused", "goursat_grad")
TUNED = ("gram", "diag", "tens_seq", "gram_bwd", "tens_seq_bwd")
# scaled error max|kernel - plain| / max|plain| allowed, per dtype
TOL = {
    "float32": (1e-4, "float32 exp and up-to-49-step DP sums, summed in "
                "another order than the plain version (about 100 ulp)"),
    "float64": (1e-11, "same arithmetic as the plain version, other "
                "summation order only"),
}
# the same for the general engines' forward kernels
GEN_TOL = {
    "float32": (3e-4, "float32 base kernels and DP sums, where a cell at "
                "order p sums up to p² run-length states and a degree-3 "
                "Poly base cubes its dot product's rounding"),
    "float64": (1e-10, "other summation order only"),
}
# the same for the backward kernels
BWD_TOL = {
    "float32": (1e-3, "float32 reverse sweep whose DP states are rebuilt by "
                "subtraction (each carries the rounding of every later "
                "column), summed with atomics in a run-dependent order"),
    "float64": (1e-10, "as float32, in float64"),
}


# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): FP32 outside
# the tensor cores, and HBM3
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def walks(rng, n, L, d):
    """Random-walk sequences [n, L, d], as the package's entry points use."""
    return (0.3 * rng.standard_normal((n, L, d))).cumsum(1)


def scaled_err(got, want):
    """max|got − want| / max|want|; for tuples, the worst component."""
    if isinstance(want, (tuple, list)):
        return max(scaled_err(g, w) for g, w in zip(got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


def abs_err(got, want):
    if isinstance(want, (tuple, list)):
        return max(abs_err(g, w) for g, w in zip(got, want))
    return (got - want).abs().max().item()


def counters():
    """The launch counters of all sixteen kernels."""
    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import goursat as gs
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    return dict(gram=fg.gram_launches, diag=fg.diag_launches,
                tens_seq=ts.launches, gram_bwd=fg.gram_bwd_launches,
                tens_seq_bwd=ts.bwd_launches, gram_ho=fgho.launches,
                tsg=tsg.launches, sig_gram=sg.launches,
                sig_gram_ho=sg.ho_launches, gram_ho_bwd=fgho.bwd_launches,
                tsg_bwd=tsg.bwd_launches, sig_gram_bwd=sg.bwd_launches,
                sig_gram_ho_bwd=sg.ho_bwd_launches, goursat=gs.launches,
                goursat_fused=gs.fused_launches,
                goursat_grad=gs.grad_launches)


def reset_counters():
    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import goursat as gs
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    fg.gram_launches = fg.diag_launches = fg.gram_bwd_launches = 0
    ts.launches = ts.bwd_launches = 0
    fgho.launches = tsg.launches = sg.launches = sg.ho_launches = 0
    fgho.bwd_launches = tsg.bwd_launches = 0
    sg.bwd_launches = sg.ho_bwd_launches = 0
    gs.launches = gs.fused_launches = gs.grad_launches = 0


# ---------------------------------------------------------------------------
# Work of each kernel on its inputs, for its bound: the operations its
# algorithm needs (an FMA counts 2, an exp or cos 1) over the FP32 peak,
# and its bytes (each input read once, each output written once) over the
# HBM rate; the larger is the least time the card could take. Counted per
# float32 value (the timed dtype).
# ---------------------------------------------------------------------------

def bound(ops, nbytes):
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def base_ops(d, kind):
    """One base-kernel value: the dot product (d FMAs), the half norms and
    the exp or cos where the kind has them."""
    return 2 * d + (3 if kind in ("rbf", "cosine") else 0)


def dp_cell_ops(nl, p):
    """The run-length column DP per increment-matrix entry at order p: at
    level m >= 2, R = min(p, m)² states each multiplied by M and added
    into the carries, and R prefix-scan adds; 1 at level 1."""
    return 1 + sum(2 * min(p, m) ** 2 + min(p, m) for m in range(2, nl + 1))


def dp_self_ops(n, nl, p):
    """The run-length column DP over one symmetric n × n increment matrix
    (a self-kernel's): state (r, s) is the transpose of state (s, r), so
    such a pair of states needs n² cells together and a state with r = s
    only its triangle n(n+1)/2; the prefix-scan adds are counted over the
    triangle. At p = 1 this is the triangle times dp_cell_ops."""
    tri = n * (n + 1) // 2
    ops = tri
    for m in range(2, nl + 1):
        R = min(p, m)
        ops += 2 * (R * tri + R * (R - 1) // 2 * n * n) + R * tri
    return ops


def gram_work(N1, N2, L, d, nl, p=1, kind="rbf", difference=True):
    """Gram (_fused_kernel, _ho_kernel): L² base values per pair, then
    (L-1)² increments (2 subtractions: along j, then along i) or L² raw
    entries through the DP."""
    rows = L - 1 if difference else L
    per_pair = (L * L * base_ops(d, kind)
                + rows * rows * (dp_cell_ops(nl, p) + 2 * difference))
    return per_pair * N1 * N2


def gram_self_work(N, L, d, nl, p=1, kind="rbf", difference=True):
    """Self-kernels (_diag_kernel): the base Gram of a sequence with itself
    is symmetric, and so are its increments, so a sequence needs L(L+1)/2
    base values, the triangle of increments and dp_self_ops."""
    rows = L - 1 if difference else L
    per_seq = (L * (L + 1) // 2 * base_ops(d, kind)
               + rows * (rows + 1) // 2 * 2 * difference
               + dp_self_ops(rows, nl, p))
    return per_seq * N


def kuf_dp_point_ops(nl, p):
    """The tensor-vs-sequence DP per sequence step: at level m, stage a has
    min(p, m, a+1) states, each a product and an accumulation."""
    return nl + sum(2 * min(p, m, a + 1) for m in range(1, nl + 1)
                    for a in range(1, m))


def kuf_work(T, F2, N, L, d, nl, p=1, kind="rbf", increments=True):
    F = F2 // 2 if increments else F2
    per_pair = (L * F2 * base_ops(d, kind)
                + (L - 1) * (F * (1 + increments) + kuf_dp_point_ops(nl, p)))
    return per_pair * T * N


def cuda_ms(fn, reps=7, warmup=2):
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=5, warmup=1):
    """Median milliseconds of ``fn()`` to completion on the card, by the
    host clock around a synchronize (for calls that sync internally)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def timed(fn):
    """(fn(), milliseconds to completion on the card by the host clock)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def profile_split(fn, label, reps=3):
    """Device time of ``fn()`` by ``torch.profiler`` (CPU and CUDA
    activities, ``reps`` calls after one warm-up): host wall per call
    inside the profiler, the device events' time per call, their ratio
    (the busy share) and the six device events with the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # the device's own events only: a host operation's self device time
    # repeats that of the kernels it launched
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=dev_us, reverse=True)
    device = sum(dev_us(e) for e in events) / 1e3 / reps
    if device == 0:
        print(f"profile {label}: device time not measured (the profiler "
              f"saw no device activity); wall {wall:.3f} ms")
        return
    top = ", ".join(f"{e.key[:48]} {dev_us(e) / 1e3 / reps:.3f} ms"
                    for e in events[:6])
    print(f"profile {label}: wall {wall:.3f} ms per call (profiled), device "
          f"{device:.3f} ms, busy share {device / wall:.2f}; top: {top}")


@contextlib.contextmanager
def plain_route():
    """Route the package's kernel entry points to their plain versions
    (explicitly, for the reference run on the card)."""
    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import goursat as gs
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    patches = [(fg, "fused_gram_levels", fg.fused_gram_levels_ref),
               (fg, "fused_diag_levels", fg.fused_diag_levels_ref),
               (fg, "fused_gram_levels_bwd", fg.fused_gram_levels_bwd_ref),
               (ts, "fused_tens_seq_levels", ts.fused_tens_seq_levels_ref),
               (ts, "tens_seq_bwd", ts.tens_seq_bwd_ref),
               (fgho, "fused_gram_ho_levels", fgho.fused_gram_ho_levels_ref),
               (tsg, "fused_tens_seq_general_levels",
                tsg.fused_tens_seq_general_levels_ref),
               (sg, "sig_gram_levels", sg.sig_gram_levels_ref),
               (sg, "sig_gram_levels_ho", sg.sig_gram_levels_ho_ref),
               (fgho, "fused_gram_ho_levels_bwd",
                fgho.fused_gram_ho_levels_bwd_ref),
               (tsg, "tens_seq_general_bwd", tsg.tens_seq_general_bwd_ref),
               (sg, "sig_gram_levels_bwd", sg.sig_gram_levels_bwd_ref),
               (sg, "sig_gram_levels_ho_bwd", sg.sig_gram_levels_ho_bwd_ref),
               (gs, "goursat_corner_fast", gs.goursat_corner_ref),
               (gs, "goursat_corner_refined", gs.goursat_corner_refined_ref),
               (gs, "goursat_grad_refined", gs.goursat_grad_refined_ref)]
    with contextlib.ExitStack() as stack:
        for module, name, plain in patches:
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def kernel_phase(dev):
    """Each kernel against its plain version at the main path's shapes."""
    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts

    rng = np.random.default_rng(SEED)
    gram_x = walks(rng, 256, 50, 2)
    gram_y = walks(rng, 256, 50, 2)
    lin_x = walks(rng, 64, 50, 2)
    seq_x = walks(rng, 2048, 50, 3)
    incs = np.diff(seq_x, axis=1).reshape(-1, 3)
    z_inc = incs[rng.integers(0, len(incs), 500 * 15 * 2)].reshape(
        500, 15, 2, 3)
    z_raw = incs[rng.integers(0, len(incs), 500 * 15)].reshape(500, 15, 3)
    g_gram = rng.standard_normal((5, 256, 256))
    train_x = seq_x[:840]
    g_kuf = rng.standard_normal((6, 500, 840))

    # work of the reported cases: (operations, bytes) for their bounds; a
    # backward counts 3 forwards (the forward recompute, the reverse sweep
    # of as many products, the chain to the inputs), its bytes the inputs
    # and cotangent read and the gradients written
    gram_ops = gram_work(256, 256, 50, 2, 4)
    kuf_ops = kuf_work(500, 30, 2048, 50, 3, 5)
    gram_bytes = 4 * (512 * 50 * 2 + 5 * 256 * 256)
    works = {
        "gram": (gram_ops, gram_bytes),
        "diag": (gram_self_work(2048, 50, 3, 5),
                 4 * (2048 * 50 * 3 + 6 * 2048)),
        "tens_seq": (kuf_ops, 4 * (500 * 30 * 3 + 2048 * 50 * 3
                                   + 6 * 500 * 2048)),
        "gram_bwd": (3 * gram_ops, 2 * gram_bytes),
        "tens_seq_bwd": (3 * kuf_work(500, 30, 50, 50, 3, 5),
                         4 * (2 * 500 * 30 * 3 + 2 * 50 * 50 * 3
                              + 6 * 500 * 50)),
    }

    # (report key, label, kernel call, plain call, inputs)
    cases = [
        ("gram", "Gram RBF N=256x256 L=50 d=2 nl=4",
         lambda a, b: fg.fused_gram_levels(a, b, 4, True),
         lambda a, b: fg.fused_gram_levels_ref(a, b, 4, True),
         (gram_x, gram_y)),
        (None, "Gram Linear N=64x64 L=50 d=2 nl=4",
         lambda a: fg.fused_gram_levels(a, a, 4, False),
         lambda a: fg.fused_gram_levels_ref(a, a, 4, False), (lin_x,)),
        ("diag", "diag RBF N=2048 L=50 d=3 nl=5",
         lambda a: fg.fused_diag_levels(a, 5, True),
         lambda a: fg.fused_diag_levels_ref(a, 5, True), (seq_x,)),
        ("tens_seq", "Kuf RBF T=500 increments N=2048 L=50 d=3 nl=5",
         lambda z, x: ts.fused_tens_seq_levels(z, x, 5, True, True),
         lambda z, x: ts.fused_tens_seq_levels_ref(z, x, 5, True, True),
         (z_inc, seq_x)),
        (None, "Kuf RBF T=500 no increments N=2048 L=50 d=3 nl=5",
         lambda z, x: ts.fused_tens_seq_levels(z, x, 5, True, False),
         lambda z, x: ts.fused_tens_seq_levels_ref(z, x, 5, True, False),
         (z_raw, seq_x)),
        ("gram_bwd", "Gram backward RBF N=256x256 L=50 d=2 nl=4",
         lambda a, b, g: fg.fused_gram_levels_bwd(a, b, g, 4, True),
         lambda a, b, g: fg.fused_gram_levels_bwd_ref(a, b, g, 4, True),
         (gram_x, gram_y, g_gram)),
        ("tens_seq_bwd", "Kuf backward RBF T=500 increments N=50 L=50 d=3 "
         "nl=5",
         lambda z, x, g: ts.tens_seq_bwd(z, x, g, 5, True, True),
         lambda z, x, g: ts.tens_seq_bwd_ref(z, x, g, 5, True, True),
         (z_inc, train_x[:50], np.ascontiguousarray(g_kuf[:, :, :50]))),
        (None, "Kuf backward RBF T=500 increments N=840 L=50 d=3 nl=5",
         lambda z, x, g: ts.tens_seq_bwd(z, x, g, 5, True, True),
         lambda z, x, g: ts.tens_seq_bwd_ref(z, x, g, 5, True, True),
         (z_inc, train_x, g_kuf)),
    ]
    return run_cases(dev, cases, works, TOL)


def run_cases(dev, cases, works, fwd_tol):
    """Each case's kernel call against its plain call in float32 and
    float64, with the tolerance for its kind (``fwd_tol`` for forwards,
    BWD_TOL for backwards); float32 timed. Returns the report entries of
    the cases with a report key."""
    import torch

    report = {}
    for key, label, kern, plain, arrays in cases:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            tol, why = (BWD_TOL if "backward" in label else fwd_tol)[name]
            args = [torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in arrays]
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            pairs = (list(zip(got, want)) if isinstance(want, tuple)
                     else [(got, want)])
            for g, w in pairs:
                check(g.shape == w.shape, f"{label}: shape {g.shape}")
                check(bool(torch.isfinite(g).all()), f"{label}: not finite")
            err = scaled_err(got, want)
            max_abs = abs_err(got, want)
            print(f"kernel {label} {name}: scaled err {err:.3e} "
                  f"(max abs {max_abs:.3e}), tolerance {tol:g}: {why}")
            check(err <= tol, f"{label} {name}: scaled err {err} > {tol}")
            if dtype == torch.float32:
                ms = cuda_ms(lambda: kern(*args))
                plain_ms = cuda_ms(lambda: plain(*args))
                print(f"time {label} float32: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms")
                if key is not None:
                    report[key] = dict(max_abs_err=max_abs, ms=ms,
                                       plain_ms=plain_ms, **bound(*works[key]),
                                       library_ms=None)
                    print(f"bound {label}: {report[key]['bound_ms']:.4f} ms "
                          f"({report[key]['bound_by']})")
            del got, want, args
            torch.cuda.empty_cache()
    return report


def build_svgp(torch, dev, dtype, rng, M, nl, d, L, C, n_train, order=1):
    from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    X = torch.as_tensor(walks(rng, n_train, L, d), dtype=dtype, device=dev)
    Y = torch.as_tensor(rng.integers(0, C, n_train), device=dev)
    kern = SignatureRBF(d, nl, normalization=True, order=order, dtype=dtype,
                        device=dev)
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(SEED), X, num_tensors=M,
        num_levels=nl, num_features=d, increments=True)
    model = SVGP.create(kern, MultiClass(C), feat, num_latent=C,
                        dtype=dtype, device=dev)
    q_mu = 0.5 * rng.standard_normal((M, C))
    q_sqrt = np.tril(0.02 * rng.standard_normal((C, M, M))) + 0.9 * np.eye(M)
    with torch.no_grad():
        model.q_mu.copy_(torch.as_tensor(q_mu))
        model.q_sqrt.copy_(torch.as_tensor(q_sqrt))
    return model, X, Y


def slice_phase(dev):
    """The serving path through the package's entry points."""
    import torch

    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.models.gpr import GPR

    f32 = torch.float32
    rng = np.random.default_rng(SEED)
    model, X, Y = build_svgp(torch, dev, f32, rng, M=500, nl=5, d=3, L=50,
                             C=10, n_train=840)
    Xb, Yb = X[:50], Y[:50]
    Xtest = torch.as_tensor(walks(rng, 2048, 50, 3), dtype=f32, device=dev)
    Xg = torch.as_tensor(walks(rng, 256, 50, 2), dtype=f32, device=dev)
    Yg = torch.as_tensor(np.sin(rng.standard_normal((256, 1))), dtype=f32,
                         device=dev)
    Xg_new = torch.as_tensor(walks(rng, 64, 50, 2), dtype=f32, device=dev)
    gpr = GPR.create(SignatureRBF(2, 4, normalization=True, dtype=f32,
                                  device=dev),
                     noise_variance=0.1, dtype=f32, device=dev)

    def serve():
        elbo = model.elbo(Xb, Yb, num_data=840)
        post = model.posterior()
        probs, pvar = post.predict_y(Xtest)
        fmean, fvar = post.predict_f(Xtest)
        Kuf = model.inducing.Kuf(model.kernel, Xtest)
        lml = gpr.log_marginal_likelihood(Xg, Yg)
        gmean, gvar = gpr.predict_f(Xg, Yg, Xg_new)
        torch.cuda.synchronize()
        return dict(elbo=elbo, probs=probs, pvar=pvar, fmean=fmean,
                    fvar=fvar, Kuf=Kuf, lml=lml, gmean=gmean, gvar=gvar)

    with torch.no_grad():
        reset_counters()
        out = serve()
        launches = counters()
        print(f"slice launches: {launches}")
        for key in ("gram", "diag", "tens_seq"):
            check(launches[key] > 0,
                  f"kernel {key} was not launched by the slice")

        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"slice {k} not finite")
        check(out["probs"].shape == (2048, 10), "predict_y shape")
        sums = out["probs"].sum(-1)
        check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-5)),
              "class probabilities do not sum to 1")
        for k in ("pvar", "fvar", "gvar"):
            check(bool((out[k] >= 0).all()), f"slice {k} has negatives")
        print(f"slice elbo {out['elbo'].item():.6g}, gpr lml "
              f"{out['lml'].item():.6g}, mean max prob "
              f"{out['probs'].max(-1).values.mean().item():.4f}")

        # the same calls routed through the plain functions on the card
        with plain_route():
            ref = serve()
        # Kuf: both routes in float32 from the same inputs. Predictive
        # means: mean = Kufᵀ L⁻ᵀ q_mu, and L⁻¹ of a Kuu carrying the f32
        # jitter 1e-4 has norm up to 1e-4^-1/2 = 100, so Kuf rounding
        # (about 1e-6 relative) can reach 1e-4 relative in the means.
        tolerances = dict(Kuf=1e-4, fmean=1e-3, probs=1e-3, elbo=1e-3,
                          lml=1e-3, gmean=1e-3)
        for k, tol in tolerances.items():
            err = scaled_err(out[k], ref[k])
            print(f"slice {k}: kernel vs plain route scaled err {err:.3e}, "
                  f"tolerance {tol:g}")
            check(err <= tol, f"slice {k}: {err} > {tol}")

        ms_predict = host_ms(lambda: model.posterior().predict_y(Xtest))
        post = model.posterior()
        ms_predict_cached = host_ms(lambda: post.predict_y(Xtest))
        ms_elbo = host_ms(lambda: model.elbo(Xb, Yb, num_data=840))
        print(f"time posterior()+predict_y N_test=2048: "
              f"{ms_predict:.3f} ms; predict_y on a cached posterior: "
              f"{ms_predict_cached:.3f} ms; elbo B=50: {ms_elbo:.3f} ms")
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              " GiB")
    return launches


def small_float64_check(dev, order=1):
    """A small float64 model on the card against the same model on the
    CPU (plain path): same parameters, same inputs, rtol 1e-8."""
    import torch

    rng = np.random.default_rng(SEED + order)
    model, X, Y = build_svgp(torch, dev, torch.float64, rng, M=20, nl=4,
                             d=3, L=20, C=4, n_train=30, order=order)
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        got = [model.elbo(X, Y, num_data=100),
               *model.posterior().predict_y(X)]
        want = [cpu_model.elbo(X.cpu(), Y.cpu(), num_data=100),
                *cpu_model.posterior().predict_y(X.cpu())]
    for g, w, name in zip(got, want, ("elbo", "probs", "var")):
        err = scaled_err(g.cpu(), w)
        print(f"small float64 order-{order} SVGP {name}: card vs CPU scaled "
              f"err {err:.3e}, tolerance 1e-8")
        check(err <= 1e-8, f"small float64 {name}: {err}")


def regression_sequences(rng, N=200, L=50, d=2, noise=0.1):
    """BASELINE config 1's data, as ``gpsig_tpu.data.synthetic.
    regression_sequences`` makes it (written out here: that package imports
    JAX): random walks with a smooth path functional as target."""
    X = np.cumsum(0.3 * rng.standard_normal((N, L, d)), axis=1)
    area = np.sum(X[:, :-1, 0] * np.diff(X[:, :, 1], axis=1), axis=1)
    y = np.tanh(X[:, -1, 0]) + 0.5 * np.tanh(area)
    return X, (y + noise * rng.standard_normal(N))[:, None]


def build_gpr(torch, dev, dtype, X, nl, order=1, ctor="SignatureRBF", **kw):
    from gpsig_tpu_torch.kernels import signature
    from gpsig_tpu_torch.models.gpr import GPR

    kern = getattr(signature, ctor)(X.shape[-1], nl, lengthscales=1.0,
                                    normalization=True, order=order,
                                    dtype=dtype, device=dev, **kw)
    return GPR.create(kern, noise_variance=0.05, dtype=dtype, device=dev)


def gpr_step_fn(torch, gpr, X, Y, lr):
    """One Adam step on −log_marginal_likelihood over every parameter, as
    benchmarks/config1_gram_gpr.py writes it; returns the step's lml."""
    from gpsig_tpu_torch.config import precise_linalg

    opt = torch.optim.Adam(gpr.parameters(), lr=lr)

    def step():
        opt.zero_grad(set_to_none=True)
        with precise_linalg():
            loss = -gpr.log_marginal_likelihood(X, Y)
            loss.backward()
        opt.step()
        return -loss.detach()

    return step


def grads_and_params(model):
    return ({n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def compare_first_step(label, got, want, lr,
                       why="float32 Kuf/Gram rounding carried through the "
                       "M=500 / N=150 Cholesky, whose f32 jitter 1e-4 lets "
                       "L⁻¹ grow to 100"):
    """The first step through the kernels against the same step through
    the plain functions on the card (float32), each parameter's gradient
    and new value."""
    (g_grad, g_par), (w_grad, w_par) = got, want
    check(set(g_grad) == set(w_grad), f"{label}: gradients of "
          f"{sorted(g_grad)} vs {sorted(w_grad)}")
    grad_tol = 1e-2
    for n in sorted(w_grad):
        err = scaled_err(g_grad[n], w_grad[n])
        print(f"train {label} step 1 grad {n}: kernel vs plain route scaled "
              f"err {err:.3e}, tolerance {grad_tol:g} ({why})")
        check(err <= grad_tol, f"{label} grad {n}: {err} > {grad_tol}")
    for n in sorted(w_par):
        if n in w_grad:
            # Adam's first step moves every entry by ±lr (m̂/√v̂ = sign g), so
            # an entry whose gradient is rounding noise may step the other
            # way: the gradients themselves are held above
            err, tol = abs_err(g_par[n], w_par[n]), 2 * lr * (1 + 1e-3)
            print(f"train {label} step 1 {n}: kernel vs plain route max abs "
                  f"err {err:.3e}, tolerance {tol:.4g} (2·lr: Adam's first "
                  "step is ±lr per entry)")
        else:
            err, tol = scaled_err(g_par[n], w_par[n]), 1e-3
            print(f"train {label} step 1 {n} (natgrad): kernel vs plain route"
                  f" scaled err {err:.3e}, tolerance {tol:g} (as the slice's "
                  "predictive means)")
        check(err <= tol, f"{label} {n}: {err} > {tol}")


def training_phase(dev):
    """Both training paths at full width, float32: natgrad + Adam steps of
    the flagship SVGP and Adam steps on GPR's log marginal likelihood."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    rng = np.random.default_rng(SEED + 2)
    model, X, Y = build_svgp(torch, dev, f32, rng, M=500, nl=5, d=3, L=50,
                             C=10, n_train=840)
    svgp_steps, gpr_steps = 6, 10
    batches = [torch.as_tensor(rng.choice(840, 50, replace=False),
                               device=dev) for _ in range(svgp_steps)]
    Xg, yg = regression_sequences(np.random.default_rng(SEED))
    Xg = torch.as_tensor(Xg[:150], dtype=f32, device=dev)
    yg = torch.as_tensor(yg[:150], dtype=f32, device=dev)
    gpr = build_gpr(torch, dev, f32, Xg, nl=4)
    plain_model, plain_gpr = copy.deepcopy(model), copy.deepcopy(gpr)

    svgp_step = make_step_fn(1e-3, num_data=840, gamma=0.1)
    state = svgp_step.init(model)
    gpr_step = gpr_step_fn(torch, gpr, Xg, yg, 5e-2)

    reset_counters()
    elbos, svgp_ms, first = [], [], {}
    for k, idx in enumerate(batches):
        (state, elbo), ms = timed(lambda: svgp_step(state, X[idx], Y[idx]))
        elbos.append(elbo.item())
        svgp_ms.append(ms)
        if k == 0:
            first["svgp"] = grads_and_params(model)
    lmls, gpr_ms = [], []
    for k in range(gpr_steps):
        lml, ms = timed(gpr_step)
        lmls.append(lml.item())
        gpr_ms.append(ms)
        if k == 0:
            first["gpr"] = grads_and_params(gpr)
    launches = counters()
    print(f"training launches: {launches}")
    for key in ("gram", "diag", "tens_seq", "gram_bwd", "tens_seq_bwd"):
        check(launches[key] > 0,
              f"kernel {key} was not launched by the training run")
    print(f"train svgp elbo per step: {elbos}")
    print(f"train gpr lml per step: {lmls}")
    check(all(np.isfinite(elbos)), "svgp elbo not finite")
    check(all(np.isfinite(lmls)), "gpr lml not finite")
    for p in (*model.parameters(), *gpr.parameters()):
        check(bool(torch.isfinite(p).all()), "trained parameter not finite")

    # the first step again, through the plain functions on the card
    with plain_route():
        pstep = make_step_fn(1e-3, num_data=840, gamma=0.1)
        pstep(pstep.init(plain_model), X[batches[0]], Y[batches[0]])
        gpr_step_fn(torch, plain_gpr, Xg, yg, 5e-2)()
    torch.cuda.synchronize()
    compare_first_step("svgp", first["svgp"], grads_and_params(plain_model),
                       1e-3)
    compare_first_step("gpr", first["gpr"], grads_and_params(plain_gpr),
                       5e-2)

    # step times: median over the steps after the first
    ms_svgp = statistics.median(svgp_ms[1:])
    ms_gpr = statistics.median(gpr_ms[1:])
    print(f"time svgp natgrad+Adam step (M=500, nl=5, C=10, B=50): "
          f"{ms_svgp:.3f} ms (median of {len(svgp_ms) - 1}; all "
          f"{[round(t, 3) for t in svgp_ms]})")
    print(f"time gpr Adam step (N=150, L=50, d=2, nl=4): {ms_gpr:.3f} ms "
          f"(median of {len(gpr_ms) - 1}; all "
          f"{[round(t, 3) for t in gpr_ms]})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    return launches


def small_float64_training_check(dev, order=1, gpr_ctor="SignatureRBF",
                                 **gpr_kw):
    """Three float64 training steps of small models on the card against
    the same steps on the CPU (plain path), rtol 1e-8: an SVGP at
    ``order`` (natgrad + Adam) and a GPR (Adam) with ``gpr_ctor``'s
    kernel."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    f64 = torch.float64
    rng = np.random.default_rng(SEED + 3)
    model, X, Y = build_svgp(torch, dev, f64, rng, M=20, nl=4, d=3, L=20,
                             C=4, n_train=30, order=order)
    Xg, yg = regression_sequences(rng, N=24, L=20)
    Xg, yg = (torch.as_tensor(a, dtype=f64, device=dev) for a in (Xg, yg))
    gpr = build_gpr(torch, dev, f64, Xg, nl=4, ctor=gpr_ctor, **gpr_kw)
    setups = {
        "card": (model, gpr, X, Y, Xg, yg),
        "cpu": (copy.deepcopy(model).to("cpu"), copy.deepcopy(gpr).to("cpu"),
                *(t.cpu() for t in (X, Y, Xg, yg))),
    }
    runs = {}
    for where, (model, gpr, X, Y, Xg, yg) in setups.items():
        step = make_step_fn(1e-2, num_data=100, gamma=0.1)
        state = step.init(model)
        gstep = gpr_step_fn(torch, gpr, Xg, yg, 5e-2)
        out = []
        for _ in range(3):
            state, elbo = step(state, X, Y)
            out += [elbo, gstep()]
        out += [p.detach() for p in (*model.parameters(),
                                     *gpr.parameters())]
        runs[where] = [t.cpu() for t in out]
    err = max(scaled_err(g, w) for g, w in zip(runs["card"], runs["cpu"]))
    print(f"small float64 training (3 order-{order} SVGP + 3 {gpr_ctor} "
          f"{gpr_kw} GPR steps): card vs CPU scaled err {err:.3e} over "
          "every ELBO, lml and parameter, tolerance 1e-8")
    check(err <= 1e-8, f"small float64 training: {err}")


# ---------------------------------------------------------------------------
# Slice 1: the general engines (order >= 2, difference=False, Poly/Cosine)
# ---------------------------------------------------------------------------

def self_increments(X):
    """The kernel layer's self-increment matrices [N, L-1, L-1] of X under
    the RBF base with unit lengthscales (the diagonal's input)."""
    sq = np.sum(X * X, -1)
    G = np.exp(-0.5 * np.maximum(
        sq[:, :, None] + sq[:, None, :] - 2 * X @ X.transpose(0, 2, 1), 0))
    return np.diff(np.diff(G, axis=1), axis=2)


def slice1_kernel_phase(dev):
    """(a) Each general-engine kernel against its plain version at the
    order-2 main path's shapes: the Gram at ``job_ho_gram``'s (N=256², L=50,
    d=2, nl=4, RBF, orders 2 and 3), Kuf at the flagship prediction's
    (T=500 with increments, N=2048, L=50, d=2, nl=5, order 2), the
    sig_gram DP on that X's 2048 self-increment matrices (L'=49, nl=5)."""
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    rng = np.random.default_rng(SEED + 10)
    gram_x = walks(rng, 256, 50, 2)
    gram_y = walks(rng, 256, 50, 2)
    seq_x = walks(rng, 2048, 50, 2)
    incs = np.diff(seq_x, axis=1).reshape(-1, 2)
    z_inc = incs[rng.integers(0, len(incs), 500 * 15 * 2)].reshape(
        500, 15, 2, 2)
    m_self = self_increments(seq_x)
    sg_bytes = 4 * (2048 * 49 * 49 + 6 * 2048)
    # the self-increment matrices are symmetric: dp_self_ops
    works = {
        "gram_ho": (gram_work(256, 256, 50, 2, 4, p=2),
                    4 * (512 * 50 * 2 + 5 * 256 * 256)),
        "tsg": (kuf_work(500, 30, 2048, 50, 2, 5, p=2),
                4 * (500 * 30 * 2 + 2048 * 50 * 2 + 6 * 500 * 2048)),
        "sig_gram_ho": (2048 * dp_self_ops(49, 5, 2), sg_bytes),
        "sig_gram": (2048 * dp_self_ops(49, 5, 1), sg_bytes),
    }
    cases = [
        ("gram_ho", "general Gram RBF order 2 N=256x256 L=50 d=2 nl=4",
         lambda a, b: fgho.fused_gram_ho_levels(a, b, 4, 2, "rbf", True),
         lambda a, b: fgho.fused_gram_ho_levels_ref(a, b, 4, 2, "rbf", True),
         (gram_x, gram_y)),
        (None, "general Gram RBF order 3 N=256x256 L=50 d=2 nl=4",
         lambda a, b: fgho.fused_gram_ho_levels(a, b, 4, 3, "rbf", True),
         lambda a, b: fgho.fused_gram_ho_levels_ref(a, b, 4, 3, "rbf", True),
         (gram_x, gram_y)),
        ("tsg", "general Kuf RBF order 2 T=500 increments N=2048 L=50 d=2 "
         "nl=5",
         lambda z, x: tsg.fused_tens_seq_general_levels(z, x, 5, 2, "rbf",
                                                        True, True),
         lambda z, x: tsg.fused_tens_seq_general_levels_ref(z, x, 5, 2, "rbf",
                                                            True, True),
         (z_inc, seq_x)),
        ("sig_gram_ho", "sig_gram order 2 B=2048 L'=49 nl=5",
         lambda m: sg.sig_gram_levels_ho(m, 5, 2),
         lambda m: sg.sig_gram_levels_ho_ref(m, 5, 2), (m_self,)),
        ("sig_gram", "sig_gram order 1 B=2048 L'=49 nl=5",
         lambda m: sg.sig_gram_levels(m, 5),
         lambda m: sg.sig_gram_levels_ref(m, 5), (m_self,)),
    ]
    return run_cases(dev, cases, works, GEN_TOL)


def with_offset_channel(X, Y, kind, c=0.6):
    """The kernel layer's Poly offset channel: x_extra = 1, y_extra = c."""
    if not kind.startswith("poly"):
        return X, Y
    return (np.concatenate([X, np.ones(X.shape[:-1] + (1,))], -1),
            np.concatenate([Y, np.full(Y.shape[:-1] + (1,), c)], -1))


def coverage_sweep(dev):
    """(b) Every base kind × difference × order 1-3 (× increments for Kuf)
    at small sizes, each kernel against its plain version in float32 and
    float64; one num_levels-7 case of each kernel; lags with ARD through
    the kernel layer against the plain route."""
    import torch

    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    rng = np.random.default_rng(SEED + 12)
    calls = []  # (kernel, kernel call, plain call, numpy inputs)
    for kind in ("linear", "rbf", "poly2", "poly3", "cosine"):
        for difference in (True, False):
            for order in (1, 2, 3):
                X, Y = with_offset_channel(walks(rng, 16, 20, 2),
                                           walks(rng, 12, 20, 2), kind)
                args = (4, order, kind, difference)
                calls.append(("gram_ho",
                              lambda x, y, a=args: fgho.fused_gram_ho_levels(
                                  x, y, *a),
                              lambda x, y, a=args:
                              fgho.fused_gram_ho_levels_ref(x, y, *a),
                              (X, Y)))
                for increments in (True, False):
                    Z = 0.4 * rng.standard_normal(
                        (8, 10, 2, 2) if increments else (8, 10, 2))
                    Xs, Zs = with_offset_channel(walks(rng, 16, 20, 2), Z,
                                                 kind)
                    a = (4, order, kind, increments, difference)
                    calls.append((
                        "tsg",
                        lambda z, x, a=a: tsg.fused_tens_seq_general_levels(
                            z, x, *a),
                        lambda z, x, a=a:
                        tsg.fused_tens_seq_general_levels_ref(z, x, *a),
                        (Zs, Xs)))
    M = 0.4 * rng.standard_normal((6, 19, 23))
    calls.append(("sig_gram", lambda m: sg.sig_gram_levels(m, 4),
                  lambda m: sg.sig_gram_levels_ref(m, 4), (M,)))
    for order in (2, 3):
        calls.append(("sig_gram_ho",
                      lambda m, o=order: sg.sig_gram_levels_ho(m, 4, o),
                      lambda m, o=order: sg.sig_gram_levels_ho_ref(m, 4, o),
                      (M,)))
    # num_levels 7 (every run-length state live at order 7)
    X, Y = walks(rng, 8, 20, 2), walks(rng, 6, 20, 2)
    calls.append(("gram_ho",
                  lambda x, y: fgho.fused_gram_ho_levels(x, y, 7, 7, "rbf"),
                  lambda x, y: fgho.fused_gram_ho_levels_ref(x, y, 7, 7,
                                                             "rbf"), (X, Y)))
    Z = 0.4 * rng.standard_normal((5, 28, 2, 2))
    calls.append(("tsg",
                  lambda z, x: tsg.fused_tens_seq_general_levels(
                      z, x, 7, 3, "cosine", True, False),
                  lambda z, x: tsg.fused_tens_seq_general_levels_ref(
                      z, x, 7, 3, "cosine", True, False), (Z, X)))
    calls.append(("sig_gram_ho", lambda m: sg.sig_gram_levels_ho(m, 7, 7),
                  lambda m: sg.sig_gram_levels_ho_ref(m, 7, 7), (M,)))

    worst = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            for key, kern, plain, arrays in calls:
                args = [torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in arrays]
                got, want = kern(*args), plain(*args)
                check(got.shape == want.shape and bool(
                    torch.isfinite(got).all()), f"sweep {key}: {got.shape}")
                k = (key, name)
                worst[k] = max(worst.get(k, 0.0), scaled_err(got, want))
            # lags and ARD through the kernel layer, against the plain route
            kern = SignatureRBF(2, 4, order=2, num_lags=2,
                                lengthscales=[0.7, 1.3], dtype=dtype,
                                device=dev)
            X = torch.as_tensor(walks(rng, 10, 20, 2), dtype=dtype,
                                device=dev)
            Z = torch.as_tensor(0.4 * rng.standard_normal((6, 10, 2, 6)),
                                dtype=dtype, device=dev)

            def layer():
                return (kern.K(X), kern.K_tens_vs_seq(Z, X, True))

            got = layer()
            with plain_route():
                want = layer()
            worst[("layer lags+ARD", name)] = scaled_err(got, want)
    for (key, name), err in sorted(worst.items()):
        tol, why = GEN_TOL[name]
        print(f"sweep {key} {name}: worst scaled err {err:.3e} over "
              f"{sum(c[0] == key for c in calls) or 1} cases, tolerance "
              f"{tol:g}: {why}")
        check(err <= tol, f"sweep {key} {name}: {err} > {tol}")


def check_general_route(launches, need, label):
    """The general kernels in ``need`` ran; the tuned order-1 ones did
    not."""
    print(f"{label} launches: {launches}")
    for key in need:
        check(launches[key] > 0, f"kernel {key} was not launched by {label}")
    for key in TUNED:
        check(launches[key] == 0, f"tuned kernel {key} ran in {label}")


def compare_routes(label, out, ref, tolerances):
    for k, tol in tolerances.items():
        err = scaled_err(out[k], ref[k])
        print(f"{label} {k}: kernel vs plain route scaled err {err:.3e}, "
              f"tolerance {tol:g}")
        check(err <= tol, f"{label} {k}: {err} > {tol}")


def slice1_serving_phase(dev):
    """(c) The order-2 flagship SVGP serving path at full width, float32
    (``job_flagship_o2``: M=500 inducing tensors with increments, nl=5,
    order 2, d=2, L=50, C=10, N_train=500)."""
    import torch

    f32 = torch.float32
    rng = np.random.default_rng(SEED + 11)
    model, X, Y = build_svgp(torch, dev, f32, rng, M=500, nl=5, d=2, L=50,
                             C=10, n_train=500, order=2)
    Xb, Yb = X[:50], Y[:50]
    Xtest = torch.as_tensor(walks(rng, 2048, 50, 2), dtype=f32, device=dev)

    def serve():
        elbo = model.elbo(Xb, Yb, num_data=500)
        post = model.posterior()
        probs, pvar = post.predict_y(Xtest)
        fmean, fvar = post.predict_f(Xtest)
        Kuf = model.inducing.Kuf(model.kernel, Xtest)
        torch.cuda.synchronize()
        return dict(elbo=elbo, probs=probs, pvar=pvar, fmean=fmean,
                    fvar=fvar, Kuf=Kuf)

    with torch.no_grad():
        reset_counters()
        out = serve()
        launches = counters()
        check_general_route(launches, ("tsg", "sig_gram_ho"),
                            "order-2 SVGP serving")
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"order-2 {k} not finite")
        check(out["probs"].shape == (2048, 10), "order-2 predict_y shape")
        sums = out["probs"].sum(-1)
        check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-5)),
              "order-2 class probabilities do not sum to 1")
        for k in ("pvar", "fvar"):
            check(bool((out[k] >= 0).all()), f"order-2 {k} has negatives")
        print(f"order-2 SVGP elbo {out['elbo'].item():.6g}, mean max prob "
              f"{out['probs'].max(-1).values.mean().item():.4f}")
        with plain_route():
            ref = serve()
        # 1e-3 throughout (means and variances alike): the normalised high
        # levels of Kuf divide float32
        # DP sums that cancel to small values by the square roots of the
        # self-kernels, themselves such sums, in both routes; the kernels
        # alone agree with their plain versions to ~1e-6 scaled (phase a).
        # Both routes' Kuf against the kernel route in float64 says which
        # rounds more.
        compare_routes("order-2 SVGP", out, ref,
                       dict(Kuf=1e-3, fmean=1e-3, fvar=1e-3, probs=1e-3,
                            pvar=1e-3, elbo=1e-3))
        model64 = copy.deepcopy(model).double()
        truth = model64.inducing.Kuf(model64.kernel, Xtest.double())
        print(f"order-2 SVGP Kuf against float64: kernel route scaled err "
              f"{scaled_err(out['Kuf'].double(), truth):.3e}, plain route "
              f"{scaled_err(ref['Kuf'].double(), truth):.3e}")
        del model64, truth
        ms_predict = host_ms(lambda: model.posterior().predict_y(Xtest))
        post = model.posterior()
        ms_cached = host_ms(lambda: post.predict_y(Xtest))
        ms_elbo = host_ms(lambda: model.elbo(Xb, Yb, num_data=500))
        with plain_route():
            ms_plain = host_ms(lambda: post.predict_y(Xtest), reps=3)
        print(f"time order-2 posterior()+predict_y N_test=2048: "
              f"{ms_predict:.3f} ms; predict_y on a cached posterior: "
              f"{ms_cached:.3f} ms (plain route {ms_plain:.3f} ms); elbo "
              f"B=50: {ms_elbo:.3f} ms")
        profile_split(lambda: post.predict_y(Xtest),
                      "order-2 predict_y, cached posterior, N_test=2048")
        profile_split(lambda: model.posterior().predict_y(Xtest),
                      "order-2 posterior()+predict_y, N_test=2048")
        profile_split(lambda: model.elbo(Xb, Yb, num_data=500),
                      "order-2 ELBO, B=50")
    return launches


def slice1_gpr_phase(dev):
    """(d) Exact GPR at BASELINE config 1's width (N=150 of 200, L=50, d=2,
    nl=4, noise 0.05), float32: order 2 (RBF) through _ho_kernel and the
    order-2 sig_gram, and order 1 with a Poly base (offset 0.6) through
    _ho_kernel and the order-1 sig_gram."""
    import torch

    f32 = torch.float32
    Xg, yg = regression_sequences(np.random.default_rng(SEED))
    Xg = torch.as_tensor(Xg, dtype=f32, device=dev)
    yg = torch.as_tensor(yg, dtype=f32, device=dev)
    X, Y, Xnew = Xg[:150], yg[:150], Xg[150:]
    models = {"order-2 RBF": build_gpr(torch, dev, f32, X, nl=4, order=2),
              "order-1 Poly": build_gpr(torch, dev, f32, X, nl=4,
                                        ctor="SignaturePoly", offset=0.6)}

    def run():
        out = {}
        for name, gpr in models.items():
            mean, var = gpr.predict_y(X, Y, Xnew)
            out[name] = dict(lml=gpr.log_marginal_likelihood(X, Y),
                             mean=mean, var=var)
        torch.cuda.synchronize()
        return out

    with torch.no_grad():
        reset_counters()
        out = run()
        launches = counters()
        check_general_route(launches, ("gram_ho", "sig_gram", "sig_gram_ho"),
                            "GPR serving")
        with plain_route():
            ref = run()
        for name in models:
            for k, v in out[name].items():
                check(bool(torch.isfinite(v).all()), f"GPR {name} {k}")
            check(bool((out[name]["var"] >= 0).all()), f"GPR {name} var")
            print(f"GPR {name}: lml {out[name]['lml'].item():.6g}")
            compare_routes(f"GPR {name}", out[name], ref[name],
                           dict(lml=1e-3, mean=1e-3, var=1e-3))
            gpr = models[name]
            ms = host_ms(lambda: gpr.log_marginal_likelihood(X, Y))
            print(f"time GPR {name} log_marginal_likelihood N=150: "
                  f"{ms:.3f} ms")
    return launches


def small_float64_gpr_check(dev):
    """(e) A small order-2 GPR (Poly base) in float64 on the card against
    the CPU, rtol 1e-8."""
    import torch

    rng = np.random.default_rng(SEED + 4)
    Xg, yg = regression_sequences(rng, N=24, L=20)
    Xg, yg = (torch.as_tensor(a, dtype=torch.float64, device=dev)
              for a in (Xg, yg))
    gpr = build_gpr(torch, dev, torch.float64, Xg, nl=4, order=2,
                    ctor="SignaturePoly", offset=0.6, difference=False)
    cpu = copy.deepcopy(gpr).to("cpu")
    with torch.no_grad():
        got = [gpr.log_marginal_likelihood(Xg[:16], yg[:16]),
               *gpr.predict_y(Xg[:16], yg[:16], Xg[16:])]
        want = [cpu.log_marginal_likelihood(Xg[:16].cpu(), yg[:16].cpu()),
                *cpu.predict_y(Xg[:16].cpu(), yg[:16].cpu(), Xg[16:].cpu())]
    err = max(scaled_err(g.cpu(), w) for g, w in zip(got, want))
    print(f"small float64 order-2 Poly GPR (difference=False): card vs CPU "
          f"scaled err {err:.3e}, tolerance 1e-8")
    check(err <= 1e-8, f"small float64 GPR: {err}")


def slice1_backward_kernel_phase(dev):
    """(f) The four general backward kernels against their plain versions
    at the training paths' shapes: the Gram backward at the order-2 GPR's
    (N=150², L=50, d=2, nl=4, RBF, order 2) and the Poly GPR's (d=2 plus
    the offset channel, order 1), the Kuf backward at the order-2 SVGP
    step's (T=500 with increments, N=50, L=50, d=2, nl=5), the sig_gram
    backwards on the self-increment matrices of the GPR's 150 sequences
    (L'=49, nl=4) and the SVGP minibatch's 50 (nl=5)."""
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    rng = np.random.default_rng(SEED + 13)
    x150 = walks(rng, 150, 50, 2)
    px, py = with_offset_channel(x150, x150, "poly2")
    x50 = walks(rng, 50, 50, 2)
    incs = np.diff(x50, axis=1).reshape(-1, 2)
    z_inc = incs[rng.integers(0, len(incs), 500 * 15 * 2)].reshape(
        500, 15, 2, 2)
    g_gram = rng.standard_normal((5, 150, 150))
    g_kuf = rng.standard_normal((6, 500, 50))
    m150, m50 = self_increments(x150), self_increments(x50)
    g150, g50 = rng.standard_normal((5, 150)), rng.standard_normal((6, 50))
    # a backward counts 3 forwards (the forward recompute, the reverse
    # sweep that rebuilds the states, the adjoint with the chain to the
    # inputs); its bytes are the inputs and cotangent read and the
    # gradients written once
    gram_bytes = 4 * (2 * 2 * 150 * 50 * 2 + 5 * 150 * 150)
    sg_bytes = 4 * (2 * 150 * 49 * 49 + 5 * 150)
    works = {
        "gram_ho_bwd": (3 * gram_work(150, 150, 50, 2, 4, p=2), gram_bytes),
        "tsg_bwd": (3 * kuf_work(500, 30, 50, 50, 2, 5, p=2),
                    4 * (2 * 500 * 30 * 2 + 2 * 50 * 50 * 2 + 6 * 500 * 50)),
        "sig_gram_ho_bwd": (3 * 150 * dp_self_ops(49, 4, 2), sg_bytes),
        "sig_gram_bwd": (3 * 150 * dp_self_ops(49, 4, 1), sg_bytes),
    }
    cases = [
        ("gram_ho_bwd", "general Gram backward RBF order 2 N=150x150 L=50 "
         "d=2 nl=4",
         lambda a, g: fgho.fused_gram_ho_levels_bwd(a, a, g, 4, 2, "rbf"),
         lambda a, g: fgho.fused_gram_ho_levels_bwd_ref(a, a, g, 4, 2,
                                                        "rbf"),
         (x150, g_gram)),
        (None, "general Gram backward Poly order 1 N=150x150 L=50 d=2+1 "
         "nl=4",
         lambda a, b, g: fgho.fused_gram_ho_levels_bwd(a, b, g, 4, 1,
                                                       "poly2"),
         lambda a, b, g: fgho.fused_gram_ho_levels_bwd_ref(a, b, g, 4, 1,
                                                           "poly2"),
         (px, py, g_gram)),
        ("tsg_bwd", "general Kuf backward RBF order 2 T=500 increments N=50 "
         "L=50 d=2 nl=5",
         lambda z, x, g: tsg.tens_seq_general_bwd(z, x, g, 5, 2, "rbf", True,
                                                  True),
         lambda z, x, g: tsg.tens_seq_general_bwd_ref(z, x, g, 5, 2, "rbf",
                                                      True, True),
         (z_inc, x50, g_kuf)),
        ("sig_gram_ho_bwd", "sig_gram backward order 2 B=150 L'=49 nl=4",
         lambda m, g: sg.sig_gram_levels_ho_bwd(m, g, 4, 2),
         lambda m, g: sg.sig_gram_levels_ho_bwd_ref(m, g, 4, 2),
         (m150, g150)),
        (None, "sig_gram backward order 2 B=50 L'=49 nl=5",
         lambda m, g: sg.sig_gram_levels_ho_bwd(m, g, 5, 2),
         lambda m, g: sg.sig_gram_levels_ho_bwd_ref(m, g, 5, 2),
         (m50, g50)),
        ("sig_gram_bwd", "sig_gram backward order 1 B=150 L'=49 nl=4",
         lambda m, g: sg.sig_gram_levels_bwd(m, g, 4),
         lambda m, g: sg.sig_gram_levels_bwd_ref(m, g, 4), (m150, g150)),
    ]
    return run_cases(dev, cases, works, GEN_TOL)


def slice1_training_phase(dev):
    """(g) The three training paths of slice 1 at full width, float32, each
    with its counters read just after it: natgrad + Adam steps of the
    order-2 flagship SVGP (``job_flagship_o2``: M=500 with increments,
    nl=5, order 2, d=2, L=50, C=10, B=50 of 500, Adam 1e-3, γ=0.05), and
    Adam steps on the log marginal likelihood of the order-2 GPR and the
    order-1 Poly GPR (offset 0.6, trained) at BASELINE config 1's width
    (N=150 of 200, L=50, d=2, nl=4, Adam 5e-2). ELBO and lml finite at
    every step; the general kernels and their backwards launch, the tuned
    ones do not; the first step agrees with the plain route."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    rng = np.random.default_rng(SEED + 14)
    model, X, Y = build_svgp(torch, dev, f32, rng, M=500, nl=5, d=2, L=50,
                             C=10, n_train=500, order=2)
    batches = [torch.as_tensor(rng.choice(500, 50, replace=False),
                               device=dev) for _ in range(6)]
    Xg, yg = regression_sequences(np.random.default_rng(SEED))
    Xg = torch.as_tensor(Xg[:150], dtype=f32, device=dev)
    yg = torch.as_tensor(yg[:150], dtype=f32, device=dev)
    gprs = {"order-2 GPR": build_gpr(torch, dev, f32, Xg, nl=4, order=2),
            "Poly GPR": build_gpr(torch, dev, f32, Xg, nl=4,
                                  ctor="SignaturePoly", offset=0.6)}
    offset0 = gprs["Poly GPR"].kernel.base.offset.item()
    plain = {"order-2 SVGP": copy.deepcopy(model),
             **{k: copy.deepcopy(v) for k, v in gprs.items()}}
    svgp_step = make_step_fn(1e-3, num_data=500, gamma=0.05)
    state = svgp_step.init(model)

    launches, first, ms = {}, {}, {}
    reset_counters()
    elbos, ms["order-2 SVGP"] = [], []
    for k, idx in enumerate(batches):
        (state, elbo), t = timed(lambda: svgp_step(state, X[idx], Y[idx]))
        elbos.append(elbo.item())
        ms["order-2 SVGP"].append(t)
        if k == 0:
            first["order-2 SVGP"] = grads_and_params(model)
    launches["order-2 SVGP"] = counters()
    check_general_route(launches["order-2 SVGP"],
                        ("tsg", "tsg_bwd", "sig_gram_ho", "sig_gram_ho_bwd"),
                        "order-2 SVGP training")
    print(f"train order-2 svgp elbo per step: {elbos}")
    check(all(np.isfinite(elbos)), "order-2 svgp elbo not finite")
    need = {"order-2 GPR": ("gram_ho", "gram_ho_bwd", "sig_gram_ho",
                            "sig_gram_ho_bwd"),
            "Poly GPR": ("gram_ho", "gram_ho_bwd", "sig_gram",
                         "sig_gram_bwd")}
    for name, gpr in gprs.items():
        step = gpr_step_fn(torch, gpr, Xg, yg, 5e-2)
        reset_counters()
        lmls, ms[name] = [], []
        for k in range(10):
            lml, t = timed(step)
            lmls.append(lml.item())
            ms[name].append(t)
            if k == 0:
                first[name] = grads_and_params(gpr)
        launches[name] = counters()
        check_general_route(launches[name], need[name], f"{name} training")
        print(f"train {name} lml per step: {lmls}")
        check(all(np.isfinite(lmls)), f"{name} lml not finite")
        profile_split(step, f"{name} Adam step, N=150")
    offset = gprs["Poly GPR"].kernel.base.offset.item()
    print(f"Poly GPR offset after training: {offset:.6g} (from {offset0:.6g})")
    check(offset != offset0, "the Poly offset did not train")
    for m in (model, *gprs.values()):
        for p in m.parameters():
            check(bool(torch.isfinite(p).all()),
                  "trained parameter not finite")

    # the first step again, through the plain functions on the card
    with plain_route():
        pstep = make_step_fn(1e-3, num_data=500, gamma=0.05)
        pstep(pstep.init(plain["order-2 SVGP"]), X[batches[0]],
              Y[batches[0]])
        for name in gprs:
            gpr_step_fn(torch, plain[name], Xg, yg, 5e-2)()
    torch.cuda.synchronize()
    for name, lr in (("order-2 SVGP", 1e-3), ("order-2 GPR", 5e-2),
                     ("Poly GPR", 5e-2)):
        compare_first_step(name, first[name], grads_and_params(plain[name]),
                           lr)
    for name, times in ms.items():
        print(f"time {name} step: {statistics.median(times[1:]):.3f} ms "
              f"(median of {len(times) - 1}; all "
              f"{[round(t, 3) for t in times]})")
    profile_split(lambda: svgp_step(state, X[batches[1]], Y[batches[1]]),
                  "order-2 SVGP natgrad+Adam step, B=50")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    return launches

# ---------------------------------------------------------------------------
# The PDE slice: the SigGPDE SVGP (untruncated Goursat kernel, inducing
# sequences)
# ---------------------------------------------------------------------------

# scaled error allowed for the Goursat routes, (forward, gradient)
GOURSAT_TOL = {
    "float32": ((1e-3, 3e-3), "float32 sweeps over up to 3,184 dependent "
                "diagonals whose values cancel, with fused multiply-adds "
                "where the plain version rounds each product (the plain "
                "float32 sweep is itself 1.2e-4 from float64 at L=200, "
                "o=2); the gradient adds its terms with atomics"),
    "float64": ((1e-10, 1e-10), "the plain version's arithmetic per cell; "
                "fused multiply-adds and the gradient's atomics round "
                "otherwise"),
}
# per refined cell: the forward's 3 adds, 2 multiplies and the increment's
# scale; the gradient's forward recompute, adjoint step (11) and emitted
# term (5)
GOURSAT_CELL_OPS = {"fwd": 6, "grad": 22}


def pde_data(N=200, L=50, seed=0):
    """``job_pde_train``'s data (``classification_sequences``, d=2, two
    classes), float64 numpy."""
    from gpsig_tpu_torch.data.synthetic import classification_sequences

    return classification_sequences(seed=seed, N=N, L=L, d=2, num_classes=2)


def pde_increments(X, Y):
    """The PDE kernel's increment grids (Linear base, lengthscale 1.5) of
    every pair of X [N1, L1, d] and Y [N2, L2, d]: [N1 N2, L1-1, L2-1]."""
    dx, dy = np.diff(X / 1.5, axis=1), np.diff(Y / 1.5, axis=1)
    return np.einsum("nid,mjd->nmij", dx, dy).reshape(
        -1, dx.shape[1], dy.shape[1])


def goursat_route(gs, goursat, route, inc, o, gbar):
    """(kernel call, plain call) of one Goursat route on inc at dyadic
    order o: the given-grid kernel on the grid refined in memory, the
    in-kernel refinement forward, or the adjoint gradient seeded with
    gbar."""
    if route == "fast":
        fine = goursat.refine_increments(inc, o)
        return (lambda: gs.goursat_corner_fast(fine),
                lambda: gs.goursat_corner_ref(fine))
    if route == "fused":
        return (lambda: gs.goursat_corner_refined(inc, o),
                lambda: gs.goursat_corner_refined_ref(inc, o))
    return (lambda: gs.goursat_grad_refined(inc, o, gbar),
            lambda: gs.goursat_grad_refined_ref(inc, o, gbar))


def goursat_kernel_phase(dev):
    """(g) The three Goursat routes against their plain versions, float32
    and float64, at the slice's grids: (49, 49) the training step's joint
    Gram ([Z; X_batch], 82² pairs), (7, 49) Kuf at prediction (32 inducing
    sequences of length 8 against 2048 test sequences), (1, 1) and (13, 5)
    at 4096 pairs, each at dyadic order 0-2, and (199, 199) (L=200, 64
    pairs) at orders 2 and 3. The given-grid route runs on the grid refined
    in memory (the ``scan`` engine's input). Float32 timed: Gcell/s counts
    refined cells; bounds as ``bound``."""
    import torch

    from gpsig_tpu_torch.inducing import make_inducing_sequences_from_data
    from gpsig_tpu_torch.ops import goursat
    from gpsig_tpu_torch.ops.cuda import goursat as gs

    rng = np.random.default_rng(SEED + 20)
    Xtr, _ = pde_data()
    Xte, _ = pde_data(N=2048, seed=1)
    # the serving path's inducing sequences (build_pde_svgp draws the same)
    Z = make_inducing_sequences_from_data(
        torch.Generator().manual_seed(SEED), torch.as_tensor(Xtr), 32, 8,
        2).raw_Z.detach().numpy()
    pad = np.repeat(Z[:, -1:], Xtr.shape[1] - Z.shape[1], 1)
    J = np.concatenate([np.concatenate([Z, pad], 1), Xtr[:50]])
    X200, _ = pde_data(N=16, L=200, seed=2)
    grids = [("joint Gram", pde_increments(J, J), (0, 1, 2)),
             ("Kuf", pde_increments(Z, Xte), (0, 1, 2)),
             ("", pde_increments(Xte[:64, :2], Xte[64:128, :2]), (0, 1, 2)),
             ("", pde_increments(Xte[:64, :14], Xte[64:128, :6]), (0, 1, 2)),
             ("L=200", pde_increments(X200[:8], X200[8:]), (2, 3))]
    # the reported cases: the main path's dyadic order 1 on its grids
    report_at = {"goursat": ("Kuf", 1, "fast"),
                 "goursat_fused": ("Kuf", 1, "fused"),
                 "goursat_grad": ("joint Gram", 1, "grad")}
    for name, ((ftol, gtol), why) in GOURSAT_TOL.items():
        print(f"goursat tolerance {name}: scaled err <= {ftol:g} forward, "
              f"{gtol:g} gradient: {why}")
    report = {}
    for role, inc_np, orders in grids:
        B, Su, Tu = inc_np.shape
        gbar_np = rng.standard_normal(B)
        for o in orders:
            cells = B * (Su << o) * (Tu << o)
            for route in ("fast", "fused", "grad"):
                errs, times = {}, {}
                for dtype in (torch.float32, torch.float64):
                    name = str(dtype).split(".")[1]
                    inc = torch.as_tensor(inc_np, dtype=dtype, device=dev)
                    gbar = torch.as_tensor(gbar_np, dtype=dtype, device=dev)
                    kern, plain = goursat_route(gs, goursat, route, inc, o,
                                                gbar)
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    check(got.shape == want.shape
                          and bool(torch.isfinite(got).all()),
                          f"goursat {route} {(Su, Tu)} o={o} {name}: "
                          f"{got.shape}, finite {torch.isfinite(got).all()}")
                    errs[name] = (scaled_err(got, want), abs_err(got, want))
                    if dtype == torch.float32:
                        times["ms"] = cuda_ms(kern)
                        big = cells > 1e9
                        times["plain_ms"] = cuda_ms(plain, reps=1 if big
                                                    else 3, warmup=1)
                    del got, want, inc, gbar, kern, plain
                    torch.cuda.empty_cache()
                kind = "grad" if route == "grad" else "fwd"
                read = B * (Su * Tu if route != "fast" else
                            (Su << o) * (Tu << o))
                nbytes = 4 * (read + B) if kind == "fwd" else \
                    4 * (2 * read + B)
                bd = bound(GOURSAT_CELL_OPS[kind] * cells, nbytes)
                gcells = cells / times["ms"] / 1e6
                label = f"goursat {route} ({Su}, {Tu}) o={o} B={B} {role}"
                print(f"{label}: scaled err float32 "
                      f"{errs['float32'][0]:.3e} (max abs "
                      f"{errs['float32'][1]:.3e}), float64 "
                      f"{errs['float64'][0]:.3e}; float32 kernel "
                      f"{times['ms']:.4f} ms ({gcells:.2f} Gcell/s), plain "
                      f"{times['plain_ms']:.4f} ms, bound {bd['bound_ms']:.4f}"
                      f" ms ({bd['bound_by']})")
                for name, (err, _) in errs.items():
                    tol = GOURSAT_TOL[name][0][kind == "grad"]
                    check(err <= tol, f"{label} {name}: {err} > {tol}")
                for key, where in report_at.items():
                    if where == (role, o, route):
                        report[key] = dict(max_abs_err=errs["float32"][1],
                                           ms=times["ms"],
                                           plain_ms=times["plain_ms"], **bd,
                                           library_ms=None)
    return report


def build_pde_svgp(torch, dev, dtype, rng, N=200, L=50, M=32, Lz=8,
                   fresh=False):
    """``job_pde_train``'s SigGPDE SVGP: the untruncated kernel (Linear
    base, lengthscale 1.5, normalised, dyadic order 1), M inducing
    sequences of length Lz drawn from the data with ``joint_psd`` (as the
    reference's ``@pde`` accuracy window builds them), MultiClass C=2;
    q(u) fresh (q_mu = 0, q_sqrt = I) or drawn from ``rng``."""
    from gpsig_tpu_torch.inducing import (InducingSequences,
                                          make_inducing_sequences_from_data)
    from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    Xn, yn = pde_data(N=N, L=L)
    X = torch.as_tensor(Xn, dtype=dtype, device=dev)
    Y = torch.as_tensor(yn, dtype=torch.int64, device=dev)
    kern = UntruncatedSignatureKernel.create(
        2, lengthscales=1.5, normalization=True, dyadic_order=1, dtype=dtype,
        device=dev)
    Z = make_inducing_sequences_from_data(
        torch.Generator().manual_seed(SEED), X, M, Lz, 2).raw_Z.detach()
    feat = InducingSequences.create(Z, joint_psd=True)
    model = SVGP.create(kern, MultiClass(2), feat, num_latent=2, dtype=dtype,
                        device=dev)
    if not fresh:
        q_mu = 0.5 * rng.standard_normal((M, 2))
        q_sqrt = (np.tril(0.02 * rng.standard_normal((2, M, M)))
                  + 0.9 * np.eye(M))
        with torch.no_grad():
            model.q_mu.copy_(torch.as_tensor(q_mu))
            model.q_sqrt.copy_(torch.as_tensor(q_sqrt))
    return model, X, Y


def check_pde_route(launches, need, label):
    """The Goursat kernels in ``need`` ran; no truncated kernel did."""
    print(f"{label} launches: {launches}")
    for key in need:
        check(launches[key] > 0, f"kernel {key} was not launched by {label}")
    for key in KERNELS:
        if key not in GOURSAT:
            check(launches[key] == 0, f"truncated kernel {key} ran in {label}")


def pde_serving_phase(dev):
    """(h) The SigGPDE SVGP serving path at ``job_pde_train``'s width,
    float32: ELBO on 50 of 200 under ``joint_psd`` on (one 82² joint solve
    and an 82 x 82 eigh) and off (Kuu, Kuf and Kdiag), ``posterior()`` +
    ``predict_y`` on N_test=2048 (Kuf: 65,536 pairs of 14 x 98 refined
    cells; the test diagonal: 2048 of 98 x 98), and Kuf through
    ``engine="scan"`` held against ``engine="auto"``."""
    import torch

    f32 = torch.float32
    rng = np.random.default_rng(SEED + 21)
    model, X, Y = build_pde_svgp(torch, dev, f32, rng)
    Xb, Yb = X[:50], Y[:50]
    Xtest = torch.as_tensor(pde_data(N=2048, seed=1)[0], dtype=f32,
                            device=dev)
    scan_kern = copy.deepcopy(model.kernel)
    scan_kern.engine = "scan"

    def serve():
        elbo = model.elbo(Xb, Yb, num_data=200)
        model.inducing.joint_psd = False
        try:
            elbo_sep = model.elbo(Xb, Yb, num_data=200)
        finally:
            model.inducing.joint_psd = True
        post = model.posterior()
        probs, pvar = post.predict_y(Xtest)
        fmean, fvar = post.predict_f(Xtest)
        Kuf = model.inducing.Kuf(model.kernel, Xtest)
        Kuf_scan = model.inducing.Kuf(scan_kern, Xtest)
        torch.cuda.synchronize()
        return dict(elbo=elbo, elbo_sep=elbo_sep, probs=probs, pvar=pvar,
                    fmean=fmean, fvar=fvar, Kuf=Kuf, Kuf_scan=Kuf_scan)

    with torch.no_grad():
        reset_counters()
        out = serve()
        launches = counters()
        check_pde_route(launches, ("goursat", "goursat_fused"),
                        "SigGPDE serving")
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"SigGPDE {k} not finite")
        check(out["probs"].shape == (Xtest.shape[0], 2),
              "SigGPDE predict_y shape")
        sums = out["probs"].sum(-1)
        check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-5)),
              "SigGPDE class probabilities do not sum to 1")
        for k in ("pvar", "fvar"):
            check(bool((out[k] >= 0).all()), f"SigGPDE {k} has negatives")
        err = scaled_err(out["Kuf_scan"], out["Kuf"])
        print(f"SigGPDE Kuf engine='scan' vs 'auto': scaled err {err:.3e}, "
              "tolerance 1e-6 (the same sweep: inc/4 refined in memory or "
              "inc·(1/4) in the kernel, both exact)")
        check(err <= 1e-6, f"SigGPDE scan vs auto Kuf: {err}")
        print(f"SigGPDE elbo {out['elbo'].item():.6g} (joint_psd), "
              f"{out['elbo_sep'].item():.6g} (separate), mean max prob "
              f"{out['probs'].max(-1).values.mean().item():.4f}")
        with plain_route():
            ref = serve()
        # Kuf: both routes' float32 sweeps from the same inputs; the rest
        # carries Kuf's rounding through the M=32 Cholesky (f32 jitter
        # 1e-4) and, in the ELBO, the eigh of the joint projection
        compare_routes("SigGPDE", out, ref,
                       dict(Kuf=1e-4, Kuf_scan=1e-4, fmean=1e-3, fvar=1e-3,
                            probs=1e-3, pvar=1e-3, elbo=1e-3,
                            elbo_sep=1e-3))
        ms_predict = host_ms(lambda: model.posterior().predict_y(Xtest))
        post = model.posterior()
        ms_cached = host_ms(lambda: post.predict_y(Xtest))
        ms_elbo = host_ms(lambda: model.elbo(Xb, Yb, num_data=200))
        with plain_route():
            ms_plain = host_ms(lambda: post.predict_y(Xtest), reps=3)
        print(f"time SigGPDE posterior()+predict_y N_test=2048: "
              f"{ms_predict:.3f} ms; predict_y on a cached posterior: "
              f"{ms_cached:.3f} ms (plain route {ms_plain:.3f} ms); elbo "
              f"B=50 (joint_psd): {ms_elbo:.3f} ms")
        profile_split(lambda: post.predict_y(Xtest),
                      "SigGPDE predict_y, cached posterior, N_test=2048")
        profile_split(lambda: model.elbo(Xb, Yb, num_data=200),
                      "SigGPDE ELBO (joint_psd), B=50")
    return launches


def pde_training_phase(dev):
    """(i) ``job_pde_train``'s training loop at its width, float32: 6
    natgrad + Adam steps (B=50 of 200, Adam 2e-3, γ=0.05, joint_psd) from a
    fresh q(u); each step solves the 82² joint Gram twice forward (natgrad
    ELBO, loss) and runs the adjoint once (the loss's backward)."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    rng = np.random.default_rng(SEED + 22)
    model, X, Y = build_pde_svgp(torch, dev, torch.float32, rng, fresh=True)
    plain_model = copy.deepcopy(model)
    N = X.shape[0]
    batches = [torch.as_tensor(rng.choice(N, 50, replace=False),
                               device=dev) for _ in range(6)]
    step = make_step_fn(2e-3, num_data=N, gamma=0.05)
    state = step.init(model)
    reset_counters()
    elbos, ms, first = [], [], None
    for k, idx in enumerate(batches):
        (state, elbo), t = timed(lambda: step(state, X[idx], Y[idx]))
        elbos.append(elbo.item())
        ms.append(t)
        if k == 0:
            first = grads_and_params(model)
    launches = counters()
    check_pde_route(launches, ("goursat_fused", "goursat_grad"),
                    "SigGPDE training")
    print(f"train SigGPDE elbo per step: {elbos}")
    check(all(np.isfinite(elbos)), "SigGPDE elbo not finite")
    for p in model.parameters():
        check(bool(torch.isfinite(p).all()), "trained parameter not finite")
    with plain_route():
        pstep = make_step_fn(2e-3, num_data=N, gamma=0.05)
        pstep(pstep.init(plain_model), X[batches[0]], Y[batches[0]])
    torch.cuda.synchronize()
    compare_first_step("SigGPDE", first, grads_and_params(plain_model), 2e-3,
                       why="float32 Goursat sweeps carried through the eigh "
                       "of the 82 x 82 joint projection and the M=32 "
                       "Cholesky")
    print(f"time SigGPDE natgrad+Adam step (M=32, Lz=8, L=50, B=50, "
          f"dyadic order 1): {statistics.median(ms[1:]):.3f} ms (median of "
          f"{len(ms) - 1}; all {[round(t, 3) for t in ms]})")
    profile_split(lambda: step(state, X[batches[1]], Y[batches[1]]),
                  "SigGPDE natgrad+Adam step, B=50")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    return launches


def small_float64_pde_check(dev):
    """(j) A small float64 SigGPDE model (M=6 inducing sequences of length
    4, N=12 sequences of L=10): three natgrad + Adam steps on the card
    against the same steps on the CPU (plain path), rtol 1e-8."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    rng = np.random.default_rng(SEED + 23)
    model, X, Y = build_pde_svgp(torch, dev, torch.float64, rng, N=12, L=10,
                                 M=6, Lz=4)
    runs = {}
    for where, (m, Xw, Yw) in {
            "card": (model, X, Y),
            "cpu": (copy.deepcopy(model).to("cpu"), X.cpu(), Y.cpu())}.items():
        step = make_step_fn(1e-2, num_data=12, gamma=0.05)
        state = step.init(m)
        out = []
        for _ in range(3):
            state, elbo = step(state, Xw, Yw)
            out.append(elbo)
        out += [p.detach() for p in m.parameters()]
        runs[where] = [t.cpu() for t in out]
    err = max(scaled_err(g, w) for g, w in zip(runs["card"], runs["cpu"]))
    print(f"small float64 SigGPDE training (3 natgrad+Adam steps): card vs "
          f"CPU scaled err {err:.3e} over every ELBO and parameter, "
          "tolerance 1e-8")
    check(err <= 1e-8, f"small float64 SigGPDE training: {err}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "gpsig_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: gpsig_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from gpsig_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib.relative_to(ROOT)}")
    for line in Path(str(lib) + ".log").read_text().splitlines():
        if line.endswith(" s") and ".cu: " in line:
            print(f"nvcc {Path(line.split(': ')[0]).name}: "
                  f"{line.split(': ')[1]}")

    dev = torch.device("cuda", 0)
    timings = kernel_phase(dev)
    launches = slice_phase(dev)
    small_float64_check(dev)
    train_launches = training_phase(dev)
    small_float64_training_check(dev)
    timings.update(slice1_kernel_phase(dev))
    coverage_sweep(dev)
    svgp2_launches = slice1_serving_phase(dev)
    gpr_launches = slice1_gpr_phase(dev)
    small_float64_check(dev, order=2)
    small_float64_gpr_check(dev)
    timings.update(slice1_backward_kernel_phase(dev))
    train1 = slice1_training_phase(dev)
    small_float64_training_check(dev, order=2, gpr_ctor="SignaturePoly",
                                 offset=0.6)
    timings.update(goursat_kernel_phase(dev))
    pde_launches = pde_serving_phase(dev)
    pde_train = pde_training_phase(dev)
    small_float64_pde_check(dev)

    # launches, each from the main-path run that its counters were reset
    # just before: slice 0's forward kernels from its serving run, the
    # backward kernels from its training run, Kuf and the order-2 diagonal
    # from the order-2 SVGP serving run, the general Gram and the order-1
    # sig_gram from the GPR run; slice 1's backwards from its training
    # paths (Kuf's and the order-2 diagonal's from the order-2 SVGP steps,
    # the general Gram's from the order-2 GPR's, the order-1 diagonal's
    # from the Poly GPR's); the Goursat forwards from the SigGPDE serving
    # run (the given-grid kernel by its engine="scan" Kuf), the adjoint from
    # its training steps
    source_of = dict(gram_bwd=train_launches, tens_seq_bwd=train_launches,
                     tsg=svgp2_launches, sig_gram_ho=svgp2_launches,
                     gram_ho=gpr_launches, sig_gram=gpr_launches,
                     tsg_bwd=train1["order-2 SVGP"],
                     sig_gram_ho_bwd=train1["order-2 SVGP"],
                     gram_ho_bwd=train1["order-2 GPR"],
                     sig_gram_bwd=train1["Poly GPR"],
                     goursat=pde_launches, goursat_fused=pde_launches,
                     goursat_grad=pde_train)
    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        n = source_of.get(key, launches)[key]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=n, **timings[key]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
