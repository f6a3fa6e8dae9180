#!/usr/bin/env python3
"""Drive the PyTorch port (``gpsig_tpu_torch``) on one NVIDIA GPU and check
it end to end: slice 0 (the order-1 model, serving and training), slice 1
(the general engines: order-2 SVGP and GPR, serving and training), the PDE
slice (the SigGPDE SVGP), sequences past 129 steps (the GunPoint-length
path, L = 150, serving and training), num_levels 8-127, the order-1
model at wide and long UEA shapes (PEMS-SF, MotorImagery), and every
sequence length and order (sig_gram's bands, orders 4-7, the inducing-
sequence SVGP at L = 3000, GPRs past 1024 rows), sig_gram past order 7,
the entry twin of ``__graft_entry__.py``, UEA archive files through the
port's reader, the rest of the GP layer (VOSF at BASELINE config 6,
VOSF under the PDE prior, the low-rank kernel, the Monte-Carlo Softmax),
NUTS at BASELINE config 5 (16 chains as one batch), the multi-process
layer (BASELINE config 4's sharded SVI on ranks sharing the card), and
GPSig's call surface (``gpsig_tpu_torch.compat``) over all of it.

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
   version at the main path's shapes in float32 and float64, timed; every
   segment plan of the two Gram forwards (``gram_plan_sweep``: each lane
   count at each rows-a-lane and level bound, the block design, the
   symmetric Gram's triangle) against its plain version; a coverage
   sweep at small sizes over every base kind × ``difference`` ×
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
   against the CPU; every launch plan of the two general Kuf kernels
   (``kuf_plan_sweep``: blocks, sequences a thread, pairs a warp, one chunk
   and several at L = 2-300, shared memory and the workspace) and all four
   Kuf kernels at d = 64, 400 and 1345 against their plain versions in
   float32 and float64, and two float64 steps of an order-2 SVGP at d = 64
   on the card against the CPU;
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
10. long sequences (L > 129): (k) rows 1-3, 6-7 and 10-13 against their
   plain versions at L in {130, 150, 300} (sig_gram at L2 in {130, 150,
   300} and the inducing-sequence shape M [B, 8, 150]), rows 1-3 at
   L = 512 (d = 8), rows 4, 5, 8 and 9 at L = 150, float32 and float64;
   (l) each at L = 150 at the GunPoint-length path's shapes, timed, with
   its bound; (m) the SynthGunPoint window model (order 1, nl=4, 64
   inducing tensors with increments, MultiClass(2)) on its own data
   (scaled, time added, L = 150, d = 2): ELBO on the 50 training
   sequences, ``posterior()`` + ``predict_y`` on the 150 test sequences
   and 2048 more, 6 natgrad + Adam steps, then its order-3 variant's
   serving and 3 steps, each with its counters and against the plain
   route; (n) exact GPR at L = 150 (order-1 RBF, order-2 RBF, order-1
   Poly; 5 Adam steps each, counters, ms per step, a profile of the
   RBF steps, the Gram forward's triangle against every pair and the
   plain version, both timed, the first step against the plain route on
   48 sequences); (o) a small float64 GunPoint-length model on the card
   against the CPU, serving and 3 steps;
11. num_levels 8-127: (p) the four sig_gram routes (forward and backward,
   orders 1 and 2) against their plain versions at num_levels 8, 12 and
   127, L' in {49, 149}, float32 and float64, one case whose DP state
   takes the device workspace (order 1, 127 levels, L' = 600, float64),
   each route timed at the nl = 10 GPR's Gram (B = 150², L' = 49);
   (q) exact GPR at BASELINE config 1's shape with num_levels = 10: order
   1, K, lml and gradients on the card against the CPU in float64, and
   order 2 against the plain route on the card, each with its counters;
12. the Goursat adjoint's redesign: (r) in phase 7 each gradient that one
   warp a pair takes is run twice and held bitwise equal; the symmetric
   joint Gram (the training step's [Z; X_batch], dyadic order 1) solves
   its triangle of pairs: values and gradients against the full solve of
   every pair, float64;
13. every d and L on the order-1 main path: (s) the diagonal at d = 64,
   400, 1345 and at L = 257, 1025, 3000 (bands), both Gram backwards at
   d = 64 and 400 (L = 50, 150), the Gram forwards' block design at
   L = 300, d = 400, float32 and float64 against their plain versions,
   each plan printed; (t) the order-1 normalised SVGP with inducing
   tensors at UEA PEMS-SF's shape (d = 963, L = 144, 7 classes, 500
   tensors, 267 train / 173 test sequences) and MotorImagery's (d = 64,
   L = 3000, 2 classes, 100 tensors, 278 / 100), synthetic data from the
   seed: ``posterior()`` + ``predict_y`` on the test sequences and natgrad
   + Adam steps (2 at B = 50, 2 at B = 16), each with its counters (the
   diagonal, the Kuf forward and its backward) and wall times; (u) the
   PEMS-SF model in float64 at small N, T, L, card against the CPU; every
   phase's wall time is printed;
14. every length and order: (v) sig_gram at every design edge (L2 in
   1-9, 31-33, 63-65, 127-129, 255-257, 1023-1025, 1300, 3000 x p in
   {1, 2, 3} x num_levels in {2, 4, 7, 10}: segments of 8-32 lanes, bands
   in shared memory and in the workspace), forward and backward, float32
   and float64, against the plain versions; (w) orders 4-7 at num_levels 8
   and 10; (x) the Goursat forward, given-grid route and adjoint on
   [2, 4100] at dyadic order 3 (16 x 32,800 refined, past the old 2^15 a
   side); (y) BASELINE config 3's SVGP (40 inducing sequences of length
   8, nl = 4, B = 50) at MotorImagery's shape (d = 64, L = 3000, C = 2):
   ``posterior()`` + ``predict_y`` and 2 natgrad + Adam steps, the
   two-length Gram through sig_gram with the short side on its rows; (z)
   exact GPRs at L = 1300 (N = 6, nl = 4), orders 1 and 2: K, lml,
   ``predict_y`` and 2 Adam steps, the Gram past 1024 rows through
   sig_gram's bands; (y) and (z) with their counters and against the plain
   route on the card;
15. past order 7, the entry twin and the UEA files: sig_gram's
   run-time-order instance (p = min(order, num_levels) > 7) forward and
   backward against the plain versions at num_levels 8 and 10, orders 8
   and 10, L2 in {49, 150}, and p = nl = 20 at L2 = 150 (the workspace
   route), float32 and float64, each case's routes printed (register,
   shared memory, workspace), within ORDER_BUDGET_S seconds; timed at
   num_levels = 8, order 8 on 150² matrices of L' = 49, then a GPR Adam
   step of
   SignatureRBF(2, 8, order=8) at N = 150, L = 50 and a small float64 one
   against the CPU; ``gpsig_tpu_torch.entry.entry()`` on the card in
   float32 against the plain route; .ts files at
   ArticularyWordRecognition's (d = 9, L = 144, 275 / 300, 25 classes) and
   CharacterTrajectories' (d = 3, L = 60-182, 1422 / 1436, 20 classes)
   published shapes read back through the port's native parser, prepared
   as the benchmarks prepare a UEA set, and 2 natgrad + Adam steps and
   ``posterior()`` + ``predict_y`` of BASELINE config 3's model and of the
   accuracy windows' base model, with their counters;
16. the rest of the GP layer, each phase with its wall time and the
   card's name and power limit beside its figures: BASELINE config 6 at
   its defaults (VOSF: the explicit signature kernel, nl = 7, M = 255,
   q_diag, MultiClass(10); 120,000 SITS-like sequences with time on the
   card): 5 Adam-only and 2 natgrad + Adam steps at B = 4096, the float32
   route against float64 on the card (fvar in units of Knn), a profile of
   a step and of serving, ``posterior()`` (``quad_is_diag``) +
   ``predict_y`` on 10,000, no kernel counter rising, a small float64
   model against the CPU; the SigGPDE VOSF model at the same width
   (untruncated Linear-base kernel, dyadic order 1, features to 7
   levels): 2 natgrad + Adam steps, each with the Goursat forward and
   adjoint counters reset just before it and rising, the first step and
   serving against the plain route, a small float64 model against the
   CPU; ``LowRankSignatureRBF`` at the ``@lowrank`` protocol on
   CharacterTrajectories' shape: 2 steps (the landmarks move), serving
   on 1,436, float64 Grams and ELBO card against CPU at the same
   landmarks and pairs, the float32 difference stated; the config-6 model
   with ``Softmax(10, 20)``: 2 steps and ``predict_y`` from seeded
   generators, twice, bitwise equal;
17. NUTS at BASELINE config 5 (``benchmarks/config5_nuts.py``: 16
   chains, N = 40 sequences of L = 20, d = 2, nl = 3), within a budget of
   NUTS_BUDGET_S seconds checked by the phase: the order-1 Gram, its
   diagonal and the Gram's backward with the chain axis [16, 40, 20, 2]
   against their plain versions in float32 and float64 and against 16
   unbatched launches (the forward and diagonal bitwise, the backward
   within its atomics' reordering), each timed as one launch, 16 launches
   and the plain version; config 5's target through ``make_chunked_sampler``
   (max_depth 6, chunks of 25; the draw counts cut to CONFIG5_RUN), the
   three counters reset just before and rising by exactly one a
   logp-and-gradient evaluation, with wall time, draws/s, the smallest
   ESS and ESS/s, the largest split-R̂, mean leaves, divergences, batch
   utilisation, host reads a transition and the posterior mean
   lengthscales; 10 float64 transitions on the card against the CPU on
   the CPU's draws (its generators' states replayed), each from the CPU's
   carry (1e-9) and freely
   (no branch may flip); a run stopped after 2 chunks and resumed from its
   checkpoint, bitwise equal to an uninterrupted one on a deterministic
   target, config 5's printed;
18. multi-process (``gpsig_tpu_torch/parallel/``), within a budget of
   PARALLEL_BUDGET_S seconds checked by the phase, each rank a process of
   this script (``--parallel-rank``) that must exit 0 and print its JSON
   line: BASELINE config 4 at full width (20,000 synthetic sequences of
   L = 30, d = 3, 5 classes; order-1 normalised SignatureRBF, nl = 3, 64
   inducing tensors, MultiClass(5), γ = 0.05, Adam 2e-3, global batch
   256 through the sharded loader, float32; 3 steps), as one rank under
   NCCL and as two ranks on cuda:0 under gloo, against the same 3 steps
   in one process on the same batches (PARALLEL_F32_TOL), the two ranks'
   parameters bitwise equal, each rank's diagonal, Kuf and Kuf backward
   counters rising, ms a sharded step and the share in all_reduce;
   ``sharded_gram`` at bench.py's shape (N = 256, L = 50, d = 2, nl = 4)
   on (2, 1) and (1, 2) meshes against K on the card, the Gram counter
   rising on each rank; the sequence-parallel Goursat corner (float64,
   s split over 2 ranks) against ``goursat_corner`` on the card; config
   5's 16 chains as 2 ranks x 8 (draws cut to CONFIG5_SHARDED's), each
   rank's chain-axis counters rising by one an evaluation and one step
   size on every chain and rank; the float64 worker's run
   (``gpsig_tpu_torch.parallel.worker.run``, 2 ranks, 4 steps) against the
   one-process CPU run (PARALLEL_F64_TOL); each rank's seconds to start
   and a scenario;
19. compat facade (``gpsig_tpu_torch/compat/``), within a budget of
   COMPAT_BUDGET_S seconds checked by the phase: the flagship (M = 500
   inducing tensors with increments, nl = 5, d = 3, L = 50, C = 10; 840
   sequences flattened to [840, 150]) through the facade's SVGP, 3
   alternations of ``NatGradOptimizer(0.1)`` and frozen
   ``AdamOptimizer(1e-3)`` at B = 50, held a step at a time against the
   core's ``natgrad_step`` and loss gradient from the facade's state on
   the same batches (ELBOs and q within PARALLEL_F32_TOL, gradients within
   BWD_TOL) and against Adam replaying its gradients, the diagonal, Kuf and
   Kuf-backward counters rising, ``predict_y`` and ``predict_density`` on
   2048 flattened sequences bitwise equal to the core's posterior, ms per
   alternation and per ``predict_y`` for facade and core; BASELINE config
   3 at MotorImagery's shape ([278, 192000] flattened) through
   ``compat.training.fit`` (2 steps at B = 50) against ``make_step_fn`` on
   the same batches (as the flagship), the sig_gram, Gram and diagonal counters (forward and
   backward) rising; ``compute_K_symm``, ``compute_K`` and
   ``compute_Kdiag`` at bench.py's shape bitwise equal to the core's
   ``K`` / ``Kdiag``; small float64 facade models (order-1 inducing
   tensors, the SigGPDE VOSF model, whose Goursat forward and adjoint
   counters rise) after 3 alternations on the card against the CPU
   (1e-10);
20. report: one JSON line with every kernel's launches, error, times and
   bound (rows 1-13 also with their L = 150 time, plain time, bound and
   launches on the long path, under "long"; rows 10-13 with the same
   at num_levels = 10, under "deep"; rows 12-13 the run-time-order
   instance's at num_levels = 8, order 8, under "order"; rows 1-3 the
   chain axis at config 5, under "nuts": one launch, 16 unbatched
   launches, plain and bound in ms, launches in the NUTS run and a
   transition), then the device line.

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
    "diag": ("_diag_kernel", "gpsig_tpu_torch/csrc/fused_diag.cuh",
             "gpsig_tpu/ops/pallas/fused_gram.py:330"),
    "tens_seq": ("_tens_seq_kernel", "gpsig_tpu_torch/csrc/tens_seq.cuh",
                 "gpsig_tpu/ops/pallas/tens_seq.py:66"),
    "gram_bwd": ("_bwd_fused_kernel", "gpsig_tpu_torch/csrc/fused_gram_bwd.cu",
                 "gpsig_tpu/ops/pallas/fused_gram.py:631"),
    "tens_seq_bwd": ("_tens_seq_bwd_kernel",
                     "gpsig_tpu_torch/csrc/tens_seq_bwd.cuh",
                     "gpsig_tpu/ops/pallas/tens_seq.py:281"),
    "gram_ho": ("_ho_kernel", "gpsig_tpu_torch/csrc/fused_gram_ho.cuh",
                "gpsig_tpu/ops/pallas/fused_gram_ho.py:133"),
    "tsg": ("_tsg_kernel", "gpsig_tpu_torch/csrc/tens_seq_general.cuh",
            "gpsig_tpu/ops/pallas/tens_seq_general.py:200"),
    "sig_gram": ("_fwd_kernel", "gpsig_tpu_torch/csrc/sig_gram.cuh",
                 "gpsig_tpu/ops/pallas/sig_gram.py:80"),
    "sig_gram_ho": ("_fwd_kernel_ho", "gpsig_tpu_torch/csrc/sig_gram.cuh",
                    "gpsig_tpu/ops/pallas/sig_gram.py:126"),
    "gram_ho_bwd": ("_ho_bwd_kernel",
                    "gpsig_tpu_torch/csrc/fused_gram_ho_bwd.cuh",
                    "gpsig_tpu/ops/pallas/fused_gram_ho_bwd.py:61"),
    "tsg_bwd": ("_tsg_bwd_kernel",
                "gpsig_tpu_torch/csrc/tens_seq_general_bwd.cuh",
                "gpsig_tpu/ops/pallas/tens_seq_general.py:364"),
    "sig_gram_bwd": ("_bwd_kernel", "gpsig_tpu_torch/csrc/sig_gram_bwd.cuh",
                     "gpsig_tpu/ops/pallas/sig_gram.py:98"),
    "sig_gram_ho_bwd": ("_bwd_kernel_ho",
                        "gpsig_tpu_torch/csrc/sig_gram_bwd.cuh",
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
# the tensor cores, and HBM3; the special-function pipe (exp, cos, sqrt)
# at 16 results a clock an SM (Hopper's MUFU), 132 SMs at 1.98 GHz
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9


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
    from gpsig_tpu_torch.ops.cuda import launch_counts

    return launch_counts()


def reset_counters():
    from gpsig_tpu_torch.ops.cuda import reset_launch_counts

    reset_launch_counts()


# ---------------------------------------------------------------------------
# Work of each kernel on its inputs, for its bound: the floating-point
# operations its algorithm needs (an FMA counts 2) over the FP32 peak, its
# exps, cosines and square roots over the special-function pipe's rate,
# and its bytes (each input read once, each output written once) over the
# HBM rate; the largest is the least time the card could take. Counted per
# float32 value (the timed dtype).
# ---------------------------------------------------------------------------

class Work:
    """A kernel's operations: ``flops`` on the FP32 pipe and ``sfu``
    special-function results; ``k * work`` and ``a + b`` as for numbers."""

    def __init__(self, flops, sfu=0):
        self.flops, self.sfu = flops, sfu

    def __rmul__(self, k):
        return Work(k * self.flops, k * self.sfu)

    __mul__ = __rmul__

    def __add__(self, other):
        other = other if isinstance(other, Work) else Work(other)
        return Work(self.flops + other.flops, self.sfu + other.sfu)

    __radd__ = __add__


def bound(ops, nbytes):
    """The least time of ``ops`` (a Work, or FP32 flops) on ``nbytes``:
    "operations" where the FP32 or the special-function pipe binds."""
    ops = ops if isinstance(ops, Work) else Work(ops)
    t_ops = max(ops.flops / F32_OPS_PER_S, ops.sfu / SFU_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def base_ops(d, kind):
    """One base-kernel value: the dot product (d FMAs), the half norms
    where the kind has them, and its exp (RBF) or cos and sqrt (cosine) on
    the special-function pipe."""
    norms = kind in ("rbf", "cosine")
    return Work(2 * d + 2 * norms,
                {"rbf": 1, "cosine": 2}.get(kind, 0))


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

    def gram_ref(X, Y, num_levels, rbf=True, symmetric=False):
        return fg.fused_gram_levels_ref(X, Y, num_levels, rbf)

    def gram_ho_ref(X, Y, num_levels, order, kind="rbf", difference=True,
                    symmetric=False):
        return fgho.fused_gram_ho_levels_ref(X, Y, num_levels, order, kind,
                                             difference)

    # (the plain Grams compute every pair: ``symmetric`` changes nothing)
    patches = [(fg, "fused_gram_levels", gram_ref),
               (fg, "fused_diag_levels", fg.fused_diag_levels_ref),
               (fg, "fused_gram_levels_bwd", fg.fused_gram_levels_bwd_ref),
               (ts, "fused_tens_seq_levels", ts.fused_tens_seq_levels_ref),
               (ts, "tens_seq_bwd", ts.tens_seq_bwd_ref),
               (fgho, "fused_gram_ho_levels", gram_ho_ref),
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
        "tens_seq_train": (kuf_work(500, 30, 50, 50, 3, 5),
                           4 * (500 * 30 * 3 + 50 * 50 * 3 + 6 * 500 * 50)),
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
        ("tens_seq_train", "Kuf RBF T=500 increments N=50 L=50 d=3 nl=5",
         lambda z, x: ts.fused_tens_seq_levels(z, x, 5, True, True),
         lambda z, x: ts.fused_tens_seq_levels_ref(z, x, 5, True, True),
         (z_inc, train_x[:50])),
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
    report = run_cases(dev, cases, works, TOL)
    # the training shape's Kuf (N = 50) rides on the Kuf's entry
    report["tens_seq"]["train"] = report.pop("tens_seq_train")
    return report


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


def build_svgp(torch, dev, dtype, rng, M, nl, d, L, C, n_train, order=1,
               data=None):
    """The flagship's SVGP (normalised SignatureRBF, inducing tensors with
    increments drawn from the data, MultiClass(C)) on ``data`` [n_train, L,
    d] (numpy; default: walks from ``rng``)."""
    from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    X = torch.as_tensor(walks(rng, n_train, L, d) if data is None else data,
                        dtype=dtype, device=dev)
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
        profile_split(lambda: post.predict_y(Xtest),
                      "order-1 predict_y, cached posterior, N_test=2048")
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
                       "L⁻¹ grow to 100", grad_tol=1e-2):
    """The first step through the kernels against the same step through
    the plain functions on the card (float32 unless the models are
    float64), each parameter's gradient and new value."""
    (g_grad, g_par), (w_grad, w_par) = got, want
    check(set(g_grad) == set(w_grad), f"{label}: gradients of "
          f"{sorted(g_grad)} vs {sorted(w_grad)}")
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
    profile_split(lambda: svgp_step(state, X[batches[1]], Y[batches[1]]),
                  "order-1 SVGP natgrad+Adam step, B=50")
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
    report = run_cases(dev, cases, works, GEN_TOL)
    gram_plan_sweep(dev)
    return report


def plan_lengths(R, lanes):
    """Sequence lengths (with difference) at which each segment of
    ``lanes`` is full at R rows a lane (S·R rows: the last lane's last row
    is the matrix's), at R = 2 also 128 rows (32 lanes at 4 rows a lane),
    and one past one warp (the block design)."""
    return [S * R + 1 for S in lanes] + ([129] if R == 2 else []) + [300]


def parent_widest_d(L, itemsize, smem_bytes):
    """The widest d whose Gram forward the one-warp design before segments
    took at L within ``smem_bytes`` of shared memory a block: x and four
    pairs' y with their half norms up to 128 rows, x and y and the W warps'
    exchange past that. The segment plan must take it too."""
    W = -(-(L - 1) // 128)
    pairs, ex = (4, 0) if W == 1 else (1, 2 * W * itemsize)
    return (smem_bytes - ex) // (itemsize * L * (1 + pairs)) - 1


def gram_plan_sweep(dev):
    """(a) Every segment plan of the two Gram forwards (each S at each R
    that ``plan.gram_fwd_plan`` gives: the order-1 kernel at level bounds 4
    and 7, the general one at orders 1-4 and 7 with level bounds 4 and 7),
    at the lengths where its segments are full, and the block design at
    L = 300; every base kind and ``difference`` False in turn; against the
    plain versions in float32 and float64, X [9, L, 2] against Y [7, L, 2]
    (a pair count that is no multiple of a block's) and the symmetric Gram
    of X (the triangle), which must also be exactly symmetric. Then the
    widest d that the design before segments took at L = 50 and 150 (the
    segments' y read from global memory where the block's y do not fit
    its shared memory), at orders 1-3, RBF."""
    import torch

    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import plan

    rng = np.random.default_rng(SEED + 13)
    kinds = ["rbf", "cosine", "poly2", "linear", "poly3"]
    calls = []  # (label, kernel, plan, kernel call, plain call)
    for nl in (3, 4, 5, 7):
        for dtype in (torch.float32, torch.float64):
            R = plan.gram_fwd_rows_per_lane(1, nl, dtype.itemsize, True)
            for i, L in enumerate(plan_lengths(R, plan.SEG_LANES)):
                a = (nl, (i + nl) % 2 == 0)  # RBF and Linear in turn
                calls.append((f"order-1 nl={nl} L={L}", "gram", dtype, L, 2,
                              a, lambda x, a=a: fg._forward_plan(
                                  "k", x, False, a[0]),
                              lambda x, y, sym, a=a: fg.fused_gram_levels(
                                  x, y, *a, symmetric=sym),
                              lambda x, y, a=a: fg.fused_gram_levels_ref(
                                  x, y, *a)))
    for order, nl in ((1, 4), (2, 4), (2, 5), (3, 4), (4, 4), (7, 7)):
        p = min(order, nl)
        for dtype in (torch.float32, torch.float64):
            R = plan.gram_fwd_rows_per_lane(p, nl, dtype.itemsize)
            lanes = plan.SEG_LANES if p <= 3 else (32,)
            lengths = plan_lengths(R, lanes)
            for i, L in enumerate(lengths + [lanes[-1] * R]):
                difference = i < len(lengths)  # the last: L rows, raw
                # (a raw Poly Gram's high levels leave float32's range)
                kind = (kinds[(i + order) % len(kinds)] if difference else
                        "cosine")
                a = (nl, order, kind, difference)
                calls.append((f"order-{order} nl={nl} {kind} difference="
                              f"{difference} L={L}", "gram_ho", dtype, L, 2,
                              a, lambda x, a=a: fgho._plan(
                                  "k", x, a[3], False, a[0], a[1]),
                              lambda x, y, sym, a=a:
                              fgho.fused_gram_ho_levels(x, y, *a,
                                                        symmetric=sym),
                              lambda x, y, a=a:
                              fgho.fused_gram_ho_levels_ref(x, y, *a)))
    for L in (50, 150):
        for dtype in (torch.float32, torch.float64):
            d = parent_widest_d(L, dtype.itemsize, plan.SMEM_BYTES)
            calls.append((f"order-1 nl=4 L={L} d={d}", "gram", dtype, L, d,
                          (4, True), lambda x: fg._forward_plan(
                              "k", x, False, 4),
                          lambda x, y, sym: fg.fused_gram_levels(
                              x, y, 4, True, symmetric=sym),
                          lambda x, y: fg.fused_gram_levels_ref(
                              x, y, 4, True)))
            for order in (2, 3):
                a = (4, order, "rbf", True)
                calls.append((f"order-{order} nl=4 rbf L={L} d={d}",
                              "gram_ho", dtype, L, d, a,
                              lambda x, a=a: fgho._plan(
                                  "k", x, True, False, 4, a[1]),
                              lambda x, y, sym, a=a:
                              fgho.fused_gram_ho_levels(x, y, *a,
                                                        symmetric=sym),
                              lambda x, y, a=a:
                              fgho.fused_gram_ho_levels_ref(x, y, *a)))
    worst, plans = {}, set()
    with torch.no_grad():
        for label, key, dtype, L, d, a, plan_of, kern, plain in calls:
            name = str(dtype).split(".")[1]
            kind = a[2] if key == "gram_ho" else "rbf"
            # wide sequences: steps of norm as at d = 2
            X, Y = with_offset_channel(
                long_walks(rng, 9, L, d) * np.sqrt(2 / d),
                long_walks(rng, 7, L, d) * np.sqrt(2 / d), kind)
            # the symmetric Gram's two sides (a Poly offset channel differs)
            Xs, Ys = with_offset_channel(X[..., :d], X[..., :d], kind)
            X, Y, Xs, Ys = (torch.as_tensor(v, dtype=dtype, device=dev)
                            for v in (X, Y, Xs, Ys))
            pl = plan_of(X)
            tol = ((TOL if key == "gram" else GEN_TOL)[name][0]
                   if name == "float64" or L <= 150 else LONG_F32_TOL[0])
            for sym, (u, v) in ((False, (X, Y)), (True, (Xs, Ys))):
                got, want = kern(u, v, sym), plain(u, v)
                check(got.shape == want.shape and bool(
                    torch.isfinite(got).all()), f"plan sweep {label}")
                err = scaled_err(got, want)
                check(err <= tol, f"plan sweep {key} {label} {name} "
                      f"symmetric={sym} plan {pl}: {err} > {tol}")
                if sym:
                    check(bool(torch.equal(got, got.transpose(1, 2))),
                          f"plan sweep {key} {label}: triangle not "
                          "symmetric")
                k = (key, name)
                worst[k] = max(worst.get(k, 0.0), err)
            plans.add((key, name, pl))
    for (key, name), err in sorted(worst.items()):
        got = sorted(pl for k, n, pl in plans if (k, n) == (key, name))
        print(f"plan sweep {key} {name}: worst scaled err {err:.3e} over "
              f"the plans (S, R, W) {got}, full and triangle")


def kuf_inputs(rng, T, N, L, d, nl, increments, kind):
    """Kuf inputs at any d: walks whose steps keep the norms of d = 2
    (``long_walks`` scaled by √(2/d)), inducing tensors drawn from the
    steps of 8 more such walks (as ``make_inducing_tensors_from_data``
    draws them from data; from X's own steps, N = 1 and L = 2 would give
    one step, both points of every increments pair equal and X̄ exactly
    0, which no scaled error can compare), the kernel layer's Poly offset
    channel, cotangents."""
    X = long_walks(rng, N, L, d) * np.sqrt(2 / d)
    steps = np.diff(long_walks(rng, 8, max(L, 10), d) * np.sqrt(2 / d),
                    axis=1).reshape(-1, d)
    F = nl * (nl + 1) // 2
    Z = steps[rng.integers(0, len(steps), T * F * (2 if increments else 1))]
    Z = Z.reshape((T, F, 2, d) if increments else (T, F, d))
    X, Z = with_offset_channel(X, Z, kind)
    return Z, X, rng.standard_normal((nl + 1, T, N))


#: the Kuf plan sweep's wide d: MotorImagery's 64, past every Kuf kernel's
#: shared memory at 400, DuckDuckGeese's 1345
KUF_WIDE_D = (64, 400, 1345)


def kuf_plan_sweep(dev):
    """(f') Every launch plan of the four Kuf kernels against their plain
    versions, float32 and float64. The general pair: the forward's blocks
    of 32, 64 and 128 threads at each number of sequences a thread (nl = 3,
    4, 5, 7), its factors staged and read from global memory; the
    backward's blocks of 1, 2 and 4 warps, one and several pairs a warp,
    one chunk and several (L = 2, 64, 65, 66, 150, 300), its columns in
    shared memory and in the workspace; every base kind, ``increments`` and
    ``difference`` in turn. The order-1 pair: N = 1, 31, 33, 50, L = 2, 65,
    66, 130 (one, two and three chunks), d = 1-3, nl 1-7, one and several
    pairs a warp. Then all four Kuf kernels at d = 64, 400 and 1345 (nl =
    5, increments, RBF, order 2 for the general pair)."""
    import torch

    from gpsig_tpu_torch.ops.cuda import plan
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    rng = np.random.default_rng(SEED + 15)
    kinds = ["rbf", "cosine", "poly2", "linear"]
    cases = []  # (key, label, T, N, L, d, nl, order, kind, inc, diff)
    for i, (nl, N) in enumerate((n, N) for n in (3, 4, 5, 7)
                                for N in (20, 50, 100, 200, 600)):
        cases.append(("tsg", f"nl={nl} N={N}", 3, N, 20, 2, nl,
                      1 + i % 3, kinds[i % 4], i % 2 == 0, i % 3 != 0))
    for i, (T, N) in enumerate(((3, 1), (3, 2), (3, 5), (300, 40))):
        for j, L in enumerate((2, 64, 65, 66, 150, 300)):
            k = i + j
            cases.append(("tsg_bwd", f"T={T} N={N} L={L}", T, N, L, 2, 4,
                          1 + k % 3, kinds[k % 4], k % 2 == 0,
                          L > 2 and k % 3 != 0))
    # the order-1 pair's plans: N on both sides of a warp, one and several
    # chunks, d = 1-3, one and several pairs a warp
    for i, (N, L) in enumerate((N, L) for N in (1, 31, 33, 50)
                               for L in (2, 65, 66, 130)):
        for key, T in (("tens_seq", 3), ("tens_seq_bwd", 3 if i % 4 else 300)):
            cases.append((key, f"order-1 T={T} N={N} L={L}", T, N, L,
                          1 + i % 3, 1 + i % 7, 1, "rbf", i % 2 == 0, True))
    for d in KUF_WIDE_D:
        for key in ("tens_seq", "tsg", "tens_seq_bwd", "tsg_bwd"):
            cases.append((key, f"d={d}", 4, 6, 10, d, 5, 2, "rbf", True,
                          True))
    # the float32 forward's factors leave shared memory only past d = 1345
    # at nl = 5: nl = 7 there
    cases.append(("tsg", "nl=7 d=1345", 4, 6, 10, 1345, 7, 3, "rbf", True,
                  True))
    worst, plans = {}, set()
    for key, label, T, N, L, d, nl, order, kind, inc, diff in cases:
        Z, X, g = kuf_inputs(rng, T, N, L, d, nl, inc, kind)
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            z, x, w = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in (Z, X, g))
            F2 = plan.factor_count(nl, inc)
            dd = x.shape[-1]
            if key == "tens_seq":
                pl = plan.kuf_fwd_plan(N, F2, dd, nl, dtype.itemsize, True)
                with torch.no_grad():
                    got = ts.fused_tens_seq_levels(z, x, nl, True, inc)
                want = ts.fused_tens_seq_levels_ref(z, x, nl, True, inc)
                tol = TOL[name][0]
            elif key == "tens_seq_bwd":
                pl = plan.kuf_bwd_plan(T, N, F2, dd, dtype.itemsize, True)
                got = ts.tens_seq_bwd(z, x, w, nl, True, inc)
                want = ts.tens_seq_bwd_ref(z, x, w, nl, True, inc)
                tol = BWD_TOL[name][0]
            elif key == "tsg":
                a = (nl, order, kind, inc, diff)
                pl = plan.kuf_fwd_plan(N, F2, dd, nl, dtype.itemsize)
                with torch.no_grad():
                    got = tsg.fused_tens_seq_general_levels(z, x, *a)
                want = tsg.fused_tens_seq_general_levels_ref(z, x, *a)
                tol = GEN_TOL[name][0]
            else:
                a = (nl, order, kind, inc, diff)
                pl = plan.kuf_bwd_plan(T, N, F2, dd, dtype.itemsize)
                got = tsg.tens_seq_general_bwd(z, x, w, *a)
                want = tsg.tens_seq_general_bwd_ref(z, x, w, *a)
                tol = BWD_TOL[name][0]
            if name == "float32" and L > 150:
                tol = max(tol, LONG_F32_TOL[0])
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"kuf plan sweep {key} {label}: not finite")
            err = scaled_err(got, want)
            check(err <= tol, f"kuf plan sweep {key} {label} {name} {kind} "
                  f"order {order} inc={inc} diff={diff} plan {pl}: {err} > "
                  f"{tol}")
            k = (key, name)
            worst[k] = max(worst.get(k, 0.0), err)
            plans.add((key, name, tuple(sorted(
                (n, v) for n, v in pl.items()
                if n in ("route", "threads", "seqs", "staged", "ppw")))))
    for (key, name), err in sorted(worst.items()):
        got = sorted(pl for k, n, pl in plans if (k, n) == (key, name))
        print(f"kuf plan sweep {key} {name}: worst scaled err {err:.3e} over "
              f"the plans {[dict(pl) for pl in got]}")


def wide_svgp_check(dev):
    """Two float64 natgrad + Adam steps of an order-2 SVGP at d = 64 (nl =
    5, 8 inducing tensors with increments, MultiClass(3), 10 sequences of
    L = 9) on the card, through the general Kuf and its backward (the
    backward's columns in the workspace), against the same steps on the
    CPU, tolerance 1e-8."""
    import torch

    from gpsig_tpu_torch.inducing import InducingTensors
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.ops.cuda import plan
    from gpsig_tpu_torch.training.loop import make_step_fn

    f64 = torch.float64
    rng = np.random.default_rng(SEED + 16)
    Z, X, _ = kuf_inputs(rng, 8, 10, 9, 64, 5, True, "rbf")
    check(not plan.kuf_bwd_plan(8, 10, 30, 64, 8)["staged"],
          "wide SVGP: the backward's columns fit shared memory")
    Y = rng.integers(0, 3, 10)
    model = SVGP.create(SignatureRBF(64, 5, order=2, device="cpu"),
                        MultiClass(3),
                        InducingTensors.create(torch.as_tensor(Z), 5, True),
                        3, device="cpu")
    runs, card = {}, copy.deepcopy(model).to(dev)
    for where, m in (("cpu", model), ("card", card)):
        x = torch.as_tensor(X, dtype=f64, device=m.q_mu.device)
        y = torch.as_tensor(Y, device=m.q_mu.device)
        step = make_step_fn(1e-2, num_data=40, gamma=0.1)
        state, out = step.init(m), []
        reset_counters()
        for _ in range(2):
            state, elbo = step(state, x, y)
            out.append(elbo)
        launches = counters()
        runs[where] = [t.detach().cpu() for t in (*out, *m.parameters())]
    check(launches["tsg"] > 0 and launches["tsg_bwd"] > 0,
          f"wide SVGP: the general Kuf pair did not launch: {launches}")
    err = max(scaled_err(g, w) for g, w in zip(runs["card"], runs["cpu"]))
    print(f"order-2 SVGP at d=64 (2 natgrad+Adam steps, float64): card vs "
          f"CPU scaled err {err:.3e} over every ELBO and parameter, "
          f"tolerance 1e-8; launches tsg {launches['tsg']}, tsg_bwd "
          f"{launches['tsg_bwd']}")
    check(err <= 1e-8, f"wide SVGP: {err}")


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
                "o=2); the gradient sums its terms per unrefined cell in "
                "another order"),
    "float64": ((1e-10, 1e-10), "the plain version's arithmetic per cell; "
                "fused multiply-adds and the gradient's summation order "
                "round otherwise"),
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
    pairs) at orders 2 and 3 (past 256 refined rows: the forward's bands).
    The given-grid route runs on the grid refined in memory (the ``scan``
    engine's input). The forwards must equal the plain sweep bit for bit,
    each with its plan printed. Float32 timed: Gcell/s counts refined
    cells; bounds as ``bound``."""
    import torch

    from gpsig_tpu_torch.inducing import make_inducing_sequences_from_data
    from gpsig_tpu_torch.ops import goursat
    from gpsig_tpu_torch.ops.cuda import goursat as gs
    from gpsig_tpu_torch.ops.cuda import plan

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
                    if route != "grad":
                        # each refined cell is the plain sweep's expression
                        # in its order: the forwards match it bit for bit
                        check(torch.equal(got, want), f"goursat {route} "
                              f"{(Su, Tu)} o={o} {name}: not bitwise equal "
                              "to the plain sweep")
                    if route == "grad":
                        # each unrefined cell written once, no atomics: the
                        # same bits on every launch
                        again = kern()
                        check(torch.equal(got, again), f"goursat grad "
                              f"{(Su, Tu)} o={o} {name}: two launches differ")
                        design = ("one warp" if gs.warp_plan(
                            Su, Tu, o, inc.element_size()) else "one block")
                        print(f"goursat grad ({Su}, {Tu}) o={o} {name}: "
                              f"{design} a pair; two launches bitwise equal")
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
                if kind == "fwd":
                    fast = route == "fast"
                    p = plan.goursat_fwd_plan(Su << o if fast else Su,
                                              Tu << o if fast else Tu,
                                              0 if fast else o, 4)
                    label += (f" [RL={p['RL']} S={p['S']} bands="
                              f"{p['bands']} W={p['W']} stage={p['stage']}"
                              f" cols={p['cols']}]")
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


# ---------------------------------------------------------------------------
# Long sequences: the truncated kernels past one warp's 128 rows, and the
# GunPoint-length path (L = 150) end to end
# ---------------------------------------------------------------------------

# scaled error allowed in float32 at L = 300 and 512, where the earlier
# tolerances hold up to L = 150: the DP sums run over up to 511 columns (at
# most 99 in the earlier phases), each state carrying the rounding of every
# column before it; float64 keeps the earlier tolerances
LONG_F32_TOL = (1e-3, "float32 DP sums over 299-511 columns, each state "
                "carrying the rounding of every earlier column (at most 99 "
                "in the earlier phases)")


# the GunPoint-length path's sizes: GPR training set, the order-2 Gram
# backward's timed batch, test sequences, minibatch, inducing tensors
LONG_SIZES = dict(gpr=150, gpr_bwd=64, test=2048, batch=50, T=64)


def long_walks(rng, n, L, d=2):
    """Walks whose steps shrink like 1/√L, so that the unnormalised levels
    stay as far inside float32's range as L = 50's do."""
    return (0.3 * np.sqrt(50 / L) * rng.standard_normal((n, L, d))).cumsum(1)


def long_correctness_phase(dev):
    """(k) Rows 1-3, 6-7 and 10-13 against their plain versions at
    L in {130, 150, 300} (sig_gram on the self-increment matrices of those
    lengths, L2 = L - 1, and the inducing-sequence shape M [B, 8, 150]),
    rows 1-3 at L = 512 with d = 8, rows 4, 5, 8 and 9 at L = 150; float32
    and float64, small batches."""
    import torch

    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    rng = np.random.default_rng(SEED + 30)
    calls = []  # (label, length, kernel call, plain call, numpy inputs)
    for L in (130, 150, 300, 512):
        d = 8 if L == 512 else 2
        X, Y = long_walks(rng, 6, L, d), long_walks(rng, 5, L, d)
        g = rng.standard_normal((5, 6, 5))
        calls += [
            ("gram", L, lambda a, b: fg.fused_gram_levels(a, b, 4),
             lambda a, b: fg.fused_gram_levels_ref(a, b, 4), (X, Y)),
            ("diag", L, lambda a: fg.fused_diag_levels(a, 4),
             lambda a: fg.fused_diag_levels_ref(a, 4), (X,)),
            ("gram_bwd", L,
             lambda a, b, c: fg.fused_gram_levels_bwd(a, b, c, 4),
             lambda a, b, c: fg.fused_gram_levels_bwd_ref(a, b, c, 4),
             (X, Y, g)),
        ]
        if L == 512:
            continue
        px, py = with_offset_channel(X, Y, "poly2")
        for kind, order, x, y in (("rbf", 2, X, Y), ("poly2", 1, px, py)):
            a = (4, order, kind, True)
            calls += [
                ("gram_ho", L, lambda u, v, a=a: fgho.fused_gram_ho_levels(
                    u, v, *a),
                 lambda u, v, a=a: fgho.fused_gram_ho_levels_ref(u, v, *a),
                 (x, y)),
                ("gram_ho_bwd", L,
                 lambda u, v, c, a=a: fgho.fused_gram_ho_levels_bwd(
                     u, v, c, *a),
                 lambda u, v, c, a=a: fgho.fused_gram_ho_levels_bwd_ref(
                     u, v, c, *a), (x, y, g)),
            ]
        for shape in ((6, L - 1, L - 1),) + (((6, 8, 150),) if L == 150
                                            else ()):
            M = rng.standard_normal(shape) * 4 / np.sqrt(shape[1] * shape[2])
            gm = rng.standard_normal((5, 6))
            for order in (1, 2, 3):
                fwd = (lambda m: sg.sig_gram_levels(m, 4)) if order == 1 \
                    else (lambda m, o=order: sg.sig_gram_levels_ho(m, 4, o))
                bwd = (lambda m, c: sg.sig_gram_levels_bwd(m, c, 4)) \
                    if order == 1 else (lambda m, c, o=order:
                                        sg.sig_gram_levels_ho_bwd(m, c, 4, o))
                key = "sig_gram" if order == 1 else "sig_gram_ho"
                # the self-increment shape at L, or the inducing-sequence
                # Kuf's [8, 150] (labelled by its longer side)
                at = L if shape[1] == L - 1 else shape[2]
                calls += [
                    (key, at, fwd,
                     lambda m, o=order: sg.sig_gram_levels_ho_ref(m, 4, o),
                     (M,)),
                    (key + "_bwd", at, bwd,
                     lambda m, c, o=order: sg.sig_gram_levels_ho_bwd_ref(
                         m, c, 4, o), (M, gm)),
                ]
    X = long_walks(rng, 7, 150)
    Z = 0.4 * rng.standard_normal((5, 10, 2, 2))
    gk = rng.standard_normal((5, 5, 7))
    calls += [
        ("tens_seq", 150, lambda z, x: ts.fused_tens_seq_levels(
            z, x, 4, True, True),
         lambda z, x: ts.fused_tens_seq_levels_ref(z, x, 4, True, True),
         (Z, X)),
        ("tens_seq_bwd", 150, lambda z, x, c: ts.tens_seq_bwd(
            z, x, c, 4, True, True),
         lambda z, x, c: ts.tens_seq_bwd_ref(z, x, c, 4, True, True),
         (Z, X, gk)),
        ("tsg", 150, lambda z, x: tsg.fused_tens_seq_general_levels(
            z, x, 4, 3, "rbf", True, True),
         lambda z, x: tsg.fused_tens_seq_general_levels_ref(
             z, x, 4, 3, "rbf", True, True), (Z, X)),
        ("tsg_bwd", 150, lambda z, x, c: tsg.tens_seq_general_bwd(
            z, x, c, 4, 3, "rbf", True, True),
         lambda z, x, c: tsg.tens_seq_general_bwd_ref(
             z, x, c, 4, 3, "rbf", True, True), (Z, X, gk)),
    ]
    print(f"long tolerances: up to L = 150 and in float64 the earlier "
          f"phases' (TOL, GEN_TOL, BWD_TOL); float32 past L = 150 "
          f"{LONG_F32_TOL[0]:g}: {LONG_F32_TOL[1]}")
    worst, lengths = {}, {}
    for key, length, *_ in calls:
        lengths.setdefault(key, set()).add(length)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for key, length, kern, plain, arrays in calls:
            args = [torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in arrays]
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            pairs = (list(zip(got, want)) if isinstance(want, tuple)
                     else [(got, want)])
            for g_, w_ in pairs:
                check(g_.shape == w_.shape and bool(torch.isfinite(g_).all()),
                      f"long {key} L={length} {name}: {g_.shape}")
            err = scaled_err(got, want)
            k = (key, name)
            if err >= worst.get(k, (-1.0, None))[0]:
                worst[k] = (err, length)
            # the earlier phases' tolerances, but in float32 past L = 150
            tol = (BWD_TOL if key.endswith("bwd") else
                   TOL if key in TUNED else GEN_TOL)[name][0]
            if name == "float32" and length > 150:
                tol = LONG_F32_TOL[0]
            check(err <= tol, f"long {key} L={length} {name}: {err} > {tol}")
    for (key, name), (err, length) in sorted(worst.items()):
        print(f"long {key} {name}: worst scaled err {err:.3e} (at "
              f"L={length}) over L in {sorted(lengths[key])}")


def long_timing_phase(dev):
    """(l) Each truncated kernel at L = 150 at the GunPoint-length path's
    shapes, float32, against its plain version on the same inputs, timed,
    with its bound: the order-1 and order-2 GPR Grams at N = 150 (the
    order-2 backward at N = 64: its plain version under autograd would hold
    some 80 GB at N = 150), the diagonal of 2048 test sequences, Kuf of 64
    inducing tensors against 2048 (backward: 50), the order-3 Kuf and
    diagonal of the order-3 variant, the Poly GPR's order-1 diagonal."""
    import torch

    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts
    from gpsig_tpu_torch.ops.cuda import tens_seq_general as tsg

    rng = np.random.default_rng(SEED + 31)
    L = 150
    N, Nb, Nt = LONG_SIZES["gpr"], LONG_SIZES["gpr_bwd"], LONG_SIZES["test"]
    B, T = LONG_SIZES["batch"], LONG_SIZES["T"]
    x150, x64 = long_walks(rng, N, L), long_walks(rng, Nb, L)
    x2048 = long_walks(rng, Nt, L)
    x50 = x2048[:B]
    incs = np.diff(x2048, axis=1).reshape(-1, 2)
    z = incs[rng.integers(0, len(incs), T * 10 * 2)].reshape(T, 10, 2, 2)
    g150 = rng.standard_normal((5, N, N))
    g64 = np.ascontiguousarray(g150[:, :Nb, :Nb])
    gk = rng.standard_normal((5, T, B))
    m150, m2048 = self_increments(x150), self_increments(x2048)
    gm150, gm50 = rng.standard_normal((5, N)), rng.standard_normal((5, B))
    rows = L - 1
    gram_bytes = 4 * (2 * N * L * 2 + 5 * N * N)
    kuf_bytes = 4 * (T * 20 * 2 + Nt * L * 2 + 5 * T * Nt)
    kuf_bwd_bytes = 4 * (2 * T * 20 * 2 + 2 * B * L * 2 + 5 * T * B)
    sg_bytes = lambda n: 4 * (n * rows * rows + 5 * n)  # noqa: E731
    sg_bwd_bytes = lambda n: 4 * (2 * n * rows * rows + 5 * n)  # noqa: E731
    # a backward counts 3 forwards (as in the earlier phases); the Gram
    # backward reads X, Y and g and writes X̄ and Ȳ
    works = {
        "gram": (gram_work(N, N, L, 2, 4), gram_bytes),
        "diag": (gram_self_work(Nt, L, 2, 4), 4 * (Nt * L * 2 + 5 * Nt)),
        "gram_bwd": (3 * gram_work(N, N, L, 2, 4),
                     4 * (2 * 2 * N * L * 2 + 5 * N * N)),
        "tens_seq": (kuf_work(T, 20, Nt, L, 2, 4), kuf_bytes),
        "tens_seq_bwd": (3 * kuf_work(T, 20, B, L, 2, 4), kuf_bwd_bytes),
        "gram_ho": (gram_work(N, N, L, 2, 4, p=2), gram_bytes),
        "gram_ho_bwd": (3 * gram_work(Nb, Nb, L, 2, 4, p=2),
                        4 * (2 * 2 * Nb * L * 2 + 5 * Nb * Nb)),
        "tsg": (kuf_work(T, 20, Nt, L, 2, 4, p=3), kuf_bytes),
        "tsg_bwd": (3 * kuf_work(T, 20, B, L, 2, 4, p=3), kuf_bwd_bytes),
        "sig_gram": (N * dp_self_ops(rows, 4, 1), sg_bytes(N)),
        "sig_gram_ho": (Nt * dp_self_ops(rows, 4, 3), sg_bytes(Nt)),
        "sig_gram_bwd": (3 * N * dp_self_ops(rows, 4, 1), sg_bwd_bytes(N)),
        "sig_gram_ho_bwd": (3 * B * dp_self_ops(rows, 4, 3),
                            sg_bwd_bytes(B)),
    }
    cases = [
        ("gram", "Gram RBF N=150x150 L=150 d=2 nl=4",
         lambda a: fg.fused_gram_levels(a, a, 4),
         lambda a: fg.fused_gram_levels_ref(a, a, 4), (x150,)),
        ("diag", "diag RBF N=2048 L=150 d=2 nl=4",
         lambda a: fg.fused_diag_levels(a, 4),
         lambda a: fg.fused_diag_levels_ref(a, 4), (x2048,)),
        ("gram_bwd", "Gram backward RBF N=150x150 L=150 d=2 nl=4",
         lambda a, c: fg.fused_gram_levels_bwd(a, a, c, 4),
         lambda a, c: fg.fused_gram_levels_bwd_ref(a, a, c, 4),
         (x150, g150)),
        ("tens_seq", "Kuf RBF T=64 increments N=2048 L=150 d=2 nl=4",
         lambda q, a: ts.fused_tens_seq_levels(q, a, 4, True, True),
         lambda q, a: ts.fused_tens_seq_levels_ref(q, a, 4, True, True),
         (z, x2048)),
        ("tens_seq_bwd", "Kuf backward RBF T=64 increments N=50 L=150 d=2 "
         "nl=4",
         lambda q, a, c: ts.tens_seq_bwd(q, a, c, 4, True, True),
         lambda q, a, c: ts.tens_seq_bwd_ref(q, a, c, 4, True, True),
         (z, x50, gk)),
        ("gram_ho", "general Gram RBF order 2 N=150x150 L=150 d=2 nl=4",
         lambda a: fgho.fused_gram_ho_levels(a, a, 4, 2),
         lambda a: fgho.fused_gram_ho_levels_ref(a, a, 4, 2), (x150,)),
        ("gram_ho_bwd", "general Gram backward RBF order 2 N=64x64 L=150 "
         "d=2 nl=4",
         lambda a, c: fgho.fused_gram_ho_levels_bwd(a, a, c, 4, 2),
         lambda a, c: fgho.fused_gram_ho_levels_bwd_ref(a, a, c, 4, 2),
         (x64, g64)),
        ("tsg", "general Kuf RBF order 3 T=64 increments N=2048 L=150 d=2 "
         "nl=4",
         lambda q, a: tsg.fused_tens_seq_general_levels(q, a, 4, 3, "rbf",
                                                        True, True),
         lambda q, a: tsg.fused_tens_seq_general_levels_ref(
             q, a, 4, 3, "rbf", True, True), (z, x2048)),
        ("tsg_bwd", "general Kuf backward RBF order 3 T=64 increments N=50 "
         "L=150 d=2 nl=4",
         lambda q, a, c: tsg.tens_seq_general_bwd(q, a, c, 4, 3, "rbf", True,
                                                  True),
         lambda q, a, c: tsg.tens_seq_general_bwd_ref(q, a, c, 4, 3, "rbf",
                                                      True, True),
         (z, x50, gk)),
        ("sig_gram", "sig_gram order 1 B=150 L'=149 nl=4",
         lambda m: sg.sig_gram_levels(m, 4),
         lambda m: sg.sig_gram_levels_ref(m, 4), (m150,)),
        ("sig_gram_ho", "sig_gram order 3 B=2048 L'=149 nl=4",
         lambda m: sg.sig_gram_levels_ho(m, 4, 3),
         lambda m: sg.sig_gram_levels_ho_ref(m, 4, 3), (m2048,)),
        ("sig_gram_bwd", "sig_gram backward order 1 B=150 L'=149 nl=4",
         lambda m, c: sg.sig_gram_levels_bwd(m, c, 4),
         lambda m, c: sg.sig_gram_levels_bwd_ref(m, c, 4), (m150, gm150)),
        ("sig_gram_ho_bwd", "sig_gram backward order 3 B=50 L'=149 nl=4",
         lambda m, c: sg.sig_gram_levels_ho_bwd(m, c, 4, 3),
         lambda m, c: sg.sig_gram_levels_ho_bwd_ref(m, c, 4, 3),
         (np.ascontiguousarray(m2048[:B]), gm50)),
    ]
    report = {}
    for key, label, kern, plain, arrays in cases:
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in arrays]
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err, max_abs = scaled_err(got, want), abs_err(got, want)
        del got, want
        tol = (BWD_TOL if "backward" in label else
               TOL if key in TUNED else GEN_TOL)["float32"][0]
        check(err <= tol, f"long {label}: scaled err {err} > {tol}")
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
        report[key] = dict(L=L, ms=ms, plain_ms=plain_ms,
                           max_abs_err=max_abs, **bound(*works[key]))
        print(f"long time {label} float32: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {report[key]['bound_ms']:.4f} ms "
              f"({report[key]['bound_by']}), scaled err {err:.3e}")
        del args
        torch.cuda.empty_cache()
    return report


def gunpoint_data(torch, dev, dtype, n_extra=0):
    """``SynthGunPoint`` as the window protocol prepares it
    (``benchmarks/common.py``'s get_classification_data): scaler fitted on
    train, a time channel added, tabulated to L = 150: d = 2, 50 train and
    150 test sequences; and ``n_extra`` ``classification_sequences`` of
    L = 150 (d = 1) prepared the same way, for the serving batch."""
    from gpsig_tpu_torch.data import preprocessing as prep
    from gpsig_tpu_torch.data import uea_like
    from gpsig_tpu_torch.data.synthetic import classification_sequences

    Xtr_l, ytr, Xte_l, yte = uea_like.load_dataset("SynthGunPoint")
    scaler = prep.SequenceScaler().fit(Xtr_l)

    def table(seqs):
        return torch.as_tensor(prep.tabulate_list_of_sequences(
            prep.add_time_to_list(scaler.transform(seqs)), 150), dtype=dtype,
            device=dev)

    out = [table(Xtr_l), torch.as_tensor(ytr, dtype=torch.int64, device=dev),
           table(Xte_l), torch.as_tensor(yte, dtype=torch.int64, device=dev)]
    if n_extra:
        Xn, _ = classification_sequences(seed=SEED, N=n_extra, L=150, d=1,
                                         num_classes=2)
        out.append(table(list(Xn)))
    return out


def build_gunpoint_svgp(torch, dev, dtype, X, order=1, T=64):
    """The SynthGunPoint window's model (``benchmarks/run_all.py``): the
    order-``order`` RBF signature kernel, nl=4, lengthscales √d,
    normalised, T inducing tensors with increments drawn from the data,
    MultiClass(2); q(u) drawn from a seed (not SVGP.create's q_mu = 0, so
    that the predictive means compared with the plain route are not 0)."""
    from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    d = X.shape[-1]
    kern = SignatureRBF(d, 4, lengthscales=float(np.sqrt(d)), order=order,
                        normalization=True, dtype=dtype, device=dev)
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(SEED), X, num_tensors=T, num_levels=4,
        num_features=d, increments=True)
    model = SVGP.create(kern, MultiClass(2), feat, num_latent=2, dtype=dtype,
                        device=dev)
    rng = np.random.default_rng(SEED + 32)
    with torch.no_grad():
        model.q_mu.copy_(torch.as_tensor(0.5 * rng.standard_normal((T, 2))))
        model.q_sqrt.copy_(torch.as_tensor(
            np.tril(0.02 * rng.standard_normal((2, T, T))) + 0.9 * np.eye(T)))
    return model


def long_svgp_phase(dev, order, steps, need):
    """(m) The SynthGunPoint window model at ``order`` on its own data,
    float32: serving (ELBO on the 50 training sequences, ``posterior()`` +
    ``predict_y`` on the 150 test sequences and on 2048 more of L = 150),
    then ``steps`` natgrad + Adam steps (lr 0.01, γ = 0.1, B = 50), counters
    read after each; the kernels of ``need`` must launch in each, the
    tuned order-1 ones must not at order >= 2; Kuf, the predictive means
    and the first step against the plain route."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    Xtr, ytr, Xte, _, Xn = gunpoint_data(torch, dev, f32,
                                         n_extra=LONG_SIZES["test"])
    model = build_gunpoint_svgp(torch, dev, f32, Xtr, order=order,
                                T=LONG_SIZES["T"])
    plain_model = copy.deepcopy(model)
    label = f"GunPoint order-{order} SVGP"

    def serve():
        elbo = model.elbo(Xtr, ytr, num_data=50)
        post = model.posterior()
        probs, pvar = post.predict_y(Xte)
        probs_n, pvar_n = post.predict_y(Xn)
        fmean, fvar = post.predict_f(Xte)
        Kuf = model.inducing.Kuf(model.kernel, Xn)
        torch.cuda.synchronize()
        return dict(elbo=elbo, probs=probs, pvar=pvar, probs_n=probs_n,
                    pvar_n=pvar_n, fmean=fmean, fvar=fvar, Kuf=Kuf)

    launches = {}
    with torch.no_grad():
        reset_counters()
        out = serve()
        launches["serving"] = counters()
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"{label} {k} not finite")
        for k in ("probs", "probs_n"):
            sums = out[k].sum(-1)
            check(bool(torch.allclose(sums, torch.ones_like(sums),
                                      atol=1e-5)),
                  f"{label} {k}: class probabilities do not sum to 1")
        for k in ("pvar", "pvar_n", "fvar"):
            check(bool((out[k] >= 0).all()), f"{label} {k} has negatives")
        check(out["probs_n"].shape == (LONG_SIZES["test"], 2),
              f"{label} predict_y shape")
        with plain_route():
            ref = serve()
        compare_routes(label, out, ref,
                       dict(Kuf=1e-4 if order == 1 else 1e-3, fmean=1e-3,
                            probs=1e-3, probs_n=1e-3, elbo=1e-3))
        acc = (out["probs"].argmax(-1).cpu()
               == gunpoint_data(torch, "cpu", f32)[3]).float().mean().item()
        print(f"{label}: elbo {out['elbo'].item():.6g}, untrained test "
              f"accuracy {acc:.3f}")
        ms_predict = host_ms(lambda: model.posterior().predict_y(Xn))
        post = model.posterior()
        ms_cached = host_ms(lambda: post.predict_y(Xn))
        ms_elbo = host_ms(lambda: model.elbo(Xtr, ytr, num_data=50))
        print(f"time {label} posterior()+predict_y N_test=2048 L=150: "
              f"{ms_predict:.3f} ms; predict_y on a cached posterior: "
              f"{ms_cached:.3f} ms; elbo B=50: {ms_elbo:.3f} ms")
    step = make_step_fn(1e-2, num_data=50, gamma=0.1)
    state = step.init(model)
    reset_counters()
    elbos, ms, first = [], [], None
    for k in range(steps):
        (state, elbo), t = timed(lambda: step(state, Xtr, ytr))
        elbos.append(elbo.item())
        ms.append(t)
        if k == 0:
            first = grads_and_params(model)
    launches["training"] = counters()
    print(f"train {label} elbo per step: {elbos}")
    check(all(np.isfinite(elbos)), f"{label} elbo not finite")
    for p in model.parameters():
        check(bool(torch.isfinite(p).all()), "trained parameter not finite")
    with plain_route():
        pstep = make_step_fn(1e-2, num_data=50, gamma=0.1)
        pstep(pstep.init(plain_model), Xtr, ytr)
    torch.cuda.synchronize()
    compare_first_step(label, first, grads_and_params(plain_model), 1e-2,
                       why="float32 Kuf rounding over 149 steps carried "
                       "through the T=64 Cholesky (f32 jitter 1e-4)")
    print(f"time {label} natgrad+Adam step (T=64, B=50, L=150): "
          f"{statistics.median(ms[1:]):.3f} ms (median of {len(ms) - 1}; "
          f"all {[round(t, 3) for t in ms]})")
    for phase, counts in launches.items():
        if order == 1:
            print(f"{label} {phase} launches: {counts}")
            for key in need[phase]:
                check(counts[key] > 0,
                      f"kernel {key} was not launched by {label} {phase}")
        else:
            check_general_route(counts, need[phase], f"{label} {phase}")
    return launches


def long_gpr_phase(dev):
    """(n) Exact GPR at L = 150 (``regression_sequences(N=200, L=150,
    d=2)``, 150 to train, nl=4, noise 0.05, Adam 5e-2), float32: order-1
    RBF (rows 1-3), order-2 RBF (rows 6, 7, 12, 13) and order-1 Poly (rows
    6, 7, 10, 11); 5 Adam steps each with its counters and ms per step, a
    profile of the RBF steps and their Gram forward's triangle
    (``gram_triangle_check``); the first step against the plain route
    on the first 48 sequences (the plain Gram at N = 150 is a
    [150, 150, 150, 150] tensor, several times that under autograd)."""
    import torch

    from gpsig_tpu_torch.data.synthetic import regression_sequences as rs

    f32 = torch.float32
    N = LONG_SIZES["gpr"]
    Xn, yn = rs(seed=SEED, N=200, L=150, d=2)
    X = torch.as_tensor(Xn[:N], dtype=f32, device=dev)
    Y = torch.as_tensor(yn[:N], dtype=f32, device=dev)
    specs = {"order-1 RBF": dict(),
             "order-2 RBF": dict(order=2),
             "order-1 Poly": dict(ctor="SignaturePoly", offset=0.6)}
    need = {"order-1 RBF": ("gram", "diag", "gram_bwd"),
            "order-2 RBF": ("gram_ho", "gram_ho_bwd", "sig_gram_ho",
                            "sig_gram_ho_bwd"),
            "order-1 Poly": ("gram_ho", "gram_ho_bwd", "sig_gram",
                             "sig_gram_bwd")}
    launches = {}
    for name, kw in specs.items():
        gpr = build_gpr(torch, dev, f32, X, nl=4, **kw)
        small, plain_small = (build_gpr(torch, dev, f32, X, nl=4, **kw)
                              for _ in range(2))
        step = gpr_step_fn(torch, gpr, X, Y, 5e-2)
        reset_counters()
        lmls, ms = [], []
        for _ in range(5):
            lml, t = timed(step)
            lmls.append(lml.item())
            ms.append(t)
        launches[name] = counters()
        if name == "order-1 RBF":
            print(f"GPR L=150 {name} launches: {launches[name]}")
            for key in need[name]:
                check(launches[name][key] > 0,
                      f"kernel {key} was not launched by GPR L=150 {name}")
        else:
            check_general_route(launches[name], need[name],
                                f"GPR L=150 {name}")
        print(f"train GPR L=150 {name} lml per step: {lmls}")
        check(all(np.isfinite(lmls)), f"GPR L=150 {name} lml not finite")
        for p in gpr.parameters():
            check(bool(torch.isfinite(p).all()), "trained parameter not finite")
        print(f"time GPR L=150 {name} Adam step (N=150): "
              f"{statistics.median(ms[1:]):.3f} ms (median of {len(ms) - 1}; "
              f"all {[round(t, 3) for t in ms]})")
        if name != "order-1 Poly":
            profile_split(step, f"GPR L=150 {name} Adam step, N=150")
            gram_triangle_check(dev, X, 2 if name == "order-2 RBF" else 1)
        # the first step on 48 sequences, kernels against the plain route
        gpr_step_fn(torch, small, X[:48], Y[:48], 5e-2)()
        with plain_route():
            gpr_step_fn(torch, plain_small, X[:48], Y[:48], 5e-2)()
        torch.cuda.synchronize()
        compare_first_step(f"GPR L=150 {name} (N=48)",
                           grads_and_params(small),
                           grads_and_params(plain_small), 5e-2,
                           why="float32 Gram rounding over 149 steps carried "
                           "through the N=48 Cholesky")
        del gpr, small, plain_small
        torch.cuda.empty_cache()
    return launches


def gram_triangle_check(dev, X, order):
    """(n) The GPR's Gram forward at L = 150 (N = 150, nl = 4, RBF) solves
    its triangle: against the full Gram kernel's every pair at N = 150 and
    the plain version at N = 48, exactly symmetric; the triangle and the
    full grid timed."""
    import torch

    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho

    if order == 1:
        def gram(x, sym):
            return fg.fused_gram_levels(x, x, 4, True, symmetric=sym)

        def ref(x):
            return fg.fused_gram_levels_ref(x, x, 4, True)
        tol = TOL["float32"][0]
    else:
        def gram(x, sym):
            return fgho.fused_gram_ho_levels(x, x, 4, 2, symmetric=sym)

        def ref(x):
            return fgho.fused_gram_ho_levels_ref(x, x, 4, 2)
        tol = GEN_TOL["float32"][0]
    with torch.no_grad():
        tri, full = gram(X, True), gram(X, False)
        small = X[:48].contiguous()
        err_small = scaled_err(gram(small, True), ref(small))
        torch.cuda.synchronize()
        err = scaled_err(tri, full)
        check(bool(torch.equal(tri, tri.transpose(1, 2))),
              f"GPR L=150 order {order}: triangle Gram not symmetric")
        check(max(err, err_small) <= tol,
              f"GPR L=150 order {order} triangle: {err}, {err_small} > {tol}")
        tri_ms = cuda_ms(lambda: gram(X, True))
        full_ms = cuda_ms(lambda: gram(X, False))
    print(f"GPR L=150 order-{order} Gram forward (N=150, nl=4): triangle "
          f"{tri_ms:.4f} ms, every pair {full_ms:.4f} ms; triangle vs every "
          f"pair scaled err {err:.3e}, vs plain (N=48) {err_small:.3e}, "
          f"tolerance {tol:g}; exactly symmetric")


def long_float64_check(dev):
    """(o) A small float64 GunPoint-length model (T=6 inducing tensors,
    N=12 sequences of L=150, order 1) on the card against the CPU: the
    ELBO and predictions, then three natgrad + Adam steps, rtol 1e-8."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    f64 = torch.float64
    Xtr, ytr, Xte, _ = gunpoint_data(torch, dev, f64)
    X, Y = Xtr[:12], ytr[:12]
    model = build_gunpoint_svgp(torch, dev, f64, X, T=6)
    runs = {}
    for where, (m, Xw, Yw, Tw) in {
            "card": (model, X, Y, Xte[:12]),
            "cpu": (copy.deepcopy(model).to("cpu"), X.cpu(), Y.cpu(),
                    Xte[:12].cpu())}.items():
        with torch.no_grad():
            out = [m.elbo(Xw, Yw, num_data=50),
                   *m.posterior().predict_y(Tw)]
        step = make_step_fn(1e-2, num_data=50, gamma=0.1)
        state = step.init(m)
        for _ in range(3):
            state, elbo = step(state, Xw, Yw)
            out.append(elbo)
        out += [p.detach() for p in m.parameters()]
        runs[where] = [t.cpu() for t in out]
    err = max(scaled_err(g, w) for g, w in zip(runs["card"], runs["cpu"]))
    print(f"small float64 GunPoint-length model (L=150): card vs CPU scaled "
          f"err {err:.3e} over the ELBO, predictions, 3 steps' ELBOs and "
          "every parameter, tolerance 1e-8")
    check(err <= 1e-8, f"small float64 L=150 model: {err}")


def pde_triangle_check(dev):
    """(r) The symmetric Gram solves only its pairs i <= j and mirrors
    them: the training step's joint Gram ([Z; X_batch], 82 sequences of
    L=50, dyadic order 1, ``job_pde_train``'s kernel) in float64, values
    and gradients (inputs and parameters, of a weighted sum of K and of
    K_sym_psd) against the full solve of all 82² pairs."""
    import torch

    rng = np.random.default_rng(SEED + 24)
    model, X, _ = build_pde_svgp(torch, dev, torch.float64, rng)
    kern = model.kernel
    Z = model.inducing.raw_Z.detach()
    pad = Z[:, -1:].expand(-1, X.shape[1] - Z.shape[1], -1)
    J = torch.cat([torch.cat([Z, pad], 1), X[:50]])
    W = torch.as_tensor(rng.standard_normal((82, 82)), device=dev)
    with torch.no_grad():
        Js = kern._scaled(J)
        tri, full = kern._solve_pairs(Js), kern._solve_pairs(Js, Js)
    iu, ju = torch.triu_indices(82, 82, device=dev)
    check(torch.equal(tri[iu, ju], full[iu, ju]),
          "joint Gram: the solved triangle differs from the full solve")
    err = scaled_err(tri, full)
    solve = kern._solve_pairs

    def grads(fn, full_solve):
        Jg = J.clone().requires_grad_()
        with mock.patch.object(kern, "_solve_pairs", (lambda A, B=None: solve(
                A, A if B is None else B)) if full_solve else solve):
            out = torch.sum(W * fn(Jg))
        return torch.autograd.grad(out, [Jg, *kern.parameters()])

    gerr = max(scaled_err(g, w) for fn in (kern.K, kern.K_sym_psd)
               for g, w in zip(grads(fn, False), grads(fn, True)))
    print(f"SigGPDE joint Gram (82 sequences, dyadic order 1, float64): "
          f"triangle of {iu.shape[0]} pairs solved of {82 * 82}; solved "
          f"entries bitwise equal to the full solve, all entries scaled err "
          f"{err:.3e}, gradients of K and K_sym_psd scaled err {gerr:.3e}, "
          "tolerance 1e-12 (the mirrored entries' double difference "
          "rounds in the other order)")
    check(err <= 1e-12 and gerr <= 1e-12,
          f"joint Gram triangle: {err}, gradients {gerr}")


# BASELINE config 1's GPR (N of its 200 sequences, L steps), which the
# num_levels = 10 phases take
DEEP_GPR = dict(N=150, L=50)

# scaled error allowed past 7 levels (the stated bounds of the deep path)
DEEP_TOL = {
    "float32": (1e-4, "float32 DP sums over up to 149 columns and 127 "
                "levels in another order than the plain version; up to "
                "order 7 the backward's states rebuilt by subtraction "
                "(deep_levels.cuh), past it recomputed from checkpoints"),
    "float64": (1e-12, "the plain version's arithmetic, other summation "
                "order only"),
}


def deep_levels_phase(dev):
    """(p) The sig_gram kernels past 7 levels (``csrc/deep_levels.cuh``,
    ``sig_gram_bwd_deep.cu``): forward and backward, orders 1 and 2,
    against their plain versions at num_levels 8, 12 and 127 on the
    self-increment matrices of 16 sequences of L' + 1 steps, L' in {49,
    149}, float32 and float64; the workspace case; then each route timed at
    the num_levels = 10 GPR's Gram (the increment matrices of its 150²
    pairs, L' = 49), float32. Returns their report entries."""
    import torch

    from gpsig_tpu_torch.ops.cuda import plan
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg

    rng = np.random.default_rng(SEED + 40)
    for name, (tol, why) in DEEP_TOL.items():
        print(f"deep tolerance {name}: scaled err <= {tol:g}: {why}")

    def routes(order):
        fwd = ((lambda m, nl: sg.sig_gram_levels(m, nl)) if order == 1 else
               (lambda m, nl: sg.sig_gram_levels_ho(m, nl, order)))
        bwd = ((lambda m, g, nl: sg.sig_gram_levels_bwd(m, g, nl))
               if order == 1 else
               (lambda m, g, nl: sg.sig_gram_levels_ho_bwd(m, g, nl, order)))
        return fwd, bwd

    cases = [(nl, order, Lp) for Lp in (49, 149) for nl in (8, 12, 127)
             for order in (1, 2)]
    cases.append((127, 1, 600))
    for nl, order, Lp in cases:
        M_np = self_increments(walks(rng, 16 if Lp < 600 else 3, Lp + 1, 2)
                               * np.sqrt(50 / (Lp + 1)))
        g_np = rng.standard_normal((nl + 1, M_np.shape[0]))
        fwd, bwd = routes(order)
        for dtype in ((torch.float32, torch.float64) if Lp < 600
                      else (torch.float64,)):
            name = str(dtype).split(".")[1]
            M = torch.as_tensor(M_np, dtype=dtype, device=dev)
            g = torch.as_tensor(g_np, dtype=dtype, device=dev)
            lp = plan.sig_gram_plan(M.shape[0], Lp, Lp, nl, min(order, nl),
                                    M.element_size(), True)
            got = (fwd(M, nl), bwd(M, g, nl))
            want = (sg.sig_gram_levels_ho_ref(M, nl, order),
                    sg.sig_gram_levels_ho_bwd_ref(M, g, nl, order))
            torch.cuda.synchronize()
            errs = [scaled_err(a, b) for a, b in zip(got, want)]
            tol = DEEP_TOL[name][0]
            where = "workspace" if lp["work"] else "shared memory"
            print(f"deep sig_gram order {order} nl={nl} M {tuple(M.shape)} "
                  f"{name}: scaled err forward {errs[0]:.3e}, backward "
                  f"{errs[1]:.3e} (backward state in {where}), tolerance "
                  f"{tol:g}")
            for a in got:
                check(bool(torch.isfinite(a).all()), "deep: not finite")
            check(max(errs) <= tol, f"deep sig_gram order {order} nl={nl} "
                  f"L'={Lp} {name}: {errs} > {tol}")
            if Lp == 600:
                check(lp["work"] > 0, "deep: the L'=600 case should take "
                      "the workspace")
            del M, g, got, want
            torch.cuda.empty_cache()

    # order 7 at 20 and 127 levels, L' = 149, float32 against the plain
    # version in float64: deep_levels.cuh's backward rebuilds a column's
    # states by subtracting its sums from the carries (deep_rebuild)
    for nl in (20, 127):
        M_np = self_increments(walks(rng, 8, 150, 2) * np.sqrt(50 / 150))
        e = order_float32_err(dev, M_np, rng.standard_normal((nl + 1, 8)),
                              nl, 7)
        torch.cuda.empty_cache()
        print(f"deep sig_gram order 7 nl={nl} M (8, 149, 149) float32 "
              f"against the plain version in float64: scaled err forward "
              f"{e[0]:.3e} (plain float32 {e[2]:.3e}), backward {e[1]:.3e} "
              f"(plain float32 {e[3]:.3e}), tolerance "
              f"{DEEP_TOL['float32'][0]:g}")
        check(max(e[:2]) <= DEEP_TOL["float32"][0], f"deep sig_gram order "
              f"7 nl={nl} L'=149 float32: {e[:2]}")

    # timed at the nl = 10 GPR's Gram: its N² increment matrices
    N, L = DEEP_GPR["N"], DEEP_GPR["L"]
    Xg, _ = regression_sequences(np.random.default_rng(SEED), L=L)
    Xf = Xg[:N].reshape(-1, 2)
    sq = np.sum(Xf * Xf, -1)
    G = np.exp(-0.5 * np.maximum(sq[:, None] + sq[None, :] - 2 * Xf @ Xf.T,
                                 0)).reshape(N, L, N, L)
    M_np = np.diff(np.diff(G.transpose(0, 2, 1, 3), axis=2), axis=3)
    l = L - 1
    M = torch.as_tensor(M_np.reshape(-1, l, l), dtype=torch.float32,
                        device=dev)
    del G, M_np
    B, nl = M.shape[0], 10
    g = torch.as_tensor(rng.standard_normal((nl + 1, B)), dtype=torch.float32,
                        device=dev)
    report = {}
    for key, order in (("sig_gram", 1), ("sig_gram_ho", 2)):
        fwd, bwd = routes(order)
        nbytes = 4 * (B * l * l + (nl + 1) * B)
        ops = B * l * l * dp_cell_ops(nl, order)
        for k, kern, plain, work in (
                (key, lambda: fwd(M, nl),
                 lambda: sg.sig_gram_levels_ho_ref(M, nl, order),
                 (ops, nbytes)),
                (f"{key}_bwd", lambda: bwd(M, g, nl),
                 lambda: sg.sig_gram_levels_ho_bwd_ref(M, g, nl, order),
                 (3 * ops, nbytes + 4 * B * l * l))):
            got, want = kern(), plain()
            err = abs_err(got, want)
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain, reps=3, warmup=1)
            report[k] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(*work), library_ms=None)
            print(f"time deep {k} (order {order}) nl={nl} B={B} L'={l} "
                  f"float32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {report[k]['bound_ms']:.4f} ms "
                  f"({report[k]['bound_by']}), scaled err "
                  f"{scaled_err(got, want):.3e}")
            del got, want
    del M, g
    torch.cuda.empty_cache()
    return report


def deep_gpr_phase(dev):
    """(q) Exact GPR at BASELINE config 1's shape (N=150 of 200, L=50,
    d=2, noise 0.05) with num_levels = 10, float64, RBF base: order 1 on
    the card against the same model on the CPU (K, lml and the gradient
    of every parameter, rtol as the small float64 checks), order 2 against
    the plain route on the card. Both run K's 150² pairs through increment
    matrices and the sig_gram kernels past 7 levels; returns each order's
    counters."""
    import torch

    f64 = torch.float64
    N = DEEP_GPR["N"]
    Xg, yg = regression_sequences(np.random.default_rng(SEED),
                                  L=DEEP_GPR["L"])
    X = torch.as_tensor(Xg[:N], dtype=f64, device=dev)
    Y = torch.as_tensor(yg[:N], dtype=f64, device=dev)
    launches = {}

    def run(gpr, X, Y):
        K = gpr.kernel.K(X)
        loss = -gpr.log_marginal_likelihood(X, Y)
        grads = torch.autograd.grad(loss, list(gpr.parameters()))
        return [K.detach(), loss.detach(), *grads]

    for order in (1, 2):
        label = f"GPR order {order} num_levels=10"
        gpr = build_gpr(torch, dev, f64, X, nl=10, order=order)
        reference = copy.deepcopy(gpr)
        reset_counters()
        (got, ms) = timed(lambda: run(gpr, X, Y))
        launches[order] = counters()
        sg_keys = (("sig_gram", "sig_gram_bwd") if order == 1 else
                   ("sig_gram_ho", "sig_gram_ho_bwd"))
        check(all(launches[order][k] > 0 for k in sg_keys)
              and not any(launches[order][k] for k in (
                  "gram", "diag", "gram_bwd", "gram_ho", "gram_ho_bwd")),
              f"{label}: counters {launches[order]}")
        if order == 1:
            t0 = time.perf_counter()
            want = run(reference.to("cpu"), X.cpu(), Y.cpu())
            where = (f"the CPU ({1e3 * (time.perf_counter() - t0):.0f} ms "
                     "there)")
        else:
            with plain_route():
                want = run(reference, X, Y)
            where = "the plain route on the card"
        err = max(scaled_err(a.cpu(), b.cpu()) for a, b in zip(got, want))
        print(f"{label}: K, lml {got[1].item():.10g} and {len(got) - 2} "
              f"gradients on the card ({ms:.1f} ms) against {where}: scaled "
              f"err {err:.3e}, tolerance 1e-8; launches "
              f"{ {k: launches[order][k] for k in sg_keys} }")
        check(err <= 1e-8, f"{label}: {err}")
        del gpr, reference, got, want
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The order-1 main path at every d and L: the Gram-side kernels past
# their shared memory, the diagonal past 1024 rows, and the main model at
# UEA PEMS-SF's and MotorImagery's widths and lengths.
# ---------------------------------------------------------------------------

#: the wide d (MotorImagery's, past the staged sequences, DuckDuckGeese's)
#: and the long L (past one band, past the old 1024-row bound,
#: MotorImagery's) of the diagonal's checks
WIDE_D = (64, 400, 1345)
WIDE_L = (257, 1025, 3000)


def uea_walks(rng, n, L, d):
    """Synthetic sequences at a UEA set's published shape: walks whose steps
    keep the norms of d = 2 at L = 50 (``long_walks`` scaled by √(2/d)), so
    the RBF signature levels stay inside float32's range at any d, L."""
    return long_walks(rng, n, L, d) * np.sqrt(2 / d)


def gram_side_phase(dev):
    """(s) Each Gram-side kernel where its old plan refused, float32 and
    float64, against its plain version with the tolerances above: the
    diagonal at d in WIDE_D (L = 50) and at L in WIDE_L (d = 3), nl 4 and 7,
    and at the shapes of phase (t)'s UEA paths (4 sequences of PEMS-SF's
    144 x 963 and MotorImagery's 3000 x 64, at the path's levels and 7;
    in float32 the plan must be the one the path runs, but for its grid),
    RBF and Linear; both Gram backwards at d = 64 and 400, L = 50 and 150;
    the Gram forwards' block design at L = 300, d = 400 (x and y read from
    global memory). Each launch's plan is printed and its counter must
    rise."""
    import torch

    from gpsig_tpu_torch.ops.cuda import fused_gram as fg
    from gpsig_tpu_torch.ops.cuda import fused_gram_ho as fgho
    from gpsig_tpu_torch.ops.cuda import plan

    rng = np.random.default_rng(SEED + 40)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        tol, gtol, btol = TOL[name][0], GEN_TOL[name][0], BWD_TOL[name][0]
        item = torch.tensor([], dtype=dtype).element_size()
        shapes = ([(8, 50, d, 4, None) for d in WIDE_D]
                  + [(4, L, 3, 4, None) for L in WIDE_L]
                  + [(4, UEA[k]["L"], UEA[k]["d"], UEA[k]["nl"], k)
                     for k in UEA])
        for N, L, d, nl0, path in shapes:
            X = torch.as_tensor(uea_walks(rng, N, L, d), dtype=dtype,
                                device=dev)
            errs = []
            for nl in (nl0, 7):
                for rbf in (True, False):
                    n0 = fg.diag_launches
                    got = fg.fused_diag_levels(X, nl, rbf)
                    want = fg.fused_diag_levels_ref(X, nl, rbf)
                    torch.cuda.synchronize()
                    check(fg.diag_launches == n0 + 1,
                          f"diag L={L} d={d}: the kernel did not launch")
                    errs.append(scaled_err(got, want))
            p = plan.diag_plan(N, L, d, nl0, item)
            carries = ("none" if p["bands"] == 1 else "shared memory"
                       if p["carry_smem"] else "workspace")
            print(f"diag {name} N={N} L={L} d={d} nl={nl0}: plan S={p['S']}"
                  f" R={p['R']} W={p['W']} bands={p['bands']} stage="
                  f"{p['stage']} carries {carries}; "
                  f"scaled err {max(errs):.3e} (tol {tol:g})")
            if path and dtype == torch.float32:
                keys = ("S", "R", "W", "bands", "stage", "carry_smem",
                        "smem")
                runs = plan.diag_plan(UEA[path]["n_test"], L, d, nl0, item)
                check(all(p[k] == runs[k] for k in keys),
                      f"diag {path}: checked {p}, the path runs {runs}")
                print(f"diag {name} at {path}'s shape: the plan its path "
                      "runs")
            check(max(errs) <= tol, f"diag {name} L={L} d={d}: {errs}")
        for L in (50, 150):
            for d in (64, 400):
                X = torch.as_tensor(uea_walks(rng, 4, L, d), dtype=dtype,
                                    device=dev)
                Y = torch.as_tensor(uea_walks(rng, 6, L, d), dtype=dtype,
                                    device=dev)
                g = torch.as_tensor(rng.standard_normal((5, 4, 6)),
                                    dtype=dtype, device=dev)
                n0 = (fg.gram_bwd_launches, fgho.bwd_launches)
                e1 = scaled_err(fg.fused_gram_levels_bwd(X, Y, g, 4, True),
                                fg.fused_gram_levels_bwd_ref(X, Y, g, 4,
                                                             True))
                e2 = scaled_err(
                    fgho.fused_gram_ho_levels_bwd(X, Y, g, 4, 2, "rbf",
                                                  True),
                    fgho.fused_gram_ho_levels_bwd_ref(X, Y, g, 4, 2, "rbf",
                                                      True))
                check((fg.gram_bwd_launches, fgho.bwd_launches)
                      == (n0[0] + 1, n0[1] + 1),
                      f"Gram backwards L={L} d={d}: a kernel did not launch")
                p1 = plan.gram_bwd_launch(4, 6, L, d, item)
                p2 = plan.gram_ho_bwd_launch(4, 6, L - 1, L, d, item)
                print(f"Gram backwards {name} L={L} d={d}: staged "
                      f"{p1['staged']} / {p2['staged']}, workspace "
                      f"{p1['work']} / {p2['work']} values; scaled err "
                      f"order 1 {e1:.3e}, order 2 {e2:.3e} (tol {btol:g})")
                check(max(e1, e2) <= btol,
                      f"Gram backwards {name} L={L} d={d}: {e1}, {e2}")
        X = torch.as_tensor(uea_walks(rng, 3, 300, 400) / np.sqrt(6),
                            dtype=dtype, device=dev)
        check(plan.gram_fwd_smem(300, 400, 32, 4, 3, item)
              < 300 * 400 * item, "block design: x and y still staged")
        e1 = scaled_err(fg.fused_gram_levels(X, X, 4, True),
                        fg.fused_gram_levels_ref(X, X, 4, True))
        e2 = scaled_err(fgho.fused_gram_ho_levels(X, X, 4, 2, "rbf", True),
                        fgho.fused_gram_ho_levels_ref(X, X, 4, 2, "rbf",
                                                      True))
        print(f"Gram forwards' block design {name} L=300 d=400 (x, y from "
              f"global memory): scaled err order 1 {e1:.3e} (tol {tol:g}), "
              f"order 2 {e2:.3e} (tol {gtol:g})")
        check(e1 <= tol and e2 <= gtol, f"block design {name}: {e1}, {e2}")
        torch.cuda.empty_cache()


#: UEA shapes (published: train, test sequences, length, channels,
#: classes) and the slice's model cut for each: levels, inducing tensors,
#: the training batch and steps (PEMS-SF's two: a step takes ~9 s, most of
#: it the general Kuf backward at d = 963)
UEA = {
    "PEMS-SF": dict(n_train=267, n_test=173, L=144, d=963, C=7, nl=5, M=500,
                    batch=50, steps=2),
    "MotorImagery": dict(n_train=278, n_test=100, L=3000, d=64, C=2, nl=4,
                         M=100, batch=16, steps=2),
}


def uea_svgp_phase(dev, name):
    """(t) The main path's model, the order-1 normalised SignatureRBF SVGP
    with inducing tensors (increments), at a UEA set's published shape
    (synthetic data from the seed, float32): ``posterior()`` +
    ``predict_y`` on the test sequences and natgrad + Adam steps (Adam
    1e-3, γ = 0.1), each with its counters: the diagonal and the order-1
    Kuf forward must launch in both, the Kuf backward in the steps (past
    d = 3 its plan takes the general kernel at order 1 and its
    workspace); outputs finite, probabilities sum to 1; wall times
    printed."""
    import torch

    from gpsig_tpu_torch.ops.cuda import plan
    from gpsig_tpu_torch.training.loop import make_step_fn

    cfg = UEA[name]
    f32 = torch.float32
    rng = np.random.default_rng(SEED + 41)
    L, d, nl, C, M = cfg["L"], cfg["d"], cfg["nl"], cfg["C"], cfg["M"]
    data = uea_walks(rng, cfg["n_train"], L, d)
    model, X, Y = build_svgp(torch, dev, f32, rng, M=M, nl=nl, d=d, L=L,
                             C=C, n_train=cfg["n_train"], data=data)
    Xte = torch.as_tensor(uea_walks(rng, cfg["n_test"], L, d), dtype=f32,
                          device=dev)
    F2 = 2 * nl * (nl + 1) // 2
    fwd = plan.kuf_fwd_plan(cfg["n_test"], F2, d, nl, 4, tuned=True)
    bwd = plan.kuf_bwd_plan(M, cfg["batch"], F2, d, 4, tuned=True)
    # the order-1 Kuf entry points count their launches whichever kernel
    # their plan's route takes (past d = 3 the general one at order 1)
    fwd_key, bwd_key = "tens_seq", "tens_seq_bwd"
    diag = plan.diag_plan(cfg["n_test"], L, d, nl, 4)
    if d > plan.KUF_TUNED_MAX_D:
        check(bwd["route"] == "general", f"{name}: Kuf backward {bwd}")
    carries = ("none" if diag["bands"] == 1 else "shared memory"
               if diag["carry_smem"] else "workspace")
    print(f"{name} SVGP (M={M}, nl={nl}, C={C}, L={L}, d={d}): diagonal "
          f"S={diag['S']} W={diag['W']} bands={diag['bands']} stage="
          f"{diag['stage']} carries {carries}; "
          f"Kuf forward {fwd['route']}, backward {bwd['route']} "
          f"(workspace {bwd['work']} values)")

    reset_counters()
    with torch.no_grad():
        (mean, var), ms = timed(lambda: model.posterior().predict_y(Xte))
    launches = counters()
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
          f"{name}: predictions not finite")
    check(bool(torch.allclose(mean.sum(-1), torch.ones_like(mean[:, 0]),
                              atol=1e-4)), f"{name}: probabilities")
    check(launches["diag"] > 0 and launches[fwd_key] > 0,
          f"{name} serving: diag / Kuf did not launch: {launches}")
    print(f"{name} posterior() + predict_y on {cfg['n_test']}: {ms:.1f} ms "
          f"(first call); launches diag {launches['diag']}, {fwd_key} "
          f"{launches[fwd_key]}")
    with torch.no_grad():
        post = model.posterior()
        _, ms = timed(lambda: post.predict_y(Xte))
    print(f"{name} predict_y on a cached posterior: {ms:.1f} ms")

    step = make_step_fn(1e-3, num_data=cfg["n_train"], gamma=0.1)
    state = step.init(model)
    reset_counters()
    elbos, times = [], []
    for _ in range(cfg["steps"]):
        idx = torch.as_tensor(rng.choice(cfg["n_train"], cfg["batch"],
                                         replace=False), device=dev)
        (state, elbo), ms = timed(lambda: step(state, X[idx], Y[idx]))
        elbos.append(elbo.item())
        times.append(ms)
    launches = counters()
    check(all(np.isfinite(elbos)), f"{name}: ELBO not finite: {elbos}")
    for p in model.parameters():
        check(bool(torch.isfinite(p).all()), f"{name}: parameter not finite")
    check(launches["diag"] > 0 and launches[fwd_key] > 0
          and launches[bwd_key] > 0,
          f"{name} training: a kernel did not launch: {launches}")
    print(f"{name} natgrad+Adam steps at B={cfg['batch']}: ELBO {elbos}; "
          f"ms {[round(t, 1) for t in times]}; launches diag "
          f"{launches['diag']}, {fwd_key} {launches[fwd_key]}, {bwd_key} "
          f"{launches[bwd_key]}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    del model, state, X, Y, Xte
    torch.cuda.empty_cache()


def wide_order1_svgp_check(dev):
    """(u) The PEMS-SF model's float64 copy at small N, T and L (d = 963,
    nl = 5, 6 inducing tensors, 8 sequences of L = 12, MultiClass(7)): two
    natgrad + Adam steps on the card against the same on the CPU,
    tolerance 1e-8; the diagonal and the Kuf kernels launch."""
    import torch

    from gpsig_tpu_torch.inducing import InducingTensors
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    f64 = torch.float64
    rng = np.random.default_rng(SEED + 42)
    Z, X, _ = kuf_inputs(rng, 6, 8, 12, 963, 5, True, "rbf")
    Y = rng.integers(0, 7, 8)
    model = SVGP.create(SignatureRBF(963, 5, normalization=True,
                                     device="cpu"), MultiClass(7),
                        InducingTensors.create(torch.as_tensor(Z), 5, True),
                        7, device="cpu")
    runs, card = {}, copy.deepcopy(model).to(dev)
    for where, m in (("cpu", model), ("card", card)):
        x = torch.as_tensor(X, dtype=f64, device=m.q_mu.device)
        y = torch.as_tensor(Y, device=m.q_mu.device)
        step = make_step_fn(1e-2, num_data=40, gamma=0.1)
        state, out = step.init(m), []
        reset_counters()
        for _ in range(2):
            state, elbo = step(state, x, y)
            out.append(elbo)
        launches = counters()
        runs[where] = [t.detach().cpu() for t in (*out, *m.parameters())]
    check(launches["diag"] > 0 and launches["tens_seq"] > 0
          and launches["tens_seq_bwd"] > 0,
          f"wide order-1 SVGP: a kernel did not launch: {launches}")
    err = max(scaled_err(g, w) for g, w in zip(runs["card"], runs["cpu"]))
    print(f"order-1 SVGP at d=963 (2 natgrad+Adam steps, float64): card vs "
          f"CPU scaled err {err:.3e} over every ELBO and parameter, "
          f"tolerance 1e-8; launches diag {launches['diag']}, tens_seq "
          f"{launches['tens_seq']}, tens_seq_bwd "
          f"{launches['tens_seq_bwd']}")
    check(err <= 1e-8, f"wide order-1 SVGP: {err}")


# ---------------------------------------------------------------------------
# Every length and order (sig_gram's segments and bands, orders 4-7 past 7
# levels, the Goursat grids past 2^15 refined points, the inducing-sequence
# SVGP at MotorImagery's length, GPRs past 1024 rows).
# ---------------------------------------------------------------------------

#: the sweep's L2: every segment width, each lane count's and band's edges
#: (8 R, 16 R, 32 R at R = 2, 4, 8), the old 1024-row bound, and two lengths
#: of many bands
SWEEP_L2 = (*range(1, 10), 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256,
            257, 1023, 1024, 1025, 1300, 3000)
SWEEP_TOL = {
    "float32": (1e-4, "float32 DP sums over up to 3000 rows, the bands' "
                "scans started from their neighbours' carries, in another "
                "order than the plain version; the backward's states "
                "rebuilt by subtraction"),
    "float64": (1e-10, "the plain version's arithmetic, other summation "
                "order only"),
}


def sig_gram_routes(order):
    """sig_gram's forward and backward entry points at ``order``."""
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg

    if order == 1:
        return (lambda m, nl: sg.sig_gram_levels(m, nl),
                lambda m, g, nl: sg.sig_gram_levels_bwd(m, g, nl))
    return (lambda m, nl: sg.sig_gram_levels_ho(m, nl, order),
            lambda m, g, nl: sg.sig_gram_levels_ho_bwd(m, g, nl, order))


def sig_gram_case(dev, rng, B, L1, L2, nl, order, dtypes, tol):
    """One sig_gram shape's forward and backward against their plain
    versions on the card; returns each dtype's larger scaled error and the
    plans (forward, backward) of the last."""
    import torch

    from gpsig_tpu_torch.ops.cuda import plan
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg

    M_np = 0.4 * rng.standard_normal((B, L1, L2)) / np.sqrt(
        max(L1, L2) / 20)
    g_np = rng.standard_normal((nl + 1, B))
    fwd, bwd = sig_gram_routes(order)
    errs = {}
    for dtype in dtypes:
        name = str(dtype).split(".")[1]
        M = torch.as_tensor(M_np, dtype=dtype, device=dev)
        g = torch.as_tensor(g_np, dtype=dtype, device=dev)
        got = (fwd(M, nl), bwd(M, g, nl))
        want = (sg.sig_gram_levels_ho_ref(M, nl, order),
                sg.sig_gram_levels_ho_bwd_ref(M, g, nl, order))
        torch.cuda.synchronize()
        for a in got:
            check(bool(torch.isfinite(a).all()), f"sig_gram M {M.shape} "
                  f"nl={nl} order {order} {name}: not finite")
        errs[name] = max(scaled_err(a, b) for a, b in zip(got, want))
        check(errs[name] <= tol[name][0], f"sig_gram M [{B}, {L1}, {L2}] "
              f"nl={nl} order {order} {name}: {errs[name]} > "
              f"{tol[name][0]}")
    item = torch.tensor([], dtype=dtypes[-1]).element_size()
    plans = tuple(plan.sig_gram_plan(B, L1, L2, nl, min(order, nl), item, b)
                  for b in (False, True))
    return errs, plans


def design(lp):
    """A sig_gram plan in a few words."""
    if lp["bands"] == 1:
        return f"S={lp['S']} R={lp['R']}"
    where = "smem" if lp["area_smem"] else "workspace"
    return f"{lp['bands']} bands R={lp['R']} W={lp['W']} {where}"


def sig_gram_sweep_phase(dev):
    """(v) sig_gram at every design edge: L2 in SWEEP_L2 x p in {1, 2, 3} x
    num_levels in {2, 4, 7, 10}, forward and backward, float32 and float64,
    against the plain versions on the card (L1 = 13 columns up to 257 rows,
    7 past them, so that the plain version stays cheap); each L2's designs
    and worst errors printed."""
    import torch

    rng = np.random.default_rng(SEED + 50)
    for name, (tol, why) in SWEEP_TOL.items():
        print(f"sweep tolerance {name}: scaled err <= {tol:g}: {why}")
    n = 0
    for L2 in SWEEP_L2:
        L1 = 13 if L2 <= 257 else 7
        worst, designs = {"float32": 0.0, "float64": 0.0}, set()
        for nl in (2, 4, 7, 10):
            for order in (1, 2, 3):
                errs, plans = sig_gram_case(
                    dev, rng, 3, L1, L2, nl, order,
                    (torch.float32, torch.float64), SWEEP_TOL)
                n += 1
                for k, e in errs.items():
                    worst[k] = max(worst[k], e)
                designs.update(design(lp) for lp in plans)
        print(f"sweep L2={L2} (L1={L1}): worst scaled err float32 "
              f"{worst['float32']:.2e}, float64 {worst['float64']:.2e}; "
              f"float64 designs {sorted(designs)}")
    print(f"sig_gram sweep: {n} shapes x 2 dtypes, forward and backward, "
          "within tolerance")


def deep_orders_phase(dev):
    """(w) sig_gram at orders 4-7 past 7 levels (num_levels 8 and 10, L2 in
    {49, 150}: segments and bands), forward and backward, float32 and
    float64, against the plain versions on the card."""
    import torch

    rng = np.random.default_rng(SEED + 51)
    for nl in (8, 10):
        for order in (4, 5, 6, 7):
            for Lp in (49, 150):
                errs, plans = sig_gram_case(
                    dev, rng, 4, 20, Lp, nl, order,
                    (torch.float32, torch.float64), DEEP_TOL)
                print(f"deep order {order} nl={nl} L2={Lp}: scaled err "
                      f"float32 {errs['float32']:.2e}, float64 "
                      f"{errs['float64']:.2e}; {design(plans[1])}")


def goursat_long_phase(dev):
    """(x) The Goursat kernels just past the old 2^15 refined points a side:
    2 pairs of [2, 4100] unrefined increments at dyadic order 3 (a 16 x
    32,800 refined grid), the forward with in-kernel refinement, the
    given-grid route on the grid refined in memory, and the adjoint
    gradient, float32 and float64, against the plain sweeps on the card."""
    import torch

    from gpsig_tpu_torch.ops.cuda import goursat as gs

    rng = np.random.default_rng(SEED + 52)
    o, (Su, Tu) = 3, (2, 4100)
    inc_np = rng.standard_normal((2, Su, Tu)) * 0.3 / np.sqrt(Tu)
    gbar_np = rng.standard_normal(2)
    fine_np = (np.repeat(np.repeat(inc_np, 1 << o, 1), 1 << o, 2)
               / 4 ** o)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        inc, fine, gbar = (torch.as_tensor(a, dtype=dtype, device=dev)
                           for a in (inc_np, fine_np, gbar_np))
        n0 = (gs.launches, gs.fused_launches, gs.grad_launches)
        got = (gs.goursat_corner_refined(inc, o), gs.goursat_corner_fast(fine),
               gs.goursat_grad_refined(inc, o, gbar))
        check((gs.launches, gs.fused_launches, gs.grad_launches)
              == (n0[0] + 1, n0[1] + 1, n0[2] + 1),
              "Goursat past 2^15: a kernel did not launch")
        want = (gs.goursat_corner_refined_ref(inc, o),
                gs.goursat_corner_ref(fine),
                gs.goursat_grad_refined_ref(inc, o, gbar))
        torch.cuda.synchronize()
        errs = [scaled_err(a, b) for a, b in zip(got, want)]
        tol = GOURSAT_TOL[name][0]
        print(f"Goursat [{Su}, {Tu}] at dyadic order {o} (refined 16 x "
              f"{Tu << o}) {name}: forward {errs[0]:.2e} (bitwise "
              f"{bool(torch.equal(got[0], want[0]))}), given grid "
              f"{errs[1]:.2e} (bitwise {bool(torch.equal(got[1], want[1]))}),"
              f" adjoint {errs[2]:.2e}; tolerance {tol}")
        check(max(errs[:2]) <= tol[0] and errs[2] <= tol[1],
              f"Goursat past 2^15 {name}: {errs}")


# BASELINE config 3's model (benchmarks/config3_natgrad_sequences.py: 40
# inducing sequences of length 8, SignatureRBF nl = 4 order 1 normalised,
# batch 50, natgrad + Adam lr 2e-3, γ = 0.1) at UEA MotorImagery's shape
CONFIG3 = dict(M=40, Lz=8, nl=4, batch=50, lr=2e-3, gamma=0.1, steps=2)


def sequence_svgp_phase(dev):
    """(y) BASELINE config 3's SVGP, inducing sequences, at MotorImagery's
    shape (d = 64, L = 3000, C = 2; 278 / 100 synthetic sequences), float32:
    ``posterior()`` + ``predict_y`` on the test sequences, held against the
    plain route on the card, and 2 natgrad + Adam steps at B = 50, each with
    its counters (the two-length Gram through sig_gram with the 7 inducing
    steps on its rows, its backward in the steps). The first step is held
    against the plain route in float64 (the same model and batch): in
    float32 the σ gradient of this model comes from near-cancelling terms,
    and two float32 routes that differ only in summation order give it 6%
    apart. Returns the launches."""
    import torch

    from gpsig_tpu_torch.inducing import make_inducing_sequences_from_data
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.ops.cuda import plan
    from gpsig_tpu_torch.training.loop import make_step_fn

    cfg, ui = CONFIG3, UEA["MotorImagery"]
    f32 = torch.float32
    rng = np.random.default_rng(SEED + 53)
    L, d, C, M = ui["L"], ui["d"], ui["C"], cfg["M"]
    X = torch.as_tensor(uea_walks(rng, ui["n_train"], L, d), dtype=f32,
                        device=dev)
    Y = torch.as_tensor(rng.integers(0, C, ui["n_train"]), device=dev)
    Xte = torch.as_tensor(uea_walks(rng, ui["n_test"], L, d), dtype=f32,
                          device=dev)
    q_mu = torch.as_tensor(0.5 * rng.standard_normal((M, C)))

    def build(dtype):
        kern = SignatureRBF(d, cfg["nl"], lengthscales=1.0,
                            normalization=True, dtype=dtype, device=dev)
        feat = make_inducing_sequences_from_data(
            torch.Generator().manual_seed(SEED), X.to(dtype), M, cfg["Lz"],
            d)
        model = SVGP.create(kern, MultiClass(C), feat, num_latent=C,
                            dtype=dtype, device=dev)
        with torch.no_grad():
            model.q_mu.copy_(q_mu)
        return model

    model = build(f32)
    label = "config 3 SVGP at MotorImagery's shape"
    lp = plan.sig_gram_plan(M * ui["n_test"], L - 1, cfg["Lz"] - 1,
                            cfg["nl"], 1, 4, False)
    print(f"{label} (M={M} inducing sequences of {cfg['Lz']}, nl="
          f"{cfg['nl']}, L={L}, d={d}): Kuf matrices [{L - 1}, "
          f"{cfg['Lz'] - 1}], sig_gram {design(lp)}")

    def serve():
        post = model.posterior()
        probs, pvar = post.predict_y(Xte)
        fmean, fvar = post.predict_f(Xte)
        torch.cuda.synchronize()
        return dict(probs=probs, pvar=pvar, fmean=fmean, fvar=fvar)

    launches = {}
    with torch.no_grad():
        reset_counters()
        out, ms = timed(serve)
        launches["serving"] = counters()
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"{label} {k} not finite")
        sums = out["probs"].sum(-1)
        check(bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-4)),
              f"{label}: probabilities do not sum to 1")
        check(bool((out["pvar"] >= 0).all() and (out["fvar"] >= 0).all()),
              f"{label}: negative variances")
        with plain_route():
            ref = serve()
        compare_routes(label, out, ref, dict(fmean=1e-3, probs=1e-3))
    print(f"{label} posterior() + predict_y on {ui['n_test']}: {ms:.1f} ms")
    step = make_step_fn(cfg["lr"], num_data=ui["n_train"],
                        gamma=cfg["gamma"])
    state = step.init(model)
    idx = [torch.as_tensor(rng.choice(ui["n_train"], cfg["batch"],
                                      replace=False), device=dev)
           for _ in range(cfg["steps"])]
    reset_counters()
    elbos, times = [], []
    for k in range(cfg["steps"]):
        (state, elbo), t = timed(lambda: step(state, X[idx[k]], Y[idx[k]]))
        elbos.append(elbo.item())
        times.append(t)
    launches["training"] = counters()
    check(all(np.isfinite(elbos)), f"{label}: ELBO not finite: {elbos}")
    for p in model.parameters():
        check(bool(torch.isfinite(p).all()), f"{label}: parameter not "
              "finite")
    firsts = []
    for route in (contextlib.nullcontext, plain_route):
        m64 = build(torch.float64)
        with route():
            step64 = make_step_fn(cfg["lr"], num_data=ui["n_train"],
                                  gamma=cfg["gamma"])
            step64(step64.init(m64), X[idx[0]].double(), Y[idx[0]])
        firsts.append(grads_and_params(m64))
    torch.cuda.synchronize()
    compare_first_step(f"{label} (float64)", *firsts, cfg["lr"],
                       why="float64 sums over 2999 steps in another order "
                       "than the plain version, carried through the M=40 "
                       "Cholesky; the σ gradient's condition is about 1e8 "
                       "(6.6e-9 on the H100, the others <= 2e-12), a kernel "
                       "fault reads >= 1e-4", grad_tol=1e-6)
    print(f"{label} natgrad+Adam steps at B={cfg['batch']}: ELBO {elbos}; "
          f"ms {[round(t, 1) for t in times]}")
    for phase_, need in (("serving", ("sig_gram", "gram", "diag")),
                         ("training", ("sig_gram", "sig_gram_bwd", "gram",
                                       "gram_bwd", "diag"))):
        print(f"{label} {phase_} launches: {launches[phase_]}")
        for key in need:
            check(launches[phase_][key] > 0,
                  f"{label} {phase_}: {key} did not launch")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    del model, m64, state, X, Y, Xte
    torch.cuda.empty_cache()
    return launches


def long_gram_gpr_phase(dev):
    """(z) Exact GPRs whose Gram has more than 1024 DP rows (N = 6 sequences
    of L = 1300, d = 2, nl = 4, RBF, normalised, noise 0.05), order 1 and
    order 2, float32: K, the log marginal likelihood and ``predict_y`` on 2
    more sequences, then 2 Adam steps on -lml (every gradient), each with
    its counters (the Gram through sig_gram: the fused Grams must not
    launch), held against the plain route on the card. Returns the
    launches by order."""
    import torch

    f32 = torch.float32
    rng = np.random.default_rng(SEED + 54)
    Xn = long_walks(rng, 8, 1300)
    yn = np.tanh(Xn[:, -1, :1]) + 0.1 * rng.standard_normal((8, 1))
    Xa = torch.as_tensor(Xn, dtype=f32, device=dev)
    ya = torch.as_tensor(yn, dtype=f32, device=dev)
    X, Y, Xnew = Xa[:6], ya[:6], Xa[6:]
    out_launches = {}
    for order in (1, 2):
        label = f"order-{order} GPR at L=1300 (N=6)"
        gpr = build_gpr(torch, dev, f32, X, nl=4, order=order)
        plain_gpr = copy.deepcopy(gpr)

        def serve(g):
            mean, var = g.predict_y(X, Y, Xnew)
            out = dict(K=g.kernel.K(X), lml=g.log_marginal_likelihood(X, Y),
                       mean=mean, var=var)
            torch.cuda.synchronize()
            return out

        with torch.no_grad():
            reset_counters()
            out = serve(gpr)
            serving = counters()
            with plain_route():
                ref = serve(plain_gpr)
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"{label} {k} not finite")
        compare_routes(label, out, ref, dict(K=1e-4, lml=1e-3, mean=1e-3,
                                             var=1e-3))
        step = gpr_step_fn(torch, gpr, X, Y, 1e-2)
        reset_counters()
        lmls = [step().item()]
        first = grads_and_params(gpr)
        lmls.append(step().item())
        training = counters()
        with plain_route():
            gpr_step_fn(torch, plain_gpr, X, Y, 1e-2)()
        torch.cuda.synchronize()
        compare_first_step(label, first, grads_and_params(plain_gpr), 1e-2,
                           why="float32 sums over 1299 x 1299 increments "
                           "carried through the N=6 Cholesky")
        check(all(np.isfinite(lmls)), f"{label}: lml not finite {lmls}")
        key = "sig_gram" if order == 1 else "sig_gram_ho"
        for name, counts, need in (("serving", serving, (key,)),
                                   ("training", training,
                                    (key, f"{key}_bwd"))):
            print(f"{label} {name} launches: {counts}")
            for k in need:
                check(counts[k] > 0, f"{label} {name}: {k} did not launch")
            for k in ("gram", "gram_ho", "gram_bwd", "gram_ho_bwd"):
                check(counts[k] == 0, f"{label} {name}: {k} launched past "
                      "its 1024 rows")
        print(f"{label}: lml {lmls}")
        out_launches[order] = training
    return out_launches


# ---------------------------------------------------------------------------
# sig_gram past order 7 (the run-time-order instance), the entry twin of
# __graft_entry__.py, and the UEA data layer on the card.
# ---------------------------------------------------------------------------

def order_counts():
    """The order >= 2 sig_gram launches (forward, backward): at p > 7 every
    one is the run-time-order instance's."""
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg

    return sg.ho_launches, sg.ho_bwd_launches


def chunked(fn, *tensors, size=1500):
    """``fn`` over the batch in blocks of ``size`` matrices, concatenated
    on the batch axis (the last for level outputs): the plain version of
    the p > 7 backward keeps every level's p² states for autograd, which
    at the full batch would not fit the card."""
    import torch

    outs = [fn(*(t[..., i:i + size] if t.ndim == 2 else t[i:i + size]
                 for t in tensors))
            for i in range(0, tensors[0].shape[0], size)]
    return torch.cat(outs, dim=-1 if outs[0].ndim == 2 else 0)


#: the wall time "deep orders past 7" may take (about 18 s on an H100,
#: most of it the plain versions of the p = nl = 20 cases and the GPR's
#: first step)
ORDER_BUDGET_S = 60.0


def order_routes(B, L1, L2, nl, order):
    """The run-time-order instance's routes for one shape: float32 and
    float64, forward and backward (``plan.sig_gram_order_plan``)."""
    from gpsig_tpu_torch.ops.cuda import plan

    return {(item, bwd): plan.sig_gram_plan(B, L1, L2, nl, min(order, nl),
                                            item, bwd)["route"]
            for item in (4, 8) for bwd in (False, True)}


def order_float32_err(dev, M_np, g_np, nl, order):
    """Scaled errors against the plain versions in float64 of the float32
    kernels' forward and backward and of the plain versions' own in
    float32: [forward, backward, plain forward, plain backward]. Past order
    7 the backward recomputes each column's states from a checkpoint, so
    its error stays near the plain version's at many levels and columns;
    up to order 7 past 7 levels (deep_levels.cuh) it rebuilds them by
    subtraction."""
    import torch

    from gpsig_tpu_torch.ops.cuda import sig_gram as sg

    M = torch.as_tensor(M_np, dtype=torch.float64, device=dev)
    g = torch.as_tensor(g_np, dtype=torch.float64, device=dev)
    want = (sg.sig_gram_levels_ho_ref(M, nl, order),
            sg.sig_gram_levels_ho_bwd_ref(M, g, nl, order))
    M32, g32 = M.float(), g.float()
    got = (sg.sig_gram_levels_ho(M32, nl, order),
           sg.sig_gram_levels_ho_bwd(M32, g32, nl, order),
           sg.sig_gram_levels_ho_ref(M32, nl, order),
           sg.sig_gram_levels_ho_bwd_ref(M32, g32, nl, order))
    for a in got[:2]:
        check(bool(torch.isfinite(a).all()), f"sig_gram nl={nl} order "
              f"{order} float32: not finite")
    return [scaled_err(a.double(), b) for a, b in zip(got, want + want)]


def order_phase(dev):
    """sig_gram past order 7 (``csrc/sig_gram_order.cuh``) within
    ORDER_BUDGET_S seconds: forward and backward against their plain
    versions at num_levels 8 and 10, orders 8 and 10, L2 in {49, 150} (4
    matrices [20, L2]), at p = nl = 20 on [4, 20, 150] and on the long
    columns of [4, 149, 49] (whose backward states take the workspace),
    float64 against the plain versions in float64 and float32 against the
    plain versions in float64 (the plain float32 version's own error
    printed beside), under DEEP_TOL, each launch the instance's own, each
    case's routes (register, shared memory or workspace) printed from the
    plan; then the instance timed at num_levels = 8, order 8 on the
    increment matrices of 150² pairs of L' = 49 (the nl = 10 GPR's Gram
    shape at a higher order), float32, with its bound; then a GPR Adam
    step of SignatureRBF(2, 8, order=8) at BASELINE config 1's N = 150, L =
    50 (finite, the instance's forward and backward launched), and a small
    float64 GPR (K, lml, gradients) on the card against the CPU. Returns
    the timings and the counters of the GPR step, reset just before it."""
    import torch

    from gpsig_tpu_torch.ops.cuda import sig_gram as sg

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 60)
    cases = [(nl, order, 20, Lp) for nl in (8, 10) for order in (8, 10)
             for Lp in (49, 150)] + [(20, 20, 20, 150), (20, 20, 149, 49)]
    for nl, order, L1, Lp in cases:
        n0 = order_counts()
        errs, plans = sig_gram_case(dev, rng, 4, L1, Lp, nl, order,
                                    (torch.float64,), DEEP_TOL)
        M_np = 0.4 * rng.standard_normal((4, L1, Lp)) / np.sqrt(
            max(L1, Lp) / 20)
        f32 = order_float32_err(dev, M_np, rng.standard_normal((nl + 1, 4)),
                                nl, order)
        n1 = order_counts()
        check(n1 == (n0[0] + 2, n0[1] + 2),
              f"order {order} nl={nl}: the p > 7 instance did not "
              f"launch ({n0} -> {n1})")
        routes = order_routes(4, L1, Lp, nl, order)
        print(f"order {order} nl={nl} M [4, {L1}, {Lp}]: scaled err against "
              f"the plain version in float64: float32 forward {f32[0]:.2e} "
              f"(plain float32 {f32[2]:.2e}), backward {f32[1]:.2e} (plain "
              f"float32 {f32[3]:.2e}); float64 {errs['float64']:.2e}; "
              f"routes float32 forward / backward {routes[4, False]} / "
              f"{routes[4, True]}, float64 {routes[8, False]} / "
              f"{routes[8, True]}")
        check(max(f32[:2]) <= DEEP_TOL["float32"][0],
              f"order {order} nl={nl} M [4, {L1}, {Lp}] float32: {f32[:2]} "
              f"> {DEEP_TOL['float32'][0]}")
        if min(order, nl) == 8 and Lp == 49:
            check(routes[4, False] == routes[4, True] == "register",
                  f"order {order} nl={nl} L2=49: float32 not on the "
                  f"register route: {routes}")
        if nl == 20:
            check(routes[8, True] == "workspace",
                  f"p = nl = 20 at L2 = {Lp}: the float64 backward should "
                  f"take the workspace: {routes}")

    # timed: the increment matrices of 150² pairs at L' = 49
    N, L, nl, order = DEEP_GPR["N"], DEEP_GPR["L"], 8, 8
    Xg, _ = regression_sequences(np.random.default_rng(SEED), L=L)
    Xf = Xg[:N].reshape(-1, 2)
    sq = np.sum(Xf * Xf, -1)
    G = np.exp(-0.5 * np.maximum(sq[:, None] + sq[None, :] - 2 * Xf @ Xf.T,
                                 0)).reshape(N, L, N, L)
    M_np = np.diff(np.diff(G.transpose(0, 2, 1, 3), axis=2), axis=3)
    l = L - 1
    M = torch.as_tensor(M_np.reshape(-1, l, l), dtype=torch.float32,
                        device=dev)
    del G, M_np
    B = M.shape[0]
    g = torch.as_tensor(rng.standard_normal((nl + 1, B)), dtype=torch.float32,
                        device=dev)
    nbytes = 4 * (B * l * l + (nl + 1) * B)
    ops = B * l * l * dp_cell_ops(nl, order)
    report = {}
    for key, kern, plain, work in (
            ("sig_gram_ho", lambda: sg.sig_gram_levels_ho(M, nl, order),
             lambda: chunked(lambda m: sg.sig_gram_levels_ho_ref(
                 m, nl, order), M),
             (ops, nbytes)),
            ("sig_gram_ho_bwd",
             lambda: sg.sig_gram_levels_ho_bwd(M, g, nl, order),
             lambda: chunked(lambda m, gg: sg.sig_gram_levels_ho_bwd_ref(
                 m, gg, nl, order), M, g),
             (3 * ops, nbytes + 4 * B * l * l))):
        got, want = kern(), plain()
        err = abs_err(got, want)
        ms, plain_ms = cuda_ms(kern, reps=3, warmup=1), cuda_ms(
            plain, reps=1, warmup=0)
        report[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           **bound(*work), library_ms=None)
        route = order_routes(B, l, l, nl, order)[4, key.endswith("bwd")]
        print(f"time order {key} nl={nl} order {order} B={B} L'={l} "
              f"float32 ({route} route): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms "
              f"(blocks of 1500 matrices), bound "
              f"{report[key]['bound_ms']:.4f} ms "
              f"({report[key]['bound_by']}), scaled err "
              f"{scaled_err(got, want):.3e}")
        check(scaled_err(got, want) <= DEEP_TOL["float32"][0],
              f"order {key} at the GPR shape: {scaled_err(got, want)}")
        del got, want
    del M, g
    torch.cuda.empty_cache()

    # a GPR Adam step through the instance at BASELINE config 1's shape
    f32 = torch.float32
    Xg, yg = regression_sequences(np.random.default_rng(SEED), L=L)
    X = torch.as_tensor(Xg[:N], dtype=f32, device=dev)
    Y = torch.as_tensor(yg[:N], dtype=f32, device=dev)
    gpr = build_gpr(torch, dev, f32, X, nl=nl, order=order)
    step = gpr_step_fn(torch, gpr, X, Y, 5e-2)
    reset_counters()
    lml, ms = timed(step)
    launches = counters()
    check(bool(np.isfinite(lml.item())), f"order-8 GPR: lml {lml.item()}")
    for p in gpr.parameters():
        check(bool(torch.isfinite(p).all()), "order-8 GPR: parameter not "
              "finite")
    # p = 8 throughout: every sig_gram_ho launch is the instance's
    check(launches["sig_gram_ho"] > 0 and launches["sig_gram_ho_bwd"] > 0,
          f"order-8 GPR step: the p > 7 instance did not launch: {launches}")
    check(not any(launches[k] for k in ("gram", "diag", "gram_bwd",
                                        "gram_ho", "gram_ho_bwd")),
          f"order-8 GPR step: a fused Gram launched: {launches}")
    print(f"order-8 GPR (SignatureRBF(2, 8, order=8), N={N}, L={L}) Adam "
          f"step: lml {lml.item():.6g}, {ms:.1f} ms (first step); launches "
          f"sig_gram_ho {launches['sig_gram_ho']}, sig_gram_ho_bwd "
          f"{launches['sig_gram_ho_bwd']} (all the p > 7 instance's)")
    _, ms2 = timed(step)
    print(f"order-8 GPR Adam step: {ms2:.1f} ms (second step)")
    del gpr, X, Y
    torch.cuda.empty_cache()

    # small float64: card against the CPU
    f64 = torch.float64
    Xs = torch.as_tensor(Xg[:6, :12], dtype=f64, device=dev)
    Ys = torch.as_tensor(yg[:6], dtype=f64, device=dev)
    gpr = build_gpr(torch, dev, f64, Xs, nl=nl, order=order)
    cpu = copy.deepcopy(gpr).to("cpu")
    out = []
    for model, Xm, Ym in ((gpr, Xs, Ys), (cpu, Xs.cpu(), Ys.cpu())):
        K = model.kernel.K(Xm)
        loss = -model.log_marginal_likelihood(Xm, Ym)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append([t.detach().cpu() for t in (K, loss, *grads)])
    err = max(scaled_err(a, b) for a, b in zip(*out))
    print(f"small float64 order-8 GPR (N=6, L=12): K, lml and "
          f"{len(out[0]) - 2} gradients, card vs CPU scaled err {err:.3e}, "
          "tolerance 1e-8")
    check(err <= 1e-8, f"small float64 order-8 GPR: {err}")
    total = time.perf_counter() - t0
    print(f"order phase: {total:.1f} s of its {ORDER_BUDGET_S:.0f} s budget")
    check(total <= ORDER_BUDGET_S, f"order phase: {total:.1f} s over its "
          f"{ORDER_BUDGET_S:.0f} s budget")
    return report, launches


def entry_phase(dev):
    """The entry twin (``gpsig_tpu_torch.entry.entry()``, the
    counterpart of ``__graft_entry__.entry()``) on the card by default, in
    float32: ``fn(model, X, Y)`` gives the ELBO and ``predict_f``, finite,
    with the diagonal and the order-1 Kuf forward launched (the SVGP with
    inducing tensors forms no Gram between its sequences, so the Gram
    kernel has nothing to do there), and against the same call through the
    plain route on the card within the slice phase's tolerances. The
    entry starts at q_mu = 0, q_sqrt = I, where none of the outputs depends
    on Kuf (fmean = 0, fvar = Knn, KL = 0): q_mu and q_sqrt are set to
    seeded values first, and shifting the inducing tensors must then move
    every output by far more than the routes differ."""
    import torch

    from gpsig_tpu_torch import entry

    fn, (model, X, Y) = entry.entry()
    check(X.device.type == "cuda" and X.dtype == torch.float32
          and all(p.device.type == "cuda" for p in model.parameters()),
          f"entry(): not float32 on the card ({X.device}, {X.dtype})")
    rng = np.random.default_rng(SEED + 70)
    M, C = model.q_mu.shape
    with torch.no_grad():
        model.q_mu.copy_(torch.as_tensor(rng.standard_normal((M, C))))
        model.q_sqrt.copy_(torch.as_tensor(
            np.tril(0.2 * rng.standard_normal((C, M, M))) + 0.8 * np.eye(M)))
        reset_counters()
        out, ms = timed(lambda: fn(model, X, Y))
        launches = counters()
        with plain_route():
            ref = fn(model, X, Y)
        model.inducing.raw_Z.add_(torch.as_tensor(
            0.3 * rng.standard_normal(tuple(model.inducing.raw_Z.shape)),
            dtype=torch.float32, device=dev))
        shifted = fn(model, X, Y)
    names = ("elbo", "fmean", "fvar")
    for k, v in zip(names, out):
        check(bool(torch.isfinite(v).all()), f"entry: {k} not finite")
    check(bool((out[2] >= 0).all()), "entry: negative fvar")
    for key in ("diag", "tens_seq"):
        check(launches[key] > 0, f"entry: {key} did not launch: {launches}")
    print(f"entry(): elbo {out[0].item():.6g}, fmean {tuple(out[1].shape)}, "
          f"fvar {tuple(out[2].shape)} on {X.device} in {ms:.1f} ms (first "
          f"call); launches diag {launches['diag']}, tens_seq "
          f"{launches['tens_seq']}, gram {launches['gram']}")
    compare_routes("entry", dict(zip(names, out)), dict(zip(names, ref)),
                   dict(elbo=1e-3, fmean=1e-3, fvar=1e-3))
    for k, a, r, b in zip(names, out, ref, shifted):
        err, moved = scaled_err(a, r), scaled_err(b, a)
        print(f"entry {k}: shifting the inducing tensors moves it by "
              f"{moved:.3e} scaled, the routes differ by {err:.3e}")
        check(moved > max(100 * err, 1e-5),
              f"entry {k} does not depend on Kuf: moved {moved}, err {err}")
    return launches


#: two UEA sets at their published shapes (train, test sequences, length
#: or length range, channels, classes) and the model each takes: BASELINE
#: config 3's (40 inducing sequences of length 8, nl = 4) and the accuracy
#: windows' base model (order-1 SignatureRBF, 64 inducing tensors with
#: increments, nl = 4, lengthscales √d)
UEA_FILES = {
    "ArticularyWordRecognition": dict(n_train=275, n_test=300, L=(144, 144),
                                      d=9, C=25, model="config3"),
    "CharacterTrajectories": dict(n_train=1422, n_test=1436, L=(60, 182),
                                  d=3, C=20, model="window"),
}


def write_ts(path, name, seqs, labels):
    """A UEA .ts file, each value written with ``repr`` (it reads back
    exactly)."""
    lines = [f"@problemName {name}", "@timeStamps false",
             "@univariate false", "@data"]
    for x, lab in zip(seqs, labels):
        lines.append(":".join(",".join(map(repr, x[:, k].tolist()))
                              for k in range(x.shape[1])) + f":{lab}")
    path.write_text("\n".join(lines) + "\n")


def uea_files_phase(dev):
    """The UEA data layer on the card: for each set of UEA_FILES, .ts files
    written from a seeded generator into a temporary directory, read back
    through ``gpsig_tpu_torch.data.uea.load_dataset`` with the native
    parser loaded (values equal to those written, labels mapped as the
    JAX package maps them), prepared as the benchmarks prepare a UEA set
    (``SequenceScaler``, add time, tabulate), then 2 natgrad + Adam steps
    at B = 50 and ``posterior()`` + ``predict_y`` on the test set, float32,
    each with its counters; wall times printed."""
    import tempfile

    import torch

    from gpsig_tpu_torch.data import _native, uea
    from gpsig_tpu_torch.data import preprocessing as prep
    from gpsig_tpu_torch.inducing import (make_inducing_sequences_from_data,
                                          make_inducing_tensors_from_data)
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    check(_native.loaded(), "UEA files: the native .ts parser did not load")
    print(f"UEA files: native parser {Path(_native._lib._name).name}")
    f32 = torch.float32
    rng = np.random.default_rng(SEED + 61)
    out_launches = {}
    with tempfile.TemporaryDirectory() as root:
        for name, cfg in UEA_FILES.items():
            t0 = time.perf_counter()
            d, C = cfg["d"], cfg["C"]
            written = {}
            (Path(root) / name).mkdir()
            for split in ("TRAIN", "TEST"):
                n = cfg[f"n_{split.lower()}"]
                lengths = rng.integers(cfg["L"][0], cfg["L"][1] + 1, n)
                seqs = [(0.3 * rng.standard_normal((L, d))).cumsum(0)
                        for L in lengths]
                labels = [f"{c + 1}.0" for c in rng.integers(0, C, n)]
                write_ts(Path(root) / name / f"{name}_{split}.ts", name, seqs,
                         labels)
                written[split] = (seqs, labels)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            Xtr_l, ytr, Xte_l, yte = uea.load_dataset(name, root=root)
            t_read = time.perf_counter() - t0
            lut = {lab: i for i, lab in enumerate(sorted(
                set(written["TRAIN"][1]) | set(written["TEST"][1])))}
            for split, got, y in (("TRAIN", Xtr_l, ytr), ("TEST", Xte_l, yte)):
                seqs, labels = written[split]
                check(len(got) == len(seqs) and all(
                    a.shape == b.shape and np.array_equal(a, b)
                    for a, b in zip(got, seqs)),
                      f"{name} {split}: values read back differ")
                check(np.array_equal(y, [lut[lab] for lab in labels]),
                      f"{name} {split}: labels read back differ")
            scaler = prep.SequenceScaler().fit(Xtr_l)
            Xtr_l = prep.add_time_to_list(scaler.transform(Xtr_l))
            Xte_l = prep.add_time_to_list(scaler.transform(Xte_l))
            L = max(max(s.shape[0] for s in Xtr_l),
                    max(s.shape[0] for s in Xte_l))
            X = torch.as_tensor(prep.tabulate_list_of_sequences(Xtr_l, L),
                                dtype=f32, device=dev)
            Xte = torch.as_tensor(prep.tabulate_list_of_sequences(Xte_l, L),
                                  dtype=f32, device=dev)
            Y = torch.as_tensor(ytr, device=dev)
            dt = X.shape[-1]
            gen = torch.Generator().manual_seed(SEED)
            if cfg["model"] == "config3":
                kern = SignatureRBF(dt, 4, lengthscales=1.0,
                                    normalization=True, dtype=f32,
                                    device=dev)
                feat = make_inducing_sequences_from_data(gen, X, 40, 8, dt)
                lr, need = 2e-3, {"serving": ("sig_gram", "gram", "diag"),
                                  "training": ("sig_gram", "sig_gram_bwd",
                                               "gram", "gram_bwd", "diag")}
                what = "40 inducing sequences of length 8"
            else:
                kern = SignatureRBF(dt, 4, lengthscales=float(np.sqrt(dt)),
                                    order=1, normalization=True, dtype=f32,
                                    device=dev)
                feat = make_inducing_tensors_from_data(
                    gen, X, num_tensors=64, num_levels=4, num_features=dt,
                    increments=True)
                lr, need = 1e-2, {"serving": ("diag", "tens_seq"),
                                  "training": ("diag", "tens_seq",
                                               "tens_seq_bwd")}
                what = "64 inducing tensors with increments"
            model = SVGP.create(kern, MultiClass(C), feat, num_latent=C,
                                dtype=f32, device=dev)
            print(f"{name}: wrote {len(Xtr_l)} + {len(Xte_l)} sequences in "
                  f"{t_write:.2f} s, read them back in {t_read:.2f} s "
                  f"(native parser, values and labels equal); tabulated "
                  f"[{X.shape[0]}, {L}, {dt}] and [{Xte.shape[0]}, {L}, "
                  f"{dt}] with time; model: {what}, nl = 4, C = {C}")
            step = make_step_fn(lr, num_data=X.shape[0], gamma=0.1)
            state = step.init(model)
            launches = {}
            reset_counters()
            elbos, times = [], []
            for _ in range(2):
                idx = torch.as_tensor(rng.choice(X.shape[0], 50,
                                                 replace=False), device=dev)
                (state, elbo), ms = timed(lambda: step(state, X[idx], Y[idx]))
                elbos.append(elbo.item())
                times.append(ms)
            launches["training"] = counters()
            check(all(np.isfinite(elbos)), f"{name}: ELBO {elbos}")
            for p in model.parameters():
                check(bool(torch.isfinite(p).all()),
                      f"{name}: parameter not finite")
            with torch.no_grad():
                reset_counters()
                (probs, pvar), ms = timed(
                    lambda: model.posterior().predict_y(Xte))
                launches["serving"] = counters()
            check(bool(torch.isfinite(probs).all()
                       and torch.isfinite(pvar).all()),
                  f"{name}: predictions not finite")
            check(probs.shape == (Xte.shape[0], C), f"{name}: {probs.shape}")
            check(bool(torch.allclose(probs.sum(-1), torch.ones_like(
                probs[:, 0]), atol=1e-4)), f"{name}: probabilities")
            acc = (probs.argmax(-1).cpu().numpy() == yte).mean()
            print(f"{name} natgrad+Adam steps at B=50: ELBO {elbos}; ms "
                  f"{[round(t, 1) for t in times]}; posterior() + predict_y "
                  f"on {Xte.shape[0]}: {ms:.1f} ms (test accuracy {acc:.3f}"
                  f" on random labels)")
            for phase_, keys in need.items():
                print(f"{name} {phase_} launches: "
                      f"{ {k: launches[phase_][k] for k in keys} }")
                for key in keys:
                    check(launches[phase_][key] > 0,
                          f"{name} {phase_}: {key} did not launch")
            out_launches[name] = launches
            del model, state, X, Xte, Y
            torch.cuda.empty_cache()
    return out_launches


# ---------------------------------------------------------------------------
# The rest of the GP layer: VOSF (Kuu = I) at BASELINE config 6's width,
# VOSF under the untruncated (PDE) prior, the low-rank kernel and the
# Monte-Carlo Softmax
# ---------------------------------------------------------------------------

#: BASELINE config 6 at its defaults (benchmarks/config6_vosf_sits.py):
#: SITS-like sequences with time added (d = 2), nl = 7 (M = 255), ten
#: classes, B = 4096; 5 Adam-only steps at lr 5e-3 (gamma 0, as config
#: 6), then 2 natgrad + Adam steps at gamma 0.1
CONFIG6 = dict(n_train=120_000, n_test=10_000, L=40, C=10, nl=7, B=4096,
               adam_steps=5, natgrad_steps=2, lr=5e-3)
#: the float32 route against the same computation in float64 on the card:
#: values scaled by their largest magnitude, the predictive variance in
#: units of Knn (under Kuu = I it is Knn − Σ Kuf² + Σ s²Kuf², where the
#: first two cancel analytically: float32 leaves noise of order eps·Knn)
F32_VS_F64_TOL = (1e-3, "float32 signature coordinates over 39 steps of "
                  "Chen's recursion, normalised per level, carried through "
                  "RobustMax quadrature and the minibatch scale N/B")
FVAR_F32_TOL = (1e-4, "|Δfvar| / Knn: the float32 cancellation of Knn − Σ "
                "Kuf², about 255 · eps · Knn, under the features' own error")


def sits_data(dev, dtype, n_train=None, n_test=None):
    """Config 6's data through the port's data layer: ``sits_sequences``
    (seed 0) with ``add_time_to_table``, split train / test, on ``dev``."""
    import torch

    from gpsig_tpu_torch.data import preprocessing as prep
    from gpsig_tpu_torch.data.synthetic import sits_sequences

    n_train = n_train or CONFIG6["n_train"]
    n_test = n_test or CONFIG6["n_test"]
    Xn, yn = sits_sequences(seed=SEED, N=n_train + n_test, L=CONFIG6["L"],
                            num_classes=CONFIG6["C"])
    X = torch.as_tensor(prep.add_time_to_table(Xn), dtype=dtype, device=dev)
    Y = torch.as_tensor(yn, dtype=torch.int64, device=dev)
    return X[:n_train], Y[:n_train], X[n_train:], Y[n_train:]


def vosf_svgp(dev, dtype, prior="explicit", nl=None, likelihood=None):
    """A Kuu = I SVGP with a diagonal q at config 6's width: the explicit
    signature kernel (lengthscale 1, normalised; config 6) or the
    untruncated kernel (Linear base, lengthscale √2, normalised, dyadic
    order 1; the ``@vosfpde`` window's) with features to ``nl`` levels;
    MultiClass(10) unless ``likelihood`` is given."""
    from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel
    from gpsig_tpu_torch.kernels.vosf import (ExplicitSignatureKernel,
                                              OrthogonalSignatureFeatures)
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    nl = nl or CONFIG6["nl"]
    if prior == "explicit":
        kern = ExplicitSignatureKernel.create(2, nl, lengthscales=1.0,
                                              normalization=True,
                                              dtype=dtype, device=dev)
        feat = OrthogonalSignatureFeatures.for_kernel(kern)
    else:
        kern = UntruncatedSignatureKernel.create(
            2, lengthscales=float(np.sqrt(2)), normalization=True,
            dyadic_order=1, dtype=dtype, device=dev)
        feat = OrthogonalSignatureFeatures.for_kernel(kern, num_levels=nl)
    C = CONFIG6["C"]
    return SVGP.create(kern, likelihood or MultiClass(C), feat, C,
                       q_diag=True, dtype=dtype, device=dev)


def max_grad_err(got, want):
    """Each parameter's gradient against the other route's, scaled by the
    largest gradient of all: a parameter the ELBO is invariant to has a
    gradient of rounding size (the signal variance σ of a VOSF model under
    RobustMax, which depends on f only through its argmax)."""
    check(set(got) == set(want), f"gradients of {sorted(got)} vs "
          f"{sorted(want)}")
    scale = max(w.abs().max().item() for w in want.values())
    return max((got[n] - want[n]).abs().max().item() / scale for n in want)


def card_vs_cpu(label, model, X, Y, num_data, tol=1e-10):
    """A small float64 model on the card against the same model on the
    CPU: the ELBO, its gradients (scaled by the largest), one natgrad step's
    q_mu and q_sqrt and the cached posterior's predict_f, each scaled,
    within ``tol``. Adam's step is left out: it moves a parameter whose
    gradient is rounding noise by up to lr·g/(|g| + 1e-8), far above
    float64 rounding."""
    import torch

    from gpsig_tpu_torch.training.natgrad import natgrad_step

    out = {}
    for where, m in (("card", model), ("cpu", copy.deepcopy(model).cpu())):
        x, y = X.to(m.q_mu.device), Y.to(m.q_mu.device)
        m.zero_grad()
        elbo = m.elbo(x, y, num_data=num_data)
        elbo.backward()
        g = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        with torch.no_grad():
            fmean, fvar = m.posterior().predict_f(x)
        natgrad_step(m, 0.1, x, y, num_data=num_data)
        out[where] = dict(elbo=elbo.detach().cpu(), fmean=fmean.cpu(),
                          fvar=fvar.cpu(), q_mu=m.q_mu.detach().cpu(),
                          q_sqrt=m.q_sqrt.detach().cpu(), grads=g)
    errs = {k: scaled_err(out["card"][k], out["cpu"][k])
            for k in ("elbo", "fmean", "fvar", "q_mu", "q_sqrt")}
    errs["gradients"] = max_grad_err(out["card"]["grads"],
                                     out["cpu"]["grads"])
    print(f"{label} float64, card vs CPU (N = {X.shape[0]}): scaled errs "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} }, tolerance {tol:g}"
          " (the same float64 arithmetic; other summation orders)")
    for k, v in errs.items():
        check(v <= tol, f"{label} float64 card vs CPU {k}: {v} > {tol}")


def f32_vs_f64(label, model32, X, Y, num_data):
    """The float32 model against a float64 copy of it on the card, at the
    same parameters: predict_f on the batch (fmean scaled, fvar in units
    of Knn), then one natgrad + Adam step from each (its ELBO, the natgrad
    q_mu and q_sqrt, scaled). Both copies step; ``model32`` is one."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    m64 = copy.deepcopy(model32).double()
    with torch.no_grad():
        f32 = model32.predict_f(X)
        f64 = m64.predict_f(X.double())
        Knn = m64.kernel.Kdiag(X.double())
    errs = dict(fmean=scaled_err(f32[0].double(), f64[0]),
                fvar=((f32[1].double() - f64[1]).abs()
                      / Knn[:, None]).max().item())
    elbos = []
    for m, x in ((model32, X), (m64, X.double())):
        step = make_step_fn(CONFIG6["lr"], num_data=num_data, gamma=0.1)
        _, elbo = step(step.init(m), x, Y)
        elbos.append(elbo)
    errs["elbo"] = scaled_err(elbos[0].double(), elbos[1])
    for k in ("q_mu", "q_sqrt"):
        errs[k] = scaled_err(getattr(model32, k).detach().double(),
                             getattr(m64, k).detach())
    print(f"{label} float32 vs float64 on the card (B = {X.shape[0]}): "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} }; tolerance "
          f"{F32_VS_F64_TOL[0]:g} scaled ({F32_VS_F64_TOL[1]}), fvar "
          f"{FVAR_F32_TOL[0]:g} ({FVAR_F32_TOL[1]})")
    for k, v in errs.items():
        tol = FVAR_F32_TOL[0] if k == "fvar" else F32_VS_F64_TOL[0]
        check(v <= tol, f"{label} float32 vs float64 {k}: {v} > {tol}")


def served(label, model, Xte, C):
    """``posterior()`` + ``predict_y`` on the test set: finite, shaped,
    probabilities summing to 1; the cached posterior's predict_f equals
    the model's (means scaled, variances in units of Knn, 1e-4: the two
    orders of Knn − Σ Kuf²(1 − s²), whose float32 rounding is up to
    M · eps · Knn = 3e-5 Knn at M = 255). Returns (probs, ms)."""
    import torch

    with torch.no_grad():
        (probs, pvar), ms = timed(lambda: model.posterior().predict_y(Xte))
        post = model.posterior()
        fm_post, fv_post = post.predict_f(Xte)
        fm, fv = model.predict_f(Xte)
        Knn = model.kernel.Kdiag(Xte)
    for k, v in dict(probs=probs, pvar=pvar, fmean=fm, fvar=fv).items():
        check(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")
    check(probs.shape == (Xte.shape[0], C), f"{label}: {probs.shape}")
    check(bool(torch.allclose(probs.sum(-1), torch.ones_like(probs[:, 0]),
                              atol=1e-4)), f"{label}: probabilities")
    check(bool((fv >= 0).all() and (pvar >= 0).all()),
          f"{label}: negative variances")
    e_mean = scaled_err(fm_post, fm)
    e_var = ((fv_post - fv).abs() / Knn[:, None]).max().item()
    print(f"{label} Posterior.predict_f vs SVGP.predict_f on "
          f"{Xte.shape[0]}: fmean scaled err {e_mean:.3e}, fvar |Δ|/Knn "
          f"{e_var:.3e}, tolerance 1e-4 (the same terms, summed in two "
          f"orders); quad_is_diag {post.quad_is_diag}")
    check(e_mean <= 1e-4 and e_var <= 1e-4,
          f"{label}: posterior vs model predict_f {e_mean}, {e_var}")
    return probs, ms


def vosf_config6_phase(dev, card):
    """BASELINE config 6 at its defaults on the card, float32: 120,000
    training sequences on the card, 5 Adam-only steps and 2 natgrad + Adam
    steps at B = 4096, ``posterior()`` (``quad_is_diag``) + ``predict_y`` on
    the 10,000 test sequences; the float32 route against float64 on the
    card; a small float64 model (N = 64, nl = 4) on the card against the
    CPU. The path is plain PyTorch (the JAX package has no Pallas kernel
    here): no kernel counter may rise."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    X, Y, Xte, _ = sits_data(dev, f32)
    N, B, C = X.shape[0], CONFIG6["B"], CONFIG6["C"]
    model = vosf_svgp(dev, f32)
    check(model.inducing.num_inducing == 255,
          f"config 6: M = {model.inducing.num_inducing}")
    rng = np.random.default_rng(SEED + 80)
    batches = [torch.as_tensor(rng.choice(N, B, replace=False), device=dev)
               for _ in range(CONFIG6["adam_steps"] + CONFIG6["natgrad_steps"]
                              + 1)]
    reset_counters()
    adam = make_step_fn(CONFIG6["lr"], num_data=N, gamma=0.0,
                        use_natgrad=False)
    state, elbos, ms = adam.init(model), {"adam": [], "natgrad": []}, \
        {"adam": [], "natgrad": []}
    for idx in batches[:CONFIG6["adam_steps"]]:
        (state, elbo), t = timed(lambda: adam(state, X[idx], Y[idx]))
        elbos["adam"].append(elbo.item())
        ms["adam"].append(t)
    # the float32 route against float64 at the step the natgrad phase
    # starts from (on a batch of its own: the copies step on it too)
    idx = batches[-1]
    f32_vs_f64("config 6", copy.deepcopy(model), X[idx], Y[idx], N)
    nat = make_step_fn(CONFIG6["lr"], num_data=N, gamma=0.1)
    state = nat.init(model)
    for idx in batches[CONFIG6["adam_steps"]:-1]:
        (state, elbo), t = timed(lambda: nat(state, X[idx], Y[idx]))
        elbos["natgrad"].append(elbo.item())
        ms["natgrad"].append(t)
    launches = counters()
    check(all(np.isfinite(v) for e in elbos.values() for v in e),
          f"config 6: ELBO {elbos}")
    for p in model.parameters():
        check(bool(torch.isfinite(p).all()), "config 6: parameter not finite")
    check(not any(launches.values()),
          f"config 6: a kernel launched on a plain path: {launches}")
    # one profiled call each: a step is many small launches, and the
    # profiler's event processing, not the card, sets this phase's time
    profile_split(lambda: nat(state, X[idx], Y[idx]),
                  f"config 6 natgrad+Adam step, B = {B}", reps=1)
    probs, ms_serve = served("config 6", model, Xte, C)
    with torch.no_grad():
        post = model.posterior()
        profile_split(lambda: post.predict_y(Xte),
                      f"config 6 predict_y on a cached posterior, "
                      f"N = {Xte.shape[0]}", reps=1)
    print(f"config 6 ELBO: Adam-only {elbos['adam']}, natgrad+Adam "
          f"{elbos['natgrad']}; no kernel counter rose (plain PyTorch)")
    print(f"time config 6 (VOSF, M = 255, B = {B}, N = {N}) on {card}: "
          f"Adam-only step {statistics.median(ms['adam'][1:]):.1f} ms "
          f"(median of the last {len(ms['adam']) - 1}; all "
          f"{[round(t, 1) for t in ms['adam']]}), natgrad+Adam step "
          f"{[round(t, 1) for t in ms['natgrad']]} ms; posterior() + "
          f"predict_y on {Xte.shape[0]}: {ms_serve:.1f} ms, "
          f"{Xte.shape[0] / ms_serve * 1e3:.0f} predictions/s (first call)")
    small = vosf_svgp(dev, torch.float64, nl=4)
    with torch.no_grad():
        small.q_mu.copy_(torch.as_tensor(0.3 * rng.standard_normal(
            tuple(small.q_mu.shape))))
        small.q_sqrt.copy_(torch.as_tensor(rng.uniform(
            0.3, 1.0, tuple(small.q_sqrt.shape))))
    card_vs_cpu("config 6 (nl = 4)", small, X[:64].double(), Y[:64], N)


def sigpde_vosf_phase(dev, card):
    """VOSF under the untruncated prior (the SigGPDE SITS model): the
    untruncated kernel (Linear base, dyadic order 1, normalised) with
    ``OrthogonalSignatureFeatures.for_kernel(kern, num_levels=7)``
    (M = 255), config 6's data and width (B = 4096, C = 10, q_diag), float32:
    2 natgrad + Adam steps (lr 2e-3, gamma 0.05, the ``@vosfpde`` window's)
    each with the Goursat counters reset just before it (the features'
    normalisation launches the refined forward, 15a, and the loss's
    backward its adjoint, 15b), the first step and serving on 10,000
    against the plain route, and a small float64 model against the CPU."""
    import torch

    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    X, Y, Xte, _ = sits_data(dev, f32)
    N, B, C = X.shape[0], CONFIG6["B"], CONFIG6["C"]
    model = vosf_svgp(dev, f32, prior="pde")
    check(model.inducing.num_inducing == 255,
          f"SigGPDE VOSF: M = {model.inducing.num_inducing}")
    plain_model = copy.deepcopy(model)
    rng = np.random.default_rng(SEED + 81)
    batches = [torch.as_tensor(rng.choice(N, B, replace=False), device=dev)
               for _ in range(2)]
    step = make_step_fn(2e-3, num_data=N, gamma=0.05)
    state, elbos, ms, first = step.init(model), [], [], None
    for k, idx in enumerate(batches):
        reset_counters()
        (state, elbo), t = timed(lambda: step(state, X[idx], Y[idx]))
        check_pde_route(counters(), ("goursat_fused", "goursat_grad"),
                        f"SigGPDE VOSF step {k + 1}")
        elbos.append(elbo)
        ms.append(t)
        if k == 0:
            first = grads_and_params(model)
    check(all(bool(torch.isfinite(e)) for e in elbos),
          f"SigGPDE VOSF: ELBO {elbos}")
    for p in model.parameters():
        check(bool(torch.isfinite(p).all()),
              "SigGPDE VOSF: parameter not finite")
    with plain_route():
        pstep = make_step_fn(2e-3, num_data=N, gamma=0.05)
        _, plain_elbo = pstep(pstep.init(plain_model), X[batches[0]],
                              Y[batches[0]])
    want = grads_and_params(plain_model)
    errs = dict(elbo=scaled_err(elbos[0], plain_elbo),
                gradients=max_grad_err(first[0], want[0]))
    moved = max(abs_err(first[1][n], want[1][n]) for n in want[0])
    errs["natgrad q_mu, q_sqrt"] = max(
        scaled_err(first[1][n], want[1][n]) for n in ("q_mu", "q_sqrt"))
    print(f"SigGPDE VOSF step 1, kernels vs plain route: {errs}, tolerance "
          "1e-3 (float32 Goursat sweeps in another order, through the "
          "features' normalisation); Adam-updated parameters max abs err "
          f"{moved:.3e}, tolerance {2 * 2e-3 * (1 + 1e-3):.4g} (2·lr: Adam's "
          "first step is ±lr per entry)")
    for k, v in errs.items():
        check(v <= 1e-3, f"SigGPDE VOSF step 1 {k}: {v}")
    check(moved <= 2 * 2e-3 * (1 + 1e-3), f"SigGPDE VOSF step 1: {moved}")
    reset_counters()
    probs, ms_serve = served("SigGPDE VOSF", model, Xte, C)
    launches = counters()
    check_pde_route(launches, ("goursat_fused",), "SigGPDE VOSF serving")
    check(launches["goursat_grad"] == 0, "SigGPDE VOSF serving: adjoint ran")
    with torch.no_grad(), plain_route():
        ref = model.posterior().predict_y(Xte)[0]
    err = scaled_err(probs, ref)
    print(f"SigGPDE VOSF predict_y on {Xte.shape[0]}: kernels vs plain route "
          f"scaled err {err:.3e}, tolerance 1e-3")
    check(err <= 1e-3, f"SigGPDE VOSF predict_y vs plain: {err}")
    print(f"time SigGPDE VOSF (M = 255, B = {B}, dyadic order 1) on {card}: "
          f"natgrad+Adam step {[round(t, 1) for t in ms]} ms; posterior() + "
          f"predict_y on {Xte.shape[0]}: {ms_serve:.1f} ms, "
          f"{Xte.shape[0] / ms_serve * 1e3:.0f} predictions/s")
    small = vosf_svgp(dev, torch.float64, prior="pde", nl=3)
    with torch.no_grad():
        small.q_mu.copy_(torch.as_tensor(0.3 * rng.standard_normal(
            tuple(small.q_mu.shape))))
        small.q_sqrt.copy_(torch.as_tensor(rng.uniform(
            0.3, 1.0, tuple(small.q_sqrt.shape))))
    reset_counters()
    card_vs_cpu("SigGPDE VOSF (nl = 3)", small, X[:64].double(), Y[:64], N)
    check(counters()["goursat_fused"] > 0,
          "SigGPDE VOSF float64: the Goursat forward did not launch")


#: the ``@lowrank`` window's protocol (benchmarks/run_all.py:51-52,
#: 132-149) on CharacterTrajectories' published shape
LOWRANK = dict(num_components=64, num_levels=4, num_sequences=64,
               seq_len=10, batch=50, lr=1e-2, gamma=0.1, steps=2)


def lowrank_phase(dev, card):
    """``LowRankSignatureRBF`` at the ``@lowrank`` protocol (64 Nyström
    components from 128 landmarks, every level sketched to 64 pairs,
    nl = 4, 64 inducing sequences of length 10, B = 50) on data of
    CharacterTrajectories' published shape, prepared as the UEA files
    phase prepares it (d = 3 + time, L 60-182 tabulated): 2 natgrad + Adam
    steps in float32 (the landmarks must move: Adam reaches them), then
    ``posterior()`` + ``predict_y`` on the 1,436 test sequences; float64 on
    the card against the CPU at the same landmarks and pair indices (K(Z),
    Kuf, Kdiag and the ELBO, 1e-10 scaled); the float32 model's difference
    from its float64 copy is stated, with finiteness checked: cuSOLVER's
    eigh lets eigenvalues near eps·λmax through the 10·jitter cutoff, and
    1/√λ amplifies them."""
    import torch

    from gpsig_tpu_torch.data import preprocessing as prep
    from gpsig_tpu_torch.inducing import make_inducing_sequences_from_data
    from gpsig_tpu_torch.kernels.low_rank import LowRankSignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    shape = UEA_FILES["CharacterTrajectories"]
    d, C = shape["d"], shape["C"]
    rng = np.random.default_rng(SEED + 90)

    def split(n):
        lengths = rng.integers(shape["L"][0], shape["L"][1] + 1, n)
        return ([(0.3 * rng.standard_normal((L, d))).cumsum(0)
                 for L in lengths], rng.integers(0, C, n))

    (Xtr_l, ytr), (Xte_l, _) = split(shape["n_train"]), split(shape["n_test"])
    scaler = prep.SequenceScaler().fit(Xtr_l)
    Xtr_l = prep.add_time_to_list(scaler.transform(Xtr_l))
    Xte_l = prep.add_time_to_list(scaler.transform(Xte_l))
    L = max(s.shape[0] for s in Xtr_l + Xte_l)
    X = torch.as_tensor(prep.tabulate_list_of_sequences(Xtr_l, L), dtype=f32,
                        device=dev)
    Xte = torch.as_tensor(prep.tabulate_list_of_sequences(Xte_l, L),
                          dtype=f32, device=dev)
    Y = torch.as_tensor(ytr, device=dev)
    N, dt = X.shape[0], X.shape[-1]
    gen = torch.Generator().manual_seed(SEED)
    kern = LowRankSignatureRBF(gen, X, dt, LOWRANK["num_levels"],
                               num_components=LOWRANK["num_components"],
                               lengthscales=float(np.sqrt(dt)),
                               normalization=True, dtype=f32, device=dev)
    feat = make_inducing_sequences_from_data(gen, X, LOWRANK["num_sequences"],
                                             LOWRANK["seq_len"], dt)
    model = SVGP.create(kern, MultiClass(C), feat, C, dtype=f32, device=dev)
    sketched = [p is not None for p in kern.pair_indices.as_tuple()]
    check(tuple(kern.landmarks.shape) == (128, dt) and all(sketched),
          f"low-rank: landmarks {tuple(kern.landmarks.shape)}, sketched "
          f"levels {sketched}")
    initial = copy.deepcopy(model)
    landmarks0 = kern.landmarks.detach().clone()
    step = make_step_fn(LOWRANK["lr"], num_data=N, gamma=LOWRANK["gamma"])
    state, elbos, ms = step.init(model), [], []
    reset_counters()
    batches = [torch.as_tensor(rng.choice(N, LOWRANK["batch"],
                                          replace=False), device=dev)
               for _ in range(LOWRANK["steps"])]
    for idx in batches:
        (state, elbo), t = timed(lambda: step(state, X[idx], Y[idx]))
        elbos.append(elbo.item())
        ms.append(t)
    launches = counters()
    check(all(np.isfinite(elbos)), f"low-rank: ELBO {elbos}")
    for n, p in model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"low-rank: {n} not finite")
    moved = (kern.landmarks.detach() - landmarks0).abs().max().item()
    check(moved > 0, "low-rank: the landmarks did not move (Adam must "
          "reach them)")
    check(not any(launches.values()),
          f"low-rank: a kernel launched on a plain path: {launches}")
    probs, ms_serve = served("low-rank", model, Xte, C)
    print(f"low-rank [{N}, {L}, {dt}] ELBO {elbos}; landmarks moved by up to "
          f"{moved:.3e} (Adam, lr {LOWRANK['lr']:g})")
    print(f"time low-rank (c = 64, nl = 4, M = 64 sequences, B = 50) on "
          f"{card}: natgrad+Adam step {[round(t, 1) for t in ms]} ms; "
          f"posterior() + predict_y on {Xte.shape[0]}: {ms_serve:.1f} ms, "
          f"{Xte.shape[0] / ms_serve * 1e3:.0f} predictions/s")
    # float64 at the initial landmarks and pairs: card, CPU, and the float32
    # model at the same parameters
    idx = batches[0]
    m64 = copy.deepcopy(initial).double()
    outs = {}
    for where, m in (("card", m64), ("cpu", copy.deepcopy(m64).cpu()),
                     ("float32", initial)):
        x = X[idx].to(device=m.q_mu.device, dtype=m.q_mu.dtype)
        y = Y[idx].to(m.q_mu.device)
        Z = m.inducing.raw_Z
        with torch.no_grad():
            outs[where] = dict(Kzz=m.kernel.K(Z), Kuf=m.kernel.K(Z, x),
                               Kdiag=m.kernel.Kdiag(x),
                               elbo=m.elbo(x, y, num_data=N))
    errs = {k: scaled_err(outs["card"][k].cpu(), outs["cpu"][k])
            for k in outs["cpu"]}
    print(f"low-rank float64 card vs CPU (same landmarks and pairs, B = 50):"
          f" {errs}, tolerance 1e-10 (the Grams are invariant to eigh's "
          "sign and rotation choices)")
    for k, v in errs.items():
        check(v <= 1e-10, f"low-rank float64 card vs CPU {k}: {v}")
    for k, v in outs["float32"].items():
        check(bool(torch.isfinite(v).all()), f"low-rank float32 {k}")
    diffs = {k: scaled_err(outs["float32"][k].double(), outs["card"][k])
             for k in outs["card"]}
    print(f"low-rank float32 vs float64 on the card (stated, not bounded: "
          f"1/√λ of eigenvalues near eps·λmax): {diffs}")


def softmax_phase(dev, card):
    """The config-6 VOSF model with ``Softmax(10, num_samples=20)``, float32:
    2 natgrad + Adam steps at B = 4096 and ``predict_y`` on the 10,000
    test sequences, drawn on the card from generators seeded alike, run
    twice: bitwise equal; a run from another seed draws other values."""
    import torch

    from gpsig_tpu_torch.likelihoods import Softmax
    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    X, Y, Xte, _ = sits_data(dev, f32)
    N, B, C = X.shape[0], CONFIG6["B"], CONFIG6["C"]
    batches = [torch.as_tensor(np.random.default_rng(SEED + 82).choice(
        N, B, replace=False), device=dev) for _ in range(2)]

    def run(seed):
        model = vosf_svgp(dev, f32, likelihood=Softmax(C, num_samples=20))
        gen = torch.Generator(device=dev).manual_seed(seed)
        step = make_step_fn(CONFIG6["lr"], num_data=N, gamma=0.1)
        state, elbos, ms = step.init(model), [], []
        for idx in batches:
            (state, elbo), t = timed(lambda: step(state, X[idx], Y[idx], gen))
            elbos.append(elbo)
            ms.append(t)
        with torch.no_grad():
            (probs, _), t = timed(lambda: model.predict_y(
                Xte, generator=torch.Generator(device=dev).manual_seed(seed)))
        return [torch.stack(elbos), probs] + [
            p.detach() for p in model.parameters()], ms, t

    a, ms, t_pred = run(1)
    b, _, _ = run(1)
    c, _, _ = run(2)
    for k, v in enumerate(a):
        check(bool(torch.isfinite(v).all()), f"Softmax: output {k} not "
              "finite")
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"Softmax ELBO {a[0].tolist()} (seed 1, twice: bitwise equal "
          f"{same}), {c[0].tolist()} (seed 2)")
    check(same, "Softmax: two runs from the same seed differ")
    check(not torch.equal(a[0], c[0]), "Softmax: another seed drew the same")
    check(bool(torch.allclose(a[1].sum(-1), torch.ones_like(a[1][:, 0]),
                              atol=1e-4)), "Softmax: probabilities")
    print(f"time Softmax VOSF (S = 20, B = {B}) on {card}: natgrad+Adam "
          f"step {[round(t, 1) for t in ms]} ms; predict_y (100 draws) on "
          f"{Xte.shape[0]}: {t_pred:.1f} ms")


# ---------------------------------------------------------------------------
# NUTS at BASELINE config 5 (benchmarks/config5_nuts.py): 16 chains as one
# batch, the order-1 Gram kernels taking a chain axis.
# ---------------------------------------------------------------------------

CONFIG5 = dict(chains=16, n=40, L=20, d=2, levels=3, warmup=200,
               samples=200, max_depth=6, draws_per_dispatch=25)
#: the draw counts the phase runs: config 5's 200 + 200 took 102 s on an
#: H100 (11-19 ms a leaf, host-bound, varying from machine to machine),
#: past the phase's budget, so the counts are cut (never the width); at
#: 60 + 60 the chains have not converged, and the run says so
CONFIG5_RUN = dict(warmup=60, samples=60)
#: chains of the float64 card-vs-CPU check (its CPU run, the plain
#: versions in float64, takes ~2 s a transition at 16 chains)
NUTS_F64_CHAINS = 4
#: the largest split-R̂ below which the config-5 run counts as converged
RHAT_CONVERGED = 1.05
#: the phase's wall-time budget in seconds: a phase that overruns fails
NUTS_BUDGET_S = 90.0
#: float64 card against CPU on replayed draws: samples, step sizes and
#: accept statistics, scaled
NUTS_F64_TOL = (1e-9, "float64, one transition of up to 15 leapfrogs "
                "from the same carry, the kernels summing in another "
                "order than the plain versions (atomics among them)")
#: a chain-axis backward against the same kernel a chain at a time, scaled
#: (its atomics add the same terms in a run-dependent order)
CHAIN_BWD_TOL = {"float32": 1e-6, "float64": 1e-14}


def config5_data(torch, dev, dtype, n=None):
    from gpsig_tpu_torch.data.synthetic import regression_sequences

    X, y = regression_sequences(seed=SEED, N=n or CONFIG5["n"],
                                L=CONFIG5["L"], d=CONFIG5["d"])
    return (torch.as_tensor(X, dtype=dtype, device=dev),
            torch.as_tensor(y, dtype=dtype, device=dev))


def config5_theta0(torch, dev, dtype):
    """θ0 [C, D] = 0.1 · standard normals from a generator seeded 1 (the
    JAX script's theta0 from PRNGKey(1), not reproducible here)."""
    dim = CONFIG5["d"] + CONFIG5["levels"] + 2
    g = torch.Generator().manual_seed(1)
    return (0.1 * torch.randn(CONFIG5["chains"], dim, generator=g,
                              dtype=torch.float64)).to(dtype=dtype,
                                                       device=dev)


def chain_axis_kernels(dev):
    """The three order-1 kernels with config 5's chain axis against their
    plain versions (float32, float64), against a loop of unbatched
    launches, and timed: one chain-axis launch, C unbatched launches and
    the plain version."""
    import torch

    from gpsig_tpu_torch.ops.cuda import fused_gram as fg

    C, n, L, d, nl = (CONFIG5[k] for k in ("chains", "n", "L", "d",
                                           "levels"))
    rng = np.random.default_rng(SEED + 50)
    # the scaled sequences of C chains' lengthscales, as the target's
    ell = rng.uniform(0.5, 2.0, (C, 1, 1, d))
    X0 = walks(rng, n, L, d)[None] / ell
    G0 = rng.standard_normal((C, nl + 1, n, n))
    tri = n * (n + 1) // 2
    item = 4
    fwd_bytes = item * (C * n * L * d + C * (nl + 1) * n * n)
    works = {
        "gram": (C * tri / (n * n) * gram_work(n, n, L, d, nl), fwd_bytes),
        "diag": (gram_self_work(C * n, L, d, nl),
                 item * (C * n * L * d + C * (nl + 1) * n)),
        "gram_bwd": (3 * C * gram_work(n, n, L, d, nl),
                     item * (2 * C * n * L * d + C * (nl + 1) * n * n)),
    }
    calls = {
        "gram": (lambda X, g: fg.fused_gram_levels(X, X, nl, True, True),
                 lambda X, g: fg.fused_gram_levels_ref(X, X, nl, True)),
        "diag": (lambda X, g: fg.fused_diag_levels(X, nl, True),
                 lambda X, g: fg.fused_diag_levels_ref(X, nl, True)),
        "gram_bwd": (lambda X, g: fg.fused_gram_levels_bwd(X, X, g, nl),
                     lambda X, g: fg.fused_gram_levels_bwd_ref(X, X, g, nl)),
    }
    tol = {"gram": TOL, "diag": TOL, "gram_bwd": BWD_TOL}
    report = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        X = torch.as_tensor(X0, dtype=dtype, device=dev).contiguous()
        G = torch.as_tensor(G0, dtype=dtype, device=dev)
        for key, (kern, plain) in calls.items():
            got, want = kern(X, G), plain(X, G)

            def loop():
                outs = [kern(X[c], G[c]) for c in range(C)]
                if isinstance(outs[0], tuple):
                    return tuple(torch.stack(o) for o in zip(*outs))
                return torch.stack(outs)

            looped, again = loop(), loop()
            torch.cuda.synchronize()
            err, max_abs = scaled_err(got, want), abs_err(got, want)
            limit, why = tol[key][name]
            print(f"nuts chain axis {key} C={C} N={n} L={L} {name}: scaled "
                  f"err {err:.3e} (max abs {max_abs:.3e}) against the plain "
                  f"version, tolerance {limit:g}: {why}")
            check(err <= limit, f"nuts chain axis {key} {name}: {err}")
            pairs = (list(zip(got, looped)) if isinstance(got, tuple)
                     else [(got, looped)])
            bitwise = all(torch.equal(a, b) for a, b in pairs)
            if key == "gram_bwd":
                spread = scaled_err(looped, again)
                gap = scaled_err(got, looped)
                print(f"nuts chain axis {key} {name}: bitwise equal to "
                      f"{C} unbatched launches {bitwise} (scaled gap "
                      f"{gap:.3e}; two loops of unbatched launches differ "
                      f"by {spread:.3e}: X̄ and Ȳ sum with atomics)")
                check(gap <= CHAIN_BWD_TOL[name], f"nuts chain axis {key} "
                      f"{name}: {gap} from the unbatched launches")
            else:
                print(f"nuts chain axis {key} {name}: bitwise equal to {C} "
                      f"unbatched launches {bitwise}")
                check(bitwise, f"nuts chain axis {key} {name}: differs from "
                      f"{C} unbatched launches")
            if dtype == torch.float32:
                ms = cuda_ms(lambda: kern(X, G))
                loop_ms = cuda_ms(loop)
                plain_ms = cuda_ms(lambda: plain(X, G))
                report[key] = dict(max_abs_err=max_abs, ms=ms,
                                   loop_ms=loop_ms, plain_ms=plain_ms,
                                   **bound(*works[key]))
                print(f"time nuts chain axis {key} float32: one launch "
                      f"{ms:.4f} ms, {C} unbatched launches {loop_ms:.4f} "
                      f"ms, plain {plain_ms:.4f} ms, bound "
                      f"{report[key]['bound_ms']:.4f} ms "
                      f"({report[key]['bound_by']})")
        del X, G
    return report


def nuts_config5_run(dev, card):
    """Config 5 at its defaults, float32, through the chunked sampler; the
    three kernels' counters reset just before and read just after."""
    import torch

    from gpsig_tpu_torch.mcmc import nuts
    from gpsig_tpu_torch.mcmc.targets import signature_gpr_logp
    from gpsig_tpu_torch.parallel.chains import make_chunked_sampler
    from gpsig_tpu_torch.utils.metrics import (effective_sample_size,
                                               split_rhat)

    f32 = torch.float32
    C, d, nl = CONFIG5["chains"], CONFIG5["d"], CONFIG5["levels"]
    W, S = CONFIG5_RUN["warmup"], CONFIG5_RUN["samples"]
    X, y = config5_data(torch, dev, f32)
    logp = signature_gpr_logp(X, y, nl)
    sampler = make_chunked_sampler(
        logp, num_warmup=W, num_samples=S, max_depth=CONFIG5["max_depth"],
        draws_per_dispatch=CONFIG5["draws_per_dispatch"])
    theta0 = config5_theta0(torch, dev, f32)
    chunks = []
    reset_counters()
    evals0, reads0 = nuts.evaluations, nuts.host_reads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, info = sampler(
        SEED, theta0, on_chunk=lambda ph, pos, tot: chunks.append(
            (ph, pos, time.perf_counter() - t0)))
    wall = time.perf_counter() - t0
    n = counters()
    evals = nuts.evaluations - evals0
    reads = nuts.host_reads - reads0
    launches = {k: n[k] for k in ("gram", "diag", "gram_bwd")}
    print(f"nuts config 5: {evals} logp-and-gradient evaluations, launches "
          f"{launches} (one each an evaluation, for all {C} chains)")
    for k, v in launches.items():
        check(v == evals, f"nuts config 5: {k} launched {v} times for "
              f"{evals} evaluations")
    others = {k: v for k, v in n.items() if k not in launches and v}
    check(not others, f"nuts config 5: other kernels launched {others}")
    check(np.all(np.isfinite(samples)), "nuts config 5: samples not finite")
    check(samples.shape == (C, S, d + nl + 2),
          f"nuts config 5: samples {samples.shape}")
    ess = effective_sample_size(samples)
    rhat = split_rhat(samples)
    leaves = info["num_leaves"].astype(np.float64)  # [C, S]
    util = leaves.sum() / (C * leaves.max(axis=0).sum())
    trans = W + S
    ell = np.exp(samples.reshape(-1, d + nl + 2)[:, :d].mean(0))
    warm_s = next(t for ph, pos, t in chunks if ph == "warmup" and pos == W)
    converged = ("converged" if rhat.max() < RHAT_CONVERGED else
                 f"NOT converged (split-R̂ ≥ {RHAT_CONVERGED}): the ESS and "
                 "R̂ describe this short run, not config 5's posterior")
    print(f"nuts config 5 on {card}: {C} chains, {W} warmup + {S} samples, "
          f"max_depth {CONFIG5['max_depth']}, chunks of "
          f"{CONFIG5['draws_per_dispatch']}: wall {wall:.2f} s (warmup "
          f"{warm_s:.2f} s), {C * S / wall:.2f} draws/s, smallest ESS "
          f"{ess.min():.1f} ({ess.min() / wall:.3f} ESS/s), largest split-R̂ "
          f"{rhat.max():.4f}, mean leaves {leaves.mean():.2f}, divergence "
          f"share {info['diverging'].mean():.4f}, mean accept "
          f"{info['accept_prob'].mean():.3f}, step sizes "
          f"{np.round(info['step_size'], 4).tolist()}, batch utilisation "
          f"{util:.3f}, {reads / trans:.2f} host reads and "
          f"{evals / trans:.2f} evaluations a transition, "
          f"{1e3 * wall / evals:.2f} ms an evaluation, posterior mean "
          f"lengthscales {ell.tolist()}; {converged}")
    # where a leaf's time goes: one logp-and-gradient evaluation of the 16
    # chains (after the counters were read)
    profile_split(lambda: nuts.value_and_grad(logp)(theta0),
                  "nuts config 5 logp and gradient (16 chains)")
    return launches, dict(evaluations=evals, transitions=trans)


def _to(device, carry):
    """A sampler carry (tensors and NamedTuples of tensors) on ``device``."""
    return tuple(type(x)(*(t.to(device) for t in x)) if isinstance(x, tuple)
                 else x.to(device) for x in carry)


def nuts_float64_card_vs_cpu(dev):
    """10 transitions (5 warmup, 5 sampling) of NUTS_F64_CHAINS chains at
    max_depth 4 and N = 12, float64, with config 5's shared step size. The CPU runs
    them, keeping the carry and the chains' generator states before each
    transition; the card then takes each transition from the CPU's carry
    with the generators restored to those states (they live on the CPU
    whatever the target's device, so they give the same draws), so that rounding does not compound from one transition to the
    next (Hamiltonian trajectories amplify it): θ, log p, the step size
    and the accept statistics agree to NUTS_F64_TOL a transition, and a
    discrete branch that flips is named by its transition and chain. Last
    the card runs the 10 transitions from the start on the same draws: no
    branch may flip, and the compounded gap is printed."""
    import torch

    from gpsig_tpu_torch.mcmc import sample as smp
    from gpsig_tpu_torch.mcmc.draws import DrawSource
    from gpsig_tpu_torch.mcmc.nuts import nuts_kernel
    from gpsig_tpu_torch.mcmc.targets import signature_gpr_logp

    f64, C, nl = torch.float64, NUTS_F64_CHAINS, CONFIG5["levels"]
    W, S, depth = 5, 5, 4
    cpu = torch.device("cpu")

    def steps(device):
        """(init, warm step, sampling step, last transition's leaves)."""
        X, y = config5_data(torch, device, f64, n=12)
        logp = signature_gpr_logp(X, y, nl)
        base = nuts_kernel(logp, max_depth=depth)
        last = {}

        def kernel(*args, **kw):
            state, info = base(*args, **kw)
            last["leaves"] = info["num_leaves"]
            return state, info

        warm = smp.make_warm_step(kernel, 0.8, int(0.1 * W), int(0.9 * W),
                                  lambda a: a.mean().expand_as(a))
        return (lambda th: smp.init_carry(logp, th, 0.1), warm,
                smp.make_samp_step(kernel), last)

    def replay(states):
        """The chains' draws from generator states taken on the CPU."""
        draws = DrawSource.from_seed(SEED, C)
        draws.load_state_dict(states)
        return draws

    def run(step_set, draws, carry, t):
        """Transition t from ``carry``: (carry, accept, leaves)."""
        _, warm, samp, last = step_set
        if t < W:
            carry, acc = warm(carry, t, draws)
            if t == W - 1:  # the switch to sampling, as the sampler's
                st, da, _, im = carry
                carry = (st, torch.exp(da.log_eps_bar), im)
        else:
            carry, out = samp(carry, draws)
            acc = out["accept_prob"]
        return carry, acc, last["leaves"]

    def step_size(carry):
        return torch.exp(carry[1].log_eps) if len(carry) == 4 else carry[1]

    cpu_steps, card_steps = steps(cpu), steps(dev)
    draws = DrawSource.from_seed(SEED, C)
    carry = cpu_steps[0](config5_theta0(torch, cpu, f64)[:C])
    history = []
    for t in range(W + S):
        before, states = carry, draws.state_dict()
        carry, acc, leaves = run(cpu_steps, draws, carry, t)
        history.append((before, states, carry, acc, leaves))
    limit, why = NUTS_F64_TOL
    worst = {}
    for t, (before, states, after, acc, leaves) in enumerate(history):
        got, gacc, gleaves = run(card_steps, replay(states),
                                 _to(dev, before), t)
        flips = np.flatnonzero(gleaves.cpu().numpy() != leaves.numpy())
        check(not len(flips), f"nuts float64: a discrete branch flipped at "
              f"transition {t}, chain {flips[0] if len(flips) else -1}")
        errs = {"theta": (got[0].theta, after[0].theta),
                "logp": (got[0].logp, after[0].logp),
                "step_size": (step_size(got), step_size(after)),
                "accept": (gacc, acc)}
        for k, (a, b) in errs.items():
            worst[k] = max(worst.get(k, 0.0), scaled_err(a.cpu(), b))
    print(f"nuts float64 card vs CPU, each of {W + S} transitions from the "
          f"CPU's carry on its draws ({C} chains, N = 12, max_depth {depth})"
          f": worst { {k: f'{v:.3e}' for k, v in worst.items()} }, "
          f"tolerance {limit:g}: {why}")
    for k, v in worst.items():
        check(v <= limit, f"nuts float64 card vs CPU: {k} {v}")
    carry = _to(dev, history[0][0])
    draws = replay(history[0][1])
    for t, (_, _, after, acc, leaves) in enumerate(history):
        carry, gacc, gleaves = run(card_steps, draws, carry, t)
        flips = np.flatnonzero(gleaves.cpu().numpy() != leaves.numpy())
        check(not len(flips), f"nuts float64 free run: a discrete branch "
              f"flipped at transition {t}, chain "
              f"{flips[0] if len(flips) else -1}")
    print(f"nuts float64 card vs CPU, the {W + S} transitions run freely on "
          f"the card: no branch flipped; compounded gap after them: θ "
          f"{scaled_err(carry[0].theta.cpu(), after[0].theta):.3e}, accept "
          f"{scaled_err(gacc.cpu(), acc):.3e}")


def nuts_resume_on_card(dev, tmp):
    """Stop after 2 chunks (max_chunks), resume from the checkpoint, and
    compare with an uninterrupted run. On a deterministic target (a
    correlated Gaussian in elementwise ops) the two are held bitwise equal;
    on config 5's target the Gram backward's atomics make the gradient
    differ run to run in its last bits, so that comparison is printed."""
    import torch

    from gpsig_tpu_torch.mcmc.targets import signature_gpr_logp
    from gpsig_tpu_torch.parallel.chains import make_chunked_sampler

    f32, C = torch.float32, CONFIG5["chains"]
    prec = torch.as_tensor([[1.0, -0.8], [-0.8, 1.3]], dtype=f32, device=dev)

    def gauss(x):
        return -0.5 * torch.sum(x[..., :, None] * prec * x[..., None, :],
                                dim=(-2, -1))

    X, y = config5_data(torch, dev, f32)
    targets = {"Gaussian": (gauss, 2),
               "config 5": (signature_gpr_logp(X, y, CONFIG5["levels"]),
                            CONFIG5["d"] + CONFIG5["levels"] + 2)}
    kw = dict(num_warmup=6, num_samples=4, max_depth=4,
              draws_per_dispatch=3)
    for label, (target, dim) in targets.items():
        theta0 = 0.1 * torch.randn(C, dim, generator=torch.Generator()
                                   .manual_seed(2)).to(dev)
        whole = make_chunked_sampler(target, **kw)(SEED, theta0)
        cdir = str(Path(tmp) / label.replace(" ", "_"))
        out = make_chunked_sampler(target, **kw)(
            SEED, theta0, checkpoint_dir=cdir, max_chunks=2)
        check(out is None, f"nuts resume {label}: finished in 2 chunks")
        resumed = make_chunked_sampler(target, **kw)(
            SEED, theta0, checkpoint_dir=cdir)
        same = np.array_equal(resumed[0], whole[0]) and all(
            np.array_equal(resumed[1][k], whole[1][k]) for k in whole[1])
        gap = float(np.abs(resumed[0] - whole[0]).max())
        print(f"nuts resume on the card, {label}: stopped after 2 chunks "
              f"and resumed: bitwise equal to the uninterrupted run {same} "
              f"(max |Δθ| {gap:.3e})")
        if label == "Gaussian":
            check(same, "nuts resume: the resumed run differs from the "
                  "uninterrupted one on a deterministic target")


def nuts_config5_phase(dev, card):
    """NUTS at BASELINE config 5 within NUTS_BUDGET_S seconds."""
    import tempfile

    t0 = time.perf_counter()
    parts = {}

    def part(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[label] = time.perf_counter() - t
        return out

    timings = part("chain-axis kernels", chain_axis_kernels, dev)
    launches, run = part("config 5 run", nuts_config5_run, dev, card)
    part("float64 card vs CPU", nuts_float64_card_vs_cpu, dev)
    with tempfile.TemporaryDirectory() as tmp:
        part("resume", nuts_resume_on_card, dev, tmp)
    total = time.perf_counter() - t0
    print(f"nuts phase on {card}: {total:.1f} s of its {NUTS_BUDGET_S:.0f} s "
          f"budget ({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    check(total <= NUTS_BUDGET_S, f"nuts phase: {total:.1f} s over its "
          f"{NUTS_BUDGET_S:.0f} s budget")
    per = run["evaluations"] / run["transitions"]
    for key in timings:
        timings[key].update(launches=launches[key],
                            launches_per_transition=per, library_ms=None)
    return timings


# ---------------------------------------------------------------------------
# Multi-process training: the parallel layer (``gpsig_tpu_torch/parallel/``)
# on torch.distributed, run by BASELINE config 4 (sharded minibatch SVI) on
# ranks that share the card. NCCL takes one rank a device, so the card runs
# one rank under NCCL (its set-up and collectives) and two ranks on cuda:0
# under gloo (the protocol); gloo copies CUDA tensors through the host, so
# the two-rank times measure the protocol, not a link between cards.
# ---------------------------------------------------------------------------

#: BASELINE config 4 (``benchmarks/config4_sharded_svi.py``), its synthetic
#: set at full width: N = 20,000 sequences of L = 30, d = 3, 5 classes;
#: order-1 normalised SignatureRBF at nl = 3, 64 inducing tensors,
#: MultiClass(5), γ = 0.05, Adam 2e-3, global batch 256, float32; the
#: steps cut from 300 to 3
CONFIG4 = dict(N=20_000, L=30, d=3, C=5, M=64, nl=3, B=256, lr=2e-3,
               gamma=0.05, steps=3)
#: further sharded steps whose all_reduce calls are synchronised and timed
CONFIG4_TIMED_STEPS = 2
#: the phase's wall-time budget in seconds: a phase that overruns fails
PARALLEL_BUDGET_S = 150.0
#: a rank's process that has not ended by then is killed, and the run fails
RANK_TIMEOUT_S = 120
#: float32 sharded config-4 steps against the one-process steps on the same
#: batches: the ELBOs relative, q_mu and q_sqrt scaled, the other
#: parameters (after 3 Adam steps) absolute. Measured (NVIDIA H100 80GB
#: HBM3, 700.00 W, two runs): ELBOs ≤ 6.7e-8, q ≤ 1.1e-5, the others ≤
#: 3.6e-6 (4.8e-7 in the other run). Adam divides a gradient by its own
#: scale, so a sum taken for a mean moves no parameter it updates: the
#: ELBO and q bounds are the checks that see one
PARALLEL_F32_TOL = {
    "elbo": (1e-5, "float32 ELBO terms of 256 sequences summed per rank "
             "then across ranks, in another order than one process, and "
             "the Kuf backward's atomics"),
    "q": (1e-4, "the ELBO's rounding through the natural-gradient "
          "statistics and float32 Cholesky solves"),
    "other": (2e-5, "Adam's step is lr times the gradient's ratio to its "
              "running scale: the gradients' rounding through 3 steps at "
              "lr 2e-3"),
}
#: float64 sharded steps on the card against the one-process CPU run
PARALLEL_F64_TOL = (1e-10, "float64, other summation order only")
#: the sequence-parallel Goursat corner against the plain sweep (the JAX
#: test's bound)
GOURSAT_SP_TOL = (1e-9, "float64 column recurrences by a doubling scan "
                  "against the sweep's diagonals")
GRAM_BENCH = dict(N=256, L=50, d=2, nl=4)
GOURSAT_SP = dict(batch=4, S=128, T=128, col_block=16)
#: BASELINE config 5 sharded: 2 ranks x 8 chains, the draw counts cut from
#: 200 + 200 to 20 + 10 (the phase's budget). Not 10 warmup draws: there the
#: reference's single adaptation window ends on the last warmup step, dual
#: averaging restarts on it, and every chain's step size is exactly 1
#: whatever the ranks pooled
CONFIG5_SHARDED = dict(warmup=20, samples=10)


def config4_problem(torch, dev):
    """(model, X, y): config 4's synthetic set (numpy, on the host) and its
    model on the card, inducing tensors from the first 500 sequences."""
    from gpsig_tpu_torch.data.synthetic import classification_sequences
    from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP

    c, f32 = CONFIG4, torch.float32
    X, y = classification_sequences(seed=SEED, N=c["N"], L=c["L"], d=c["d"],
                                    num_classes=c["C"])
    kern = SignatureRBF(c["d"], c["nl"], lengthscales=1.0, order=1,
                        normalization=True, dtype=f32, device=dev)
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(SEED),
        torch.as_tensor(X[:500], dtype=f32, device=dev),
        num_tensors=c["M"], num_levels=c["nl"], num_features=c["d"])
    model = SVGP.create(kern, MultiClass(num_classes=c["C"]), feat,
                        num_latent=c["C"], dtype=f32, device=dev)
    return model, X, y


def config4_steps(torch, dev, mesh, step):
    """CONFIG4["steps"] steps of ``step`` on the batches of a
    ``ShardedLoader`` over ``mesh`` (the same global stream at every mesh
    size), the counters reset just before: ELBOs, ms a step (host clock
    around a synchronise), launches, the parameters after, and the model,
    state and loader to go on with."""
    from gpsig_tpu_torch.parallel.loader import ShardedLoader

    c = CONFIG4
    model, X, y = config4_problem(torch, dev)
    state = step.init(model)
    loader = ShardedLoader(mesh, X, y, c["B"], seed=SEED, device=dev,
                           dtype=torch.float32)
    elbos, ms = [], []
    torch.cuda.synchronize()
    reset_counters()
    for _ in range(c["steps"]):
        Xb, Yb = next(loader)
        t = time.perf_counter()
        state, elbo = step(state, Xb, Yb)
        elbos.append(float(elbo))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    params = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    return dict(elbos=elbos, ms=ms, launches=counters(), params=params,
                batch=Xb.shape[0]), (state, loader)


def config4_sharded(torch, dev, world):
    """Config 4's sharded steps on this rank of a (world, 1) mesh, then
    CONFIG4_TIMED_STEPS more with every ``psum`` synchronised before and
    after and timed: the all_reduce share of a step."""
    from gpsig_tpu_torch.parallel.mesh import make_mesh
    from gpsig_tpu_torch.parallel.train import make_sharded_step_fn
    from gpsig_tpu_torch.training import loop

    c = CONFIG4
    mesh = make_mesh(world, 1)
    step = make_sharded_step_fn(c["lr"], c["N"], mesh, gamma=c["gamma"])
    out, (state, loader) = config4_steps(torch, dev, mesh, step)
    spent = []
    psum = loop.psum

    def timed_psum(tensors, group):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = psum(tensors, group)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return got

    steps = []
    with mock.patch.object(loop, "psum", timed_psum):
        for _ in range(CONFIG4_TIMED_STEPS):
            Xb, Yb = next(loader)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = step(state, Xb, Yb)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t)
    out.update(timed_ms=1e3 * statistics.median(steps),
               all_reduce_ms=1e3 * sum(spent) / CONFIG4_TIMED_STEPS,
               all_reduces=len(spent) // CONFIG4_TIMED_STEPS)
    return out


def bench_gram_inputs(torch, dev):
    from gpsig_tpu_torch.kernels.signature import SignatureRBF

    g = GRAM_BENCH
    rng = np.random.default_rng(SEED + 70)
    X = torch.as_tensor(walks(rng, g["N"], g["L"], g["d"]),
                        dtype=torch.float32, device=dev)
    kern = SignatureRBF(g["d"], g["nl"], lengthscales=1.0, order=1,
                        normalization=True, dtype=torch.float32, device=dev)
    return kern, X


def gram_sharded(torch, dev, world):
    """``sharded_gram`` at bench.py's shape on the (world, 1) and (1,
    world) meshes, each with its counters and ms."""
    from gpsig_tpu_torch.parallel.mesh import make_mesh
    from gpsig_tpu_torch.parallel.train import sharded_gram

    kern, X = bench_gram_inputs(torch, dev)
    out = {}
    for shape in ((world, 1), (1, world)):
        mesh = make_mesh(*shape)
        sharded_gram(kern, mesh, X)  # warm-up
        torch.cuda.synchronize()
        reset_counters()
        t = time.perf_counter()
        K = sharded_gram(kern, mesh, X)
        torch.cuda.synchronize()
        out[shape] = dict(K=K.cpu(), launches=counters(),
                          ms=1e3 * (time.perf_counter() - t))
    return out


def goursat_sp_inputs(torch, dev):
    g = GOURSAT_SP
    rng = np.random.default_rng(SEED + 71)
    return torch.as_tensor(0.05 * rng.standard_normal(
        (g["batch"], g["S"], g["T"])), dtype=torch.float64, device=dev)


def goursat_sharded(torch, dev, world):
    from gpsig_tpu_torch.parallel.goursat_sp import goursat_corner_seq_sharded
    from gpsig_tpu_torch.parallel.mesh import make_mesh

    inc = goursat_sp_inputs(torch, dev)
    mesh = make_mesh(world, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    u = goursat_corner_seq_sharded(inc, mesh, GOURSAT_SP["col_block"])
    torch.cuda.synchronize()
    return dict(u=u.cpu(), ms=1e3 * (time.perf_counter() - t))


def config5_sharded(torch, dev, world):
    """Config 5's 16 chains split over the ranks, draws cut to
    CONFIG5_SHARDED's, through ``run_chains_sharded``: this rank's
    evaluations, launches and every chain's step size."""
    from gpsig_tpu_torch.mcmc import nuts
    from gpsig_tpu_torch.mcmc.targets import signature_gpr_logp
    from gpsig_tpu_torch.parallel.chains import run_chains_sharded
    from gpsig_tpu_torch.parallel.mesh import make_mesh

    f32 = torch.float32
    X, y = config5_data(torch, dev, f32)
    logp = signature_gpr_logp(X, y, CONFIG5["levels"])
    mesh = make_mesh(world, 1)
    torch.cuda.synchronize()
    reset_counters()
    evals0 = nuts.evaluations
    t = time.perf_counter()
    samples, info = run_chains_sharded(
        SEED, logp, config5_theta0(torch, dev, f32), mesh,
        num_warmup=CONFIG5_SHARDED["warmup"],
        num_samples=CONFIG5_SHARDED["samples"],
        max_depth=CONFIG5["max_depth"],
        draws_per_dispatch=CONFIG5["draws_per_dispatch"])
    return dict(evaluations=nuts.evaluations - evals0, launches=counters(),
                step_size=info["step_size"], shape=samples.shape,
                finite=bool(np.all(np.isfinite(samples))),
                wall=time.perf_counter() - t)


def worker_float64(torch, dev, world):
    """``python -m gpsig_tpu_torch.parallel.worker``'s run (4 float64 steps
    of ``distributed_check``'s problem) on this rank, the counters reset
    just before."""
    from gpsig_tpu_torch.parallel import worker
    from gpsig_tpu_torch.parallel.mesh import make_mesh

    reset_counters()
    return worker.run(make_mesh(world, 1), 4, torch.float64, dev)


RANK_SCENARIOS = {"config4": config4_sharded, "gram": gram_sharded,
                  "goursat": goursat_sharded, "config5": config5_sharded,
                  "float64": worker_float64}


def parallel_rank(argv):
    """A rank's process (``chip_smoke.py --parallel-rank R ...``, started by
    the multi-process phase): join the process group, run the scenarios
    asked for on cuda:0, save their results and print one JSON line."""
    started = time.perf_counter()
    import argparse

    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parallel-rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--backend", required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--scenarios", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke rank: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from gpsig_tpu_torch.ops.cuda import _build
    from gpsig_tpu_torch.parallel.mesh import init_distributed

    # the phase built the library before starting the ranks: a rank loads
    # it and never runs nvcc
    check(_build.library_path().exists(), "rank: the kernel library is not "
          "built")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rank = args.parallel_rank
    init_distributed(args.backend, f"file://{args.store}", args.world, rank)
    try:
        torch.zeros(1, device=dev)  # the CUDA context
        seconds = {"start": time.perf_counter() - started}
        results = {}
        for name in args.scenarios.split(","):
            t = time.perf_counter()
            results[name] = RANK_SCENARIOS[name](torch, dev, args.world)
            seconds[name] = time.perf_counter() - t
        torch.save(results, Path(args.out) / f"rank{rank}.pt")
        print(json.dumps({"rank": rank, "world": args.world,
                          "backend": args.backend, "seconds": seconds}),
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_processes(cmds, label):
    """Start every command, wait for all (RANK_TIMEOUT_S), kill any left
    over; each must exit 0 and print a JSON line as its last. Returns the
    parsed lines."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for cmd in cmds]
    lines = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            last = out.strip().splitlines()[-1:] or [""]
            check(p.returncode == 0, f"{label}: rank {i} exited "
                  f"{p.returncode}:\n{err[-4000:]}")
            check(last[0].startswith("{"), f"{label}: rank {i} printed no "
                  f"JSON line:\n{out[-2000:]}\n{err[-2000:]}")
            lines.append(json.loads(last[0]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return lines


def run_ranks(tmp, backend, world, scenarios):
    """``world`` rank processes of this script under ``backend``; each
    rank's results."""
    import torch

    out = Path(tmp) / f"{backend}{world}"
    out.mkdir()
    cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
             str(r), "--world", str(world), "--backend", backend, "--store",
             str(out / "store"), "--out", str(out), "--scenarios",
             ",".join(scenarios)] for r in range(world)]
    for line in run_processes(cmds, f"{backend} x{world}"):
        print(f"multi-process {backend} rank {line['rank']} of {world}: "
              f"seconds {  {k: round(v, 1) for k, v in line['seconds'].items()} } "
              "(start: from importing torch to a CUDA context in the "
              "process group)")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def config4_vs_one_process(label, got, ref):
    """A rank's config-4 steps against the one-process steps: ELBOs, q_mu
    and q_sqrt, and the other parameters, each within its
    PARALLEL_F32_TOL."""
    errs = {
        "elbo": max(abs(a - b) / abs(b)
                    for a, b in zip(got["elbos"], ref["elbos"])),
        "q": max(scaled_err(got["params"][k], ref["params"][k])
                 for k in ("q_mu", "q_sqrt")),
    }
    others = {k: abs_err(v, ref["params"][k])
              for k, v in got["params"].items() if k not in ("q_mu", "q_sqrt")}
    errs["other"] = max(others.values())
    print(f"multi-process {label}: ELBOs {got['elbos']} against one "
          f"process's {ref['elbos']}; " + "; ".join(
              f"{k} err {errs[k]:.3e} (tolerance {limit:g}: {why})"
              for k, (limit, why) in PARALLEL_F32_TOL.items())
          + f"; other parameters' abs err "
          f"{ {k: f'{v:.2e}' for k, v in others.items()} }")
    for k, (limit, _) in PARALLEL_F32_TOL.items():
        check(errs[k] <= limit, f"multi-process {label}: {k} err "
              f"{errs[k]} over {limit}")
    rise = {k: got["launches"][k] for k in ("diag", "tens_seq",
                                            "tens_seq_bwd")}
    print(f"multi-process {label}: launches {rise}")
    check(all(rise.values()), f"multi-process {label}: a kernel did not "
          f"launch: {rise}")


def parallel_phase(dev, card):
    """The parallel layer on the card within PARALLEL_BUDGET_S seconds:
    config 4's one-process steps here, then one rank under NCCL, and two
    ranks on cuda:0 under gloo (config 4, sharded_gram, the
    sequence-parallel Goursat corner, config 5's chains, and the float64
    worker's run against the one-process CPU run)."""
    import tempfile

    import torch

    from gpsig_tpu_torch.ops.goursat import goursat_corner
    from gpsig_tpu_torch.parallel import distributed_check as dc
    from gpsig_tpu_torch.parallel.mesh import Mesh, make_mesh
    from gpsig_tpu_torch.training.loop import make_step_fn

    t0 = time.perf_counter()
    parts = {}

    def part(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[label] = time.perf_counter() - t
        return out

    c = CONFIG4
    ref, _ = part("config 4, one process", config4_steps, torch, dev,
                  Mesh(1, 1), make_step_fn(c["lr"], c["N"],
                                           gamma=c["gamma"]))
    with tempfile.TemporaryDirectory() as tmp:
        (nccl,) = part("NCCL, one rank", run_ranks, tmp, "nccl", 1,
                       ["config4"])
        gloo = part("gloo, two ranks", run_ranks, tmp, "gloo", 2,
                    ["config4", "gram", "goursat", "config5", "float64"])
    workers = [res["float64"] for res in gloo]

    # config 4: one rank under NCCL and two under gloo against one process
    config4_vs_one_process("config 4, NCCL, one rank", nccl["config4"], ref)
    for r, res in enumerate(gloo):
        config4_vs_one_process(f"config 4, gloo, rank {r} of 2",
                               res["config4"], ref)
    p0, p1 = (res["config4"]["params"] for res in gloo)
    same = all(torch.equal(p0[k], p1[k]) for k in p0)
    print(f"multi-process config 4, gloo: the two ranks' parameters bitwise "
          f"equal after {c['steps']} steps: {same}")
    check(same, "multi-process config 4: the ranks' parameters differ")
    one = statistics.median(ref["ms"])
    for label, res in (("NCCL, one rank", nccl["config4"]),
                       ("gloo, two ranks on one card", gloo[0]["config4"])):
        print(f"time multi-process config 4 on {card}, {label}: "
              f"{statistics.median(res['ms']):.2f} ms a sharded step (global "
              f"batch {c['B']}, {res['batch']} a rank; one process "
              f"{one:.2f} ms); with synchronised collectives "
              f"{res['timed_ms']:.2f} ms, of which {res['all_reduce_ms']:.2f} "
              f"ms in {res['all_reduces']} all_reduce calls (share "
              f"{res['all_reduce_ms'] / res['timed_ms']:.3f})")

    # sharded_gram at bench.py's shape against K on the card
    kern, X = bench_gram_inputs(torch, dev)
    with torch.no_grad():
        K = kern.K(X)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad():
        kern.K(X)
    torch.cuda.synchronize()
    k_ms = 1e3 * (time.perf_counter() - t)
    limit, why = TOL["float32"]
    for r, res in enumerate(gloo):
        for shape, g in res["gram"].items():
            err = scaled_err(g["K"], K.cpu())
            print(f"multi-process sharded_gram {shape} rank {r}: scaled err "
                  f"{err:.3e} against K on the card (tolerance {limit:g}: "
                  f"{why}), gram launches {g['launches']['gram']}, "
                  f"{g['ms']:.2f} ms (K in one process {k_ms:.2f} ms)")
            check(err <= limit, f"multi-process sharded_gram {shape}: {err}")
            check(g["launches"]["gram"] > 0, f"multi-process sharded_gram "
                  f"{shape} rank {r}: the Gram kernel did not launch")

    # the sequence-parallel Goursat corner against the sweep on the card
    limit, why = GOURSAT_SP_TOL
    want = goursat_corner(goursat_sp_inputs(torch, dev)).cpu()
    for r, res in enumerate(gloo):
        err = scaled_err(res["goursat"]["u"], want)
        print(f"multi-process Goursat corner, s split over 2 ranks, "
              f"{GOURSAT_SP}: rank {r} scaled err {err:.3e} against "
              f"goursat_corner on the card (tolerance {limit:g}: {why}), "
              f"{res['goursat']['ms']:.1f} ms")
        check(err <= limit, f"multi-process Goursat corner rank {r}: {err}")

    # config 5's chains over two ranks
    steps = [res["config5"]["step_size"] for res in gloo]
    for r, res in enumerate(gloo):
        got = res["config5"]
        n = got["evaluations"]
        rise = {k: got["launches"][k] for k in ("gram", "diag", "gram_bwd")}
        print(f"multi-process config 5, rank {r} of 2 ({CONFIG5['chains']} "
              f"chains, {CONFIG5['chains'] // 2} a rank, "
              f"{CONFIG5_SHARDED['warmup']} + {CONFIG5_SHARDED['samples']} "
              f"draws): {n} evaluations, launches {rise}, step sizes "
              f"{np.unique(got['step_size']).tolist()}, {got['wall']:.1f} s")
        check(all(v == n for v in rise.values()), f"multi-process config 5 "
              f"rank {r}: launches {rise} for {n} evaluations")
        check(got["finite"] and got["shape"] == (
            CONFIG5["chains"], CONFIG5_SHARDED["samples"],
            CONFIG5["d"] + CONFIG5["levels"] + 2),
            f"multi-process config 5 rank {r}: samples {got['shape']}")
    check(np.array_equal(steps[0], steps[1]) and len(np.unique(steps[0])) == 1,
          "multi-process config 5: the step sizes differ across chains or "
          "ranks")

    # the float64 worker at two ranks against the one-process CPU run
    elbo, checksum = dc.run_steps(make_mesh(), 4, torch.float64, "cpu")
    limit, why = PARALLEL_F64_TOL
    errs = [max(abs(w["elbo"] - elbo) / abs(elbo),
                abs(w["checksum"] - checksum) / abs(checksum))
            for w in workers]
    print(f"multi-process worker's run, float64, 2 ranks on cuda:0 under "
          f"gloo, 4 "
          f"steps: ELBO {workers[0]['elbo']!r}, checksum "
          f"{workers[0]['checksum']!r} against the CPU's {elbo!r}, "
          f"{checksum!r}: relative err {max(errs):.3e} (tolerance {limit:g}: "
          f"{why}); launches {workers[0]['launches']}")
    check(max(errs) <= limit, f"multi-process worker: {errs}")
    check(workers[0]["elbo"] == workers[1]["elbo"]
          and workers[0]["checksum"] == workers[1]["checksum"],
          "multi-process worker: the ranks differ")
    check(all(w["launches"][k] for w in workers
              for k in ("diag", "tens_seq", "tens_seq_bwd")),
          "multi-process worker: a kernel did not launch")

    total = time.perf_counter() - t0
    print(f"multi-process phase on {card}: {total:.1f} s of its "
          f"{PARALLEL_BUDGET_S:.0f} s budget "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    check(total <= PARALLEL_BUDGET_S, f"multi-process phase: {total:.1f} s "
          f"over its {PARALLEL_BUDGET_S:.0f} s budget")


# ---------------------------------------------------------------------------
# The GPSig call surface (``gpsig_tpu_torch/compat/``): flattened inputs,
# numpy in and out, the data-holding SVGP drawing its own minibatches and
# the GPflow-style optimizers, over the port's modules. The facade launches
# no kernel of its own; what it adds is the host's numpy round trips.
# ---------------------------------------------------------------------------

#: the phase's wall-time budget in seconds: a phase that overruns fails
COMPAT_BUDGET_S = 90.0
#: the flagship (slice_phase's model at full width) through the facade
COMPAT_FLAGSHIP = dict(M=500, nl=5, d=3, L=50, C=10, n_train=840,
                       n_test=2048, batch=50, lr=1e-3, gamma=0.1,
                       alternations=3)
#: the SigGPDE VOSF model's σ under RobustMax: f's scale does not move its
#: argmax and Kuu = I, so the ELBO does not depend on σ and its gradient is
#: rounding (2.2e-15 on the CPU); at |g| <= 1e-13 Adam moves it by
#: lr·g/(|g| + 1e-8) <= 1e-5·lr a step, on either device
COMPAT_SIGMA_TOL = 1e-5


def param_copies(model):
    """Every parameter of ``model``, detached copies by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def grad_copies(model):
    """The gradients an Adam step used (those that are not None), by
    name."""
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def core_step_from(template, params, nat_batch, batch, num_data, gamma):
    """The core's calls from ``params`` (in a copy of ``template``):
    ``natgrad_step`` on ``nat_batch``, then the loss −ELBO on ``batch`` and
    its gradients with q frozen. Returns the ELBO, the gradients and the
    parameters after the natgrad step."""
    import torch

    from gpsig_tpu_torch.config import precise_linalg
    from gpsig_tpu_torch.training.natgrad import natgrad_step

    model = copy.deepcopy(template)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    natgrad_step(model, gamma, *nat_batch, num_data=num_data)
    after = param_copies(model)
    model.zero_grad(set_to_none=True)
    with precise_linalg():
        loss = -model.elbo(*batch, num_data=num_data)
        loss.backward()
    model.q_mu.grad = model.q_sqrt.grad = None
    return -loss.item(), grad_copies(model), after


def facade_steps_agree(label, got, template, batches, num_data, gamma, lr):
    """The facade's float32 run against the core's calls, a step at a
    time from the facade's own state. ``got`` holds the parameters before
    the first step (``start``) and after each (``params``), and each
    step's ELBO and gradients; ``batches`` each step's (natgrad, Adam)
    minibatches. For each step the core starts from the facade's
    parameters before it: the ELBO and the natgrad step's q within
    PARALLEL_F32_TOL, the gradients within BWD_TOL's float32 bound (the
    backward kernels' atomics are the only difference); then
    ``torch.optim.Adam`` at ``lr``, fed the facade's gradients from its
    start, must give its parameters after every step (PARALLEL_F32_TOL's
    "other"). A step at a time, because Adam turns an entry whose gradient
    is of the atomics' size into ±lr whatever its sign, and the next step
    carries that to the entries around it."""
    import torch

    hyper = [n for n in got["start"] if n not in ("q_mu", "q_sqrt")]
    replay = {n: got["start"][n].clone() for n in hyper}
    opt = torch.optim.Adam(list(replay.values()), lr=lr)
    errs = dict(elbo=0.0, q=0.0, gradients=0.0, other=0.0)
    before = got["start"]
    for k, (nat_batch, batch) in enumerate(batches):
        elbo, grads, natgrad = core_step_from(template, before, nat_batch,
                                              batch, num_data, gamma)
        after, facade_grads = got["params"][k], got["grads"][k]
        check(set(grads) == set(facade_grads) == set(hyper),
              f"{label} step {k + 1}: gradients of {sorted(facade_grads)} "
              f"vs the core's {sorted(grads)}")
        errs["elbo"] = max(errs["elbo"], abs(got["elbos"][k] - elbo)
                           / abs(elbo))
        errs["q"] = max(errs["q"], *(scaled_err(after[n], natgrad[n])
                                     for n in ("q_mu", "q_sqrt")))
        errs["gradients"] = max(errs["gradients"], *(
            scaled_err(facade_grads[n], grads[n]) for n in hyper))
        for n, p in replay.items():
            p.grad = facade_grads[n]
        opt.step()
        errs["other"] = max(errs["other"], *(abs_err(after[n], replay[n])
                                             for n in hyper))
        before = after
    limits = dict(PARALLEL_F32_TOL, gradients=BWD_TOL["float32"])
    print(f"{label}, {len(batches)} steps, each from the facade's state "
          f"against the core's calls: ELBOs {got['elbos']}; " + "; ".join(
              f"{k} err {errs[k]:.3e} (tolerance {limit:g}: {why})"
              for k, (limit, why) in limits.items()))
    for k, (limit, _) in limits.items():
        check(errs[k] <= limit, f"{label}: {k} err {errs[k]} over {limit}")


def compat_flagship(dev, card):
    """(1) The flagship (M = 500 inducing tensors with increments, nl = 5,
    d = 3, L = 50, C = 10; 840 training sequences flattened to [840, 150],
    the data and Z from ``build_svgp``'s generators) through the facade,
    float32: 3 alternations of NatGrad(0.1) and frozen Adam(1e-3) at
    B = 50, the diagonal, Kuf and Kuf-backward counters rising, held a
    step at a time against the core's calls on the same batches
    (``facade_steps_agree``); ``predict_y`` and ``predict_density`` on 2048
    flattened test sequences bitwise against the core's posterior on the
    same parameters; ms per alternation and per ``predict_y``, facade and
    core (the core's own run of the same calls)."""
    import torch

    from gpsig_tpu_torch import compat as gpsig
    from gpsig_tpu_torch.config import precise_linalg
    from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
    from gpsig_tpu_torch.training.natgrad import natgrad_step

    f = COMPAT_FLAGSHIP
    f32 = torch.float32
    M, nl, d, L, C, n = (f[k] for k in ("M", "nl", "d", "L", "C", "n_train"))
    rng = np.random.default_rng(SEED + 90)
    X = walks(rng, n, L, d)
    y = rng.integers(0, C, n)
    Z = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(SEED),
        torch.as_tensor(X, dtype=f32, device=dev), num_tensors=M,
        num_levels=nl, num_features=d, increments=True).raw_Z.detach()
    Xte = walks(rng, f["n_test"], L, d).reshape(f["n_test"], L * d)
    yte = rng.integers(0, C, f["n_test"])
    kern = gpsig.kernels.SignatureRBF(L * d, d, nl, dtype=f32, device=dev)
    feat = gpsig.inducing_variables.InducingTensors(
        Z, nl, increments=True, dtype=f32, device=dev)
    m = gpsig.models.SVGP(X.reshape(n, L * d), y, kern,
                          gpsig.likelihoods.MultiClass(C), feat=feat,
                          num_latent=C, minibatch_size=f["batch"], seed=SEED)
    core = copy.deepcopy(m.to_functional())
    nat = gpsig.training.NatGradOptimizer(f["gamma"])
    adam = gpsig.training.AdamOptimizer(f["lr"])
    got = dict(start=param_copies(m.to_functional()), elbos=[], grads=[],
               params=[])

    def record(it, elbo):
        got["elbos"].append(elbo)
        got["grads"].append(grad_copies(m.to_functional()))
        got["params"].append(param_copies(m.to_functional()))

    def facade_alternation():
        nat.minimize(m, maxiter=1)
        adam.minimize(m, maxiter=1, freeze_variational=True, callback=record)

    reset_counters()
    for _ in range(f["alternations"]):
        facade_alternation()
    launches = counters()
    print(f"compat flagship training launches: {launches}")
    for key in ("diag", "tens_seq", "tens_seq_bwd"):
        check(launches[key] > 0, f"compat flagship: {key} did not launch")

    # the facade's stream of batches: a natgrad batch, then an Adam batch
    stream = np.random.default_rng(SEED)

    def batch():
        idx = torch.as_tensor(stream.choice(n, f["batch"], replace=False),
                              device=dev)
        return m.X[idx], m.Y[idx]

    batches = [(batch(), batch()) for _ in range(f["alternations"])]
    facade_steps_agree("compat flagship", got, core, batches, n,
                       f["gamma"], f["lr"])

    # times, in turns: the facade's alternation (its batches drawn and
    # indexed, numpy out) and the core's same calls on batches it indexes
    opt = torch.optim.Adam(core.parameters(), lr=f["lr"])

    def core_alternation():
        natgrad_step(core, f["gamma"], *batch(), num_data=n)
        opt.zero_grad(set_to_none=True)
        with precise_linalg():
            loss = -core.elbo(*batch(), num_data=n)
            loss.backward()
        core.q_mu.grad = core.q_sqrt.grad = None
        opt.step()
        return -loss.item()

    ms = dict(facade=[], core=[])
    for _ in range(f["alternations"]):
        ms["facade"].append(timed(lambda: (
            nat.minimize(m, maxiter=1),
            adam.minimize(m, maxiter=1, freeze_variational=True)))[1])
        ms["core"].append(timed(core_alternation)[1])

    # serving: the facade's cached posterior against the core's, bitwise
    Xte_dev = torch.as_tensor(Xte, dtype=f32, device=dev)
    yte_dev = torch.as_tensor(yte, device=dev)
    reset_counters()
    probs, pvar = m.predict_y(Xte)
    dens = m.predict_density(Xte, yte)
    serving = counters()
    print(f"compat flagship serving launches: {serving}")
    for key in ("diag", "tens_seq"):
        check(serving[key] > 0, f"compat flagship serving: {key} did not "
              "launch")
    with torch.no_grad():
        post = m.to_functional().posterior()
        want = [t.cpu().numpy() for t in (*post.predict_y(Xte_dev),
                                          post.predict_log_density(
                                              Xte_dev, yte_dev))]
    for name, g, w in zip(("predict_y mean", "predict_y var",
                           "predict_density"), (probs, pvar, dens), want):
        check(g.shape == w.shape and np.array_equal(g, w),
              f"compat flagship {name}: not bitwise equal to the core's "
              f"(max abs diff {np.abs(g - w).max():.3e})")
    check(np.allclose(probs.sum(-1), 1.0, atol=1e-5),
          "compat flagship: probabilities do not sum to 1")
    ms_facade = host_ms(lambda: m.predict_y(Xte))
    ms_core = host_ms(lambda: post.predict_y(Xte_dev))
    print(f"compat flagship on {card}: predict_y and predict_density on "
          f"{f['n_test']} bitwise equal to the core's posterior; ms per "
          f"NatGrad + frozen Adam alternation (B = {f['batch']}, in turns): "
          + ", ".join(f"{k} {statistics.median(v):.3f} (all "
                      f"{[round(t, 3) for t in v]})" for k, v in ms.items())
          + f"; ms per predict_y on "
          f"{f['n_test']} (cached posterior): facade {ms_facade:.3f} "
          f"(numpy in and out), core {ms_core:.3f}")


def compat_config3(dev, card):
    """(2) BASELINE config 3 (40 inducing sequences of length 8, nl = 4,
    MultiClass(2)) at MotorImagery's shape (L = 3000, d = 64; 278
    sequences flattened to [278, 192000]), float32, sequence_svgp_phase's
    data: ``compat.training.fit`` for 2 steps at B = 50 (Adam 2e-3,
    γ = 0.1) with sig_gram, its backward, the Gram, its backward and the
    diagonal rising, held a step at a time against ``make_step_fn``'s calls
    on the same batches (``facade_steps_agree``); ms a step, facade and
    core (``make_step_fn``'s own run)."""
    import torch

    from gpsig_tpu_torch import compat as gpsig
    from gpsig_tpu_torch.inducing import make_inducing_sequences_from_data
    from gpsig_tpu_torch.training.loop import make_step_fn

    cfg, ui = CONFIG3, UEA["MotorImagery"]
    f32 = torch.float32
    L, d, C, M, n = ui["L"], ui["d"], ui["C"], cfg["M"], ui["n_train"]
    rng = np.random.default_rng(SEED + 53)
    X = uea_walks(rng, n, L, d)
    y = rng.integers(0, C, n)
    Z = make_inducing_sequences_from_data(
        torch.Generator().manual_seed(SEED),
        torch.as_tensor(X, dtype=f32, device=dev), M, cfg["Lz"],
        d).raw_Z.detach()
    kern = gpsig.kernels.SignatureRBF(L * d, d, cfg["nl"], lengthscales=1.0,
                                      normalization=True, dtype=f32,
                                      device=dev)
    feat = gpsig.inducing_variables.InducingSequences(Z, dtype=f32,
                                                      device=dev)
    m = gpsig.models.SVGP(X.reshape(n, L * d), y, kern,
                          gpsig.likelihoods.MultiClass(C), feat=feat,
                          num_latent=C, minibatch_size=cfg["batch"],
                          seed=SEED)
    del X
    core = copy.deepcopy(m.to_functional())
    got = dict(start=param_copies(m.to_functional()), elbos=[], grads=[],
               params=[])

    def record(it, elbo):
        got["elbos"].append(elbo)
        got["grads"].append(grad_copies(m.to_functional()))
        got["params"].append(param_copies(m.to_functional()))

    reset_counters()
    gpsig.training.fit(m, maxiter=cfg["steps"], learning_rate=cfg["lr"],
                       gamma=cfg["gamma"], callback=record)
    launches = counters()
    print(f"compat config 3 training launches: {launches}")
    for key in ("sig_gram", "sig_gram_bwd", "gram", "gram_bwd", "diag"):
        check(launches[key] > 0, f"compat config 3: {key} did not launch")

    # the facade's stream of batches: one a step, for natgrad and Adam
    stream = np.random.default_rng(SEED)
    batches = []
    for _ in range(cfg["steps"]):
        idx = torch.as_tensor(stream.choice(n, cfg["batch"], replace=False),
                              device=dev)
        batches.append(((m.X[idx], m.Y[idx]),) * 2)
    facade_steps_agree("compat config 3", got, core, batches, n,
                       cfg["gamma"], cfg["lr"])

    # times, in turns: a step of the facade's fit (its batch drawn and
    # indexed) and of make_step_fn on a batch it indexes
    step = make_step_fn(cfg["lr"], num_data=n, gamma=cfg["gamma"])
    state = step.init(core)
    ms = dict(facade=[], core=[])
    for _ in range(cfg["steps"]):
        ms["facade"].append(timed(lambda: gpsig.training.fit(
            m, maxiter=1, learning_rate=cfg["lr"], gamma=cfg["gamma"]))[1])
        idx = torch.as_tensor(stream.choice(n, cfg["batch"], replace=False),
                              device=dev)
        (state, _), t = timed(lambda: step(state, m.X[idx], m.Y[idx]))
        ms["core"].append(t)
    print(f"compat config 3 on {card}: ms a natgrad + Adam step at B = "
          f"{cfg['batch']}, in turns: " + ", ".join(
              f"{k} {[round(t, 1) for t in v]}" for k, v in ms.items()))
    del m, core, state, batches
    torch.cuda.empty_cache()


def compat_gram(dev, card):
    """(3) ``compute_K_symm``, ``compute_K`` and ``compute_Kdiag`` at
    bench.py's shape (N = 256, L = 50, d = 2, nl = 4, float32), each
    bitwise equal to ``to_functional().K`` / ``Kdiag`` on the card, the
    Gram counter rising; ms facade and core."""
    import torch

    from gpsig_tpu_torch import compat as gpsig

    g = GRAM_BENCH
    N, L, d = g["N"], g["L"], g["d"]
    rng = np.random.default_rng(SEED + 70)
    X = walks(rng, N, L, d).reshape(N, L * d)
    kern = gpsig.kernels.SignatureRBF(L * d, d, g["nl"], lengthscales=1.0,
                                      normalization=True,
                                      dtype=torch.float32, device=dev)
    reset_counters()
    got = [kern.compute_K_symm(X), kern.compute_K(X[:N // 2], X[N // 2:]),
           kern.compute_Kdiag(X)]
    launches = counters()
    check(launches["gram"] > 0, "compat compute_K: the Gram did not launch")
    core = kern.to_functional()
    Xd = torch.as_tensor(X, dtype=torch.float32, device=dev)
    with torch.no_grad():
        want = [core.K(Xd), core.K(Xd[:N // 2], Xd[N // 2:]), core.Kdiag(Xd)]
    for name, a, b in zip(("compute_K_symm", "compute_K", "compute_Kdiag"),
                          got, want):
        b = b.cpu().numpy()
        check(a.shape == b.shape and np.array_equal(a, b),
              f"compat {name}: not bitwise equal to the core's")
    ms_facade = host_ms(lambda: kern.compute_K_symm(X))
    with torch.no_grad():
        ms_core = host_ms(lambda: core.K(Xd))
    print(f"compat compute_K_symm / compute_K / compute_Kdiag at N = {N}, "
          f"L = {L}, d = {d}, nl = {g['nl']}: bitwise equal to the core's; "
          f"launches {launches}; on {card}: compute_K_symm {ms_facade:.3f} "
          f"ms (numpy in and out), core K {ms_core:.3f} ms")


def compat_small_float64(dev):
    """(4) Small float64 facade models on the card against the CPU
    (PARALLEL_F64_TOL): the order-1 inducing-tensor model of
    tests/test_compat.py's test_svgp_wrapper_trains_and_predicts and its
    SigGPDE VOSF model, 3 alternations each; the full-data ELBO, every
    parameter and ``predict_y``. The VOSF model launches the Goursat
    forward and adjoint (row 15) on the card."""
    import torch

    from gpsig_tpu_torch import compat as gpsig

    N, L, D, C, NL = 20, 10, 2, 3, 3
    rng = np.random.default_rng(0)
    X = 0.4 * rng.standard_normal((N, L * D))
    y = rng.integers(0, C, N)
    Z = 0.3 * np.random.default_rng(2).standard_normal(
        (5, NL * (NL + 1) // 2, D))

    def tensors(where):
        kern = gpsig.kernels.SignatureRBF(L * D, D, NL, device=where)
        feat = gpsig.inducing_variables.InducingTensors(Z, NL, device=where)
        return (gpsig.models.SVGP(X, y, kern, gpsig.likelihoods.MultiClass(C),
                                  feat=feat, num_latent=C, minibatch_size=8),
                0.2, 1e-2)

    def siggpde(where):
        kern = gpsig.kernels.UntruncSignatureKernel(
            L * D, D, dyadic_order=1, normalization=True, device=where)
        feat = gpsig.inducing_variables.OrthogonalFeatures(kern, num_levels=3)
        return (gpsig.models.SVGP(X, y, kern, gpsig.likelihoods.MultiClass(C),
                                  feat=feat, num_latent=C, q_diag=True),
                0.1, 5e-3)

    for label, build in (("inducing tensors", tensors),
                         ("SigGPDE VOSF", siggpde)):
        out = {}
        for where in ("cpu", dev):
            m, gamma, lr = build(where)
            nat = gpsig.training.NatGradOptimizer(gamma)
            adam = gpsig.training.AdamOptimizer(lr)
            reset_counters()
            for _ in range(3):
                nat.minimize(m, maxiter=1)
                adam.minimize(m, maxiter=1, freeze_variational=True)
            launches = counters()
            core = m.to_functional()
            core.zero_grad()
            core.elbo(m.X, m.Y, num_data=N).backward()
            out[where] = dict(
                elbo=torch.tensor(m.compute_log_likelihood_full()),
                predict_y=torch.as_tensor(np.stack(m.predict_y(X[:4]))),
                params={k: v.cpu() for k, v in param_copies(core).items()},
                grads={k: p.grad.detach().cpu()
                       for k, p in core.named_parameters()},
                launches=launches)
        on_card, cpu = out[dev], out["cpu"]
        errs = {k: scaled_err(on_card[k], cpu[k])
                for k in ("elbo", "predict_y")}
        sigma = "kernel.raw_sigma" if label == "SigGPDE VOSF" else None
        for k, v in cpu["params"].items():
            if k != sigma:
                errs[k] = scaled_err(on_card["params"][k], v)
        print(f"compat {label} float64, card vs CPU after 3 alternations: "
              f"scaled errs { {k: f'{v:.3e}' for k, v in errs.items()} }, "
              f"tolerance {PARALLEL_F64_TOL[0]:g} ({PARALLEL_F64_TOL[1]})")
        for k, v in errs.items():
            check(v <= PARALLEL_F64_TOL[0], f"compat {label} float64 {k}: {v}")
        if sigma is not None:
            scale = max(g.abs().max().item() for g in cpu["grads"].values())
            g_sigma = max(abs(o["grads"][sigma].item())
                          for o in (on_card, cpu))
            moved = abs_err(on_card["params"][sigma], cpu["params"][sigma])
            tol = 3 * 5e-3 * COMPAT_SIGMA_TOL
            print(f"compat {label} float64: σ's gradient {g_sigma:.3e} "
                  f"(the largest {scale:.3e}), raw σ card vs CPU "
                  f"{moved:.3e}, tolerance {tol:g} (the ELBO does not depend "
                  "on σ under RobustMax with Kuu = I: 3 Adam steps of lr "
                  f"5e-3 move its rounding by up to {COMPAT_SIGMA_TOL:g}·lr "
                  "each)")
            check(g_sigma <= 1e-13, f"compat {label}: σ's gradient "
                  f"{g_sigma} is not rounding")
            check(moved <= tol, f"compat {label}: raw σ {moved}")
            for key in ("goursat_fused", "goursat_grad"):
                check(on_card["launches"][key] > 0,
                      f"compat {label} float64: {key} did not launch")
            print(f"compat {label} float64 launches on the card: "
                  f"{ {k: on_card['launches'][k] for k in GOURSAT} }")


def compat_phase(dev, card):
    """The GPSig facade on the card within COMPAT_BUDGET_S seconds."""
    t0 = time.perf_counter()
    parts = {}
    for label, fn, args in (("flagship", compat_flagship, (dev, card)),
                            ("config 3", compat_config3, (dev, card)),
                            ("compute_K", compat_gram, (dev, card)),
                            ("float64 card vs CPU", compat_small_float64,
                             (dev,))):
        t = time.perf_counter()
        fn(*args)
        parts[label] = time.perf_counter() - t
    total = time.perf_counter() - t0
    print(f"compat facade phase on {card}: {total:.1f} s of its "
          f"{COMPAT_BUDGET_S:.0f} s budget "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")
    check(total <= COMPAT_BUDGET_S, f"compat facade phase: {total:.1f} s "
          f"over its {COMPAT_BUDGET_S:.0f} s budget")


def phase(label, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall time printed under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
    timings = phase("kernels", kernel_phase, dev)
    launches = phase("slice", slice_phase, dev)
    phase("slice float64", small_float64_check, dev)
    train_launches = phase("training", training_phase, dev)
    phase("training float64", small_float64_training_check, dev)
    timings.update(phase("slice 1 kernels", slice1_kernel_phase, dev))
    phase("coverage", coverage_sweep, dev)
    svgp2_launches = phase("slice 1 serving", slice1_serving_phase, dev)
    gpr_launches = phase("slice 1 GPR", slice1_gpr_phase, dev)
    phase("slice 1 float64", small_float64_check, dev, order=2)
    phase("slice 1 GPR float64", small_float64_gpr_check, dev)
    timings.update(phase("slice 1 backward kernels",
                         slice1_backward_kernel_phase, dev))
    phase("Kuf plan sweep", kuf_plan_sweep, dev)
    phase("wide SVGP", wide_svgp_check, dev)
    train1 = phase("slice 1 training", slice1_training_phase, dev)
    phase("slice 1 training float64", small_float64_training_check, dev,
          order=2, gpr_ctor="SignaturePoly", offset=0.6)
    timings.update(phase("Goursat kernels", goursat_kernel_phase, dev))
    pde_launches = phase("PDE serving", pde_serving_phase, dev)
    pde_train = phase("PDE training", pde_training_phase, dev)
    phase("PDE float64", small_float64_pde_check, dev)
    phase("long correctness", long_correctness_phase, dev)
    long_timings = phase("long timing", long_timing_phase, dev)
    gp1 = phase("GunPoint order 1", long_svgp_phase, dev, 1, 6, {
        "serving": ("diag", "tens_seq"),
        "training": ("diag", "tens_seq", "tens_seq_bwd")})
    gp3 = phase("GunPoint order 3", long_svgp_phase, dev, 3, 3, {
        "serving": ("tsg", "sig_gram_ho"),
        "training": ("tsg", "tsg_bwd", "sig_gram_ho", "sig_gram_ho_bwd")})
    gpr150 = phase("GPR L=150", long_gpr_phase, dev)
    phase("long float64", long_float64_check, dev)
    phase("PDE triangle", pde_triangle_check, dev)
    deep_timings = phase("deep levels", deep_levels_phase, dev)
    deep_gpr = phase("deep GPR", deep_gpr_phase, dev)
    phase("Gram side past shared memory", gram_side_phase, dev)
    phase("PEMS-SF SVGP", uea_svgp_phase, dev, "PEMS-SF")
    phase("PEMS-SF float64", wide_order1_svgp_check, dev)
    phase("MotorImagery SVGP", uea_svgp_phase, dev, "MotorImagery")
    phase("sig_gram sweep", sig_gram_sweep_phase, dev)
    phase("deep orders 4-7", deep_orders_phase, dev)
    phase("Goursat past 2^15", goursat_long_phase, dev)
    phase("config 3 SVGP at MotorImagery's shape", sequence_svgp_phase, dev)
    phase("GPR past 1024 rows", long_gram_gpr_phase, dev)
    order_timings, order_gpr = phase("deep orders past 7", order_phase, dev)
    phase("driver entry", entry_phase, dev)
    phase("UEA files", uea_files_phase, dev)
    phase("VOSF at config 6", vosf_config6_phase, dev, card)
    phase("SigGPDE VOSF", sigpde_vosf_phase, dev, card)
    phase("low-rank", lowrank_phase, dev, card)
    phase("Softmax", softmax_phase, dev, card)
    nuts_timings = phase("NUTS at config 5", nuts_config5_phase, dev, card)
    phase("multi-process", parallel_phase, dev, card)
    phase("compat facade", compat_phase, dev, card)

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
    # the long path's launches (L = 150): the order-1 kernels' from the
    # order-1 GPR's steps (Gram, diagonal, backward) and the GunPoint
    # SVGP's serving and steps (Kuf and its backward), the general ones
    # from the order-3 GunPoint SVGP (Kuf, the order-3 diagonal) and the
    # order-2 and Poly GPRs (the general Gram, both sig_grams)
    long_source = dict(
        gram=gpr150["order-1 RBF"], diag=gp1["serving"],
        gram_bwd=gpr150["order-1 RBF"], tens_seq=gp1["serving"],
        tens_seq_bwd=gp1["training"], gram_ho=gpr150["order-2 RBF"],
        gram_ho_bwd=gpr150["order-2 RBF"], tsg=gp3["serving"],
        tsg_bwd=gp3["training"], sig_gram=gpr150["order-1 Poly"],
        sig_gram_bwd=gpr150["order-1 Poly"], sig_gram_ho=gp3["serving"],
        sig_gram_ho_bwd=gp3["training"])
    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        n = source_of.get(key, launches)[key]
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=n, **timings[key])
        if "train" in entry:  # the Kuf at the training shape (N = 50)
            entry["train"] = dict(launches=train_launches[key],
                                  **entry["train"])
        if key in long_timings:
            entry["long"] = dict(launches=long_source[key][key],
                                 **long_timings[key])
        if key in deep_timings:
            # past 7 levels: launches from the num_levels = 10 GPRs
            order = 2 if key.startswith("sig_gram_ho") else 1
            entry["deep"] = dict(launches=deep_gpr[order][key],
                                 **deep_timings[key])
        if key in nuts_timings:
            # BASELINE config 5's chain axis (C = 16, N = 40, L = 20):
            # launches from its NUTS run, a launch for all chains
            entry["nuts"] = nuts_timings[key]
        if key in order_timings:
            # past order 7: launches from the order-8 GPR's Adam step
            entry["order"] = dict(
                launches=order_gpr[key],
                source="gpsig_tpu_torch/csrc/sig_gram_order.cuh",
                **order_timings[key])
        kernels.append(entry)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build's "
          "start to the report")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(parallel_rank(sys.argv[1:]) if len(sys.argv) > 1 else main())
