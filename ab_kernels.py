#!/usr/bin/env python3
"""Time the truncated-kernel wrappers of two checkouts of this repository on
one CUDA card, in turns (A, B, B, A), so that a kernel change is measured
against its parent within one machine and one card.

    python3 ab_kernels.py PARENT_DIR [CHANGE_DIR]   # CHANGE_DIR: this one
    python3 ab_kernels.py -k TEXT PARENT_DIR [CHANGE_DIR]
    python3 ab_kernels.py --builds PARENT_DIR [CHANGE_DIR]

Each checkout's kernels are built (both builds at once), then each turn
runs in its own process (the two packages share a name), times every case
below in float32 by CUDA events (the median of 7 after 2 warm-ups) and
prints one JSON line; the script ends with the card's name and power limit
and a table of the per-case medians over each checkout's two turns. The
cases are ``chip_smoke.py``'s shapes at L = 50 (the bench Gram, the
flagship diagonal, the general Gram and sig_gram at the shapes of their
serving and training checks), the order-1 Gram and its backward at
L = 150, the general Gram backward at L = 150, the Goursat adjoint at the
SigGPDE joint Gram (82² pairs of 49 x 49 increments, dyadic order 1) and
at 64 pairs of 199 x 199 increments (order 2), sig_gram past 7 levels
(order 1 at num_levels 8), where a parent that refuses the shape reports
null, the general Gram at order 2 and L = 150 and at order 3 and L = 50,
the order-2 flagship's prediction Kuf, the general Gram where the state
takes 2 rows a lane (order 4, and order 3 in float64, at L = 100), the
order-1 Gram at the widest d = 231 that one warp took at L = 50 before
segments, and one Adam step of the order-1 and order-2 RBF GPRs at L = 150
(``chip_smoke.py``'s phase (n): N = 150, nl = 4, the whole step by CUDA
events, host work included); the four Kuf kernels: the general pair at
the L = 150 shapes (T = 64, nl = 4, order 3), its backward at the
training shape, a cosine case without increments and a float64 order-7
case (Poly / Linear, no difference) of each, the order-1 pair at d = 2
and d = 64 (where the parent's backward refused: null), at the flagship's
d = 3 (serving N = 2048 and training N = 50), at the L = 150 shapes
(T = 64, nl = 4, d = 2) and at d = 8, and the general pair at order 1 on
the first five; and one ``predict_y`` on a cached posterior (N_test =
2048) and one flagship natgrad + Adam step at order 2 (d = 2) and order 1
(d = 3), whole calls by CUDA events; the order-1 diagonal at L = 150
(N = 2048, d = 2), at d = 64 (N = 256, L = 50) and at L = 1025 (N = 64,
d = 2); the Goursat forward at the SigGPDE Kuf at prediction (65,536
pairs of 7 x 49 increments, dyadic order 1, and its 14 x 98 refined grid
through the given-grid route), at the joint Gram (82² pairs of 49 x 49,
order 1) and at 64 pairs of 199 x 199 at order 3, and its given-grid
route on the grids refined in memory at order 1 (joint Gram) and 2 (joint
Gram, Kuf, 199 x 199); sig_gram at its redesign's shapes: order 3 at
L' = 149 (B = 2048 forward, B = 50 backward), order 1 at L' = 149
(B = 150), orders 1 and 2 at the num_levels = 10 GPR's Gram (150² pairs of
L' = 49), forward and backward, and the cases the parent refuses (null):
the inducing-sequence Gram at MotorImagery's length (2000 matrices of
2999 x 7), the triangle of a Gram at L = 1300 (21 matrices of 1299 x 1299,
order 2) and order 5 at num_levels = 8; sig_gram past order 7 at its timed
shape (nl = 8, order 8, 22,500 matrices of 49 x 49, forward and
backward) and an Adam step of the order-8 GPR at BASELINE config 1's
L = 50 (N = 150, nl = 8); and, as "kernel alone", the flagship and
L = 150 diagonal and both Goursat Kuf routes by their C entry point's
call (and sig_gram at the flagship diagonal and
the inducing-sequence matrices), recorded once through the wrapper and
replayed with no plan, allocation or check, the kernel's device time by
``torch.profiler`` (median of 7 windows of 10 launches). Every Gram kernel is timed on its full grid
of pairs (no triangle), so that both checkouts do the same work; the GPR
steps go through ``K(X)``, which solves the triangle where the checkout
does.
With ``-k TEXT`` only the cases whose name contains TEXT run.
With ``--builds`` it instead builds each checkout's kernels from
scratch, alone on the machine, in turns A, B, A, and prints each build's
wall time and the sum of its compiles. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (name, function path, argument builder); arrays from a fixed seed
CASES = [
    ("gram L=50 N=256x256 d=2 nl=4", "fused_gram.fused_gram_levels", "gram"),
    ("diag L=50 N=2048 d=3 nl=5", "fused_gram.fused_diag_levels", "diag"),
    ("gram_bwd L=50 N=256x256 d=2 nl=4", "fused_gram.fused_gram_levels_bwd",
     "gram_bwd"),
    ("gram_ho order 2 L=50 N=256x256", "fused_gram_ho.fused_gram_ho_levels",
     "gram_ho"),
    ("gram_ho_bwd order 2 L=50 N=150x150",
     "fused_gram_ho.fused_gram_ho_levels_bwd", "gram_ho_bwd"),
    ("sig_gram order 1 B=2048 L'=49", "sig_gram.sig_gram_levels", "sg1"),
    ("sig_gram order 2 B=2048 L'=49", "sig_gram.sig_gram_levels_ho", "sg2"),
    ("sig_gram_bwd order 1 B=150 L'=49", "sig_gram.sig_gram_levels_bwd",
     "sg1_bwd"),
    ("sig_gram_bwd order 2 B=150 L'=49", "sig_gram.sig_gram_levels_ho_bwd",
     "sg2_bwd"),
    ("gram L=150 N=150x150 d=2 nl=4", "fused_gram.fused_gram_levels",
     "gram150"),
    ("gram_bwd L=150 N=150x150 d=2 nl=4", "fused_gram.fused_gram_levels_bwd",
     "gram_bwd150"),
    ("gram_ho_bwd order 2 L=150 N=64x64",
     "fused_gram_ho.fused_gram_ho_levels_bwd", "gram_ho_bwd150"),
    ("goursat_grad joint Gram 82x82 pairs 49x49 o=1",
     "goursat.goursat_grad_refined", "goursat_joint"),
    ("goursat_grad 64 pairs 199x199 o=2", "goursat.goursat_grad_refined",
     "goursat199"),
    ("sig_gram order 1 B=2048 L'=49 nl=8", "sig_gram.sig_gram_levels",
     "sg1_nl8"),
    ("sig_gram_bwd order 1 B=150 L'=49 nl=8",
     "sig_gram.sig_gram_levels_bwd", "sg1_bwd_nl8"),
    ("gram_ho order 2 L=150 N=150x150", "fused_gram_ho.fused_gram_ho_levels",
     "gram_ho150"),
    ("gram_ho order 3 L=50 N=256x256", "fused_gram_ho.fused_gram_ho_levels",
     "gram_ho3"),
    ("tsg order 2 T=500 N=2048 L=50 nl=5",
     "tens_seq_general.fused_tens_seq_general_levels", "tsg"),
    ("gram_ho order 4 L=100 N=256x256", "fused_gram_ho.fused_gram_ho_levels",
     "gram_ho4_100"),
    ("gram_ho order 3 L=100 N=256x256 f64",
     "fused_gram_ho.fused_gram_ho_levels", "gram_ho3_100_f64"),
    ("gram L=50 N=64x64 d=231 nl=4", "fused_gram.fused_gram_levels",
     "gram_wide"),
    ("GPR Adam step order 1 RBF L=150 N=150", "step", "gpr1"),
    ("GPR Adam step order 2 RBF L=150 N=150", "step", "gpr2"),
    ("tsg order 3 T=64 N=2048 L=150 nl=4",
     "tens_seq_general.fused_tens_seq_general_levels", "tsg150"),
    ("tsg cosine no increments T=500 N=2048 L=50",
     "tens_seq_general.fused_tens_seq_general_levels", "tsg_cos"),
    ("tsg poly2 order 7 no difference f64 T=100 N=512",
     "tens_seq_general.fused_tens_seq_general_levels", "tsg_poly7"),
    ("tsg_bwd order 2 T=500 N=50 L=50 nl=5",
     "tens_seq_general.tens_seq_general_bwd", "tsg_bwd"),
    ("tsg_bwd order 3 T=64 N=50 L=150 nl=4",
     "tens_seq_general.tens_seq_general_bwd", "tsg_bwd150"),
    ("tsg_bwd cosine no increments T=500 N=50",
     "tens_seq_general.tens_seq_general_bwd", "tsg_bwd_cos"),
    ("tsg_bwd linear order 7 no difference f64 T=100 N=50",
     "tens_seq_general.tens_seq_general_bwd", "tsg_bwd_lin7"),
    ("tens_seq T=500 N=2048 L=50 d=2 nl=5", "tens_seq.fused_tens_seq_levels",
     "ts"),
    ("tens_seq T=500 N=2048 L=50 d=64 nl=5", "tens_seq.fused_tens_seq_levels",
     "ts64"),
    ("tens_seq_bwd T=500 N=50 L=50 d=2 nl=5", "tens_seq.tens_seq_bwd",
     "ts_bwd"),
    ("tens_seq_bwd T=500 N=50 L=50 d=64 nl=5", "tens_seq.tens_seq_bwd",
     "ts_bwd64"),
    ("predict_y order 2 cached posterior N=2048", "step", "predict2"),
    ("SVGP natgrad+Adam step order 2 B=50", "step", "svgp2"),
    ("tens_seq T=500 N=2048 L=50 d=3 nl=5", "tens_seq.fused_tens_seq_levels",
     "ts3"),
    ("tens_seq T=500 N=50 L=50 d=3 nl=5", "tens_seq.fused_tens_seq_levels",
     "ts3_train"),
    ("tens_seq T=64 N=2048 L=150 d=2 nl=4", "tens_seq.fused_tens_seq_levels",
     "ts150"),
    ("tens_seq_bwd T=500 N=50 L=50 d=3 nl=5", "tens_seq.tens_seq_bwd",
     "ts_bwd3"),
    ("tens_seq_bwd T=64 N=50 L=150 d=2 nl=4", "tens_seq.tens_seq_bwd",
     "ts_bwd150"),
    ("tens_seq T=500 N=2048 L=50 d=8 nl=5", "tens_seq.fused_tens_seq_levels",
     "ts8"),
    ("tens_seq_bwd T=500 N=50 L=50 d=8 nl=5", "tens_seq.tens_seq_bwd",
     "ts_bwd8"),
    ("tsg order 1 T=500 N=2048 L=50 d=3 nl=5",
     "tens_seq_general.fused_tens_seq_general_levels", "tsg_ts3"),
    ("tsg order 1 T=500 N=50 L=50 d=3 nl=5",
     "tens_seq_general.fused_tens_seq_general_levels", "tsg_ts3_train"),
    ("tsg order 1 T=64 N=2048 L=150 d=2 nl=4",
     "tens_seq_general.fused_tens_seq_general_levels", "tsg_ts150"),
    ("tsg_bwd order 1 T=500 N=50 L=50 d=3 nl=5",
     "tens_seq_general.tens_seq_general_bwd", "tsg_bwd_ts3"),
    ("tsg_bwd order 1 T=64 N=50 L=150 d=2 nl=4",
     "tens_seq_general.tens_seq_general_bwd", "tsg_bwd_ts150"),
    ("predict_y order 1 cached posterior N=2048 d=3", "step", "predict1"),
    ("SVGP natgrad+Adam step order 1 B=50 d=3", "step", "svgp1"),
    ("diag L=50 N=2048 d=3 nl=5 kernel alone",
     "alone:fused_gram.fused_diag_levels", "diag"),
    ("diag L=150 N=2048 d=2 nl=4", "fused_gram.fused_diag_levels", "diag150"),
    ("diag L=150 N=2048 d=2 nl=4 kernel alone",
     "alone:fused_gram.fused_diag_levels", "diag150"),
    ("diag L=50 N=256 d=64 nl=5", "fused_gram.fused_diag_levels", "diag64"),
    ("diag L=1025 N=64 d=2 nl=4", "fused_gram.fused_diag_levels",
     "diag1025"),
    ("goursat_fused Kuf 65536 pairs 7x49 o=1",
     "goursat.goursat_corner_refined", "goursat_kuf"),
    ("goursat_fused Kuf 65536 pairs 7x49 o=1 kernel alone",
     "alone:goursat.goursat_corner_refined", "goursat_kuf"),
    ("goursat given grid Kuf 65536 pairs 14x98",
     "goursat.goursat_corner_fast", "goursat_kuf_fine"),
    ("goursat given grid Kuf 65536 pairs 14x98 kernel alone",
     "alone:goursat.goursat_corner_fast", "goursat_kuf_fine"),
    ("goursat_fused joint Gram 82x82 pairs 49x49 o=1",
     "goursat.goursat_corner_refined", "goursat_joint_fwd"),
    ("goursat_fused 64 pairs 199x199 o=3", "goursat.goursat_corner_refined",
     "goursat199_o3"),
    ("goursat given grid joint Gram 82x82 pairs 98x98",
     "goursat.goursat_corner_fast", "goursat_joint_fine"),
    ("goursat given grid joint Gram 82x82 pairs 196x196",
     "goursat.goursat_corner_fast", "goursat_joint_fine2"),
    ("goursat given grid Kuf 65536 pairs 28x196",
     "goursat.goursat_corner_fast", "goursat_kuf_fine2"),
    ("goursat given grid 64 pairs 796x796", "goursat.goursat_corner_fast",
     "goursat199_fine2"),
    ("sig_gram order 3 B=2048 L'=149 nl=4", "sig_gram.sig_gram_levels_ho",
     "sg3_149"),
    ("sig_gram_bwd order 3 B=50 L'=149 nl=4",
     "sig_gram.sig_gram_levels_ho_bwd", "sg3_bwd_149"),
    ("sig_gram order 1 B=150 L'=149 nl=4", "sig_gram.sig_gram_levels",
     "sg1_149"),
    ("sig_gram_bwd order 1 B=150 L'=149 nl=4", "sig_gram.sig_gram_levels_bwd",
     "sg1_bwd_149"),
    ("sig_gram order 1 B=22500 L'=49 nl=10", "sig_gram.sig_gram_levels",
     "sg1_nl10"),
    ("sig_gram order 2 B=22500 L'=49 nl=10", "sig_gram.sig_gram_levels_ho",
     "sg2_nl10"),
    ("sig_gram_bwd order 1 B=22500 L'=49 nl=10",
     "sig_gram.sig_gram_levels_bwd", "sg1_bwd_nl10"),
    ("sig_gram_bwd order 2 B=22500 L'=49 nl=10",
     "sig_gram.sig_gram_levels_ho_bwd", "sg2_bwd_nl10"),
    ("sig_gram order 1 B=2000 [2999, 7] nl=4", "sig_gram.sig_gram_levels",
     "sg1_seq"),
    ("sig_gram_bwd order 1 B=2000 [2999, 7] nl=4",
     "sig_gram.sig_gram_levels_bwd", "sg1_bwd_seq"),
    ("sig_gram order 2 B=21 L'=1299 nl=4", "sig_gram.sig_gram_levels_ho",
     "sg2_1299"),
    ("sig_gram_bwd order 2 B=21 L'=1299 nl=4",
     "sig_gram.sig_gram_levels_ho_bwd", "sg2_bwd_1299"),
    ("sig_gram order 5 B=2048 L'=49 nl=8", "sig_gram.sig_gram_levels_ho",
     "sg5_nl8"),
    ("sig_gram order 2 B=2048 L'=49 kernel alone",
     "alone:sig_gram.sig_gram_levels_ho", "sg2"),
    ("sig_gram order 1 B=2000 [2999, 7] nl=4 kernel alone",
     "alone:sig_gram.sig_gram_levels", "sg1_seq"),
    ("sig_gram order 8 B=22500 L'=49 nl=8", "sig_gram.sig_gram_levels_ho",
     "sg8_nl8"),
    ("sig_gram_bwd order 8 B=22500 L'=49 nl=8",
     "sig_gram.sig_gram_levels_ho_bwd", "sg8_bwd_nl8"),
    ("GPR Adam step order 8 RBF L=50 N=150 nl=8", "step", "gpr8"),
]


def _walks(rng, n, L, d):
    import numpy as np

    return (0.3 * np.sqrt(50 / L) * rng.standard_normal((n, L, d))).cumsum(1)


def _args(kind, torch, dev):
    import numpy as np

    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def self_inc(X):
        sq = np.sum(X * X, -1)
        G = np.exp(-0.5 * (sq[:, :, None] + sq[:, None, :]
                           - 2 * X @ X.transpose(0, 2, 1)))
        return np.diff(np.diff(G, axis=1), axis=2)

    x256 = t(_walks(rng, 256, 50, 2))
    if kind == "gram":
        return (x256, x256, 4, True)
    if kind == "diag":
        return (t(_walks(rng, 2048, 50, 3)), 5, True)
    if kind in ("diag150", "diag64", "diag1025"):
        n, L, d, nl = {"diag150": (2048, 150, 2, 4),
                       "diag64": (256, 50, 64, 5),
                       "diag1025": (64, 1025, 2, 4)}[kind]
        return (t(_walks(rng, n, L, d) * np.sqrt(2 / d)), nl, True)
    if kind in ("goursat_joint_fine", "goursat_joint_fine2",
                "goursat_kuf_fine2", "goursat199_fine2"):
        # chip_smoke.py's given-grid route at dyadic order 1 and 2: the
        # grids refined in memory
        base, o = {"goursat_joint_fine": ("goursat_joint_fwd", 1),
                   "goursat_joint_fine2": ("goursat_joint_fwd", 2),
                   "goursat_kuf_fine2": ("goursat_kuf", 2),
                   "goursat199_fine2": ("goursat199_o3", 2)}[kind]
        inc = _args(base, torch, dev)[0].cpu().numpy()
        fine = np.repeat(np.repeat(inc, 1 << o, 1), 1 << o, 2) / 4**o
        return (t(fine),)
    if kind in ("goursat_kuf", "goursat_kuf_fine"):
        # the SigGPDE Kuf at prediction: 32 inducing sequences of length 8
        # against 2048 test sequences of L = 50 (Linear base, lengthscale
        # 1.5), dyadic order 1; refined in memory for the given-grid route
        dz = np.diff(_walks(rng, 32, 8, 2) / 1.5, axis=1)
        dx = np.diff(_walks(rng, 2048, 50, 2) / 1.5, axis=1)
        inc = np.einsum("nid,mjd->nmij", dz, dx).reshape(-1, 7, 49)
        if kind == "goursat_kuf":
            return (t(inc), 1)
        fine = np.repeat(np.repeat(inc, 2, 1), 2, 2) / 4
        return (t(fine),)
    if kind == "gram_bwd":
        return (x256, x256, t(rng.standard_normal((5, 256, 256))), 4, True)
    if kind in ("gram_ho", "gram_ho3"):
        return (x256, x256, 4, 2 if kind == "gram_ho" else 3, "rbf", True)
    if kind in ("gram_ho4_100", "gram_ho3_100_f64"):
        x = torch.as_tensor(_walks(rng, 256, 100, 2), device=dev,
                            dtype=torch.float32 if kind == "gram_ho4_100"
                            else torch.float64)
        return (x, x, 4, 4 if kind == "gram_ho4_100" else 3, "rbf", True)
    if kind == "gram_wide":
        x = t(_walks(rng, 64, 50, 231) * np.sqrt(2 / 231))
        return (x, x, 4, True)
    if kind in ("gpr1", "gpr2"):
        return (_gpr_step(torch, dev, int(kind[-1])),)
    if kind == "gpr8":
        return (_gpr_step(torch, dev, 8, L=50, nl=8),)
    if kind in ("predict2", "svgp2"):
        return (_svgp_call(torch, dev, kind == "svgp2", order=2, d=2),)
    if kind in ("predict1", "svgp1"):
        return (_svgp_call(torch, dev, kind == "svgp1", order=1, d=3),)
    if kind in _KUF_SHAPES:
        return _kuf_args(kind, torch, dev, rng)
    if kind == "tsg":
        # the order-2 flagship's prediction Kuf: 500 inducing tensors with
        # increments (F = 15 factors) against 2048 sequences, d = 2
        x = _walks(rng, 2048, 50, 2)
        inc = np.diff(x, axis=1).reshape(-1, 2)
        z = inc[rng.integers(0, len(inc), 500 * 15 * 2)].reshape(
            500, 15, 2, 2)
        return (t(z), t(x), 5, 2, "rbf", True, True)
    if kind == "gram_ho_bwd":
        x = x256[:150].contiguous()
        return (x, x, t(rng.standard_normal((5, 150, 150))), 4, 2, "rbf",
                True)
    if kind in ("sg1", "sg2", "sg1_nl8"):
        m = t(self_inc(_walks(rng, 2048, 50, 2)))
        return {"sg1": (m, 5), "sg2": (m, 5, 2), "sg1_nl8": (m, 8)}[kind]
    if kind in ("sg1_bwd", "sg2_bwd", "sg1_bwd_nl8"):
        m = t(self_inc(_walks(rng, 150, 50, 2)))
        if kind == "sg1_bwd_nl8":
            return (m, t(rng.standard_normal((9, 150))), 8)
        g = t(rng.standard_normal((5, 150)))
        return (m, g, 4) if kind == "sg1_bwd" else (m, g, 4, 2)
    if kind in ("sg3_149", "sg3_bwd_149", "sg1_149", "sg1_bwd_149"):
        n = {"sg3_149": 2048, "sg3_bwd_149": 50}.get(kind, 150)
        m = t(self_inc(_walks(rng, n, 150, 2)))
        g = t(rng.standard_normal((5, n)))
        return {"sg3_149": (m, 4, 3), "sg3_bwd_149": (m, g, 4, 3),
                "sg1_149": (m, 4), "sg1_bwd_149": (m, g, 4)}[kind]
    if kind in ("sg8_nl8", "sg8_bwd_nl8"):
        # chip_smoke.py's timed shape past order 7: the order-8 GPR's Gram
        # at num_levels = 8 (every pair of 150 sequences)
        m = _args("sg1_nl10", torch, dev)[0]
        if kind == "sg8_nl8":
            return (m, 8, 8)
        return (m, t(rng.standard_normal((9, m.shape[0]))), 8, 8)
    if kind in ("sg1_nl10", "sg2_nl10", "sg1_bwd_nl10", "sg2_bwd_nl10"):
        # the num_levels = 10 GPR's Gram: every pair of 150 sequences
        x = _walks(rng, 150, 50, 2).reshape(-1, 2)
        sq = np.sum(x * x, -1)
        G = np.exp(-0.5 * (sq[:, None] + sq[None, :] - 2 * x @ x.T))
        G = G.reshape(150, 50, 150, 50).transpose(0, 2, 1, 3)
        m = t(np.diff(np.diff(G, axis=2), axis=3).reshape(-1, 49, 49))
        del G
        g = t(rng.standard_normal((11, m.shape[0])))
        o = 2 if "sg2" in kind else 1
        if "bwd" in kind:
            return (m, g, 10) if o == 1 else (m, g, 10, 2)
        return (m, 10) if o == 1 else (m, 10, 2)
    if kind in ("sg1_seq", "sg1_bwd_seq"):
        # 40 inducing sequences of length 8 against a batch of 50 at L =
        # 3000, the shorter side on the rows
        m = t(rng.standard_normal((2000, 2999, 7)) * 0.02)
        if kind == "sg1_seq":
            return (m, 4)
        return (m, t(rng.standard_normal((5, 2000))), 4)
    if kind in ("sg2_1299", "sg2_bwd_1299"):
        # the triangle of a Gram of 6 sequences of L = 1300
        m = t(self_inc(_walks(rng, 21, 1300, 2)))
        if kind == "sg2_1299":
            return (m, 4, 2)
        return (m, t(rng.standard_normal((5, 21))), 4, 2)
    if kind == "sg5_nl8":
        return (t(self_inc(_walks(rng, 2048, 50, 2))), 8, 5)
    if kind in ("goursat_joint", "goursat199", "goursat_joint_fwd",
                "goursat199_o3"):
        # the PDE kernel's increments (Linear base, lengthscale 1.5) of every
        # pair of 82 sequences of L = 50, or 64 pairs of L = 200
        joint = kind.startswith("goursat_joint")
        n, L, o = (82, 50, 1) if joint else (16, 200, 2)
        dx = np.diff(_walks(rng, n, L, 2) / 1.5, axis=1)
        a, b = (dx, dx) if joint else (dx[:8], dx[8:])
        inc = np.einsum("nid,mjd->nmij", a, b).reshape(-1, L - 1, L - 1)
        if kind == "goursat_joint_fwd":
            return (t(inc), 1)
        if kind == "goursat199_o3":
            return (t(inc), 3)
        return (t(inc), o, t(rng.standard_normal(inc.shape[0])))
    if kind == "gram_ho_bwd150":
        x = t(_walks(rng, 64, 150, 2))
        return (x, x, t(rng.standard_normal((5, 64, 64))), 4, 2, "rbf",
                True)
    x150 = t(_walks(rng, 150, 150, 2))
    if kind == "gram150":
        return (x150, x150, 4, True)
    if kind == "gram_ho150":
        return (x150, x150, 4, 2, "rbf", True)
    return (x150, x150, t(rng.standard_normal((5, 150, 150))), 4, True)


_KUF_SHAPES = {  # T, N, L, d, nl, order, kind, increments, difference, f64
    "tsg150": (64, 2048, 150, 2, 4, 3, "rbf", True, True, False),
    "tsg_cos": (500, 2048, 50, 2, 5, 2, "cosine", False, True, False),
    "tsg_poly7": (100, 512, 50, 2, 7, 7, "poly2", True, False, True),
    "tsg_bwd": (500, 50, 50, 2, 5, 2, "rbf", True, True, False),
    "tsg_bwd150": (64, 50, 150, 2, 4, 3, "rbf", True, True, False),
    "tsg_bwd_cos": (500, 50, 50, 2, 5, 2, "cosine", False, True, False),
    "tsg_bwd_lin7": (100, 50, 50, 2, 7, 7, "linear", True, False, True),
    "ts": (500, 2048, 50, 2, 5, 1, "rbf", True, True, False),
    "ts64": (500, 2048, 50, 64, 5, 1, "rbf", True, True, False),
    "ts_bwd": (500, 50, 50, 2, 5, 1, "rbf", True, True, False),
    "ts_bwd64": (500, 50, 50, 64, 5, 1, "rbf", True, True, False),
    "ts3": (500, 2048, 50, 3, 5, 1, "rbf", True, True, False),
    "ts3_train": (500, 50, 50, 3, 5, 1, "rbf", True, True, False),
    "ts150": (64, 2048, 150, 2, 4, 1, "rbf", True, True, False),
    "ts_bwd3": (500, 50, 50, 3, 5, 1, "rbf", True, True, False),
    "ts_bwd150": (64, 50, 150, 2, 4, 1, "rbf", True, True, False),
    "ts8": (500, 2048, 50, 8, 5, 1, "rbf", True, True, False),
    "ts_bwd8": (500, 50, 50, 8, 5, 1, "rbf", True, True, False),
}
# the general kernels at order 1 on the order-1 pair's shapes
for _k in ("ts3", "ts3_train", "ts150", "ts_bwd3", "ts_bwd150"):
    _KUF_SHAPES["tsg_" + _k.replace("ts_bwd", "bwd_ts")] = _KUF_SHAPES[_k]


def _kuf_args(kind, torch, dev, rng):
    """The Kuf cases: inducing tensors drawn from the data's increments,
    pairs with ``increments`` (stacked as the model's), cotangents for the
    backwards."""
    import numpy as np

    T, N, L, d, nl, order, base, inc, diff, f64 = _KUF_SHAPES[kind]
    dtype = torch.float64 if f64 else torch.float32
    x = _walks(rng, N, L, d) * np.sqrt(2 / d)
    steps = np.diff(x, axis=1).reshape(-1, d)
    F = nl * (nl + 1) // 2
    z = steps[rng.integers(0, len(steps), T * F * (2 if inc else 1))]
    z = z.reshape((T, F, 2, d) if inc else (T, F, d))
    if base.startswith("poly"):
        z = np.concatenate([z, np.full(z.shape[:-1] + (1,), 0.6)], -1)
        x = np.concatenate([x, np.ones(x.shape[:-1] + (1,))], -1)
    z, x = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (z, x))
    g = torch.as_tensor(rng.standard_normal((nl + 1, T, N)), dtype=dtype,
                        device=dev)
    if kind.startswith("tsg_bwd"):
        return (z, x, g, nl, order, base, inc, diff)
    if kind.startswith("tsg"):
        return (z, x, nl, order, base, inc, diff)
    if kind.startswith("ts_bwd"):
        return (z, x, g, nl, True, inc)
    return (z, x, nl, True, inc)


def _svgp_call(torch, dev, train, order, d):
    """The flagship SVGP at ``order`` and width d (``chip_smoke.py``'s: M =
    500 inducing tensors with increments from the data, nl = 5, L = 50,
    C = 10, N_train = 500; order 2 at d = 2, order 1 at the reference's
    d = 3), float32: ``predict_y`` of 2048 test sequences on a cached
    posterior, or (``train``) one natgrad + Adam step on a batch of 50
    (Adam 1e-3, γ = 0.05)."""
    import numpy as np

    from gpsig_tpu_torch.inducing import make_inducing_tensors_from_data
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.likelihoods import MultiClass
    from gpsig_tpu_torch.models.svgp import SVGP
    from gpsig_tpu_torch.training.loop import make_step_fn

    f32 = torch.float32
    rng = np.random.default_rng(1)
    X = torch.as_tensor((0.3 * rng.standard_normal((500, 50, d))).cumsum(1),
                        dtype=f32, device=dev)
    Y = torch.as_tensor(rng.integers(0, 10, 500), device=dev)
    kern = SignatureRBF(d, 5, normalization=True, order=order, dtype=f32,
                        device=dev)
    feat = make_inducing_tensors_from_data(
        torch.Generator().manual_seed(0), X, num_tensors=500, num_levels=5,
        num_features=d, increments=True)
    model = SVGP.create(kern, MultiClass(10), feat, num_latent=10, dtype=f32,
                        device=dev)
    if train:
        step = make_step_fn(1e-3, num_data=500, gamma=0.05)
        state = [step.init(model)]
        idx = torch.as_tensor(rng.choice(500, 50, replace=False), device=dev)

        def call():
            state[0], _ = step(state[0], X[idx], Y[idx])
        return call
    Xtest = torch.as_tensor((0.3 * rng.standard_normal((2048, 50, d))
                             ).cumsum(1), dtype=f32, device=dev)
    with torch.no_grad():
        post = model.posterior()

    def call():
        with torch.no_grad():
            post.predict_y(Xtest)
    return call


def _gpr_step(torch, dev, order, L=150, nl=4):
    """One Adam step (lr 5e-2) on -log_marginal_likelihood of an exact RBF
    GPR, float32: regression_sequences(seed=0, N=200, L, d=2), 150 to
    train, noise 0.05; L = 150 and nl = 4, or BASELINE config 1's L = 50
    at nl = 8, order 8 (the Gram through sig_gram past order 7)."""
    from gpsig_tpu_torch.config import precise_linalg
    from gpsig_tpu_torch.data.synthetic import regression_sequences
    from gpsig_tpu_torch.kernels.signature import SignatureRBF
    from gpsig_tpu_torch.models.gpr import GPR

    f32 = torch.float32
    Xn, yn = regression_sequences(seed=0, N=200, L=L, d=2)
    X = torch.as_tensor(Xn[:150], dtype=f32, device=dev)
    Y = torch.as_tensor(yn[:150], dtype=f32, device=dev)
    kern = SignatureRBF(2, nl, lengthscales=1.0, normalization=True,
                        order=order, dtype=f32, device=dev)
    gpr = GPR.create(kern, noise_variance=0.05, dtype=f32, device=dev)
    opt = torch.optim.Adam(gpr.parameters(), lr=5e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        with precise_linalg():
            loss = -gpr.log_marginal_likelihood(X, Y)
            loss.backward()
        opt.step()

    return step


def _cases(text):
    """The cases whose name contains ``text`` (every case for None)."""
    return [c for c in CASES if text is None or text in c[0]]


def _turn(root, text=None):
    """Time the cases (:func:`_cases`) with the package under ``root``; one
    JSON line."""
    import importlib

    import torch

    sys.path.insert(0, str(root))
    dev = torch.device("cuda", 0)
    out = {}
    for name, path, kind in _cases(text):
        if path == "step":
            def f(step):
                step()
        else:
            mod, fn = path.removeprefix("alone:").rsplit(".", 1)
            f = getattr(importlib.import_module(
                f"gpsig_tpu_torch.ops.cuda.{mod}"), fn)
        args = _args(kind, torch, dev)
        try:
            f(*args)
        except (ValueError, RuntimeError):  # a shape the checkout refuses
            # (before the launch plans, the Kuf backwards' launch returned
            # an error past their shared memory)
            out[name] = None
            continue
        if path.startswith("alone:"):
            out[name] = _direct_launch(f, args, torch, dev)
            continue
        for _ in range(2):
            f(*args)
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = statistics.median(times)
    print(json.dumps(out))


def _direct_launch(f, args, torch, dev):
    """The kernel alone: the C entry point's call that the wrapper ``f``
    makes on ``args``, recorded once, then replayed with no plan,
    allocation or check; returns the device time of one launch (ms) by
    ``torch.profiler`` over 10 replays, the median of 7 such windows."""
    from torch.profiler import ProfilerActivity, profile

    from gpsig_tpu_torch.ops.cuda import _build

    calls = []
    launch = _build.launch

    def record(entry, device, *a):
        calls.append((entry, a))
        return launch(entry, device, *a)

    _build.launch = record
    try:
        keep = f(*args)  # the outputs stay alive while the replays write
    finally:
        _build.launch = launch
    entry, a = calls[-1]
    fn = getattr(_build.library(), entry)
    c_args = [x.data_ptr() if torch.is_tensor(x) else int(x) for x in a]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(2):
        fn(*c_args, stream)
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(*c_args, stream)
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA"))
        times.append(us / 1e3 / 10)
    del keep
    return statistics.median(times)


def _build_turns(roots):
    """Each checkout's kernels built from scratch, one build at a time, in
    turns A, B, A: the wall time and the sum of the per-source compile
    times (from the build's log)."""
    import shutil
    import time

    for label in ("A", "B", "A"):
        build_dir = roots[label] / "gpsig_tpu_torch" / ".build"
        shutil.rmtree(build_dir, ignore_errors=True)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             "sys.argv[1]); from gpsig_tpu_torch.ops.cuda import _build; "
             "_build.build()", str(roots[label])], check=True)
        wall = time.perf_counter() - t0
        log = next(build_dir.glob("*.log")).read_text().splitlines()
        compiles = sum(float(line.rsplit(": ", 1)[1][:-2]) for line in log
                       if line.endswith(" s") and ".cu: " in line)
        print(f"build {label}: wall {wall:.1f} s, compiles sum "
              f"{compiles:.1f} s", flush=True)


def main():
    import torch

    if len(sys.argv) in (3, 4) and sys.argv[1] == "--turn":
        _turn(Path(sys.argv[2]).resolve(), *sys.argv[3:])
        return 0
    builds = sys.argv[1:2] == ["--builds"]
    args = sys.argv[1 + builds:]
    text = None
    if not builds and args[:1] == ["-k"] and len(args) > 1:
        text, args = args[1], args[2:]
    if not torch.cuda.is_available() or len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(args[0]).resolve(),
             "B": Path(args[1] if len(args) == 2 else
                       Path(__file__).parent).resolve()}
    if builds:
        _build_turns(roots)
        return 0
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from gpsig_tpu_torch.ops.cuda import _build; _build.build()",
         str(root)]) for root in roots.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    runs = {"A": [], "B": []}
    for label in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, __file__, "--turn",
                               str(roots[label]),
                               *([text] if text is not None else [])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        print(f"turn {label}: {proc.stdout.strip()}")
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(f"{'case':40s} {'A ms':>10s} {'B ms':>10s} {'B/A':>6s}")
    for name, _, _ in _cases(text):
        med = {k: [r[name] for r in v] for k, v in runs.items()}
        a = None if None in med["A"] else statistics.median(med["A"])
        b = None if None in med["B"] else statistics.median(med["B"])
        ratio = f"{b / a:6.3f}" if a and b else "     -"
        print(f"{name:40s} {a if a is None else round(a, 4)!s:>10s} "
              f"{b if b is None else round(b, 4)!s:>10s} {ratio}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
