#!/usr/bin/env python3
"""Check and time variants of sig_gram's run-time-order instance
(``gpsig_tpu_torch/csrc/sig_gram_order.cuh``) on one CUDA card, alone.

    python3 order_probe.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each CSRC_DIR is a copy of ``gpsig_tpu_torch/csrc`` (the first is usually
the package's own, ``gpsig_tpu_torch/csrc``), edited as the variant needs.
For each, only ``sig_gram_order.cu``, ``sig_gram_order_f64.cu`` and a small
C entry point (written here) are compiled, all at once, into a library of
its own under ``gpsig_tpu_torch/.build/order_probe/NAME`` (each nvcc's
register and spill lines printed), so a call costs seconds of nvcc, not
the whole package's build. Every variant is then held against the plain
versions (``ops/signature.py`` through ``ops/cuda/sig_gram.py``) at a few
shapes past order 7, float32 and float64 (scaled error 1e-4 / 1e-12, the
routes that ``plan.sig_gram_order_plan`` picks), and timed at
``chip_smoke.py``'s shape, nl = 8, order 8, the 22,500 increment matrices
of 49 x 49 of 150 sequences' pairs, float32, forward and backward: the
median of 5 launches after one, by CUDA events, the variants in turns
(A, B, ..., B, A). Ends with the card's name and power limit; exits
non-zero without a card or when a check fails. A variant that keeps more
in its workspace than the plan counts runs with
``ORDER_PROBE_WORK_SCALE=N`` in the environment: every call allocates N
times the plan's workspace.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ENTRY = """
#include "sig_gram_order.cuh"
using namespace gpsig;
extern "C" {
int probe_fwd(const void* M, void* out, void* work, int B, int L1, int L2,
              int nl, int order, int S, int R, int bands, int W,
              int area_smem, int blocks, int area, int f64, void* stream) {
  const int P = order < nl ? order : nl;
  const SgArgs a{M, nullptr, out, work, B, L1, L2, nl, P, S, R, bands, W,
                 area_smem, blocks, area};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? sg_fwd_order<double>(a, s) : sg_fwd_order<float>(a, s);
}
int probe_bwd(const void* M, const void* g, void* Mbar, void* work, int B,
              int L1, int L2, int nl, int order, int S, int R, int bands,
              int W, int area_smem, int blocks, int area, int f64,
              void* stream) {
  const int P = order < nl ? order : nl;
  const SgArgs a{M, g, Mbar, work, B, L1, L2, nl, P, S, R, bands, W,
                 area_smem, blocks, area};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? sg_bwd_order<double>(a, s) : sg_bwd_order<float>(a, s);
}
}
"""

#: the workspace a call allocates, in multiples of the plan's (a variant
#: that keeps more than the plan counts asks for more:
#: ORDER_PROBE_WORK_SCALE=N in the environment)
WORK_SCALE = int(os.environ.get("ORDER_PROBE_WORK_SCALE", "1"))

CHECKS = [(4, 20, 49, 8, 8), (4, 20, 49, 10, 8), (5, 7, 5, 12, 8),
          (3, 9, 240, 9, 8), (2, 10, 150, 10, 10), (3, 1, 7, 8, 8),
          (4, 20, 150, 20, 20), (4, 149, 49, 20, 20)]


def build(variants):
    """Each variant's library, compiled from its directory (all nvcc runs
    at once); returns {name: ctypes library}."""
    from gpsig_tpu_torch.ops.cuda import _build

    jobs, outs = [], {}
    for name, src_dir in variants.items():
        src_dir = (ROOT / src_dir).resolve()
        out = ROOT / "gpsig_tpu_torch" / ".build" / "order_probe" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "probe_entry.cu").write_text(ENTRY)
        outs[name] = out
        for src in (src_dir / "sig_gram_order.cu",
                    src_dir / "sig_gram_order_f64.cu", out / "probe_entry.cu"):
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir),
                   "-c", "-o", str(out / f"{src.stem}.o"), str(src)]
            jobs.append((name, src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, src, proc in jobs:
        log = proc.communicate()[0]
        keep = [line.replace("ptxas info    : ", "")
                for line in log.splitlines()
                if "error" in line.lower() or "Used" in line
                or "spill" in line or "Compiling entry" in line]
        print(f"== {name} {src.name} rc {proc.returncode}\n"
              + "\n".join(keep), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(log[-3000:])
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, out in outs.items():
        objs = [str(out / f"{s}.o") for s in
                ("sig_gram_order", "sig_gram_order_f64", "probe_entry")]
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(out / "libprobe.so"), *objs], check=True)
        lib = ctypes.CDLL(str(out / "libprobe.so"))
        lib.probe_fwd.argtypes = [P, P, P] + [I] * 13 + [P]
        lib.probe_bwd.argtypes = [P, P, P, P] + [I] * 13 + [P]
        libs[name] = lib
    return libs


def call(lib, M, g, nl, order, backward):
    """One launch of a variant's forward (or backward) on the plan that
    ``plan.sig_gram_order_plan`` gives the shape; returns (out, plan)."""
    import torch

    from gpsig_tpu_torch.ops.cuda import plan

    B, L1, L2 = M.shape
    lp = plan.sig_gram_order_plan(B, L1, L2, nl, min(order, nl),
                                  M.element_size(), backward)
    work = torch.empty(max(lp["work"], 1) * WORK_SCALE, dtype=M.dtype,
                       device=M.device)
    args = (lp["S"], lp["R"], lp["bands"], lp["W"], int(lp["area_smem"]),
            lp["blocks"], lp["area"], int(M.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if backward:
        out = torch.empty_like(M)
        err = lib.probe_bwd(M.data_ptr(), g.data_ptr(), out.data_ptr(),
                            work.data_ptr(), B, L1, L2, nl, order, *args)
    else:
        out = torch.empty(nl + 1, B, dtype=M.dtype, device=M.device)
        err = lib.probe_fwd(M.data_ptr(), out.data_ptr(), work.data_ptr(),
                            B, L1, L2, nl, order, *args)
    if err:
        raise RuntimeError(f"launch failed ({err}) on {lp}")
    return out, lp


def scaled(a, b):
    return float((a - b).abs().max() / b.abs().max())


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gpsig_tpu_torch.ops.cuda import sig_gram as sg

    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    t0 = time.perf_counter()
    libs = build(variants)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ok = True
    for B, L1, L2, nl, order in CHECKS:
        M_np = 0.4 * rng.standard_normal((B, L1, L2)) / np.sqrt(
            max(L1, L2) / 20)
        g_np = rng.standard_normal((nl + 1, B))
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
            M = torch.as_tensor(M_np, dtype=dtype, device=dev)
            g = torch.as_tensor(g_np, dtype=dtype, device=dev)
            want = (sg.sig_gram_levels_ho_ref(M, nl, order),
                    sg.sig_gram_levels_ho_bwd_ref(M, g, nl, order))
            for name, lib in libs.items():
                (f, lf), (b, lb) = (call(lib, M, g, nl, order, bwd)
                                    for bwd in (False, True))
                errs = scaled(f, want[0]), scaled(b, want[1])
                ok &= max(errs) <= tol
                print(f"{name} [{B}, {L1}, {L2}] nl={nl} order={order} "
                      f"{dtype}: forward {errs[0]:.2e} ({lf['route']}), "
                      f"backward {errs[1]:.2e} ({lb['route']})", flush=True)
    print("checks", "ok" if ok else "FAILED", flush=True)

    x = (0.3 * rng.standard_normal((150, 50, 2))).cumsum(1).reshape(-1, 2)
    sq = (x * x).sum(-1)
    G = np.exp(-0.5 * np.maximum(sq[:, None] + sq[None, :] - 2 * x @ x.T,
                                 0)).reshape(150, 50, 150, 50)
    M = torch.as_tensor(np.diff(np.diff(G.transpose(0, 2, 1, 3), axis=2),
                                axis=3).reshape(-1, 49, 49),
                        dtype=torch.float32, device=dev)
    del G
    g = torch.as_tensor(rng.standard_normal((9, M.shape[0])),
                        dtype=torch.float32, device=dev)
    names = list(libs)
    times = {}
    for backward, name in itertools.product((False, True),
                                            names + names[::-1]):
        def run():
            call(libs[name], M, g, 8, 8, backward)
        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        times.setdefault((name, backward), []).append(statistics.median(ts))
    for (name, backward), turns in times.items():
        print(f"time {'backward' if backward else 'forward'} {name} "
              f"B={M.shape[0]} L'=49 nl=8 order 8 float32: turns "
              f"{[round(t, 4) for t in turns]} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
