#!/usr/bin/env python3
"""Time the order-1 Kuf kernels (``csrc/tens_seq.cuh``,
``csrc/tens_seq_bwd.cuh``) alone, as built and in design variants made by
text edits of their sources, on one CUDA card.

    python3 kuf_variants.py

Each variant's four order-1 sources (float32 and float64, forward and
backward) are compiled into a library of their own under
``gpsig_tpu_torch/.build/variants/`` (all at once, with a stub
``gpsig_error_string``), loaded with ``ctypes`` and launched directly on
the card, without the wrappers' transpose and host work, at the
five shapes of ``ab_kernels.py`` (the flagship's d = 3 at N = 2048 and
N = 50, and the L = 150 shapes), float32, CUDA events, the median of 7
after 2 warm-ups, each variant checked against the plain version first.
The variants: ``expf`` (e^a by ``expf``, no log2(e) fold), ``regcap``
(the forward capped at 168 registers, three blocks an SM), ``points4``
(the backward at 4 DP points a lane, chunks of 128) and ``warps4`` (the
backward in blocks of four warps). It prints the card's name and power
limit, each variant's registers and spills of the flagship instances
(nvcc's ptxas report), the instruction mix of the as-built flagship
forward (``cuobjdump -sass``) and one line of times a variant. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = ("tens_seq.cu", "tens_seq_f64.cu", "tens_seq_bwd.cu",
           "tens_seq_bwd_f64.cu")
FWD_BOUNDS = "__global__ void __launch_bounds__(kMaxThreads)\nts_kernel"
# name: (edits as (file, old, new), backward threads a block)
VARIANTS = {
    "as built": ((), 64),
    "expf": ((("common.cuh",
               'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));',
               "r = expf(a);"),
              ("common.cuh",
               "return sizeof(T) == 4 ? T(1.4426950408889634) : T(1);",
               "return T(1);")), 64),
    "regcap": ((("tens_seq.cuh", FWD_BOUNDS,
                 FWD_BOUNDS.replace("(kMaxThreads)", "(kMaxThreads, 3)")),),
               64),
    "points4": ((("tens_seq_bwd.cuh", "constexpr int kPoints = 2;",
                  "constexpr int kPoints = 4;"),), 64),
    "warps4": ((("tens_seq_bwd.cuh", "constexpr int kThreads = 64;",
                 "constexpr int kThreads = 128;"),), 128),
}
FLAGSHIP = ("ts_kernel<float, 5, true, false>",
            "ts_bwd_kernel<float, 5, true>")
SHAPES = ("ts3", "ts150", "ts3_train", "ts_bwd3", "ts_bwd150")


def build(name, edits, build_dir, nvcc, flags):
    """Start compiling the variant's sources (copied and edited); returns
    the compile processes and the variant's directory."""
    src = build_dir / name.replace(" ", "_")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "gpsig_tpu_torch" / "csrc", src)
    for f, old, new in edits:
        text = (src / f).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {f} has no {old!r}")
        (src / f).write_text(text.replace(old, new))
    (src / "stub.cu").write_text(
        '#include <cuda_runtime.h>\nextern "C" const char* '
        "gpsig_error_string(int e) { return cudaGetErrorString("
        "static_cast<cudaError_t>(e)); }\n")
    procs = [subprocess.Popen(
        [nvcc, *flags, "-c", "-o", str(src / f"{f}.o"), str(src / f)],
        stdout=open(src / f"{f}.log", "w"), stderr=subprocess.STDOUT)
        for f in (*SOURCES, "stub.cu")]
    return procs, src


def ptxas_lines(src):
    """Registers and spills of the flagship instances, from ptxas."""
    out = []
    for log in sorted(src.glob("tens_seq*.cu.log")):
        lines = log.read_text().splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if not m:
                continue
            name = subprocess.run(["c++filt", m.group(1)], text=True,
                                  capture_output=True).stdout.strip()
            if any(k in name for k in FLAGSHIP):
                info = [ln.split("ptxas info    :")[-1].strip()
                        for ln in lines[i + 1:i + 4]
                        if "registers" in ln or "spill" in ln]
                out.append(f"{name.split('(')[0]}: {'; '.join(info)}")
    return out


def sass_mix(obj):
    """Instruction counts of the flagship forward in an object file."""
    sass = subprocess.run(["cuobjdump", "-sass", str(obj)], text=True,
                          capture_output=True).stdout
    for fun in re.split(r"\n\s*Function : ", sass)[1:]:
        head = fun.split("\n", 1)[0].strip()
        name = subprocess.run(["c++filt", head], text=True,
                              capture_output=True).stdout.strip()
        if FLAGSHIP[0] not in name:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", fun)
        counts = {k: ops.count(k) for k in ("MUFU", "FFMA", "FADD", "FMUL",
                                            "LDS", "LDG")}
        return f"{FLAGSHIP[0]}: {len(ops)} instructions, {counts}"
    return "flagship forward not found"


def main():
    import torch

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ab_kernels
    from gpsig_tpu_torch.ops.cuda import _build, plan
    from gpsig_tpu_torch.ops.cuda import tens_seq as ts

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build_dir = ROOT / "gpsig_tpu_torch" / ".build" / "variants"
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {name: build(name, edits, build_dir, nvcc, _build.NVCC_FLAGS)
            for name, (edits, _) in VARIANTS.items()}
    libs = {}
    for name, (procs, src) in jobs.items():
        if any(p.wait() != 0 for p in procs):
            print(f"variant {name}: nvcc failed; see {src}", file=sys.stderr)
            return 1
        lib = src / "libvariant.so"
        objs = [str(src / f"{f}.o") for f in (*SOURCES, "stub.cu")]
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib),
                        *objs], check=True)
        lib = ctypes.CDLL(str(lib))
        for fn in ("gpsig_tens_seq", "gpsig_tens_seq_bwd"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        for line in ptxas_lines(src):
            print(f"ptxas {name}: {line}")
    print("sass as built:", sass_mix(build_dir / "as_built" /
                                     "tens_seq.cu.o"))

    dev = torch.device("cuda", 0)

    def call(lib, kind, threads):
        """A direct launch of the kind's kernel on its inputs, and the
        plain version's result."""
        import numpy as np

        args = ab_kernels._kuf_args(kind, torch, dev,
                                    np.random.default_rng(0))
        stream = torch.cuda.current_stream().cuda_stream
        if kind.startswith("ts_bwd"):
            z, x, g, nl, rbf, inc = args
            T, N, L, d = z.shape[0], x.shape[0], x.shape[1], x.shape[2]
            ppw = plan._pairs_a_warp(T, N, threads // 32,
                                     plan.KUF_TUNED_BWD_TARGET_BLOCKS)
            blocks = T * -(-N // (threads // 32 * ppw))
            zb, xb = torch.zeros_like(z), torch.zeros_like(x)

            def run():
                zb.zero_()
                xb.zero_()
                err = lib.gpsig_tens_seq_bwd(
                    z.data_ptr(), x.data_ptr(), g.data_ptr(), zb.data_ptr(),
                    xb.data_ptr(), T, N, L, d, nl, 1, int(inc), 0, ppw,
                    blocks, stream)
                if err:
                    raise RuntimeError(f"launch failed ({err})")
                return zb, xb
            return run, ts.tens_seq_bwd_ref(z, x, g, nl, rbf, inc)
        z, x, nl, rbf, inc = args
        T, N, L, d = z.shape[0], x.shape[0], x.shape[1], x.shape[2]
        out = torch.empty((nl + 1, T, N), device=dev)
        xt = x.permute(1, 2, 0).contiguous()
        nt = plan.kuf_fwd_plan(N, plan.factor_count(nl, inc), d, nl, 4,
                               True)["threads"]

        def run():
            err = lib.gpsig_tens_seq(z.data_ptr(), xt.data_ptr(),
                                     out.data_ptr(), T, N, L, d, nl, 1,
                                     int(inc), 0, nt, stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")
            return (out,)
        return run, (ts.fused_tens_seq_levels_ref(z, x, nl, rbf, inc),)

    def cuda_ms(fn):
        for _ in range(2):
            fn()
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    for name, (_, threads) in VARIANTS.items():
        cells = []
        for kind in SHAPES:
            run, want = call(libs[name], kind, threads)
            got = run()
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            if err > 1e-3:
                print(f"variant {name} {kind}: scaled error {err}",
                      file=sys.stderr)
                return 1
            cells.append(f"{kind} {cuda_ms(run):.4f}")
        print(f"times {name} (ms, float32): {', '.join(cells)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
