"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), as many at once as there are cores, the slowest first, and
the objects are linked into one shared library with a plain C interface,
at first use, and loaded with ``ctypes``. The library's name carries a hash of the sources, the shared
header and the flags, so an edited ``.cu`` or ``.cuh`` file builds anew.
Builds go to ``gpsig_tpu_torch/.build/`` (git-ignored). A failed build
raises with nvcc's output; nothing falls back to another implementation.

Nothing here runs at import time: the package imports on machines with no
CUDA toolkit, and only a launch on a CUDA tensor reaches :func:`library`.
:func:`check_inputs` and :func:`launch` are the wrappers' shared checks
and launch path. Gradients are the business of the wrappers'
``torch.autograd.Function``s: a launch reads only the inputs' data.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / ".build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points and their argument types (every pointer and the stream
#: as c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "gpsig_fused_gram": [_P, _P, _P, *[_I] * 12, _P],
    "gpsig_fused_diag": [_P, _P, _P, *[_I] * 13, _P],
    "gpsig_tens_seq": [_P, _P, _P, *[_I] * 9, _P],
    "gpsig_fused_gram_bwd": [*[_P] * 6, *[_I] * 13, _P],
    "gpsig_tens_seq_bwd": [*[_P] * 5, *[_I] * 10, _P],
    "gpsig_fused_gram_ho": [_P, _P, _P, *[_I] * 14, _P],
    "gpsig_sig_gram": [_P, _P, _P, *[_I] * 13, _P],
    "gpsig_tens_seq_general": [_P, _P, _P, *[_I] * 13, _P],
    "gpsig_fused_gram_ho_bwd": [*[_P] * 6, *[_I] * 14, _P],
    "gpsig_fused_gram_ho_bwd_block": [*[_P] * 6, *[_I] * 14, _P],
    "gpsig_sig_gram_bwd": [*[_P] * 4, *[_I] * 13, _P],
    "gpsig_tens_seq_general_bwd": [*[_P] * 6, *[_I] * 16, _P],
    "gpsig_goursat": [_P, _P, _P, *[_I] * 11, _P],
    "gpsig_goursat_refined": [_P, _P, _P, *[_I] * 12, _P],
    "gpsig_goursat_grad": [*[_P] * 4, *[_I] * 7, _P],
}

#: the sources that take longest to compile, slowest first, as measured on
#: an 8-core H100 machine (each of the others takes a fraction of their
#: time). They start first, the others after them in name order, and no
#: more nvcc run than there are cores, so that a long compile neither starts
#: late nor shares its core with the short ones.
SLOWEST_FIRST = (
    "fused_gram_ho_bwd_block_f64.cu", "tens_seq_general_bwd.cu",
    "fused_gram_ho_bwd_f64.cu", "fused_gram_bwd.cu", "sig_gram_bwd_f64.cu",
    "tens_seq_general_bwd_f64.cu", "sig_gram_bwd.cu", "fused_gram_ho_bwd.cu",
    "sig_gram_bwd_deep_f64.cu", "sig_gram_bwd_band_f64.cu", "fused_diag.cu",
    "sig_gram_bwd_deep.cu", "fused_gram_ho_bwd_block.cu",
    "sig_gram_bwd_band.cu", "fused_gram_ho.cu", "fused_gram_ho_f64.cu",
    "tens_seq_general.cu", "tens_seq_general_f64.cu", "sig_gram.cu",
    "sig_gram_f64.cu", "sig_gram_deep.cu",
)

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin); the "
        "CUDA kernels cannot be built"
    )


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpsig_kernels-{h.hexdigest()[:16]}.so"


def _compile(cmds, outs):
    """Run the commands, at most one per core the process may use, in the
    order given, each writing to its file in ``outs``. Returns each one's
    exit code and wall time from its own start."""
    jobs = len(os.sched_getaffinity(0))
    pending = list(range(len(cmds)))
    running, started = {}, {}
    codes, seconds = [None] * len(cmds), [None] * len(cmds)
    while pending or running:
        while pending and len(running) < jobs:
            i = pending.pop(0)
            with open(outs[i], "w") as f:
                running[i] = subprocess.Popen(cmds[i], stdout=f,
                                              stderr=subprocess.STDOUT)
            started[i] = time.perf_counter()
        # polled: the output goes to a file, so no process waits on a pipe
        for i, proc in list(running.items()):
            if proc.poll() is not None:
                codes[i] = proc.returncode
                seconds[i] = time.perf_counter() - started[i]
                del running[i]
        time.sleep(0.1)
    return codes, seconds


def build():
    """Compile the sources unless a library of the same hash exists: one
    ``nvcc -c`` per source (as many at once as there are cores, the
    slowest first), then one link. Returns the library's path. nvcc's
    reports (registers, spills) and each source's compile time are kept
    beside it as ``<lib>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(_sources(), key=lambda src: (
        SLOWEST_FIRST.index(src.name) if src.name in SLOWEST_FIRST
        else len(SLOWEST_FIRST)))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
        outs = [obj.with_suffix(".txt") for obj in objs]
        codes, seconds = _compile(cmds, outs)
        logs = [f"{path.read_text()}{cmd[-1]}: {sec:.1f} s\n"
                for cmd, path, sec in zip(cmds, outs, seconds)]
        for cmd, code, log in zip(cmds, codes, logs):
            if code != 0:
                raise RuntimeError(
                    f"nvcc failed ({code}): {' '.join(cmd)}\n{log}")
        lib = Path(tmp) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        Path(str(out) + ".log").write_text("".join(logs))
        os.replace(lib, out)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gpsig_error_string.argtypes = [ctypes.c_int]
        lib.gpsig_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(name, tensors):
    """Validate what a kernel takes: CUDA tensors on one device, float32 or
    float64 alike, contiguous. Raises on anything else."""
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(
                f"{name}: all inputs must be CUDA tensors on one device; "
                f"got {[str(x.device) for x in tensors]}"
            )
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: float32 or float64 only; got {t.dtype}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype}, {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def launch(name, device, *args):
    """Call C entry point ``name`` with ``args`` (tensors are passed by
    data pointer) on ``device``'s current stream; raise if the launch
    reported a CUDA error (the entry points return
    ``cudaGetLastError()`` right after their launch). On the current
    device it sets no device guard: a launch's host time is part of every
    small kernel's call."""
    lib = library()
    c_args = [a.data_ptr() if torch.is_tensor(a) else int(a) for a in args]
    fn = getattr(lib, name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*c_args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.gpsig_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
