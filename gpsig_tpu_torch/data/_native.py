"""ctypes bindings for the port's native .ts parser
(``gpsig_tpu_torch/native/fastts.cpp``, a copy of ``native/fastts.cpp``).

A copy of ``gpsig_tpu/data/_native.py`` that builds the port's own source
into ``gpsig_tpu_torch/.build/`` (git-ignored) with g++ at first use, the
library's name keyed by a hash of the source, moved into place with an
atomic ``os.replace`` so that concurrent builds do not collide. As there,
it is failure-tolerant: any problem (no compiler, a parse rejection such
as the timestamped .ts dialect) returns None and the caller falls back to
the Python parser in ``gpsig_tpu_torch/data/uea.py``. This is a host
parser, not a device path.

Set ``GPSIG_TPU_NO_NATIVE=1`` to disable it (the JAX package's switch).
:func:`loaded` says whether the library was built and loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "fastts.cpp"
BUILD_DIR = _PKG / ".build"

_lock = threading.Lock()
_lib = None
_tried = False


def _build(src):
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"fastts-{tag}.so"
    if so.exists():
        return so
    tmp = BUILD_DIR / f"{so.name}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           str(src), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)  # atomic under concurrent builds
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("GPSIG_TPU_NO_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(str(_build(SOURCE)))
            lib.fastts_parse.restype = ctypes.c_void_p
            lib.fastts_parse.argtypes = [ctypes.c_char_p]
            lib.fastts_num_series.argtypes = [ctypes.c_void_p]
            lib.fastts_num_dims.argtypes = [ctypes.c_void_p]
            lib.fastts_labels_size.argtypes = [ctypes.c_void_p]
            lib.fastts_labels_size.restype = ctypes.c_longlong
            lib.fastts_get_labels.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p]
            lib.fastts_get_lengths.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
            lib.fastts_get_values.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ]
            lib.fastts_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:  # noqa: BLE001 - fall back to the Python parser
            _lib = None
        return _lib


def loaded():
    """True once the native library is built and loaded (builds it)."""
    return _load() is not None


def parse_ts(path):
    """Parse a .ts file natively. Returns (list of [L_i, d] float64 arrays,
    list of label strings), or None to request the Python fallback."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fastts_parse(os.fsencode(path))
    if not h:
        return None
    try:
        n = lib.fastts_num_series(h)
        d = lib.fastts_num_dims(h)
        lengths = np.empty(n, np.int32)
        lib.fastts_get_lengths(h, lengths)
        lsize = lib.fastts_labels_size(h)
        buf = ctypes.create_string_buffer(int(lsize))
        lib.fastts_get_labels(h, buf)
        labels = buf.raw[:lsize].decode("utf-8", "replace").split("\n")
        seqs = []
        for i in range(n):
            arr = np.empty((int(lengths[i]), d), np.float64)
            lib.fastts_get_values(h, i, arr)
            seqs.append(arr)
        if len(labels) != n:
            return None
        return seqs, labels
    finally:
        lib.fastts_free(h)
