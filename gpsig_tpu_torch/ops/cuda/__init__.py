"""The hand-written CUDA kernels' wrappers, and their launch counters.

Each wrapper module counts its kernels' launches in module globals (a
launch on a CUDA tensor adds one; the plain version on a CPU tensor adds
nothing). :func:`launch_counts` reads all sixteen, :func:`reset_launch_counts`
sets them to 0.
"""

from __future__ import annotations

import importlib


#: report key → (module's name, its counter)
COUNTERS = {
    "gram": ("fused_gram", "gram_launches"),
    "diag": ("fused_gram", "diag_launches"),
    "tens_seq": ("tens_seq", "launches"),
    "gram_bwd": ("fused_gram", "gram_bwd_launches"),
    "tens_seq_bwd": ("tens_seq", "bwd_launches"),
    "gram_ho": ("fused_gram_ho", "launches"),
    "tsg": ("tens_seq_general", "launches"),
    "sig_gram": ("sig_gram", "launches"),
    "sig_gram_ho": ("sig_gram", "ho_launches"),
    "gram_ho_bwd": ("fused_gram_ho", "bwd_launches"),
    "tsg_bwd": ("tens_seq_general", "bwd_launches"),
    "sig_gram_bwd": ("sig_gram", "bwd_launches"),
    "sig_gram_ho_bwd": ("sig_gram", "ho_bwd_launches"),
    "goursat": ("goursat", "launches"),
    "goursat_fused": ("goursat", "fused_launches"),
    "goursat_grad": ("goursat", "grad_launches"),
}


def _module(name):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts():
    """{report key: launches so far} of the sixteen kernels in this
    process."""
    return {k: getattr(_module(m), c) for k, (m, c) in COUNTERS.items()}


def reset_launch_counts():
    for m, c in COUNTERS.values():
        setattr(_module(m), c, 0)
