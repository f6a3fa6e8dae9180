"""Checkpoint and resume with ``torch.save`` / ``torch.load``.

Counterpart of ``gpsig_tpu/utils/checkpoint.py``, which saves a pytree
with orbax. Here a checkpoint is one file holding a nested dict (or list)
of tensors, numpy arrays and Python scalars and strings. numpy arrays and
scalars are stored as CPU tensors and Python numbers, so the file loads
with ``torch.load(weights_only=True)``: a checkpoint can hold no code.

A save writes a temporary file beside ``path`` (its name starts with a
dot) and renames it into place, so an interrupted save never leaves a
file under ``path`` that looks complete; readers that scan a directory
for saves skip the dot files.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _storable(tree):
    if isinstance(tree, dict):
        return {k: _storable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_storable(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path, state):
    """Save ``state`` (a nested dict of tensors, arrays and scalars) to
    ``path``: written to a temporary name, then renamed."""
    path = os.path.abspath(path)
    head, tail = os.path.split(path)
    os.makedirs(head, exist_ok=True)
    tmp = os.path.join(head, f".{tail}.tmp")
    torch.save(_storable(state), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path):
    """The state saved at ``path``: tensors on the CPU (numpy arrays come
    back as tensors). The file carries its own structure, so no template
    is taken, as orbax takes one."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
