"""Checkpoint files in the JAX package's format, read and written without
JAX (counterpart of ``fmov_pose_tpu/train/checkpoint.py``).

A checkpoint is one pickle of ``{"leaves", "treedef", "host_meta"}``: the
training state's leaves as numpy arrays in ``jax.tree_util`` flatten
order, the pickled JAX tree structure (bytes), and the Runner's host
counters.  This module returns the leaves and the host meta and never
unpickles ``treedef``, which would need JAX; the Runner maps the leaves
onto its state by position, name and shape (``Runner.load_checkpoint``).

The port writes the same payload with ``"treedef": None`` and
``"format": FORMAT``, which JAX files lack, and its leaves in the same
order, so one reader takes both.  The JAX package cannot read a port
file: its loader unpickles the treedef.  A file is written under a
temporary name and renamed into place, so a crash never leaves a
half-written file where ``latest_checkpoint`` looks.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["FORMAT", "JAX_FORMAT", "save_checkpoint", "load_checkpoint",
           "latest_checkpoint"]

FORMAT = "fmov_pose_torch/1"
JAX_FORMAT = "fmov_pose_tpu"


def save_checkpoint(path: str, leaves: List[np.ndarray], host_meta: Dict[str, Any]):
    """Write ``leaves`` (numpy, in JAX flatten order) and ``host_meta`` to
    ``path``, atomically."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"leaves": [np.asarray(leaf) for leaf in leaves], "treedef": None,
               "host_meta": host_meta, "format": FORMAT}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str) -> Tuple[List[np.ndarray], Dict[str, Any], str]:
    """-> (leaves, host_meta, format): ``JAX_FORMAT`` for a file of the JAX
    package, ``FORMAT`` for one of the port."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return (list(payload["leaves"]), payload["host_meta"],
            payload.get("format", JAX_FORMAT))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The last ``*.ckpt`` of ``ckpt_dir`` by name (the JAX rule), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(n for n in os.listdir(ckpt_dir) if n.endswith(".ckpt"))
    return os.path.join(ckpt_dir, names[-1]) if names else None
