"""Parameter trees between the JAX package and the port.

Both packages keep parameters as nested dicts with the same keys
(``sdf.layers.lin{l}.{v,g,b}``, ``color.layers.lin{l}.{v,g,b}``,
``nerf.pts.lin{i}.{w,b}``, ``variance.variance``, ``pose.lin1/lin2/lin3*``)
and the weight-norm ``(v, g)`` layout.  The JAX side's leaves are numpy
arrays here (``np.asarray`` of its device arrays), so this module needs no
JAX.  ``flatten`` orders leaves by sorted keys at every level, which is the
order of JAX's ``ravel_pytree``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def to_torch(tree, device=None, dtype=torch.float32):
    """Nested dict of array-likes -> nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, copy=True))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(dotted name, leaf)] in sorted-key (``ravel_pytree``) order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(flatten(v, name + "."))
        else:
            out.append((name, v))
    return out


def unflatten(items) -> Tree:
    """Inverse of :func:`flatten` (dotted names -> nested dicts)."""
    root: Tree = {}
    for name, leaf in items:
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


class ParamLayout:
    """Every trainable leaf raveled into one flat f32 buffer.

    ``views(flat)`` returns the nested parameter dict whose leaves are views
    of ``flat``; gradients of anything computed from those views land in
    one flat gradient, which the flat Adam updates in place."""

    def __init__(self, tree: Tree):
        self.names, self.shapes, self.offsets = [], [], []
        off = 0
        for name, leaf in flatten(tree):
            shape = tuple(leaf.shape)
            self.names.append(name)
            self.shapes.append(shape)
            self.offsets.append(off)
            off += int(np.prod(shape, dtype=np.int64))
        self.size = off

    def ravel(self, tree: Tree, device=None) -> torch.Tensor:
        leaves = dict(flatten(tree))
        parts = [(leaves[n] if isinstance(leaves[n], torch.Tensor)
                  else torch.from_numpy(np.array(leaves[n], np.float32))
                  ).to(torch.float32).reshape(-1) for n in self.names]
        flat = torch.cat(parts) if parts else torch.zeros(0)
        return flat.to(device) if device is not None else flat

    def views(self, flat: torch.Tensor) -> Tree:
        sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        parts = torch.split(flat, sizes)  # one op, one backward
        return unflatten((name, p.view(shape)) for name, shape, p
                         in zip(self.names, self.shapes, parts))

    def mask(self, pred, device=None) -> torch.Tensor:
        """0/1 f32 vector over the flat buffer: 1 where pred(name)."""
        m = torch.zeros(self.size, dtype=torch.float32)
        for name, shape, off in zip(self.names, self.shapes, self.offsets):
            if pred(name):
                m[off:off + int(np.prod(shape, dtype=np.int64))] = 1.0
        return m.to(device) if device is not None else m


def seg_bank_to_torch(bank, device=None) -> Tree:
    """A JAX segment bank (``poses/picture_pose.py:init_seg_bank``; leaves
    as numpy) -> the port's: the train leaves [S, ...] and the static
    bands and init poses as tensors, the ``initialized`` flags as host
    numpy (its unread ``progress`` buffer is dropped)."""
    static = bank["static"]
    return {"train": to_torch(bank["train"], device),
            "static": {"b": to_torch(static["b"], device),
                       "init_c2w": to_torch(static["init_c2w"], device),
                       "initialized": np.array(static["initialized"], bool)}}


def seg_adam_to_torch(opt, device=None):
    """A JAX ``SegAdamState`` (flat moments over the bank's ravel order,
    which is ``ParamLayout``'s) -> the port's."""
    from fmov_pose_torch.train.optim import SegAdamState
    return SegAdamState(
        step=torch.as_tensor(np.array(opt.step, np.int32), device=device),
        mu=torch.as_tensor(np.array(opt.mu, np.float32), device=device),
        nu=torch.as_tensor(np.array(opt.nu, np.float32), device=device))
