"""Picture-level learned poses: the Gaussian-Fourier pose MLP (port of
``fmov_pose_tpu/poses/picture_pose.py:43-133``).

Parameters are {"train": trainable leaves, "static": buffers (Fourier
bands b, init_c2w)}.  The initializer is numpy with the JAX module's draw
order, so both packages build identical pose nets from one seed.  The
segment bank (``seg_*``) is slice 3 of the port.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fmov_pose_torch.core.embedder import fourier_features
from fmov_pose_torch.core.lie import make_c2w

Params = Dict[str, Any]

EMBED_SIZE = 128


class PoseCfg(NamedTuple):
    emphasize_rot: bool = False
    small_rot: bool = False
    pose_encoding: bool = False
    embedding_scale: float = 10.0


def _bands(rng: np.random.Generator, cfg: PoseCfg) -> np.ndarray:
    if cfg.pose_encoding:
        b = 2.0 ** np.linspace(0, 5, EMBED_SIZE // 2) - 1.0
        b = b[:, None]
        b = np.concatenate([b, np.roll(b, 1, axis=-1)], 0)
        return b.astype(np.float32)
    return rng.normal(0.0, cfg.embedding_scale, (EMBED_SIZE, 1)).astype(np.float32)


def _kaiming_linear(rng, d_in, d_out):
    bound = 1.0 / math.sqrt(d_in)
    w = rng.uniform(-bound, bound, (d_out, d_in)).astype(np.float32)
    b = rng.uniform(-bound, bound, (d_out,)).astype(np.float32)
    return {"w": w, "b": b}


def _gf_train_np(rng, cfg: PoseCfg):
    """Trainable GF-pose leaves as numpy, in the JAX module's draw order."""
    train = {
        "lin1": _kaiming_linear(rng, EMBED_SIZE * 2, 64),
        "lin2": _kaiming_linear(rng, 64, 64),
    }
    if cfg.emphasize_rot:
        train["lin3_rot"] = {
            "w": rng.normal(0, 0.01, (3, 64)).astype(np.float32),
            "b": np.zeros((3,), np.float32)}
        train["lin3_trans"] = {"w": np.zeros((3, 64), np.float32),
                               "b": np.zeros((3,), np.float32)}
        train["lin3_scale"] = {
            "w": rng.normal(0, 0.01, (1, 64)).astype(np.float32),
            "b": np.ones((1,), np.float32)}
    else:
        train["lin3"] = {
            "w": rng.normal(0, 0.01, (6, 64)).astype(np.float32),
            "b": np.zeros((6,), np.float32)}
    return train


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32))


def init_gf(seed: int, cfg: PoseCfg, init_c2w: np.ndarray) -> Params:
    """init_c2w: [num_cams, 4, 4] (or [4, 4]).  CPU tensors."""
    rng = np.random.default_rng(seed)
    b = _bands(rng, cfg)
    train = _tensors(_gf_train_np(rng, cfg))
    init_c2w = np.asarray(init_c2w, np.float32)
    if init_c2w.ndim == 2:
        init_c2w = init_c2w[None]
    return {"train": train,
            "static": {"b": torch.from_numpy(b),
                       "init_c2w": torch.from_numpy(init_c2w.copy())}}


def _lin(p, x):
    return x @ p["w"].T + p["b"]


def gf_apply(params: Params, cfg: PoseCfg, cam_id) -> torch.Tensor:
    """cam_id: int or 0-dim integer tensor.  Returns c2w [3, 4]."""
    static, train = params["static"], params["train"]
    b = static["b"]
    cam = torch.as_tensor(cam_id, device=b.device)
    feat = fourier_features(cam.to(torch.float32).reshape(1, 1), b)  # [1, 256]
    h = F.gelu(_lin(train["lin1"], feat), approximate="none")
    h = F.gelu(_lin(train["lin2"], h), approximate="none")
    rot_scale = math.pi / 6 if cfg.small_rot else math.pi
    if cfg.emphasize_rot:
        pred_rot = _lin(train["lin3_rot"], h) * rot_scale
        pred_trans = _lin(train["lin3_trans"], h)
        pred_scale = _lin(train["lin3_scale"], h)
    else:
        pred = _lin(train["lin3"], h)
        pred_rot = pred[:, :3] * rot_scale
        pred_trans = pred[:, 3:]
        pred_scale = None
    c2w = make_c2w(pred_rot, pred_trans)[0]  # [3, 4]

    init_bank = static["init_c2w"]
    init = init_bank[torch.clamp(cam.long(), max=init_bank.shape[0] - 1)]
    t = init[:3, 3] * (pred_scale[0, 0] if pred_scale is not None else 1.0)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=c2w.dtype, device=c2w.device)
    tmp = torch.cat([torch.cat([init[:3, :3], t[:, None]], dim=1), bottom], dim=0)
    return c2w @ tmp  # [3, 4]
