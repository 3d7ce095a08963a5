"""Picture-level learned poses: the Gaussian-Fourier pose MLP and the
segment bank (port of ``fmov_pose_tpu/poses/picture_pose.py``).

Parameters are {"train": trainable leaves, "static": buffers (Fourier
bands b, init_c2w)}.  The initializers are numpy with the JAX module's draw
order, so both packages build identical pose nets from one seed.

Frame ids are host ints: the training loop plans them on the host, so
the pose of a frame costs no host-to-device copy (a pageable copy of a
frame id stalls the stream until the device has caught up).

The segment bank (``SegLearnPose`` of the reference): one pose net per
``segment_img_num`` frames, every trainable leaf stacked on a leading
segment axis [S, ...].  Freezing is a per-segment gate in the optimizer
(``train/optim.py``), and the lazy init of a new segment from the last pose
of the one before is ``seg_initialize``, called by the Runner when it
admits frames.  The bank's ``initialized`` flags stay on the host as numpy,
so deciding whether a segment needs its init reads nothing back from the
device.  The JAX bank's ``progress`` buffer, which nothing reads, is not
carried.
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


def gf_apply(params: Params, cfg: PoseCfg, cam_id: int) -> torch.Tensor:
    """cam_id: a host int.  Returns c2w [3, 4]."""
    static, train = params["static"], params["train"]
    b = static["b"]
    cam = torch.full((1, 1), float(cam_id), dtype=torch.float32, device=b.device)
    feat = fourier_features(cam, b)  # [1, 256]
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
    init = init_bank[min(int(cam_id), init_bank.shape[0] - 1)]
    t = init[:3, 3] * (pred_scale[0, 0] if pred_scale is not None else 1.0)
    bottom = torch.eye(4, dtype=c2w.dtype, device=c2w.device)[3:]
    tmp = torch.cat([torch.cat([init[:3, :3], t[:, None]], dim=1), bottom], dim=0)
    return c2w @ tmp  # [3, 4]


# ---------------------------------------------------------------------------
# segment bank (SegLearnPose)
# ---------------------------------------------------------------------------


def num_segments(n_images: int, segment_img_num: int) -> int:
    return -(-n_images // segment_img_num)


def init_seg_bank(seed: int, cfg: PoseCfg, n_images: int, segment_img_num: int,
                  init_c2w: np.ndarray) -> Params:
    """Stacked bank of S = ceil(N / interval) pose nets, segment s drawn
    from ``default_rng(seed + 1000 s)`` as in the JAX module; all start
    from one seed pose init_c2w [4, 4] (or [1, 4, 4]).  CPU tensors, and
    the host flags ``static["initialized"]`` (segment 0 only)."""
    S = num_segments(n_images, segment_img_num)
    init_c2w = np.asarray(init_c2w, np.float32)
    if init_c2w.ndim == 3:
        init_c2w = init_c2w[0]
    trains, bands = [], []
    for s in range(S):
        rng = np.random.default_rng(seed + 1000 * s)
        bands.append(_bands(rng, cfg))
        trains.append(_gf_train_np(rng, cfg))

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*[leaf[k] for leaf in leaves]) for k in leaves[0]}
        return torch.from_numpy(np.stack(leaves))

    initialized = np.zeros((S,), bool)
    initialized[0] = True
    return {"train": stack(*trains),
            "static": {"b": torch.from_numpy(np.stack(bands)),
                       "init_c2w": torch.from_numpy(np.repeat(init_c2w[None], S, 0)),
                       "initialized": initialized}}


def seg_slice(bank: Params, seg_idx: int) -> Params:
    """The single-segment pose net of segment ``seg_idx`` (views)."""

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[seg_idx]

    return {"train": take(bank["train"]),
            "static": {"b": bank["static"]["b"][seg_idx],
                       "init_c2w": bank["static"]["init_c2w"][seg_idx][None]}}


def seg_apply(bank: Params, cfg: PoseCfg, segment_img_num: int, cam_id: int) -> torch.Tensor:
    """Pose [3, 4] of frame cam_id through its segment's net."""
    # init_c2w has one entry per segment: gf_apply clamps the index to 0
    return gf_apply(seg_slice(bank, cam_id // segment_img_num), cfg, cam_id)


def seg_initialize(bank: Params, cfg: PoseCfg, segment_img_num: int,
                   seg_idx: int) -> Params:
    """Lazy init of segment ``seg_idx`` from the previous segment's pose of
    its last frame: written into the bank's init_c2w in place, on the
    device, and flagged on the host.  A no-op once initialized."""
    static = bank["static"]
    if static["initialized"][seg_idx]:
        return bank
    last_cam = seg_idx * segment_img_num - 1
    with torch.no_grad():
        # rows 0-2 of the 4x4 (its bottom row is already 0, 0, 0, 1)
        static["init_c2w"][seg_idx, :3] = gf_apply(seg_slice(bank, seg_idx - 1),
                                                   cfg, last_cam)
    static["initialized"][seg_idx] = True
    return bank


def seg_set_pose(bank: Params, seg_idx: int, pose4x4, force: bool = False) -> Params:
    """Explicit seeding of segment ``seg_idx``'s init pose (in place)."""
    static = bank["static"]
    if static["initialized"][seg_idx] and not force:
        return bank
    with torch.no_grad():
        static["init_c2w"][seg_idx] = torch.as_tensor(
            np.asarray(pose4x4, np.float32), device=static["init_c2w"].device)
    static["initialized"][seg_idx] = True
    return bank
