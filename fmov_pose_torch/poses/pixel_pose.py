"""Pixel-level learned poses: the deep per-frame pose network and its
segment bank (port of ``fmov_pose_tpu/poses/pixel_pose.py``).

* ``rotation_from_ortho6d``: the continuous 6D rotation representation.
* ``init_deep_pose`` / ``deep_pose_apply``: a NeRF-style D x W ReLU MLP
  with a skip, fed the encoded camera id (position PE, Gaussian Fourier,
  the reference's "original" Fourier, or a learned embedding), with the
  zero, direct or small-weight output init; frame-level (``disable_pts``)
  or conditioned per pixel on camera-space points (``input_pts``).
* The segment bank (``model.pixel_level``, pose mode ``seg_pixel``): one
  deep net per ``segment_img_num`` frames, every trainable leaf stacked
  on a leading segment axis, with the picture-level bank's lazy init
  (``seg_deep_initialize``) and per-segment freezing (in the optimizer).

The initializers are numpy with the JAX module's draw order, so both
packages build the same nets from one seed.  A frame id is a host int or
an int64 device tensor of one element, gathered with on the device (the
planned steps read it from their chunk's rows).  The bank's
``initialized`` flags stay on the host as numpy, as in the picture-level
bank; its ``progress`` buffer, which nothing reads, is not carried.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from fmov_pose_torch.core.embedder import fourier_features, positional_encode
from fmov_pose_torch.core.lie import make_c2w
from fmov_pose_torch.core.pose import to_4x4
from fmov_pose_torch.poses.picture_pose import num_segments, seg_row

Params = Dict[str, Any]


def rotation_from_ortho6d(ortho6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> SO(3) [..., 3, 3], columns x, y, z."""
    x_raw, y_raw = ortho6d[..., 0:3], ortho6d[..., 3:6]
    x = x_raw / (torch.linalg.norm(x_raw, dim=-1, keepdim=True) + 1e-12)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-12)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


class DeepPoseCfg(NamedTuple):
    D: int = 8
    W: int = 256
    skips: tuple = (4,)
    x_multires: int = 10
    t_multires: int = 10
    rot_type: str = "angle"
    output_init: str = "small_weight"
    cam_id_encoding: str = "position"
    fourier_embed_dim: int = 128
    disable_pts: bool = True
    n_images: int = 1


def _t_feature_dim(cfg: DeepPoseCfg) -> int:
    if cfg.cam_id_encoding == "original_fourier":
        return 512
    if cfg.cam_id_encoding == "fourier":
        return cfg.fourier_embed_dim * 2
    if cfg.cam_id_encoding == "position":
        return 1 * (1 + 2 * cfg.t_multires)
    if cfg.cam_id_encoding == "embedding":
        return 128
    raise NotImplementedError(cfg.cam_id_encoding)


def _kaiming(rng, d_in, d_out):
    bound = 1.0 / math.sqrt(d_in)
    return {"w": rng.uniform(-bound, bound, (d_out, d_in)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (d_out,)).astype(np.float32)}


def _deep_pose_np(seed: int, cfg: DeepPoseCfg, init_c2w: np.ndarray) -> Params:
    """One deep pose net as numpy, in the JAX module's draw order."""
    rng = np.random.default_rng(seed)
    init_c2w = np.asarray(init_c2w, np.float32)
    in_x = 3 * (1 + 2 * cfg.x_multires)
    in_ch = in_x + _t_feature_dim(cfg)
    layers = [_kaiming(rng, in_ch, cfg.W)]
    for i in range(cfg.D - 1):
        d_in = cfg.W + in_ch if i in cfg.skips else cfg.W
        layers.append(_kaiming(rng, d_in, cfg.W))
    out_dim = 6 if cfg.rot_type == "angle" else 9
    out = _kaiming(rng, cfg.W, out_dim)
    if cfg.output_init == "zero":
        out = {"w": np.zeros_like(out["w"]), "b": np.zeros_like(out["b"])}
    elif cfg.output_init == "small_weight":
        out = {"w": rng.normal(0, 0.01, out["w"].shape).astype(np.float32),
               "b": np.zeros_like(out["b"])}
    elif cfg.output_init == "direct":
        bias = np.zeros(out_dim, np.float32)
        bias[3:6] = init_c2w[0, :3, 3] if init_c2w.ndim == 3 else init_c2w[:3, 3]
        out = {"w": np.zeros_like(out["w"]), "b": bias}

    static: Dict[str, Any] = {
        "init_c2w": init_c2w if init_c2w.ndim == 3 else init_c2w[None]}
    if cfg.cam_id_encoding == "fourier":
        static["t_bands"] = rng.normal(0, 1.0 / (4 * cfg.n_images),
                                       (cfg.fourier_embed_dim, 1)).astype(np.float32)
    elif cfg.cam_id_encoding == "original_fourier":
        static["t_bands"] = rng.normal(0, 10.0, (256, 1)).astype(np.float32)
    elif cfg.cam_id_encoding == "embedding":
        static["t_embed"] = rng.normal(0, 1.0, (cfg.n_images, 128)).astype(np.float32)
    train = {f"lin{i}": p for i, p in enumerate(layers)}
    train["out"] = out
    return {"train": train, "static": static}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def init_deep_pose(seed: int, cfg: DeepPoseCfg, init_c2w: np.ndarray) -> Params:
    """A deep pose net {"train", "static"} as CPU tensors; init_c2w [4, 4]
    or [n, 4, 4]."""
    return _tensors(_deep_pose_np(seed, cfg, init_c2w))


def _t_features(cfg: DeepPoseCfg, static, cam_id, device):
    """The camera id's encoding [T] (a host int or a device id tensor)."""
    on_device = isinstance(cam_id, torch.Tensor)
    if cfg.cam_id_encoding == "embedding":
        return seg_row(static["t_embed"], cam_id)
    if on_device:
        cam_f = cam_id.reshape(()).to(torch.float32)
    else:
        cam_f = torch.tensor(float(cam_id), dtype=torch.float32, device=device)
    if cfg.cam_id_encoding == "fourier":
        bands = static["t_bands"]
        return fourier_features(cam_f[None, None], bands)[0] * math.sqrt(bands.shape[0])
    if cfg.cam_id_encoding == "original_fourier":
        ang = (2.0 * math.pi * cam_f) * static["t_bands"][:, 0]
        return torch.cat([torch.sin(ang), torch.cos(ang)]) / math.sqrt(256.0)
    # position PE on the normalized id
    return positional_encode((cam_f / cfg.n_images)[None, None], cfg.t_multires)[0]


def deep_pose_apply(params: Params, cfg: DeepPoseCfg, cam_id,
                    input_pts=None) -> torch.Tensor:
    """Frame-level (``disable_pts`` or no points: [3, 4]) or per-pixel
    pose ([..., 3, 4] for input_pts [..., 3])."""
    static, train = params["static"], params["train"]
    device = static["init_c2w"].device
    t_feat = _t_features(cfg, static, cam_id, device)
    if cfg.disable_pts or input_pts is None:
        x_feat = positional_encode(torch.zeros((1, 3), device=device), cfg.x_multires)
        feats = torch.cat([x_feat, t_feat[None]], dim=-1)
    else:
        x_feat = positional_encode(input_pts, cfg.x_multires)
        t_rep = t_feat.expand(input_pts.shape[:-1] + t_feat.shape)
        feats = torch.cat([x_feat, t_rep], dim=-1)

    h = feats
    for i in range(cfg.D):
        p = train[f"lin{i}"]
        h = torch.relu(h @ p["w"].T + p["b"])
        if i in cfg.skips:
            h = torch.cat([feats, h], dim=-1)
    out = train["out"]
    pred = h @ out["w"].T + out["b"]

    if cfg.output_init == "direct":
        pred = torch.cat([torch.tanh(pred[..., :3]) * math.pi / 18, pred[..., 3:]], -1)
    if cfg.rot_type == "angle":
        c2w = make_c2w(pred[..., :3].reshape(-1, 3), pred[..., 3:].reshape(-1, 3))
    else:
        R = rotation_from_ortho6d(pred[..., :6]).reshape(-1, 3, 3)
        c2w = torch.cat([R, pred[..., 6:9].reshape(-1, 3, 1)], dim=-1)

    if cfg.output_init != "direct":
        init_bank = static["init_c2w"]
        last = init_bank.shape[0] - 1
        if isinstance(cam_id, torch.Tensor):
            init = init_bank.index_select(0, torch.clamp(cam_id.reshape(1), max=last))[0]
        else:
            init = init_bank[min(int(cam_id), last)]
        c2w = c2w @ init

    if cfg.disable_pts or input_pts is None:
        return c2w[0]
    return c2w.reshape(input_pts.shape[:-1] + (3, 4))


# ---------------------------------------------------------------------------
# segment bank (SegDeepPixelPose)
# ---------------------------------------------------------------------------


def init_seg_deep_bank(seed: int, cfg: DeepPoseCfg, n_images: int,
                       segment_img_num: int, init_c2w: np.ndarray) -> Params:
    """S = ceil(N / interval) deep nets stacked on a leading segment axis,
    segment s from seed + 1000 s as in the JAX module, all from the one
    pose init_c2w [4, 4] (or [1, 4, 4]).  CPU tensors; the host flags
    ``static["initialized"]`` (segment 0 only)."""
    S = num_segments(n_images, segment_img_num)
    init_c2w = np.asarray(init_c2w, np.float32)
    if init_c2w.ndim == 3:
        init_c2w = init_c2w[0]
    singles = [_deep_pose_np(seed + 1000 * s, cfg, init_c2w[None]) for s in range(S)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*[leaf[k] for leaf in leaves]) for k in leaves[0]}
        return torch.from_numpy(np.stack(leaves))

    initialized = np.zeros((S,), bool)
    initialized[0] = True
    static = {"init_c2w": torch.from_numpy(np.repeat(init_c2w[None], S, 0)),
              "initialized": initialized}
    for k in singles[0]["static"]:
        if k.startswith("t_"):
            static[k] = torch.from_numpy(np.stack([s["static"][k] for s in singles]))
    return {"train": stack(*[s["train"] for s in singles]), "static": static}


def seg_deep_slice(bank: Params, seg_idx) -> Params:
    """Segment ``seg_idx``'s deep net (a host int: views; a device index
    tensor of one element: gathers)."""

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return seg_row(tree, seg_idx)

    static = {"init_c2w": seg_row(bank["static"]["init_c2w"], seg_idx)[None]}
    for k, v in bank["static"].items():
        if k.startswith("t_"):
            static[k] = seg_row(v, seg_idx)
    return {"train": take(bank["train"]), "static": static}


def seg_deep_apply(bank: Params, cfg: DeepPoseCfg, segment_img_num: int,
                   cam_id) -> torch.Tensor:
    """Pose [3, 4] of frame cam_id through its segment's deep net."""
    return deep_pose_apply(seg_deep_slice(bank, cam_id // segment_img_num), cfg, cam_id)


def seg_deep_initialize(bank: Params, cfg: DeepPoseCfg, segment_img_num: int,
                        seg_idx: int) -> Params:
    """Lazy init of segment ``seg_idx`` from the previous segment's pose of
    its last frame: written into the bank's init_c2w in place, on the
    device, and flagged on the host.  A no-op once initialized."""
    static = bank["static"]
    if static["initialized"][seg_idx]:
        return bank
    last_cam = seg_idx * segment_img_num - 1
    with torch.no_grad():
        last_pose = deep_pose_apply(seg_deep_slice(bank, seg_idx - 1), cfg, last_cam)
        static["init_c2w"][seg_idx] = to_4x4(last_pose)
    static["initialized"][seg_idx] = True
    return bank
