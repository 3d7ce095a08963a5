"""In-memory synthetic scene: an orbit around a textured sphere.

Counterpart of ``fmov_pose_tpu/data/synthetic.py`` that builds the arrays
in memory instead of writing PNGs, so it needs neither OpenCV nor the
disk.  It returns the fields the runner reads from a ``data/dataset.py``
``Dataset``, with the same conventions: images in BGR order quantized to 8
bits and divided by 256, 3-channel masks, black background when
``wo_mask``, frame names ``0000``, ``0001``, ...; ``crop_poses`` as the
phase-2 initial poses (here the ground truth turned by a seeded small
rotation, standing in for the phase-1 estimate); and what phase 1 reads:
exact correspondences between consecutive frames, drawn as ``synthetic.py``
writes its match files (the analytic sphere's depth, 200 matches a pair,
seeded) and filtered as the Dataset filters them, and the mask-init seed
pose ``max_mask_pose``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from fmov_pose_torch.data.dataset import (add_flow_pair, filter_matches, mask_bboxes,
                                          mask_init_pose)

SPHERE_RADIUS = 0.5


def look_at_pose(cam_pos, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """OpenCV-convention c2w: +z forward toward target."""
    cam_pos = np.asarray(cam_pos, np.float64)
    fwd = np.asarray(target, np.float64) - cam_pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = cam_pos
    return pose.astype(np.float32)


def _sphere_color(pts):
    """Smooth angular texture (deterministic, view-independent)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = np.linalg.norm(pts, axis=-1) + 1e-9
    u, v, w = x / r, y / r, z / r
    col = np.stack(
        [0.5 + 0.5 * np.sin(3 * u + 1.0) * np.cos(2 * v),
         0.5 + 0.5 * np.sin(4 * v) * np.cos(3 * w),
         0.5 + 0.5 * np.sin(5 * w + 0.5)], axis=-1)
    return np.clip(col, 0.0, 1.0)


def render_sphere_frame(K, c2w, H, W, radius=SPHERE_RADIUS):
    """Analytic ray-traced lambertian sphere: (rgb [H,W,3] in [0,1],
    mask [H,W] bool, depth [H,W] along the ray)."""
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    dirs = pix @ np.linalg.inv(K).T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T
    o = c2w[:3, 3][None, None, :]

    b = 2.0 * (o * dirs).sum(-1)
    c = (o * o).sum() - radius ** 2
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    hit &= t > 0
    pts = o + dirs * t[..., None]
    normal = pts / (np.linalg.norm(pts, axis=-1, keepdims=True) + 1e-9)
    light = np.array([0.5, -0.7, -0.5])
    light /= np.linalg.norm(light)
    lambert = np.clip((normal * light).sum(-1), 0.0, 1.0) * 0.6 + 0.4
    rgb = _sphere_color(pts) * lambert[..., None]
    rgb = np.where(hit[..., None], rgb, 0.0)
    depth = np.where(hit, t, 0.0)
    return rgb.astype(np.float32), hit, depth.astype(np.float32)


def orbit(n_frames, H, W, span_deg=60.0, cam_dist=2.5, elevation_deg=15.0):
    """(K [3, 3], GT c2w [N, 4, 4]) of ``synthetic.make_orbit_sequence``."""
    f = 0.9 * max(H, W) / (2 * np.tan(np.deg2rad(25)))
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    el = np.deg2rad(elevation_deg)
    poses = []
    for i in range(n_frames):
        ang = np.deg2rad(span_deg) * i / max(n_frames - 1, 1)
        cam_pos = cam_dist * np.array(
            [np.sin(ang) * np.cos(el), np.sin(el), -np.cos(ang) * np.cos(el)])
        poses.append(look_at_pose(cam_pos))
    return K, np.stack(poses)


def noisy_poses(poses, noise_deg=5.0, seed=0):
    """Each c2w turned about the world origin by noise_deg around a seeded
    random axis (the camera keeps looking near the object)."""
    rng = np.random.default_rng(seed)
    out = np.array(poses, np.float64)
    for i in range(len(out)):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        th = np.deg2rad(noise_deg)
        kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                       [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        out[i, :3, :] = R @ out[i, :3, :]
    return out.astype(np.float32)


def exact_matches(K, c2w1, c2w2, mask1, depth1, mask2, rng, n_matches=200):
    """Frame 1's pixels [n, 2] and their exact projections into frame 2
    [n, 2] through the analytic geometry, drawn and rounded as
    ``synthetic.py:_write_matches`` writes them (3 decimals)."""
    ys, xs = np.where(mask1)
    if len(ys) == 0:
        return np.zeros((0, 2)), np.zeros((0, 2))
    sel = rng.choice(len(ys), min(n_matches * 3, len(ys)), replace=False)
    xs, ys = xs[sel], ys[sel]
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    dirs = pix @ np.linalg.inv(K).T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts_w = (dirs * depth1[ys, xs][:, None]) @ c2w1[:3, :3].T + c2w1[:3, 3]
    w2c2 = np.linalg.inv(c2w2)
    pts_c2 = pts_w @ w2c2[:3, :3].T + w2c2[:3, 3]
    proj = pts_c2 @ K.T
    px2, py2 = proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]
    H, W = mask2.shape
    keep = (px2 >= 0) & (px2 < W) & (py2 >= 0) & (py2 < H) & (pts_c2[:, 2] > 0)
    xi, yi = np.clip(px2, 0, W - 1).astype(int), np.clip(py2, 0, H - 1).astype(int)
    keep &= mask2[yi, xi]
    rows = np.round(np.stack([xs[keep], ys[keep], px2[keep], py2[keep]], -1)
                    [:n_matches], 3)
    return rows[:, :2], rows[:, 2:]


@dataclass
class Scene:
    """The Dataset fields the port's runner reads (see module docstring)."""
    images_np: np.ndarray          # [N, H, W, 3] BGR, k/256
    masks_np: np.ndarray           # [N, H, W, 3], 255/256 inside
    intrinsics_all: np.ndarray     # [N, 4, 4]
    intrinsics_all_inv: np.ndarray
    pose_all: np.ndarray           # [N, 4, 4] GT c2w
    gt_poses: np.ndarray
    crop_poses: np.ndarray         # [N, 4, 4] initial (noisy) c2w
    mask_bboxes: np.ndarray        # [N, 4] int32 ymin, ymax, xmin, xmax
    H: int
    W: int
    n_images: int
    max_mask_pose: np.ndarray = None
    index_to_frame: Dict[int, str] = field(default_factory=dict)
    frame_to_index: Dict[str, int] = field(default_factory=dict)
    loftr_flows: Dict[str, tuple] = field(default_factory=dict)
    flow_pairs: Dict[str, set] = field(default_factory=dict)


def make_orbit_scene(n_frames=8, H=480, W=640, span_deg=60.0, cam_dist=2.5,
                     elevation_deg=15.0, noise_deg=5.0, seed=0,
                     wo_mask=True, crop=True, match_seed=0) -> Scene:
    """``crop``: the conf's ``dataset.crop``, which sets how the mask-init
    pose is placed.  ``match_seed``: the match draw's seed (``synthetic.py``
    uses 0)."""
    K, poses = orbit(n_frames, H, W, span_deg, cam_dist, elevation_deg)
    images, masks, frames = [], [], []
    for c2w in poses:
        rgb, hit, depth = render_sphere_frame(K, c2w, H, W)
        # the PNG round trip of synthetic.py + Dataset: 8-bit BGR, /256
        images.append((rgb[..., ::-1] * 255).astype(np.uint8))
        masks.append(np.repeat((hit * 255).astype(np.uint8)[..., None], 3, -1))
        frames.append((hit, depth))
    images_np = np.stack(images).astype(np.float32) / 256.0
    masks_np = np.stack(masks).astype(np.float32) / 256.0
    if wo_mask:
        images_np[masks_np < 0.5] = 0.0
    intr = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    intr[:, :3, :3] = K
    names = [f"{i:04d}" for i in range(n_frames)]
    flows, pairs = {}, {}
    rng = np.random.default_rng(match_seed)
    for i in range(n_frames - 1):
        xys1, xys2 = exact_matches(K, poses[i], poses[i + 1], frames[i][0],
                                   frames[i][1], frames[i + 1][0], rng)
        if len(xys1):
            xys1, xys2 = filter_matches(xys1, xys2, masks_np[i][..., 0],
                                        masks_np[i + 1][..., 0], H, W)
            add_flow_pair(flows, pairs, names[i], names[i + 1], xys1, xys2)
    return Scene(
        images_np=images_np, masks_np=masks_np,
        intrinsics_all=intr, intrinsics_all_inv=np.linalg.inv(intr),
        pose_all=poses, gt_poses=poses.copy(),
        crop_poses=noisy_poses(poses, noise_deg, seed),
        mask_bboxes=mask_bboxes(masks_np), H=H, W=W, n_images=n_frames,
        max_mask_pose=mask_init_pose(masks_np[0][..., 0], intr[0][:3, :3], crop),
        index_to_frame=dict(enumerate(names)),
        frame_to_index={n: i for i, n in enumerate(names)},
        loftr_flows=flows, flow_pairs=pairs)
