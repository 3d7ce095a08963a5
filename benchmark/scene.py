"""The benchmark's scene: an orbit of a camera around a textured sphere,
made from the seed, in memory.

A frozen copy of the program's synthetic scene generator, so that the
yardstick's inputs do not move when the program's generator does.  It
returns the fields a training Runner reads from a dataset: images in BGR
order quantized to 8 bits and divided by 256, 3-channel masks, black
background, frame names ``0000``, ``0001``, ...; ``crop_poses``, the
phase-2 initial poses (the ground truth turned by a seeded small
rotation, standing in for the phase-1 estimate); exact correspondences
between consecutive frames through the analytic sphere (200 a pair,
seeded), filtered to both masks; and the mask-init pose of phase 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

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
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, cam_pos
    return pose.astype(np.float32)


def _sphere_color(pts):
    """Smooth angular texture (view-independent)."""
    import torch
    u, v, w = (pts / (torch.linalg.norm(pts, dim=-1, keepdim=True) + 1e-9)).unbind(-1)
    col = torch.stack([0.5 + 0.5 * torch.sin(3 * u + 1.0) * torch.cos(2 * v),
                       0.5 + 0.5 * torch.sin(4 * v) * torch.cos(3 * w),
                       0.5 + 0.5 * torch.sin(5 * w + 0.5)], dim=-1)
    return torch.clamp(col, 0.0, 1.0)


def render_sphere_frames(K, poses, H, W, device, radius=SPHERE_RADIUS):
    """Ray-traced lambertian sphere seen by every c2w of ``poses``, in f64
    on ``device``: (rgb [N, H, W, 3] f32, hit [N, H, W] bool, depth along
    the ray [N, H, W] f32), as numpy."""
    import torch
    f64 = torch.float64
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=f64),
                            torch.arange(W, device=device, dtype=f64), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    dirs = pix @ torch.as_tensor(np.linalg.inv(K), device=device).T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    c2w = torch.as_tensor(np.asarray(poses, np.float64), device=device)
    dirs = torch.einsum("hwj,nij->nhwi", dirs, c2w[:, :3, :3])
    o = c2w[:, None, None, :3, 3]
    b = 2.0 * (o * dirs).sum(-1)
    c = (o * o).sum(-1) - radius ** 2
    disc = b * b - 4 * c
    hit = disc > 0
    t = torch.where(hit, (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / 2.0, 0.0)
    hit &= t > 0
    pts = o + dirs * t[..., None]
    normal = pts / (torch.linalg.norm(pts, dim=-1, keepdim=True) + 1e-9)
    light = torch.tensor([0.5, -0.7, -0.5], device=device, dtype=f64)
    light = light / torch.linalg.norm(light)
    lambert = torch.clamp((normal * light).sum(-1), 0.0, 1.0) * 0.6 + 0.4
    rgb = torch.where(hit[..., None], _sphere_color(pts) * lambert[..., None], 0.0)
    depth = torch.where(hit, t, 0.0)
    return (rgb.float().cpu().numpy(), hit.cpu().numpy(), depth.float().cpu().numpy())


def orbit(n_frames, H, W, span_deg, cam_dist, elevation_deg):
    f = 0.9 * max(H, W) / (2 * np.tan(np.deg2rad(25)))
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    el = np.deg2rad(elevation_deg)
    poses = []
    for i in range(n_frames):
        ang = np.deg2rad(span_deg) * i / max(n_frames - 1, 1)
        poses.append(look_at_pose(cam_dist * np.array(
            [np.sin(ang) * np.cos(el), np.sin(el), -np.cos(ang) * np.cos(el)])))
    return K, np.stack(poses)


def noisy_poses(poses, noise_deg, rng):
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
    """Frame 1's pixels [n, 2] and their projections into frame 2 [n, 2],
    to 3 decimals."""
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
    proj = (pts_w @ w2c2[:3, :3].T + w2c2[:3, 3]) @ K.T
    px2, py2 = proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]
    H, W = mask2.shape
    keep = (px2 >= 0) & (px2 < W) & (py2 >= 0) & (py2 < H) & (proj[:, 2] > 0)
    xi, yi = np.clip(px2, 0, W - 1).astype(int), np.clip(py2, 0, H - 1).astype(int)
    keep &= mask2[yi, xi]
    rows = np.round(np.stack([xs[keep], ys[keep], px2[keep], py2[keep]], -1)[:n_matches], 3)
    return rows[:, :2], rows[:, 2:]


def in_masks(xys1, xys2, m1, m2, H, W):
    """The matches inside the image and inside both frames' masks."""
    keep = ((xys1[:, 0] >= 0) & (xys1[:, 0] < W) & (xys1[:, 1] >= 0) & (xys1[:, 1] < H)
            & (xys2[:, 0] >= 0) & (xys2[:, 0] < W) & (xys2[:, 1] >= 0) & (xys2[:, 1] < H))
    xys1, xys2 = xys1[keep], xys2[keep]
    keep = ((m1[xys1[:, 1].astype(int), xys1[:, 0].astype(int)] > 0.5)
            & (m2[xys2[:, 1].astype(int), xys2[:, 0].astype(int)] > 0.5))
    return xys1[keep], xys2[keep]


def mask_bboxes(masks_np):
    """Per frame [ymin, ymax, xmin, xmax] of the mask (the frame if empty)."""
    n, H, W = masks_np.shape[:3]
    boxes = np.zeros((n, 4), np.int32)
    for i in range(n):
        ys, xs = np.where(masks_np[i][:, :, 0] > 0.5)
        boxes[i] = ((0, H, 0, W) if len(ys) == 0
                    else (ys.min(), ys.max() + 1, xs.min(), xs.max() + 1))
    return boxes


def mask_init_pose(mask, K, crop):
    """Phase 1's seed pose: the camera on -z at the distance that fits the
    mask's footprint to the unit sphere."""
    ys, xs = np.where(mask > 0.5)
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    cam = (np.linalg.inv(K) @ pix.T).T
    cam = cam / cam[:, 2:]
    pose = np.eye(4, dtype=np.float32)
    if crop:
        pose[:3, 3] = np.array([0.0, 0.0, -0.9 / np.linalg.norm(cam[:, :2], axis=-1).max()])
    else:
        lo, hi = cam[:, :2].min(0), cam[:, :2].max(0)
        center = (lo + hi) / 2
        r = np.linalg.norm(cam[:, :2] - center[None], axis=-1).max()
        pose[:3, 3] = np.array([center[0], center[1], 1.0]) * (-0.9 / r)
    return pose


@dataclass
class Scene:
    images_np: np.ndarray
    masks_np: np.ndarray
    intrinsics_all: np.ndarray
    intrinsics_all_inv: np.ndarray
    pose_all: np.ndarray
    gt_poses: np.ndarray
    crop_poses: np.ndarray
    mask_bboxes: np.ndarray
    H: int
    W: int
    n_images: int
    max_mask_pose: np.ndarray = None
    scale_mats_np: list = field(default_factory=list)
    object_bbox_min: np.ndarray = None
    object_bbox_max: np.ndarray = None
    index_to_frame: Dict[int, str] = field(default_factory=dict)
    frame_to_index: Dict[str, int] = field(default_factory=dict)
    loftr_flows: Dict[str, tuple] = field(default_factory=dict)
    # a frame's partners as a list: a set would iterate in the order of
    # the process's salted string hash
    flow_pairs: Dict[str, list] = field(default_factory=dict)


def make_scene(spec: dict, seed: int, device="cpu") -> Scene:
    """The scene of a configuration's ``scene`` entry (n_frames, H, W,
    span_deg, cam_dist, elevation_deg, noise_deg, crop) from ``seed``; the
    frames are rendered on ``device``."""
    n, H, W = spec["n_frames"], spec["H"], spec["W"]
    K, poses = orbit(n, H, W, spec["span_deg"], spec["cam_dist"], spec["elevation_deg"])
    rng = np.random.default_rng(seed)
    rgb, hits, depths = render_sphere_frames(K, poses, H, W, device)
    frames = list(zip(hits, depths))
    # 8-bit BGR over 256, 3-channel masks of 255/256, black background
    images_np = (rgb[..., ::-1] * 255).astype(np.uint8).astype(np.float32) / 256.0
    masks_np = np.repeat((hits * 255).astype(np.uint8)[..., None], 3, -1).astype(
        np.float32) / 256.0
    images_np[masks_np < 0.5] = 0.0
    intr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr[:, :3, :3] = K
    names = [f"{i:04d}" for i in range(n)]
    flows, pairs = {}, {}
    for i in range(n - 1):
        xys1, xys2 = exact_matches(K, poses[i], poses[i + 1], frames[i][0], frames[i][1],
                                   frames[i + 1][0], rng)
        xys1, xys2 = in_masks(xys1, xys2, masks_np[i][..., 0], masks_np[i + 1][..., 0], H, W)
        if len(xys1):
            a, b = names[i], names[i + 1]
            flows[f"{a}_{b}"] = (xys1[:, 0], xys1[:, 1], xys2[:, 0], xys2[:, 1])
            flows[f"{b}_{a}"] = (xys2[:, 0], xys2[:, 1], xys1[:, 0], xys1[:, 1])
            pairs.setdefault(a, []).append(b)
            pairs.setdefault(b, []).append(a)
    eye = np.eye(4, dtype=np.float32)
    return Scene(
        images_np=images_np, masks_np=masks_np, intrinsics_all=intr,
        intrinsics_all_inv=np.linalg.inv(intr), pose_all=poses, gt_poses=poses.copy(),
        crop_poses=noisy_poses(poses, spec["noise_deg"], rng),
        mask_bboxes=mask_bboxes(masks_np), H=H, W=W, n_images=n,
        max_mask_pose=mask_init_pose(masks_np[0][..., 0], K, spec["crop"]),
        scale_mats_np=[eye.copy() for _ in range(n)],
        object_bbox_min=np.full(3, -1.01), object_bbox_max=np.full(3, 1.01),
        index_to_frame=dict(enumerate(names)),
        frame_to_index={nm: i for i, nm in enumerate(names)},
        loftr_flows=flows, flow_pairs=pairs)


def device_tensors(scene: Scene, device):
    """The scene as the reference reads it, on ``device``: images, masks
    (one channel), K, its inverse and the mask boxes."""
    import torch
    return {"images": torch.as_tensor(scene.images_np, device=device),
            "masks": torch.as_tensor(scene.masks_np[..., 0], device=device),
            "K": torch.as_tensor(scene.intrinsics_all[:, :3, :3], device=device),
            "intr_inv": torch.as_tensor(scene.intrinsics_all_inv, device=device),
            "bbox": torch.as_tensor(scene.mask_bboxes, device=device)}
