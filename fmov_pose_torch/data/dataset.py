"""Host-side dataset: IDR-convention cameras, masks, LoFTR matches (port of
``fmov_pose_tpu/data/dataset.py``).

Loads a sequence directory (``image/*.png``, ``mask_obj/*.png``,
``cameras_sphere.npz``, optional ``transform_matrixs.npy``,
``noise_cameras_sphere.npz`` and LoFTR match files) into the numpy fields
the Runner reads, with the JAX module's conventions: images and masks BGR
divided by 256; P = world_mat @ scale_mat decomposed into a normalized K
and a c2w pose; the match filtering (3-sigma outliers, the crop
transform, the image border, mask membership); the mask-init seed pose
from frame 0's mask; per-frame mask bboxes for mask-guided sampling.

OpenCV is imported only where PNGs are read, so the GPU machine, which
has no OpenCV, can import this module (``data/scene.py`` uses its
functions).  The decomposition is ``scipy.linalg.rq`` with the signs fixed
so that K has a positive diagonal, the convention of
``cv2.decomposeProjectionMatrix``.  Optional depth maps (``depth_weight``)
are not ported: the Runner raises for them.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import linalg

__all__ = ["Dataset", "load_K_Rt_from_P", "apply_2d_transform", "mask_init_pose",
           "filter_matches", "add_flow_pair", "mask_bboxes"]


def load_K_Rt_from_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection K [R | -R C] into (4x4 intrinsics with
    K[2, 2] = 1, 4x4 c2w pose [R^T | C])."""
    P = np.asarray(P, np.float64)
    K, R = linalg.rq(P[:, :3])
    signs = np.diag(np.sign(np.diag(K)))
    K, R = K @ signs, signs @ R          # signs is its own inverse
    center = -np.linalg.solve(P[:, :3], P[:, 3])
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = center
    return intrinsics, pose


def apply_2d_transform(coords: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Apply a 3x3 affine to [N, 2] pixel coords."""
    hom = np.concatenate([coords, np.ones((coords.shape[0], 1))], axis=-1)
    return (M @ hom.T).T[:, :2]


def mask_init_pose(mask: np.ndarray, K: np.ndarray, crop: bool) -> np.ndarray:
    """The phase-1 seed pose from one frame's mask [H, W] (> 0.5 inside)
    and its K [3, 3]: the camera on the -z axis at the distance that
    fits the mask's footprint to the unit sphere (centred on it without
    ``crop``)."""
    ys, xs = np.where(mask > 0.5)
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    cam_pts = (np.linalg.inv(K) @ pix.T).T
    cam_pts = cam_pts / cam_pts[:, 2:]
    pose = np.eye(4, dtype=np.float32)
    if crop:
        xy_radius = np.linalg.norm(cam_pts[:, :2], axis=-1).max()
        pose[:3, 3] = np.array([0.0, 0.0, -0.9 / xy_radius])
    else:
        lo, hi = cam_pts[:, :2].min(0), cam_pts[:, :2].max(0)
        center = (lo + hi) / 2
        xy_radius = np.linalg.norm(cam_pts[:, :2] - center[None], axis=-1).max()
        pose[:3, 3] = np.array([center[0], center[1], 1.0]) * (-0.9 / xy_radius)
    return pose


def filter_matches(xys1, xys2, m1, m2, H: int, W: int, T1=None, T2=None,
                   filter_outliers: bool = False):
    """One frame pair's matches [N, 2] -> the kept ones: 3-sigma outliers
    of the match distance (``filter_outliers``), the crop transforms T1/T2
    (3x3, or None), the image border, and both frames' masks [H, W]."""
    if filter_outliers:
        d = np.linalg.norm(xys1 - xys2, axis=-1)
        keep = np.abs(d - d.mean()) < 3 * d.std()
        xys1, xys2 = xys1[keep], xys2[keep]
    if T1 is not None:
        xys1 = apply_2d_transform(xys1, T1)
        xys2 = apply_2d_transform(xys2, T2)
    keep = ((xys1[:, 0] >= 0) & (xys1[:, 0] < W) & (xys1[:, 1] >= 0) & (xys1[:, 1] < H)
            & (xys2[:, 0] >= 0) & (xys2[:, 0] < W) & (xys2[:, 1] >= 0) & (xys2[:, 1] < H))
    xys1, xys2 = xys1[keep], xys2[keep]
    keep = ((m1[xys1[:, 1].astype(int), xys1[:, 0].astype(int)] > 0.5)
            & (m2[xys2[:, 1].astype(int), xys2[:, 0].astype(int)] > 0.5))
    return xys1[keep], xys2[keep]


def add_flow_pair(loftr_flows: Dict[str, tuple], flow_pairs: Dict[str, set],
                  f1: str, f2: str, xys1, xys2) -> None:
    """Record frames f1 and f2's matches in both directions."""
    loftr_flows.setdefault(f"{f1}_{f2}", (xys1[:, 0], xys1[:, 1], xys2[:, 0], xys2[:, 1]))
    loftr_flows.setdefault(f"{f2}_{f1}", (xys2[:, 0], xys2[:, 1], xys1[:, 0], xys1[:, 1]))
    flow_pairs.setdefault(f1, set()).add(f2)
    flow_pairs.setdefault(f2, set()).add(f1)


def mask_bboxes(masks_np) -> np.ndarray:
    """Per-frame [ymin, ymax, xmin, xmax] of masks [N, H, W, 3] > 0.5 (the
    whole frame where a mask is empty)."""
    n, H, W = masks_np.shape[:3]
    boxes = np.zeros((n, 4), np.int32)
    for i in range(n):
        ys, xs = np.where(masks_np[i][:, :, 0] > 0.5)
        boxes[i] = ((0, H, 0, W) if len(ys) == 0
                    else (ys.min(), ys.max() + 1, xs.min(), xs.max() + 1))
    return boxes


def _read_pngs(paths) -> np.ndarray:
    import cv2 as cv
    return np.stack([cv.imread(p) for p in paths]).astype(np.float32) / 256.0


class Dataset:
    """The JAX ``Dataset``'s fields that training reads, from
    ``conf["data_dir"]`` (the object bbox and depth maps, which only mesh
    export and depth supervision read, are not ported)."""

    def __init__(self, conf, exp_dir: Optional[str] = None):
        self.exp_dir = exp_dir
        self.data_dir = conf.get_string("data_dir")
        camera_dir = exp_dir if exp_dir is not None else self.data_dir
        self.render_cameras_name = conf.get_string(
            "render_cameras_name", "cameras_sphere.npz")
        camera_dict = None
        if not conf.get_bool("unknown_camera", False):
            cam_path = os.path.join(camera_dir, self.render_cameras_name)
            if os.path.exists(cam_path):
                camera_dict = (np.load(cam_path) if cam_path.endswith(".npz")
                               else np.load(cam_path, allow_pickle=True).item())

        self.images_lis = sorted(glob(os.path.join(self.data_dir, "image/*")))
        assert self.images_lis, f"no images in {self.data_dir}/image"
        self.masks_lis = sorted(glob(os.path.join(self.data_dir, "mask_obj/*")))
        assert self.masks_lis, f"no masks in {self.data_dir}/mask_obj"
        self.n_images = len(self.images_lis)
        self.images_np = _read_pngs(self.images_lis)
        self.masks_np = _read_pngs(self.masks_lis)
        if conf.get_bool("wo_mask", False):
            self.images_np[self.masks_np < 0.5] = 0.0

        self.start_idx = conf.get_int("start_idx", 0)
        self.end_idx = conf.get_int("end_idx", self.n_images)
        self.frame_to_index: Dict[str, int] = {}
        self.index_to_frame: Dict[int, str] = {}
        for idx, name in enumerate(self.images_lis[self.start_idx:self.end_idx]):
            stem = os.path.basename(name).split(".")[0]
            self.frame_to_index[stem] = idx
            self.index_to_frame[idx] = stem
        self.image_names_set = set(self.frame_to_index)
        self.H, self.W = self.images_np.shape[1], self.images_np.shape[2]

        self.avai_ann_frame = []
        self.crop_poses = None
        self.crop_transforms = None
        self.loftr_flows: Dict[str, tuple] = {}
        self.flow_pairs: Dict[str, set] = {}
        self.max_mask_pose = None
        intrinsics, poses, gt = self._load_cameras(conf, camera_dict)
        # crop-init may supply the intrinsics when no frame is annotated
        self._load_crop_init(conf, camera_dir, intrinsics, gt)
        self.intrinsics_all = np.stack(intrinsics).astype(np.float32)
        self.pose_all = (np.stack(poses).astype(np.float32) if poses
                         else np.zeros((0, 4, 4), np.float32))
        self.gt_poses = (np.stack(gt).astype(np.float32) if gt
                         else np.zeros((0, 4, 4), np.float32))
        self.crop = conf.get_bool("crop", False)
        if self.crop:
            self.crop_transforms = np.load(
                os.path.join(self.data_dir, "transform_matrixs.npy"),
                allow_pickle=True).item()
        self._load_loftr(conf)
        self.mask_init = conf.get_bool("mask_init", False)
        if self.mask_init:
            # the reference seeds from the first frame
            self.max_mask_pose = mask_init_pose(
                self.masks_np[0][:, :, 0], self.intrinsics_all[0][:3, :3], self.crop)
            self.max_mask_index = 0

        sl = slice(self.start_idx, self.end_idx)
        self.images_np = self.images_np[sl]
        self.masks_np = self.masks_np[sl]
        self.intrinsics_all = self.intrinsics_all[sl]
        self.intrinsics_all_inv = np.linalg.inv(self.intrinsics_all)
        if len(self.gt_poses):
            self.pose_all = self.pose_all[sl]
            self.gt_poses = self.gt_poses[sl]
        self.n_images = self.images_np.shape[0]
        self.mask_bboxes = mask_bboxes(self.masks_np)

    # ------------------------------------------------------------------
    def _load_cameras(self, conf, camera_dict):
        """(intrinsics, poses, gt poses) lists of the configured source."""
        intrinsics, poses, gt = [], [], []
        n = self.n_images
        eye = np.eye(4, dtype=np.float32)
        ml_intr = conf.get("ml_camera_intrinsics", "")
        if ml_intr or conf.get_bool("unknown_camera", False):
            if ml_intr:
                with open(ml_intr) as f:
                    K = np.array([list(map(float, f.readline().split()))
                                  for _ in range(3)])
            else:
                K = np.load(os.path.join(self.data_dir, "K.npy"))
            for _ in range(n):
                intr = eye.copy()
                intr[:3, :3] = K
                intrinsics.append(intr)
                poses.append(eye.copy())
        elif conf.get_bool("partial_ann", False):
            def P_of(k):
                return (camera_dict[f"world_mat_{k}"].astype(np.float32)
                        @ camera_dict[f"scale_mat_{k}"].astype(np.float32))[:3, :4]

            annotated = {k for k in self.frame_to_index
                         if camera_dict is not None and f"world_mat_{k}" in camera_dict}
            # an unannotated frame takes the intrinsics of the annotated
            # frame before it (of the first one before any)
            first = next((k for k in self.frame_to_index if k in annotated), None)
            shared = load_K_Rt_from_P(P_of(first))[0] if first is not None else None
            for k in self.frame_to_index:
                if k in annotated:
                    intr, pose = load_K_Rt_from_P(P_of(k))
                    shared = intr
                    gt.append(pose)
                    intrinsics.append(intr)
                    poses.append(pose)
                    self.avai_ann_frame.append(self.frame_to_index[k])
                elif shared is not None:
                    intrinsics.append(shared)
        elif camera_dict is not None:
            # full annotation (GT-pose NeuS), indices 0..n-1
            for i in range(n):
                P = (camera_dict[f"world_mat_{i}"].astype(np.float32)
                     @ camera_dict[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
                intr, pose = load_K_Rt_from_P(P)
                intrinsics.append(intr)
                poses.append(pose)
                gt.append(pose)
                self.avai_ann_frame.append(i)
        else:
            raise NotImplementedError("no camera source configured")
        return intrinsics, poses, gt

    def _load_crop_init(self, conf, camera_dir, intrinsics, gt):
        self.use_crop_init = conf.get_bool("use_crop_init", False)
        if not self.use_crop_init:
            return
        noise_path = os.path.join(camera_dir, "noise_cameras_sphere.npz")
        noise_dict = np.load(noise_path)
        n_noise = sum(1 for k in noise_dict.files if k.startswith("world_mat_"))
        if n_noise < self.n_images:
            raise ValueError(
                f"noise init {noise_path} covers {n_noise} frames but the image "
                f"dir has {self.n_images}: phase 1 did not admit/align every frame")
        use_noise_intrinsic = len(gt) == 0
        crop_poses = []
        for i in range(self.n_images):
            P = (noise_dict[f"world_mat_{i}"] @ noise_dict[f"scale_mat_{i}"])[:3, :4]
            intr, pose = load_K_Rt_from_P(P.astype(np.float32))
            crop_poses.append(pose)
            if use_noise_intrinsic:
                intrinsics.append(intr)
        self.crop_poses = np.stack(crop_poses).astype(np.float32)

    def _load_loftr(self, conf):
        flow_dir = conf.get("loftr_interval_flow_dir", None)
        self.filter_match_outliers = conf.get_bool("filter_match_outliers", False)
        if flow_dir is None:
            return
        seq_name = self.data_dir.rstrip("/").split("/")[-1].split("_")[0]
        seq_flow_dir = os.path.join(flow_dir, seq_name)
        if not os.path.isdir(seq_flow_dir):
            return
        for fname in sorted(os.listdir(seq_flow_dir)):
            f1, f2 = fname.split("_")[:2]
            f2 = f2.split(".")[0]
            if f1 not in self.image_names_set or f2 not in self.image_names_set:
                continue
            rows = np.loadtxt(os.path.join(seq_flow_dir, fname), ndmin=2)
            if rows.size == 0:
                continue
            T1 = T2 = None
            if self.crop:
                T1, T2 = self.crop_transforms[f1], self.crop_transforms[f2]
            xys1, xys2 = filter_matches(
                rows[:, :2], rows[:, 2:4],
                self.masks_np[self.frame_to_index[f1]][..., 0],
                self.masks_np[self.frame_to_index[f2]][..., 0], self.H, self.W,
                T1, T2, self.filter_match_outliers)
            add_flow_pair(self.loftr_flows, self.flow_pairs, f1, f2, xys1, xys2)
