"""Scene normalization: object-centered unit-sphere scale matrices.

A copy of the JAX package's ``fmov_pose_tpu/pipeline/norm.py`` (numpy and
OpenCV on the host), the re-implementation of the reference repo's
`utils/get_norm_matrix.py` (IDR/NeuS preprocessing): per-mask-point
epipolar min/max depth bracketing across cameras, then a visual-hull
refinement on a 100^3 grid, producing the `scale_mat_i` entries of
cameras_sphere.npz.  The mask points are drawn from an unseeded generator
when none is given, as in the reference.  OpenCV is imported where it is
called, so that importing the port does not load it.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

__all__ = ["get_normalization", "normalization_from_masks"]


def _glob_imgs(path):
    out = []
    for ext in ("*.png", "*.jpg", "*.JPEG", "*.JPG"):
        out.extend(glob(os.path.join(path, ext)))
    return out


def _fundamental_matrix(P_1, P_2):
    """F mapping points in camera-2's image to epipolar lines in camera-1."""
    P_2_center = np.linalg.svd(P_2)[-1][-1, :]
    epipole = P_1 @ P_2_center
    ex = np.array([
        [0.0, -epipole[2], epipole[1]],
        [epipole[2], 0.0, -epipole[0]],
        [-epipole[1], epipole[0], 0.0],
    ])
    return ex @ P_1 @ np.linalg.pinv(P_2)


def _min_max_depth(curx, cury, P_j, sil_j, P_0, F_j0):
    """Depth bracket of pixel (curx, cury) in cam 0 against cam j's
    silhouette via epipolar transfer + triangulation."""
    import cv2
    line = F_j0 @ np.array([curx, cury, 1.0])
    line = line / np.linalg.norm(line[:2])
    dists = np.abs(sil_j.T @ line)
    pts = sil_j[:, dists < 0.7]
    if pts.shape[1] == 0:
        return 0.0, 0.0
    X = cv2.triangulatePoints(
        P_0, P_j,
        np.tile(np.array([curx, cury], np.float64), (pts.shape[1], 1)).T,
        pts[:2, :])
    depths = P_0[2] @ (X / X[3])
    depths = depths[depths >= 0]
    if depths.shape[0] == 0:
        return 0.0, 0.0
    return float(depths.min()), float(depths.max())


def _refine_visual_hull(masks, Ps, scale, center, grid_size=100,
                        minimal_views=None):
    num_cam, h, w = masks.shape[0], masks.shape[1], masks.shape[2]
    if minimal_views is None:
        minimal_views = min(25, num_cam)
    lin = np.linspace(-scale, scale, grid_size)
    xx, yy, zz = np.meshgrid(lin, lin, lin)
    points = np.stack((xx.flatten(), yy.flatten(), zz.flatten()))
    points = points + center[:, None]
    appears = np.zeros((grid_size**3,), np.int32)
    hom = np.concatenate([points, np.ones((1, points.shape[1]))], axis=0)
    for i in range(num_cam):
        proj = Ps[i] @ hom
        depths = proj[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            pix = np.round(proj[:2] / depths).astype(np.int64)
        ok = ((pix[0] >= 0) & (pix[0] < w) & (pix[1] >= 0) & (pix[1] < h)
              & (depths > 0))
        idx = np.where(ok)[0]
        inmask = masks[i][pix[1, idx], pix[0, idx]] > 0.5
        appears[idx[inmask]] += 1
    final = points[:, appears >= minimal_views]
    if final.shape[1] == 0:
        return center, scale, points.T
    centroid = final.mean(axis=1)
    spread = np.sqrt(((final - centroid[:, None]) ** 2).sum(axis=0)).mean() * 3
    return centroid, spread, final.T


def normalization_from_masks(Ps, mask_points_all, masks_all,
                             n_points=100, rng=None):
    """Compute the 4x4 normalization (scale) matrix from projection
    matrices + mask silhouettes (`get_norm_matrix.py:201-264`)."""
    rng = rng or np.random.default_rng()
    P_0 = Ps[0]
    Fs = np.array([_fundamental_matrix(Ps[i], P_0) for i in range(len(Ps))])
    P_0_center = np.linalg.svd(P_0)[-1][-1, :]
    P_0_center = P_0_center / P_0_center[3]

    xs, ys = mask_points_all[0][0, :], mask_points_all[0][1, :]
    all_Xs = []
    for i in rng.permutation(xs.shape[0])[:n_points]:
        curx, cury = xs[i], ys[i]
        seen_everywhere = True
        max_d_all, min_d_all = 1e10, 1e-10
        for j in range(1, len(Ps), 5):
            min_d, max_d = _min_max_depth(
                curx, cury, Ps[j], mask_points_all[j], P_0, Fs[j])
            if abs(min_d) < 1e-5:
                seen_everywhere = False
                break
            max_d_all = min(max_d_all, max_d)
            min_d_all = max(min_d_all, min_d)
            if max_d_all < min_d_all + 1e-2:
                seen_everywhere = False
                break
        if seen_everywhere:
            direction = np.linalg.inv(P_0[:3, :3]) @ np.array([curx, cury, 1.0])
            all_Xs.append(P_0_center[:3] + direction * min_d_all)
            all_Xs.append(P_0_center[:3] + direction * max_d_all)

    if not all_Xs:
        raise RuntimeError("no normalization points survived epipolar check")
    centroid = np.array(all_Xs).mean(axis=0)
    scale = np.array(all_Xs).std()
    centroid, scale, _ = _refine_visual_hull(masks_all, Ps, scale, centroid)

    normalization = np.eye(4, dtype=np.float32)
    normalization[:3, 3] = centroid
    normalization[0, 0] = normalization[1, 1] = normalization[2, 2] = scale
    return normalization


def get_normalization(source_dir, use_linear_init=False, masks_dir=None):
    """Read cameras_sphere.np[yz] + masks, write back with scale mats
    (`get_norm_matrix.py:267-312`)."""
    import cv2
    n_points = 1000 if use_linear_init else 100
    cameras_filename = ("cameras_linear_init" if use_linear_init
                        else "cameras_sphere")
    masks_dir = masks_dir or os.path.join(source_dir, "mask_obj")
    npy_path = os.path.join(source_dir, cameras_filename + ".npy")
    npz_path = os.path.join(source_dir, cameras_filename + ".npz")
    if os.path.exists(npy_path):
        cameras = np.load(npy_path, allow_pickle=True).item()
    else:
        cameras = np.load(npz_path)

    mask_paths = sorted(_glob_imgs(masks_dir),
                        key=lambda x: x.split("/")[-1].split(".")[0])
    mask_points_all, mask_ims = [], []
    for path in mask_paths:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.float64) / 255.0
        cur = img > 0.5
        ys_, xs_ = np.where(cur)
        mask_points_all.append(
            np.stack((xs_, ys_, np.ones_like(xs_))).astype(np.float64))
        mask_ims.append(cur)
    masks_all = np.array(mask_ims)
    n_cams = len(masks_all)
    Ps = np.array([cameras[f"world_mat_{i}"][:3, :].astype(np.float64)
                   for i in range(n_cams)])

    normalization = normalization_from_masks(Ps, mask_points_all, masks_all,
                                             n_points)

    cameras_new = {}
    for i in range(n_cams):
        cameras_new[f"scale_mat_{i}"] = normalization
        cameras_new[f"world_mat_{i}"] = np.concatenate(
            (Ps[i], np.array([[0, 0, 0, 1.0]])), axis=0).astype(np.float32)
    if os.path.exists(npy_path):
        np.save(npy_path, cameras_new)
    else:
        np.savez(npz_path, **cameras_new)
    return normalization
