"""Virtual-camera preprocessing: object-centering warp + PnP GT poses.

A copy of the JAX package's ``fmov_pose_tpu/pipeline/preprocess.py``
(numpy and OpenCV, host only), importing ``apply_2d_transform`` and
``load_K_Rt_from_P`` from the port's ``data/dataset.py``.  It
re-implements the reference repo's `utils/virtual_cam_preprocess.py`:
per frame, translate (or crop+rescale) the object's mask-bbox center to
the image center, write the `<seq>_ori` / `<seq>_480` dataset, and — when
GT depth+pose annotations exist — back-project depth through the mask to
world points and PnP-RANSAC the shifted 2D<->3D pairs into virtual-camera
GT poses (quality-gated by the logged reprojection error, the reference's
only regression check, `virtual_cam_preprocess.py:335-347`).  OpenCV is
imported where it is called.

    python -m fmov_pose_torch.pipeline.preprocess --root DIR [--ori] [--has_gt]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from fmov_pose_torch.data.dataset import apply_2d_transform, load_K_Rt_from_P

LOG = logging.getLogger(__name__)

__all__ = ["get_crop_M", "get_crop_M_ori", "solve_pose_by_pnp",
           "preprocess_sequence"]


def get_crop_M_ori(mask: np.ndarray):
    """Pure translation: mask-bbox center -> image center
    (`virtual_cam_preprocess.py:54-67`)."""
    h, w = mask.shape[:2]
    ys, xs = np.where(mask > 0)
    if len(ys) < 3:
        return None
    cx = (xs.max() + xs.min()) / 2
    cy = (ys.max() + ys.min()) / 2
    M = np.array([[1.0, 0.0, w / 2 - cx],
                  [0.0, 1.0, h / 2 - cy],
                  [0.0, 0.0, 1.0]], np.float32)
    return M


def get_crop_M(mask: np.ndarray, patch_width=480, patch_height=480,
               patch_border=5):
    """Crop + rescale the object bbox into a patch (`:37-51`)."""
    ys, xs = np.where(mask > 0)
    if len(ys) < 3:
        return None
    cx = (xs.max() + xs.min()) / 2
    cy = (ys.max() + ys.min()) / 2
    raw_w = xs.max() - xs.min() + 2 * patch_border
    raw_h = ys.max() - ys.min() + 2 * patch_border
    scale = min(patch_width / raw_w, patch_height / raw_h)
    M = np.array([[scale, 0.0, patch_width / 2 - cx * scale],
                  [0.0, scale, patch_height / 2 - cy * scale],
                  [0.0, 0.0, 1.0]], np.float32)
    return M


def solve_pose_by_pnp(points_2d, points_3d, K, reprojection_error=3.0,
                      iterations=100):
    """EPNP+RANSAC w2c solve (`:97-129`). Returns (R, t, ok)."""
    import cv2
    if len(points_2d) < 4:
        return None, None, False
    ok, rvec, tvec, _ = cv2.solvePnPRansac(
        np.asarray(points_3d, np.float64), np.asarray(points_2d, np.float64),
        np.asarray(K, np.float64), None, flags=cv2.SOLVEPNP_EPNP,
        reprojectionError=reprojection_error, iterationsCount=iterations)
    if not ok:
        return None, None, False
    R = cv2.Rodrigues(rvec)[0].reshape(3, 3)
    t = tvec.reshape(-1)
    if np.isnan(R.sum()) or np.isnan(t.sum()):
        return None, None, False
    return R, t, True


def preprocess_sequence(data_dir: str, ori=True, has_gt=False,
                        crop_resolution=480, patch_border=5):
    """Process one sequence dir -> `<seq>_ori` (or `<seq>_<res>`).

    Returns (new_data_dir, reproj_errors).
    """
    import cv2
    new_data_dir = data_dir + ("_ori" if ori else f"_{crop_resolution}")
    if not ori and patch_border != 5:
        new_data_dir += f"_{patch_border}"
    os.makedirs(os.path.join(new_data_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(new_data_dir, "mask_obj"), exist_ok=True)

    image_dir = os.path.join(data_dir, "image")
    mask_dir = os.path.join(data_dir, "mask_obj")
    depth_dir = os.path.join(data_dir, "depth")

    image_names = [n.split(".")[0] for n in sorted(os.listdir(image_dir))]
    frame_to_id = {n: i for i, n in enumerate(image_names)}
    images = [cv2.imread(os.path.join(image_dir, f))
              for f in sorted(os.listdir(image_dir))]
    masks = [cv2.imread(os.path.join(mask_dir, f), cv2.IMREAD_GRAYSCALE)
             for f in sorted(os.listdir(mask_dir))]
    depths = []
    if os.path.isdir(depth_dir):
        for f in sorted(os.listdir(depth_dir)):
            p = os.path.join(depth_dir, f)
            depths.append(cv2.imread(p, cv2.IMREAD_UNCHANGED)
                          if f.endswith("png") else np.load(p))

    transform_matrixs, scales = [], []
    for i, name in enumerate(image_names):
        if ori:
            M = get_crop_M_ori(masks[i])
            shape = (masks[i].shape[1], masks[i].shape[0])
        else:
            M = get_crop_M(masks[i], crop_resolution, crop_resolution,
                           patch_border)
            shape = (crop_resolution, crop_resolution)
        new_img = cv2.warpAffine(images[i], M[:2], shape,
                                 flags=cv2.INTER_NEAREST)
        new_mask = cv2.warpAffine(masks[i], M[:2], shape,
                                  flags=cv2.INTER_NEAREST)
        scales.append(M[0, 0])
        transform_matrixs.append(M)
        cv2.imwrite(os.path.join(new_data_dir, "image", f"{name}.jpg"),
                    new_img)
        cv2.imwrite(os.path.join(new_data_dir, "mask_obj", f"{name}.jpg.png"),
                    new_mask)
    mean_scale = float(np.mean(scales))

    camera_dict = (np.load(os.path.join(data_dir, "cameras_sphere.npz"))
                   if has_gt else {})
    new_camera_dict = {}
    reproj_errors = []
    HO3D_K = None
    new_K = np.eye(3)
    new_K[:2, 2] = [crop_resolution / 2, crop_resolution / 2]

    avai = sorted({k.split("_")[2] for k in camera_dict.keys()
                   if "world_mat" in k})
    avai = [f for f in avai if f in frame_to_id]  # only named frames
    for frame in avai:
        P = (camera_dict[f"world_mat_{frame}"].astype(np.float32)
             @ camera_dict[f"scale_mat_{frame}"].astype(np.float32))[:3, :4]
        intrinsics, pose = load_K_Rt_from_P(P)
        scale_mat = camera_dict[f"scale_mat_{frame}"].astype(np.float32)
        if HO3D_K is None:
            HO3D_K = intrinsics[:3, :3]
            if ori:
                new_K = HO3D_K
            else:
                new_K[0, 0] = intrinsics[0, 0] * mean_scale
                new_K[1, 1] = intrinsics[1, 1] * mean_scale
        fid = frame_to_id[frame]
        gt_depth = depths[fid] / scale_mat[2, 2]
        ys, xs = np.where(masks[fid] > 0)
        cam_pts = np.stack([xs, ys, np.ones_like(xs)], -1) \
            * gt_depth[ys, xs, None]
        cam_pts = (np.linalg.inv(HO3D_K) @ cam_pts.T).T
        cam_hom = np.concatenate([cam_pts, np.ones((len(cam_pts), 1))], -1)
        world_pts = (pose @ cam_hom.T).T
        valid = np.linalg.norm(world_pts[:, :3], axis=-1) < 1
        world_pts = world_pts[valid]
        new_2d = apply_2d_transform(np.stack([xs, ys], -1).astype(np.float64),
                                    transform_matrixs[fid])[valid]

        R, t, ok = solve_pose_by_pnp(new_2d, world_pts[:, :3], new_K)
        if not ok:
            LOG.warning("PnP failed for frame %s", frame)
            continue
        Rt = np.concatenate([R, t[:, None]], -1)
        est = (new_K @ (Rt @ world_pts.T)).T
        est = est[:, :2] / est[:, 2:]
        reproj_errors.append(float(np.linalg.norm(new_2d - est, axis=-1).mean()))
        K4 = np.eye(4)
        K4[:3, :3] = new_K
        Rt4 = np.concatenate([Rt, np.array([[0, 0, 0, 1.0]])], 0)
        new_camera_dict[f"world_mat_{frame}"] = K4 @ Rt4
        new_camera_dict[f"scale_mat_{frame}"] = np.eye(4)

    if reproj_errors:
        LOG.info("reproj_error mean=%.4f std=%.4f", np.mean(reproj_errors),
                 np.std(reproj_errors))
    np.savez(os.path.join(new_data_dir, "cameras_sphere.npz"),
             **new_camera_dict)
    np.save(os.path.join(new_data_dir, "transform_matrixs.npy"),
            {n: transform_matrixs[i] for i, n in enumerate(image_names)})
    return new_data_dir, reproj_errors


def main():
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="./data_to_test_virtual_cam")
    parser.add_argument("--has_gt", default=False, action="store_true")
    parser.add_argument("--ori", default=False, action="store_true")
    parser.add_argument("--crop_resolution", type=int, default=480)
    parser.add_argument("--patch_border", type=int, default=5)
    args = parser.parse_args()
    for seq in os.listdir(args.root):
        if f"_{args.crop_resolution}" in seq or "_ori" in seq:
            continue
        preprocess_sequence(os.path.join(args.root, seq), ori=args.ori,
                            has_gt=args.has_gt,
                            crop_resolution=args.crop_resolution,
                            patch_border=args.patch_border)


if __name__ == "__main__":
    main()
