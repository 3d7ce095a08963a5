"""Phase-transition alignment: virtual-camera poses -> real-camera dataset.

A copy of the JAX package's ``fmov_pose_tpu/pipeline/align.py`` (numpy and
OpenCV on the host), the re-implementation of the reference repo's
`utils/align_poses.py`: sample mesh vertices, project them through each
learned virtual pose, undo the per-frame crop shift, PnP-RANSAC back to
the original camera, and write the phase-2 dataset
(noise_cameras_sphere.npz + normalized cameras_sphere.npz).  Where the
reference falls back it does too: the identity scale when the
normalization fails, the previous frame's pose (or the identity) when PnP
finds none.  OpenCV is imported where it is called.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from fmov_pose_torch.data.dataset import load_K_Rt_from_P
from fmov_pose_torch.pipeline import evalpose
from fmov_pose_torch.pipeline.meshio import read_ply
from fmov_pose_torch.pipeline.norm import get_normalization

LOG = logging.getLogger(__name__)

__all__ = ["align_poses", "align_poses_wo_virtual", "pnp_pose_from_mesh"]


def _load_ori_gt(ori_cam_path, img_names, Ks):
    """Original-resolution GT poses (HO3D ann) or fallback intrinsics (ML)."""
    eval_ids = set()
    ori_gt_poses = []
    camera_dict = {}
    if ori_cam_path is not None and os.path.exists(ori_cam_path):
        camera_dict = dict(np.load(ori_cam_path))
        ori_K = None
        for i, name in enumerate(img_names):
            if f"scale_mat_{name}" not in camera_dict:
                continue
            P = (camera_dict[f"world_mat_{name}"]
                 @ camera_dict[f"scale_mat_{name}"])[:3, :4]
            intrinsics, pose = load_K_Rt_from_P(P)
            if ori_K is None:
                ori_K = intrinsics
            ori_gt_poses.append(pose)
            eval_ids.add(i)
        ori_gt_poses = np.stack(ori_gt_poses) if ori_gt_poses else None
    else:
        ori_K = np.asarray(Ks[0])
        ori_gt_poses = None
    return camera_dict, ori_K, ori_gt_poses, eval_ids


def pnp_pose_from_mesh(mesh_pts, virtual_pose, K, transform_matrix, ori_K,
                       H, W, rng, n_sample=1000, max_tries=30):
    """One frame: mesh pts -> virtual-cam pixels -> unshift -> PnP.

    Returns the real-camera c2w pose [4, 4] or None when the projection
    never covers enough of the image (`align_poses.py:63-117`).
    """
    import cv2
    w2c = np.linalg.inv(virtual_pose)
    for _ in range(max_tries):
        pts = mesh_pts[rng.choice(mesh_pts.shape[0],
                                  min(n_sample, mesh_pts.shape[0]),
                                  replace=False)]
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        pix = (K[:3, :3] @ cam.T).T
        pix = pix[:, :2] / pix[:, 2:]
        ratio = np.mean((pix[:, 0] > 0) & (pix[:, 0] < W)
                        & (pix[:, 1] > 0) & (pix[:, 1] < H))
        if ratio < 0.3:
            continue
        hom = np.concatenate([pix, np.ones((pix.shape[0], 1))], axis=1)
        if transform_matrix is not None:
            hom = (np.linalg.inv(transform_matrix) @ hom.T).T
        ori_pix = hom[:, :2] / hom[:, 2:]
        ok, rvec, tvec, _ = cv2.solvePnPRansac(
            pts.astype(np.float64), ori_pix.astype(np.float64),
            ori_K[:3, :3].astype(np.float64), None,
            flags=cv2.SOLVEPNP_EPNP, reprojectionError=3, iterationsCount=100)
        if not ok:
            continue
        R = cv2.Rodrigues(rvec)[0]
        obj_pose = np.eye(4)
        obj_pose[:3, :3] = R
        obj_pose[:3, 3] = tvec.reshape(3)
        return np.linalg.inv(obj_pose)
    return None


def _write_phase2_dataset(tgt_dir, img_names, global_poses, ori_K,
                          camera_dict, normalize_trans, global_mask_dir,
                          data_root=None, case=None, save_meta=True):
    import cv2
    os.makedirs(tgt_dir, exist_ok=True)
    if save_meta and data_root is not None and case is not None:
        src = os.path.join(data_root, case.split("_")[0])
        for sub in ("image", "mask_obj"):
            os.makedirs(os.path.join(tgt_dir, sub), exist_ok=True)
            src_dir = os.path.join(src, sub)
            if os.path.isdir(src_dir):
                for name in img_names:
                    for ext in (".jpg", ".png"):
                        p = os.path.join(src_dir, name + ext)
                        if os.path.exists(p):
                            img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
                            cv2.imwrite(os.path.join(tgt_dir, sub, name + ext),
                                        img)
                            break
    noise_dict = {}
    for i in range(len(img_names)):
        noise_dict[f"world_mat_{i}"] = ori_K @ np.linalg.inv(global_poses[i])
        if not normalize_trans:
            noise_dict[f"scale_mat_{i}"] = np.eye(4)
    np.savez(os.path.join(tgt_dir, "cameras_sphere.npz"), **noise_dict)
    if normalize_trans:
        try:
            get_normalization(tgt_dir, False, masks_dir=global_mask_dir)
        except Exception as e:  # identity fallback (`align_poses.py:151-160`)
            LOG.warning("get_normalization failed (%s); identity scale", e)
            for i in range(len(img_names)):
                noise_dict[f"scale_mat_{i}"] = np.eye(4)
            np.savez(os.path.join(tgt_dir, "cameras_sphere.npz"), **noise_dict)
    os.replace(os.path.join(tgt_dir, "cameras_sphere.npz"),
               os.path.join(tgt_dir, "noise_cameras_sphere.npz"))
    np.savez(os.path.join(tgt_dir, "cameras_sphere.npz"), **camera_dict)


def _eval_and_report(exp_dir, img_names, iteration, eval_global_poses,
                     ori_gt_poses, ori_K, H, W):
    if ori_gt_poses is None or not len(eval_global_poses):
        return None
    est = np.stack(eval_global_poses)
    est_aligned = evalpose.align_ate_c2b_use_a2b(est, ori_gt_poses)
    ate = evalpose.compute_ATE(ori_gt_poses, est_aligned)
    rpe_trans, rpe_rot = evalpose.compute_rpe(ori_gt_poses, est_aligned)
    LOG.info("alignment ATE=%.5f rpe_trans=%.5f rpe_rot=%.4f", ate, rpe_trans,
             rpe_rot)
    try:
        from fmov_pose_torch.pipeline import vis
        vis.vis_poses(
            est_aligned, ori_gt_poses, H, W, ori_K[0, 0], ori_K[1, 1],
            os.path.join(exp_dir,
                         f"global_alignment{len(img_names)}_{iteration}"
                         f"_ate={ate:.5f}.png"))
    except Exception as e:
        LOG.warning("alignment vis failed: %s", e)
    return ate, rpe_trans, rpe_rot


def align_poses(ori_cam_path, mesh_path, pred_poses, Ks, transform_matrixs,
                exp_dir, img_names, iteration, case, H=480, W=640,
                save_dataset=True, normalize_trans=True, tgt_dir=None,
                save_meta=True, global_mask_dir=None, data_root=None,
                seed=0):
    """Virtual-camera (cropped) variant: un-shift pixels via the crop
    transform before PnP (`align_poses.py:12-208`)."""
    rng = np.random.default_rng(seed)
    camera_dict, ori_K, ori_gt_poses, eval_ids = _load_ori_gt(
        ori_cam_path, img_names, Ks)
    mesh_pts, _ = read_ply(mesh_path)

    global_poses, eval_global_poses = [], []
    for i in range(len(img_names)):
        pose = pnp_pose_from_mesh(
            mesh_pts, pred_poses[i], Ks[i],
            transform_matrixs[i] if transform_matrixs is not None else None,
            ori_K, H, W, rng)
        if pose is None:
            pose = global_poses[-1] if global_poses else np.eye(4)
        global_poses.append(pose)
        if i in eval_ids:
            eval_global_poses.append(pose)

    if save_dataset:
        out_dir = tgt_dir or f"./global_reset_data/{case}"
        _write_phase2_dataset(out_dir, img_names, global_poses, ori_K,
                              camera_dict, normalize_trans, global_mask_dir,
                              data_root, case, save_meta)
    else:
        noise_dict = {
            f"world_mat_{i}": ori_K @ np.linalg.inv(global_poses[i])
            for i in range(len(img_names))}
        np.savez(os.path.join(exp_dir, "noise_cameras_sphere.npz"),
                 **noise_dict)

    np.save(os.path.join(exp_dir,
                         f"global_poses_{len(img_names)}_{iteration}.npy"),
            np.stack(global_poses))
    return _eval_and_report(exp_dir, img_names, iteration, eval_global_poses,
                            ori_gt_poses, ori_K, H, W)


def align_poses_wo_virtual(ori_cam_path, mesh_path, pred_poses, Ks,
                           transform_matrixs, exp_dir, img_names, iteration,
                           case, H=480, W=640, save_dataset=True,
                           normalize_trans=True, tgt_dir=None, save_meta=True,
                           global_mask_dir=None, data_root=None, seed=0):
    """No-crop variant: learned poses pass through directly
    (`align_poses.py:211-307`)."""
    camera_dict, ori_K, ori_gt_poses, eval_ids = _load_ori_gt(
        ori_cam_path, img_names, Ks)
    global_poses = [np.asarray(pred_poses[i]) for i in range(len(img_names))]
    eval_global_poses = [global_poses[i] for i in sorted(eval_ids)]

    out_dir = tgt_dir or exp_dir
    _write_phase2_dataset(out_dir, img_names, global_poses, ori_K,
                          camera_dict, normalize_trans, global_mask_dir,
                          data_root, case, save_meta=False)
    np.save(os.path.join(exp_dir,
                         f"global_poses_{len(img_names)}_{iteration}.npy"),
            np.stack(global_poses))
    return _eval_and_report(exp_dir, img_names, iteration, eval_global_poses,
                            ori_gt_poses, ori_K, H, W)
