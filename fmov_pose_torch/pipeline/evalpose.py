"""Pose-trajectory metrics: Umeyama Sim(3) alignment, ATE-RMSE, RPE.

A copy of the JAX package's ``fmov_pose_tpu/pipeline/evalpose.py`` (numpy
only), so that the port reports the same numbers without importing that
package.  It consolidates the reference repo's evaluation stack
(`utils/nope_nerf_utils_poses/comp_ate.py:35-78`,
`utils/ATE/align_trajectory.py:30-82`, `align_utils.py:115-143`,
`align_traj.py:28-75`) into one module.
"""

from __future__ import annotations

import numpy as np

__all__ = ["align_umeyama", "align_ate_c2b_use_a2b", "compute_ATE",
           "compute_rpe"]


def align_umeyama(model: np.ndarray, data: np.ndarray,
                  known_scale: bool = False):
    """Least-squares Sim(3): model ~= s * R @ data + t. Returns (s, R, t)."""
    mu_M, mu_D = model.mean(0), data.mean(0)
    model_c, data_c = model - mu_M, data - mu_D
    n = model.shape[0]
    C = (model_c.T @ data_c) / n
    sigma2 = (data_c * data_c).sum() / n
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt.T) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0 if known_scale else np.trace(np.diag(D) @ S) / sigma2
    t = mu_M - s * R @ mu_D
    return s, R, t


def align_ate_c2b_use_a2b(traj_a: np.ndarray, traj_b: np.ndarray,
                          traj_c: np.ndarray | None = None) -> np.ndarray:
    """Align trajectory c to b using the Sim(3) fit from a to b.

    traj_*: [N, 3/4, 4] c2w poses. Returns aligned [N1, 4, 4].
    """
    traj_a = np.asarray(traj_a, np.float64)
    traj_b = np.asarray(traj_b, np.float64)
    traj_c = traj_a.copy() if traj_c is None else np.asarray(traj_c, np.float64)

    s, R, t = align_umeyama(traj_b[:, :3, 3], traj_a[:, :3, 3])

    R_c = traj_c[:, :3, :3]
    t_c = traj_c[:, :3, 3:4]
    R_aligned = R[None] @ R_c
    t_aligned = s * (R[None] @ t_c) + t[None, :, None]
    out = np.zeros((traj_c.shape[0], 4, 4))
    out[:, :3, :3] = R_aligned
    out[:, :3, 3:] = t_aligned
    out[:, 3, 3] = 1.0
    return out.astype(np.float32)


def _rotation_error(pose_error: np.ndarray) -> float:
    d = 0.5 * (pose_error[0, 0] + pose_error[1, 1] + pose_error[2, 2] - 1.0)
    return float(np.arccos(max(min(d, 1.0), -1.0)))


def compute_ATE(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE of absolute translation error over aligned trajectories."""
    err = gt[:, :3, 3] - pred[: len(gt), :3, 3]
    return float(np.sqrt((np.linalg.norm(err, axis=-1) ** 2).mean()))


def compute_rpe(gt: np.ndarray, pred: np.ndarray):
    """Mean relative-pose errors (translation, rotation rad) over
    consecutive frame pairs."""
    trans_errors, rot_errors = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pred_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        rel_err = np.linalg.inv(gt_rel) @ pred_rel
        trans_errors.append(float(np.linalg.norm(rel_err[:3, 3])))
        rot_errors.append(_rotation_error(rel_err))
    return float(np.mean(trans_errors)), float(np.mean(rot_errors))
