"""Pose/trajectory plots (matplotlib with the Agg backend): a copy of the JAX
package's ``fmov_pose_tpu/pipeline/vis.py``.

Camera frustum wireframes and 3D trajectory comparisons written as PNGs,
the counterpart of the reference repo's
`utils/nope_nerf_utils_poses/vis_cam_traj.py` and `utils/draw_plotly.py`.
matplotlib is imported where a figure is drawn, so the module imports on
a machine without it; the callers (``align._eval_and_report``) log a
warning and go on when the import fails, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np

__all__ = ["frustum_points", "vis_poses", "vis_simple_traj"]


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def frustum_points(c2w, H, W, fx, fy, frustum_length=0.5):
    """5 corner points (apex + 4 image-plane corners) of a camera frustum."""
    half_w = frustum_length * W / (2.0 * fx)
    half_h = frustum_length * H / (2.0 * fy)
    corners = np.array([
        [0, 0, 0],
        [-half_w, -half_h, frustum_length],
        [half_w, -half_h, frustum_length],
        [half_w, half_h, frustum_length],
        [-half_w, half_h, frustum_length],
    ])
    return corners @ np.asarray(c2w)[:3, :3].T + np.asarray(c2w)[:3, 3]


_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]


def _draw_frustums(ax, poses, H, W, fx, fy, color, length):
    for c2w in poses:
        pts = frustum_points(c2w, H, W, fx, fy, length)
        for a, b in _EDGES:
            ax.plot(*zip(pts[a], pts[b]), color=color, linewidth=0.6)


def vis_poses(est_poses, gt_poses, H, W, fx, fy, save_path,
              frustum_length=None):
    """Frustum comparison (est green, gt red) — counterpart of
    `vis_cam_traj.py:197-245`."""
    plt = _pyplot()
    est_poses = np.asarray(est_poses)
    gt_poses = np.asarray(gt_poses) if gt_poses is not None else None
    centers = est_poses[:, :3, 3]
    if gt_poses is not None:
        centers = np.concatenate([centers, gt_poses[:, :3, 3]])
    span = max(np.ptp(centers, axis=0).max(), 1e-3)
    length = frustum_length or 0.15 * span

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    _draw_frustums(ax, est_poses, H, W, fx, fy, "tab:green", length)
    if gt_poses is not None:
        _draw_frustums(ax, gt_poses, H, W, fx, fy, "tab:red", length)
    ax.plot(*est_poses[:, :3, 3].T, color="tab:green", label="estimated")
    if gt_poses is not None:
        ax.plot(*gt_poses[:, :3, 3].T, color="tab:red", label="ground truth")
    ax.legend()
    ax.set_box_aspect((1, 1, 1))
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def vis_simple_traj(est_poses, gt_poses, save_path, no_gt=False, H=None,
                    W=None):
    """Camera-center trajectory lines (`vis_cam_traj.py:265-347`)."""
    plt = _pyplot()
    est_poses = np.asarray(est_poses)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    t = est_poses[:, :3, 3]
    ax.plot(t[:, 0], t[:, 1], t[:, 2], "-o", markersize=2,
            color="tab:green", label="estimated")
    if gt_poses is not None and not no_gt:
        g = np.asarray(gt_poses)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 1], g[:, 2], "-o", markersize=2,
                color="tab:red", label="ground truth")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
