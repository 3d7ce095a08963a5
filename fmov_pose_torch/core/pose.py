"""Rigid-pose algebra on [..., 3, 4] camera-to-world matrices (port of
``fmov_pose_tpu/core/pose.py``)."""

from __future__ import annotations

import torch

__all__ = [
    "make_pose",
    "invert",
    "compose_pair",
    "compose",
    "to_hom",
    "to_4x4",
    "world2cam",
    "cam2img",
    "img2cam",
    "cam2world",
    "procrustes",
    "apply_sim3",
]


def make_pose(R=None, t=None) -> torch.Tensor:
    """Assemble [..., 3, 4] from R [..., 3, 3] and/or t [..., 3]."""
    if R is None:
        t = torch.as_tensor(t, dtype=torch.float32)
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(
            t.shape[:-1] + (3, 3))
    elif t is None:
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    else:
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.as_tensor(t, dtype=torch.float32, device=R.device)
    return torch.cat([R, t[..., None]], dim=-1)


def invert(pose: torch.Tensor) -> torch.Tensor:
    """Invert a rigid [..., 3, 4] pose (R orthonormal)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-2, -1)
    return torch.cat([R_inv, -(R_inv @ t)], dim=-1)


def compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return torch.cat([R_b @ R_a, R_b @ t_a + t_b], dim=-1)


def compose(pose_list) -> torch.Tensor:
    """Compose a list left-to-right: poseN o ... o pose1."""
    out = pose_list[0]
    for p in pose_list[1:]:
        out = compose_pair(out, p)
    return out


def to_hom(X: torch.Tensor) -> torch.Tensor:
    """Append homogeneous 1: [..., d] -> [..., d+1]."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def to_4x4(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with bottom row (0, 0, 0, 1)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype,
                          device=pose.device).expand(pose.shape[:-2] + (1, 4))
    return torch.cat([pose, bottom], dim=-2)


def world2cam(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """World points [..., N, 3] through w2c pose [..., 3, 4]."""
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2img(X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    return X @ intr.transpose(-1, -2)


def img2cam(X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    return X @ torch.linalg.inv(intr).transpose(-1, -2)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Camera points through the inverse of the given c2w's inverse (== c2w)."""
    return to_hom(X) @ invert(pose).transpose(-1, -2)


def procrustes(X0: torch.Tensor, X1: torch.Tensor):
    """Similarity alignment of point sets [N, 3] -> dict(t0, t1, s0, s1, R).

    X1 maps onto X0 by ``(X1 - t1)/s1 @ R.T * s0 + t0``.
    """
    t0 = X0.mean(dim=0, keepdim=True)
    t1 = X1.mean(dim=0, keepdim=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c ** 2).sum(-1).mean()) + 1e-8
    s1 = torch.sqrt((X1c ** 2).sum(-1).mean()) + 1e-8
    U, _, Vt = torch.linalg.svd((X0c / s0).T @ (X1c / s1))
    det = torch.linalg.det(U @ Vt)
    # reflection fix without branching
    flip = torch.ones(3, dtype=U.dtype, device=U.device)
    flip[2] = torch.where(det < 0, -1.0, 1.0)
    R = (U * flip) @ Vt
    return {"t0": t0[0], "t1": t1[0], "s0": s0, "s1": s1, "R": R}


def apply_sim3(sim3, X1: torch.Tensor) -> torch.Tensor:
    """Apply the procrustes() result to map X1 into X0's frame."""
    return (X1 - sim3["t1"]) / sim3["s1"] @ sim3["R"].T * sim3["s0"] + sim3["t0"]
