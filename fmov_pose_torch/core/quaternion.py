"""Quaternion helpers and the novel-view pose oscillation (port of
``fmov_pose_tpu/core/quaternion.py``).

Quaternions are (w, x, y, z), as in the reference.  ``R_to_q`` is the
branchless sign form of the reference's primary path, with its square
roots clamped at 0 (plus ``eps``) where the reference falls back to an
eigendecomposition.
"""

from __future__ import annotations

import math

import torch

from fmov_pose_torch.core.pose import compose, make_pose

__all__ = ["q_to_R", "R_to_q", "q_invert", "q_product", "slerp",
           "angle_to_rotation_matrix", "get_novel_view_poses"]


def q_to_R(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    qa, qb, qc, qd = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                        2 * (qa * qc + qb * qd)], dim=-1)
    row1 = torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                        2 * (qc * qd - qa * qb)], dim=-1)
    row2 = torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                        1 - 2 * (qb ** 2 + qc ** 2)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def R_to_q(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z)."""
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    def root(v):
        return 0.5 * torch.sqrt(torch.clamp(v, min=0.0) + eps)

    qa = root(1 + (R00 + R11 + R22))
    qb = torch.sign(R21 - R12) * root(1 + R00 - R11 - R22)
    qc = torch.sign(R02 - R20) * root(1 - R00 + R11 - R22)
    qd = torch.sign(R10 - R01) * root(1 - R00 - R11 + R22)
    return torch.stack([qa, qb, qc, qd], dim=-1)


def q_invert(q: torch.Tensor) -> torch.Tensor:
    """The quaternion inverse."""
    norm2 = (q * q).sum(dim=-1, keepdim=True)
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1) / norm2


def q_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The Hamilton product q1 q2."""
    a1, b1, c1, d1 = q1.unbind(-1)
    a2, b2, c2, d2 = q2.unbind(-1)
    return torch.stack([
        a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
    ], dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, u, eps: float = 1e-8) -> torch.Tensor:
    """Spherical interpolation between unit quaternions along the shorter
    arc; u in [0, 1] (a float or a tensor broadcasting against q0[..., 0])."""
    u = torch.as_tensor(u, dtype=q0.dtype, device=q0.device)[..., None]
    dot = (q0 * q1).sum(dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    near = sin_t < eps
    w0 = torch.where(near, 1.0 - u, torch.sin((1.0 - u) * theta) / (sin_t + eps))
    w1 = torch.where(near, u, torch.sin(u * theta) / (sin_t + eps))
    out = w0 * q0 + w1 * q1
    return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + eps)


def angle_to_rotation_matrix(a, axis: str) -> torch.Tensor:
    """The rotation by angle(s) ``a`` about one axis: the [cos -sin; sin
    cos] block rolled to the reference's position (X 1, Y 2, Z 0)."""
    roll = {"X": 1, "Y": 2, "Z": 0}[axis]
    a = torch.as_tensor(a)
    c, s = torch.cos(a), torch.sin(a)
    O, I = torch.zeros_like(a), torch.ones_like(a)
    M = torch.stack([torch.stack([c, -s, O], dim=-1),
                     torch.stack([s, c, O], dim=-1),
                     torch.stack([O, O, I], dim=-1)], dim=-2)
    return torch.roll(torch.roll(M, roll, dims=-2), roll, dims=-1)


def get_novel_view_poses(pose_anchor: torch.Tensor, N: int = 60,
                         scale: float = 1.0) -> torch.Tensor:
    """A small circular oscillation of N poses [N, 3, 4] around the w2c
    anchor pose [3, 4]."""
    pose_anchor = torch.as_tensor(pose_anchor, dtype=torch.float32)
    dev = pose_anchor.device
    theta = torch.arange(N, device=dev) / N * 2 * math.pi
    R_x = angle_to_rotation_matrix(torch.arcsin(torch.sin(theta) * 0.05), "X")
    R_y = angle_to_rotation_matrix(torch.arcsin(torch.cos(theta) * 0.05), "Y")
    pose_rot = make_pose(R=R_y @ R_x)
    pose_shift = make_pose(t=torch.tensor([0.0, 0.0, -4.0 * scale], device=dev))
    pose_shift2 = make_pose(t=torch.tensor([0.0, 0.0, 3.8 * scale], device=dev))
    pose_oscil = compose([pose_shift.expand(N, 3, 4), pose_rot,
                          pose_shift2.expand(N, 3, 4)])
    return compose([pose_oscil, pose_anchor.expand(N, 3, 4)])
