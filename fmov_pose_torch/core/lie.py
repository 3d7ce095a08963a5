"""SO(3)/SE(3) Lie-group maps (port of ``fmov_pose_tpu/core/lie.py``).

Series expansions near zero keep gradients finite at theta -> 0; all
rotations are 3x3 and poses are [..., 3, 4] = [R | t] camera-to-world.
Everything is a function of the squared angle, as in the JAX module.
"""

from __future__ import annotations

import torch

__all__ = [
    "skew",
    "taylor_A",
    "taylor_B",
    "taylor_C",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "axis_angle_to_R",
    "make_c2w",
    "rotation_distance",
]


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([zeros, -w2, w1], dim=-1),
            torch.stack([w2, zeros, -w0], dim=-1),
            torch.stack([-w1, w0, zeros], dim=-1),
        ],
        dim=-2,
    )


_SMALL_SQ = 1e-4  # switch to series below theta = 1e-2


def _safe_branch_sq(t2, series, exact):
    """where(theta^2 small, series(theta^2), exact(sqrt(theta^2))); the
    exact branch sees a clamped theta^2 so neither branch yields NaN."""
    small = t2 < _SMALL_SQ
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return torch.where(small, series(t2), exact(theta))


def _A_sq(t2):
    """sin(theta)/theta as a function of theta^2."""
    return _safe_branch_sq(
        t2, lambda v: 1.0 - v / 6.0 + v * v / 120.0,
        lambda th: torch.sin(th) / th)


def _B_sq(t2):
    """(1-cos(theta))/theta^2 as a function of theta^2."""
    return _safe_branch_sq(
        t2, lambda v: 0.5 - v / 24.0 + v * v / 720.0,
        lambda th: (1.0 - torch.cos(th)) / (th * th))


def _C_sq(t2):
    """(theta-sin(theta))/theta^3 as a function of theta^2."""
    return _safe_branch_sq(
        t2, lambda v: 1.0 / 6.0 - v / 120.0 + v * v / 5040.0,
        lambda th: (th - torch.sin(th)) / (th * th * th))


def taylor_A(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """sin(x)/x (exact, series near 0)."""
    del nth
    return _A_sq(x * x)


def taylor_B(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """(1-cos(x))/x**2 (exact, series near 0)."""
    del nth
    return _B_sq(x * x)


def taylor_C(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """(x-sin(x))/x**3 (exact, series near 0)."""
    del nth
    return _C_sq(x * x)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) exponential map. [..., 3] -> [..., 3, 3]."""
    wx = skew(w)
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    return _eye(w) + _A_sq(t2) * wx + _B_sq(t2) * (wx @ wx)


def so3_log(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SO(3) -> so(3) log map. [..., 3, 3] -> [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.remainder(
        torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)),
        torch.pi)[..., None, None]
    ln_R = 1.0 / (2.0 * taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack(
        [ln_R[..., 2, 1], ln_R[..., 0, 2], ln_R[..., 1, 0]], dim=-1)


def se3_exp(wu: torch.Tensor, only_rot: bool = False) -> torch.Tensor:
    """se(3) -> SE(3): [..., 6] (w | u) -> [..., 3, 4] = [R | V u]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    eye = _eye(wu)
    A, B, C = _A_sq(t2), _B_sq(t2), _C_sq(t2)
    wx2 = wx @ wx
    R = eye + A * wx + B * wx2
    V = eye + B * wx + C * wx2
    t = V @ u[..., None]
    if only_rot:
        t = torch.zeros_like(t.detach())
    return torch.cat([R, t], dim=-1)


def se3_log(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """SE(3) [..., 3, 4] -> se(3) [..., 6]."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = so3_log(R)
    wx = skew(w)
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    A, B = _A_sq(t2), _B_sq(t2)
    inv_V = (_eye(Rt) - 0.5 * wx
             + (1.0 - A / (2.0 * B)) / (t2 + eps) * (wx @ wx))
    u = (inv_V @ t)[..., 0]
    return torch.cat([w, u], dim=-1)


def axis_angle_to_R(r: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """Axis-angle -> rotation (Rodrigues, squared-angle branch at 0)."""
    del eps
    wx = skew(r)
    t2 = torch.sum(r * r, dim=-1)[..., None, None]
    return _eye(r) + _A_sq(t2) * wx + _B_sq(t2) * (wx @ wx)


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] + translation [..., 3] -> pose [..., 3, 4]."""
    return torch.cat([axis_angle_to_R(r), t[..., None]], dim=-1)


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor,
                      eps: float = 1e-7) -> torch.Tensor:
    """Angle (radians) between two rotations."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps))
