"""Chamfer distance between point sets / meshes (quality metric): the
port's copy of ``fmov_pose_tpu/pipeline/chamfer.py``, numpy on the host.

The reference's headline reconstruction metric (paper Table 1; the
reference repo ships no implementation).  The quality harness
(``fmov_pose_torch/quality.py``) reads the final mesh's Chamfer distance
to the synthetic sphere with it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["chamfer_distance", "sample_mesh_surface"]


def _nn_dist_sq(a: np.ndarray, b: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """Per-point squared distance from a to its nearest neighbor in b."""
    out = np.empty(len(a), np.float64)
    b2 = (b**2).sum(-1)
    for i in range(0, len(a), chunk):
        aa = a[i:i + chunk]
        d = ((aa**2).sum(-1)[:, None] - 2.0 * aa @ b.T + b2[None, :])
        out[i:i + chunk] = d.min(axis=1)
    return np.maximum(out, 0.0)


def chamfer_distance(a: np.ndarray, b: np.ndarray, squared: bool = False):
    """Symmetric Chamfer distance between point sets [N,3], [M,3].

    Returns (chamfer, a_to_b_mean, b_to_a_mean) — mean of (squared)
    nearest-neighbor distances in both directions.
    """
    d_ab = _nn_dist_sq(np.asarray(a, np.float64), np.asarray(b, np.float64))
    d_ba = _nn_dist_sq(np.asarray(b, np.float64), np.asarray(a, np.float64))
    if not squared:
        d_ab, d_ba = np.sqrt(d_ab), np.sqrt(d_ba)
    return float(d_ab.mean() + d_ba.mean()), float(d_ab.mean()), float(d_ba.mean())


def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                        seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples from a triangle mesh."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    p = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(faces), n, p=p)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1.0
    u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
    return v0[idx] + u * (v1[idx] - v0[idx]) + v * (v2[idx] - v0[idx])
