"""Occupancy-grid guided sampling (port of ``fmov_pose_tpu/render/occupancy.py``).

A [R, R, R] grid of "surface nearby" flags, refreshed every few hundred
steps from the SDF (|sdf| below a band, dilated by a 3^3 max-pool), replaces
the SDF-guided up-sampling passes with one gather: the importance samples
are drawn by the same inverse-CDF sampler with per-section occupancy as
the pdf, so the sample count never changes, only the placement.  Enabled
by ``train.occupancy_sampling``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fmov_pose_torch.core.sampling import merge_sorted, sample_pdf

__all__ = ["make_grid_points", "update_occ_grid", "occupancy_importance",
           "query_occ"]


def make_grid_points(res: int, bound: float = 1.0) -> np.ndarray:
    """[res^3, 3] grid points in [-bound, bound]^3, x-major."""
    lin = np.linspace(-bound, bound, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.stack([x, y, z], -1).reshape(-1, 3)


def update_occ_grid(sdf_vals: torch.Tensor, res: int, bound: float = 1.0,
                    threshold_cells: float = 4.0) -> torch.Tensor:
    """|sdf| on the grid -> dilated binary occupancy [R, R, R] float32.

    threshold_cells: half-width of the surface band in voxels.  The 3^3
    dilation is a max-pool with stride 1 and padding 1, which pads with
    -inf as the JAX "SAME" reduce_window does."""
    cell = 2.0 * bound / (res - 1)
    occ = (torch.abs(sdf_vals.reshape(res, res, res))
           < threshold_cells * cell).to(torch.float32)
    return F.max_pool3d(occ[None, None], kernel_size=3, stride=1, padding=1)[0, 0]


def query_occ(occ_grid: torch.Tensor, pts: torch.Tensor,
              bound: float = 1.0) -> torch.Tensor:
    """Nearest-voxel occupancy of [..., 3] points in [-bound, bound]."""
    res = occ_grid.shape[0]
    idx = torch.clamp(torch.round((pts + bound) / (2 * bound) * (res - 1)),
                      0, res - 1).to(torch.int64)
    return occ_grid[idx[..., 0], idx[..., 1], idx[..., 2]]


@torch.no_grad()
def occupancy_importance(occ_grid, rays_o, rays_d, z_vals, n_importance: int,
                         bound: float = 1.0):
    """n_importance extra samples where the grid says "surface nearby",
    merge-sorted into z_vals; gradient-free.  The JAX function's ``key``
    is not taken: its sampler is deterministic."""
    mid_z = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
    occ = query_occ(occ_grid, pts, bound)           # [B, N-1]
    # a 1e-2 floor: fully empty rays fall back to uniform
    new_z = sample_pdf(z_vals, occ + 1e-2, n_importance)
    return merge_sorted(z_vals, new_z)
