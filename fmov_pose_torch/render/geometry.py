"""Mesh extraction: the SDF on a grid on the device, then the host's
marching cubes (port of ``fmov_pose_tpu/render/geometry.py``).

``make_sdf_query`` evaluates -sdf through the renderer's gradient-free SDF
(``neus._sdf_only_fn``): with K1 enabled by the config, one pack of the
weights (``fused_sdf.FwdPack``) serves the whole grid and every chunk
launches K1 on it (on a CPU tensor, K1's plain version).
``extract_fields`` builds each chunk's points on the device by index from
the three ``np.linspace`` axes, which gives the f32 values of the JAX
module's host ``meshgrid``, evaluates the chunk (the last one ragged: the
JAX module's zero padding serves its fixed jit shapes and is not ported)
and copies it into one host grid.  ``extract_color`` runs the f32 networks
with autograd, where the JAX module runs no Pallas kernel either.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fmov_pose_torch.fields import nets
from fmov_pose_torch.native.mc import marching_cubes

CHUNK = 64 ** 3


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def extract_fields(bound_min, bound_max, resolution: int, query_fn, device,
                   chunk: int = CHUNK, seconds=None) -> np.ndarray:
    """``query_fn`` over the resolution^3 grid spanning the bounds, chunk
    points at a time on ``device`` -> host f32 [res, res, res] (index
    (i, j, k) at (xs[i], ys[j], zs[k])).  ``seconds``: a dict that gains
    the time of the evaluation ("grid", device synchronised) and of the
    copies back ("copy")."""
    device = torch.device(device)
    axes = [torch.from_numpy(np.linspace(bound_min[d], bound_max[d], resolution,
                                         dtype=np.float32)).to(device) for d in range(3)]
    n = resolution ** 3
    grid = np.empty(n, np.float32)
    host = torch.from_numpy(grid)
    t_grid = t_copy = 0.0
    for start in range(0, n, chunk):
        t0 = time.perf_counter()
        idx = torch.arange(start, min(start + chunk, n), device=device)
        pts = torch.stack([axes[0][idx // (resolution * resolution)],
                           axes[1][(idx // resolution) % resolution],
                           axes[2][idx % resolution]], dim=-1)
        out = query_fn(pts).reshape(-1)
        _sync(device)
        t1 = time.perf_counter()
        host[start:start + out.shape[0]].copy_(out)
        t_copy += time.perf_counter() - t1
        t_grid += t1 - t0
    if seconds is not None:
        seconds["grid"] = seconds.get("grid", 0.0) + t_grid
        seconds["copy"] = seconds.get("copy", 0.0) + t_copy
    return grid.reshape(resolution, resolution, resolution)


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_fn, device, seconds=None):
    """Grid, isosurface, and voxel coordinates rescaled to the bounds.
    ``seconds`` gains "grid", "copy" and "marching_cubes"."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    u = extract_fields(bound_min, bound_max, resolution, query_fn, device,
                       seconds=seconds)
    t0 = time.perf_counter()
    vertices, triangles = marching_cubes(u, threshold)
    if seconds is not None:
        seconds["marching_cubes"] = time.perf_counter() - t0
    vertices = vertices / (resolution - 1.0) * (bound_max - bound_min)[None, :] \
        + bound_min[None, :]
    return vertices, triangles


def make_sdf_query(params, model_cfg):
    """x [M, 3] -> -sdf [M, 1] without gradients (the reference meshes -sdf
    at threshold 0), on one K1 pack of ``params["sdf"]`` when K1 is on."""
    from fmov_pose_torch.render.neus import _sdf_only_fn
    with torch.no_grad():  # the pack's weights carry no graph
        fn = _sdf_only_fn(model_cfg, params["sdf"])

    @torch.no_grad()
    def query(pts):
        return -fn(pts)

    return query


def extract_color(params, model_cfg, vertices: np.ndarray, device,
                  chunk: int = 8192) -> np.ndarray:
    """Vertex colors [V, 3] from the color field with view dir = -normal."""
    out = []
    for i in range(0, len(vertices), chunk):
        pts = torch.as_tensor(np.asarray(vertices[i:i + chunk], np.float32),
                              device=device)
        with torch.no_grad():
            feat = nets.sdf_apply(params["sdf"], model_cfg["sdf"], pts)[:, 1:]
            grads = nets.sdf_gradient(params["sdf"], model_cfg["sdf"], pts)
            out.append(nets.color_apply(params["color"], model_cfg["color"], pts,
                                        grads, -grads, feat).cpu().numpy())
    return (np.concatenate(out) if out
            else np.zeros((0, model_cfg["color"]["d_out"]), np.float32))


def normal_colors(params, model_cfg, vertices: np.ndarray, device,
                  chunk: int = 16384) -> np.ndarray:
    """(n + 1) / 2 of the unit SDF normals of ``vertices``: the Runner's
    ``validate_mesh(use_norml_color=True)`` colors."""
    grads = []
    for i in range(0, len(vertices), chunk):
        pts = torch.as_tensor(np.asarray(vertices[i:i + chunk], np.float32),
                              device=device)
        with torch.no_grad():
            grads.append(nets.sdf_gradient(params["sdf"], model_cfg["sdf"],
                                           pts).cpu().numpy())
    grads = np.concatenate(grads)
    grads = grads / (np.linalg.norm(grads, axis=-1, keepdims=True) + 1e-9)
    return (grads + 1) / 2
