"""Texture baking: color field -> UV-mapped OBJ (+PNG), no xatlas (port of
``fmov_pose_tpu/pipeline/textured.py``).

``per_face_uv_atlas``, ``_texel_queries`` and ``bake_texture`` are copies
of the JAX module's (numpy): a per-face grid atlas replaces the reference's
xatlas unwrap (`utils/textured_mesh.py`), every triangle gets its own
texture cell, so texel -> (face, barycentric) is a direct O(1) mapping.
``bake_rays`` is the first half of the JAX ``bake_texture`` (the texel
rays and their length), split out so that a caller can render a bake
chunk of its own.
``textured_mesh`` is the port's own: the vertex normals come from the
port's ``nets.sdf_gradient`` in chunks of 8,192 vertices, and each chunk
of 8,192 texel rays goes through the Runner's eval render
(``Runner.eval_render``: no occupancy grid, under ``torch.no_grad``, on
the fused kernels where the conf enables them) with the near/far of the
bake, (0, raylen), not the sphere's, and a cos-anneal ratio of 1, as in
the JAX module.  Rays start ``0.5 raylen`` outside the surface along the
outward normal and march inward (`textured_mesh.py:180-206`).  OpenCV is
imported where the texture is written.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

LOG = logging.getLogger(__name__)

__all__ = ["per_face_uv_atlas", "bake_rays", "bake_texture", "textured_mesh"]

BAKE_CHUNK = 8192  # texel rays a render, the JAX module's chunk


def per_face_uv_atlas(n_faces: int, tex_size: int = 1024, pad: float = 1.0):
    """Assign each face a right-triangle inside its own grid cell.

    Returns (uvs [F, 3, 2] in [0, 1], cell px size, grid side).
    """
    grid = int(np.ceil(np.sqrt(n_faces)))
    cell = tex_size / grid
    f = np.arange(n_faces)
    cx = (f % grid) * cell
    cy = (f // grid) * cell
    p = pad
    v0 = np.stack([cx + p, cy + p], -1)
    v1 = np.stack([cx + cell - p, cy + p], -1)
    v2 = np.stack([cx + p, cy + cell - p], -1)
    uvs = np.stack([v0, v1, v2], axis=1) / tex_size
    return uvs.astype(np.float32), cell, grid


def _texel_queries(vertices, faces, normals, tex_size, pad=1.0):
    """All texel (origin, direction, pixel index) triplets of the atlas."""
    uvs, cell, grid = per_face_uv_atlas(len(faces), tex_size, pad)
    c = int(np.floor(cell))
    # local texel grid inside one cell (lower-left triangle incl. diagonal)
    ys, xs = np.meshgrid(np.arange(c), np.arange(c), indexing="ij")
    inside = (xs + ys) <= c - 1
    lx, ly = xs[inside].astype(np.float64), ys[inside].astype(np.float64)
    # barycentric coords w.r.t. (v0, v1, v2) right triangle of leg c-2*pad
    leg = max(cell - 2 * pad, 1.0)
    w1 = np.clip((lx - pad + 0.5) / leg, 0, 1)
    w2 = np.clip((ly - pad + 0.5) / leg, 0, 1)
    scale = np.maximum(w1 + w2, 1.0)
    w1, w2 = w1 / scale, w2 / scale
    w0 = 1.0 - w1 - w2

    n_faces = len(faces)
    f = np.arange(n_faces)
    cx = (f % grid) * cell
    cy = (f // grid) * cell
    px = (np.floor(cx)[:, None] + lx[None, :]).astype(np.int64)
    py = (np.floor(cy)[:, None] + ly[None, :]).astype(np.int64)
    ok = (px < tex_size) & (py < tex_size)

    tri_v = vertices[faces]   # [F, 3, 3]
    tri_n = normals[faces]
    w = np.stack([w0, w1, w2], axis=-1)  # [T, 3]
    origins = np.einsum("tk,fkd->ftd", w, tri_v)  # [F, T, 3]
    dirs = -np.einsum("tk,fkd->ftd", w, tri_n)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12
    flat_idx = py * tex_size + px
    ok = ok.reshape(-1)
    return (origins.reshape(-1, 3)[ok], dirs.reshape(-1, 3)[ok],
            flat_idx.reshape(-1)[ok], uvs)


def bake_rays(vertices, faces, normals, tex_size=1024):
    """The bake's texel rays: (origins [N, 3], pulled back half a ray
    length against their directions, dirs [N, 3], flat_idx [N], uvs
    [F, 3, 2], raylen), rendered with near 0 and far raylen."""
    origins, dirs, flat_idx, uvs = _texel_queries(
        np.asarray(vertices), np.asarray(faces), np.asarray(normals),
        tex_size)
    tri_v = np.asarray(vertices)[np.asarray(faces)]
    raylen = 2.0 * np.mean(np.linalg.norm(tri_v[:, 1] - tri_v[:, 0], axis=-1))
    return origins - 0.5 * raylen * dirs, dirs, flat_idx, uvs, raylen


def bake_texture(vertices, faces, normals, render_fn, tex_size=1024,
                 chunk=BAKE_CHUNK):
    """Rasterize + render every texel. render_fn(origins, dirs, near, far)
    -> colors [N, 3]. Returns (texture [H, W, 3] uint8, uvs [F, 3, 2])."""
    origins, dirs, flat_idx, uvs, raylen = bake_rays(vertices, faces, normals,
                                                     tex_size)

    tex = np.zeros((tex_size * tex_size, 3), np.float32)
    n = len(origins)
    pad_n = (-n) % chunk
    o = np.concatenate([origins, np.zeros((pad_n, 3))]).astype(np.float32)
    d = np.concatenate([dirs, np.ones((pad_n, 3))]).astype(np.float32)
    cols = []
    for i in range(0, n + pad_n, chunk):
        near = np.zeros((chunk, 1), np.float32)
        far = np.full((chunk, 1), raylen, np.float32)
        cols.append(render_fn(o[i:i + chunk], d[i:i + chunk], near, far))
    colors = np.concatenate(cols)[:n]
    tex[flat_idx] = colors
    tex_img = (tex.reshape(tex_size, tex_size, 3) * 255).clip(0, 255).astype(
        np.uint8)
    return tex_img, uvs


def _vertex_normals(runner, vertices):
    """d sdf / dx at the vertices (unnormalised, as the JAX module's), on
    the Runner's device in chunks of 8,192."""
    from fmov_pose_torch.fields import nets
    params = runner.eval_params()
    normals = []
    for i in range(0, len(vertices), BAKE_CHUNK):
        x = torch.as_tensor(vertices[i:i + BAKE_CHUNK], dtype=torch.float32,
                            device=runner.device)
        with torch.no_grad():  # the gradient's own graph is not kept
            normals.append(nets.sdf_gradient(params["sdf"], runner.model_cfg["sdf"], x))
    if not normals:
        return np.zeros_like(vertices)
    return torch.cat(normals).cpu().numpy()


def textured_mesh(ply_path, runner, tex_size=1024):
    """Bake the runner's color field onto a mesh; writes
    textured_<name>/{mesh.obj, material_0.mtl, material_0.png}."""
    import cv2

    from fmov_pose_torch.pipeline.meshio import read_ply

    vertices, faces = read_ply(ply_path)
    # vertex normals from the SDF gradient (`textured_mesh.py:167-173`)
    normals = _vertex_normals(runner, vertices)

    def render_fn(o, d, near, far):
        return runner.eval_render(o, d, near, far, 1.0)["color_fine"].cpu().numpy()

    tex_img, uvs = bake_texture(vertices, faces, normals, render_fn, tex_size)

    out_dir = os.path.join(
        os.path.dirname(ply_path),
        f"textured_{os.path.basename(ply_path).split('.')[0]}")
    os.makedirs(out_dir, exist_ok=True)
    cv2.imwrite(os.path.join(out_dir, "material_0.png"), tex_img[..., ::-1])
    with open(os.path.join(out_dir, "material_0.mtl"), "w") as f:
        f.write("newmtl material_0\nKa 1.000 1.000 1.000\n"
                "Kd 1.000 1.000 1.000\nKs 0.000 0.000 0.000\nd 1.0\n"
                "illum 2\nNs 1.00000000\nmap_Kd material_0.png\n")
    obj_path = os.path.join(out_dir, "mesh.obj")
    with open(obj_path, "w") as f:
        f.write("mtllib material_0.mtl\nusemtl material_0\n")
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for fi in range(len(faces)):
            for uv in uvs[fi]:
                f.write(f"vt {uv[0]} {1.0 - uv[1]}\n")
        for nrm in normals:
            f.write(f"vn {nrm[0]} {nrm[1]} {nrm[2]}\n")
        for fi, face in enumerate(faces):
            v1, v2, v3 = face + 1
            t1, t2, t3 = fi * 3 + 1, fi * 3 + 2, fi * 3 + 3
            f.write(f"f {v1}/{t1}/{v1} {v2}/{t2}/{v2} {v3}/{t3}/{v3}\n")
    LOG.info("textured mesh written to %s", out_dir)
    return out_dir
