"""Minimal mesh IO (PLY binary/ascii, OBJ+MTL): a copy of the JAX package's
``fmov_pose_tpu/pipeline/meshio.py`` (numpy only), so that the port writes
byte-identical files without importing that package.

The reference exports `.ply` meshes via trimesh (`exp_runner.py:1673-1683`)
and textured `.obj` via xatlas+trimesh (`utils/textured_mesh.py:209-287`);
neither wheel is needed here.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["write_ply", "read_ply", "write_obj"]


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None, binary: bool = True):
    """vertices [V, 3] float, faces [F, 3] int, colors [V, 3] float 0..1 or
    uint8."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    has_color = vertex_colors is not None
    if has_color:
        c = np.asarray(vertex_colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0.0, 1.0) * 255).astype(np.uint8)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {len(vertices)}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                vert_dtype = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                buf = np.empty(len(vertices), vert_dtype)
                buf["xyz"] = vertices
                buf["rgb"] = c
                f.write(buf.tobytes())
            else:
                f.write(vertices.tobytes())
            face_dtype = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
            fb = np.empty(len(faces), face_dtype)
            fb["n"] = 3
            fb["idx"] = faces
            f.write(fb.tobytes())
        else:
            for i, v in enumerate(vertices):
                line = f"{v[0]} {v[1]} {v[2]}"
                if has_color:
                    line += f" {c[i][0]} {c[i][1]} {c[i][2]}"
                f.write((line + "\n").encode())
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())


def read_ply(path: str):
    """Returns (vertices [V, 3] float32, faces [F, 3] int32). Handles the
    formats written by write_ply plus common ascii/binary_le exports."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end + len(b"end_header") + 1:]

    fmt = "ascii"
    n_vert = n_face = 0
    vert_props = []
    current = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            current = parts[1]
            if current == "vertex":
                n_vert = int(parts[2])
            elif current == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and current == "vertex":
            if parts[1] == "list":
                continue
            vert_props.append((parts[2], parts[1]))

    type_map = {"float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
                "uchar": ("u1", 1), "uint8": ("u1", 1), "char": ("i1", 1),
                "int": ("i4", 4), "int32": ("i4", 4), "uint": ("u4", 4),
                "short": ("i2", 2), "ushort": ("u2", 2)}

    if fmt == "ascii":
        text = body.decode()
        rows = text.strip().splitlines()
        verts = np.array(
            [[float(x) for x in r.split()[:3]] for r in rows[:n_vert]],
            np.float32)
        faces = np.array(
            [[int(x) for x in r.split()[1:4]] for r in rows[n_vert:n_vert + n_face]],
            np.int32)
        return verts, faces

    vert_dtype = np.dtype([(name, type_map[t][0]) for name, t in vert_props])
    verts_rec = np.frombuffer(body, dtype=vert_dtype, count=n_vert)
    verts = np.stack([verts_rec["x"], verts_rec["y"], verts_rec["z"]],
                     axis=-1).astype(np.float32)
    offset = vert_dtype.itemsize * n_vert
    faces = np.empty((n_face, 3), np.int32)
    pos = offset
    for i in range(n_face):
        n = body[pos]
        pos += 1
        idx = struct.unpack_from(f"<{n}i", body, pos)
        pos += 4 * n
        faces[i] = idx[:3]
    return verts, faces


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
              uvs: np.ndarray | None = None, texture_png: str | None = None):
    """OBJ with optional per-vertex UVs and an MTL referencing texture_png."""
    base = os.path.splitext(path)[0]
    lines = []
    if texture_png is not None:
        mtl_path = base + ".mtl"
        with open(mtl_path, "w") as f:
            f.write("newmtl material_0\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n"
                    f"map_Kd {os.path.basename(texture_png)}\n")
        lines.append(f"mtllib {os.path.basename(mtl_path)}")
        lines.append("usemtl material_0")
    for v in vertices:
        lines.append(f"v {v[0]} {v[1]} {v[2]}")
    if uvs is not None:
        for uv in uvs:
            lines.append(f"vt {uv[0]} {uv[1]}")
        for f3 in faces:
            a, b, c = f3 + 1
            lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
    else:
        for f3 in faces:
            a, b, c = f3 + 1
            lines.append(f"f {a} {b} {c}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
