"""Synthetic test sequences on disk, in the reference's dataset format: the
port's copy of ``fmov_pose_tpu/data/synthetic.py``'s writer.

Writes a small orbit around the analytically shaded sphere of
``data/scene.py`` (the same cameras, frames and match draw) in the
directory layout the Dataset loader and the reference repo read:
``image/*.png``, ``mask_obj/*.png``, ``cameras_sphere.npz`` with
IDR-convention ``world_mat_<frame>`` / ``scale_mat_<frame>`` keys (and
integer-indexed aliases), an optional ``transform_matrixs.npy`` of
identity crops, and optional LoFTR-style match files under
``<parent>/matches/<sequence>/`` — so the two-phase CLI (training, the
alignment between the phases) runs end to end without HO3D data.  The
files are byte for byte the JAX package's.  OpenCV is imported where the
PNGs are written.
"""

from __future__ import annotations

import os

import numpy as np

from fmov_pose_torch.data.scene import (SPHERE_RADIUS, look_at_pose, match_rows,
                                        orbit, render_sphere_frame)

__all__ = ["make_orbit_sequence", "render_sphere_frame", "look_at_pose",
           "SPHERE_RADIUS"]


def make_orbit_sequence(out_dir, n_frames=8, H=120, W=120, span_deg=60.0,
                        with_matches=True, with_crop=True, cam_dist=2.5,
                        ann_stride=1, elevation_deg=15.0):
    """Write a synthetic sequence dataset; returns dict of ground truth
    (``K``, ``poses`` [N, 4, 4] c2w, frame ``names``, ``frames`` as
    (rgb, mask, depth))."""
    import cv2 as cv
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask_obj"), exist_ok=True)

    K, poses = orbit(n_frames, H, W, span_deg, cam_dist, elevation_deg)
    cam_dict = {}
    names, frames = [], []
    for i, c2w in enumerate(poses):
        rgb, mask, depth = render_sphere_frame(K, c2w, H, W)
        name = f"{i:04d}"
        cv.imwrite(os.path.join(out_dir, "image", name + ".png"),
                   (rgb[..., ::-1] * 255).astype(np.uint8))
        cv.imwrite(os.path.join(out_dir, "mask_obj", name + ".png"),
                   (mask * 255).astype(np.uint8))
        names.append(name)
        frames.append((rgb, mask, depth))
        if i % ann_stride == 0:
            w2c = np.linalg.inv(c2w)
            world_mat = np.eye(4)
            world_mat[:3, :4] = K @ w2c[:3, :4]
            cam_dict[f"world_mat_{name}"] = world_mat.astype(np.float32)
            cam_dict[f"scale_mat_{name}"] = np.eye(4, dtype=np.float32)
            # integer-indexed aliases for the full-annotation (GT) loader
            cam_dict[f"world_mat_{i}"] = world_mat.astype(np.float32)
            cam_dict[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(os.path.join(out_dir, "cameras_sphere.npz"), **cam_dict)

    if with_crop:
        transforms = {n: np.eye(3, dtype=np.float32) for n in names}
        np.save(os.path.join(out_dir, "transform_matrixs.npy"), transforms)

    if with_matches:
        seq = os.path.basename(os.path.normpath(out_dir)).split("_")[0]
        match_dir = os.path.join(os.path.dirname(os.path.normpath(out_dir)),
                                 "matches", seq)
        os.makedirs(match_dir, exist_ok=True)
        rng = np.random.default_rng(0)
        for i in range(n_frames - 1):
            _write_matches(match_dir, names[i], names[i + 1],
                           frames[i], frames[i + 1], poses[i], poses[i + 1],
                           K, rng)

    return {"K": K, "poses": poses, "names": names, "frames": frames}


def _write_matches(match_dir, n1, n2, fr1, fr2, c2w1, c2w2, K, rng,
                   n_matches=200):
    """Exact correspondences via the analytic geometry (stand-in for LoFTR),
    one ``x1 y1 x2 y2`` row a match, 3 decimals, tab-separated."""
    rows = match_rows(K, c2w1, c2w2, fr1[1], fr1[2], fr2[1], rng, n_matches)
    if rows is None:
        return
    with open(os.path.join(match_dir, f"{n1}_{n2}_matches.txt"), "w") as f:
        for r in rows:
            f.write("\t".join(f"{v:.3f}" for v in r) + "\n")
