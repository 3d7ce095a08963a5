"""The two-phase quality harness: the port's ``scripts/pipeline_quality.py``.

    python -m fmov_pose_torch.quality [--p1_iters 3600] [--p2_iters 3000]
        [--frames 10] [--span 150] [--res 256] [--occupancy] [--fused]
        [--device cpu]

Runs the whole product path on a synthetic sphere orbit through the
port's CLI (``exp_runner.main``, in-process, on the card unless
``--device cpu``): the progressive phase 1 (segment pose bank, flow,
admission curriculum) on ``confs/ho3d_virtual.conf``, the PnP alignment,
the phase-2 global refinement on ``confs/ho3d_global_womask.conf`` (which
the Runner trains on its scan path, 100 steps a dispatch), the final
512^3 mesh; then evaluates:

* phase-1 ATE (``validate_poses`` against the partial annotations);
* phase-2 ATE and RPE against the true orbit (name-matched Umeyama Sim(3));
* phase-2 render PSNR (frame 0 at half resolution);
* the final mesh's Chamfer distance to the analytic sphere, after
  aligning its centre and scale (the reconstruction's frame differs from
  the world's by a Sim(3));
* phase 1's per-frame errors (``per_frame_errors``, the JAX package's
  ``scripts/seed2_postmortem.py``) and the orbit they trace
  (``orbit_errors``: the relative rotation error of each transition, the
  degrees a frame the learned and the true orbits turn, their radii),
  printed on a line of their own before the JSON result.

The flags, their defaults, the confs' edits, the data and the JSON keys
are the JAX script's; the port adds ``p2_dispatch`` (the phase-2 loop:
"scan x100" or "per-step"), ``device`` and ``power_limit`` (the card's,
from nvidia-smi).  The steps are separate functions (``make_data``,
``write_confs``, ``run``, then ``evaluate``: ``read_run`` and
``metrics``; ``result``), so that a caller can edit the confs between
them.  The work directory is a new temporary one unless ``--work`` names
one.  The training seed is the CLI's ``--seed`` (2024, as in the JAX
script); ``run`` and ``main`` take another as ``seed``
(``python -m fmov_pose_torch.phase1_probe --harness`` runs several).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P1_CONF, P2_CONF = "confs/virtual.conf", "confs/ho3d_global.conf"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--p1_iters", type=int, default=3600)
    ap.add_argument("--p2_iters", type=int, default=3000)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--span", type=int, default=150)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--max_pro", type=int, default=250)
    ap.add_argument("--mesh_warmup", type=int, default=500)
    ap.add_argument("--occupancy", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="train.use_fused_train_kernels in BOTH phases")
    ap.add_argument("--p2_batch", type=int, default=512,
                    help="phase-2 batch size")
    ap.add_argument("--p2_lr", type=str, default=None,
                    help="phase-2 learning_rate override (e.g. 1e-3)")
    ap.add_argument("--p2_warmup", type=int, default=200,
                    help="phase-2 warm_up_end (scale down for short "
                         "big-batch schedules)")
    ap.add_argument("--device", type=str, default=None,
                    help="the torch device (default: the CUDA device, which must exist)")
    ap.add_argument("--work", type=str, default=None,
                    help="the work directory (default: a new temporary one)")
    return ap.parse_args(argv)


def shrink_conf(src, dst, subs):
    with open(src) as f:
        text = f.read()
    for pat, rep in subs.items():
        text = re.sub(pat, rep, text)
    with open(dst, "w") as f:
        f.write(text)


def make_data(work, args):
    """The synthetic sequence in the HO3D layout under ``work``: SYN_ori
    (crops and matches) for phase 1, SYN for phase 2.  Returns SYN_ori's
    ground truth (``make_orbit_sequence``)."""
    from fmov_pose_torch.data.synthetic import make_orbit_sequence
    os.makedirs(os.path.join(work, "data/HO3Dv3"), exist_ok=True)
    gt = make_orbit_sequence(os.path.join(work, "data/HO3Dv3/SYN_ori"),
                             n_frames=args.frames, H=args.res, W=args.res,
                             span_deg=args.span)
    make_orbit_sequence(os.path.join(work, "data/HO3Dv3/SYN"),
                        n_frames=args.frames, H=args.res, W=args.res,
                        span_deg=args.span, with_matches=False, with_crop=False)
    return gt


def write_confs(work, args):
    """The two phases' confs under ``work``/confs, the JAX script's edits
    of the reference confs.  Returns their paths (phase 1, phase 2)."""
    os.makedirs(os.path.join(work, "confs"), exist_ok=True)
    common = {
        r"batch_size = \d+": "batch_size = 512",
        r"save_freq = \d+": "save_freq = 1000000",
        r"val_freq = \d+": "val_freq = 1000000",
        r"val_mesh_freq = \d+": "val_mesh_freq = 1000000",
        r"pose_freq = \d+": "pose_freq = 1000000",
        r"report_freq = \d+": "report_freq = 200",
        r"validate_resolution_level = \d+": "validate_resolution_level = 2",
    }
    p1, p2 = os.path.join(work, P1_CONF), os.path.join(work, P2_CONF)
    shrink_conf(
        os.path.join(REPO, "confs/ho3d_virtual.conf"), p1,
        dict(common, **{
            r"end_iter = \d+": f"end_iter = {args.p1_iters}",
            r"warm_up_end = \d+": "warm_up_end = 200",
            r"max_pro_iteration = \d+": f"max_pro_iteration = {args.max_pro}",
            r"pro_warm_up_end = \d+": f"pro_warm_up_end = {args.max_pro // 2}",
            r"mesh_warmup_step = \d+": f"mesh_warmup_step = {args.mesh_warmup}",
            # the synthetic orbit would trip the 60-degree rotation reset
            # (which rewinds iter_step and re-runs the mesh warm-up)
            r"reset_rot_threshold = \d+": "reset_rot_threshold = 999",
            r"maintain_shape = True":
                "maintain_shape = True\n    occupancy_sampling = "
                + ("True" if args.occupancy else "False")
                + "\n    use_fused_train_kernels = "
                + ("True" if args.fused else "False"),
        }))
    p2_subs = dict(common, **{
        r"end_iter = \d+": f"end_iter = {args.p2_iters}",
        r"batch_size = \d+": f"batch_size = {args.p2_batch}",
        r"warm_up_end = \d+": f"warm_up_end = {args.p2_warmup}",
        r"mask_guided_sampling = True":
            "mask_guided_sampling = True\n    use_fused_train_kernels = "
            + ("True" if args.fused else "False"),
    })
    if args.p2_lr is not None:
        p2_subs[r"learning_rate = \S+"] = f"learning_rate = {args.p2_lr}"
    shrink_conf(os.path.join(REPO, "confs/ho3d_global_womask.conf"), p2, p2_subs)
    return p1, p2


def run(work, device, final_mesh_resolution=512, seed=2024, init=None):
    """The two-phase CLI command in ``work`` (the confs' relative paths),
    trained from ``seed`` (the CLI's ``--seed``); returns (phase-2 Runner,
    seconds).  ``init``: a checkpoint phase 1 starts from instead of its
    own initial state (e.g. the JAX Runner's before its first step),
    placed in phase 1's checkpoint directory for ``--is_continue``."""
    from fmov_pose_torch import exp_runner
    argv = ["--mode", "train", "--conf", "./" + P1_CONF, "--case", "SYN_ori",
            "--global_conf", "./" + P2_CONF,
            "--final_mesh_resolution", str(final_mesh_resolution), "--seed", str(seed)]
    if init is not None:
        ckpt_dir = os.path.join(work, "exp/SYN_ori/ours/checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        shutil.copy(init, os.path.join(ckpt_dir, "ckpt_000001_000000.ckpt"))
        argv.append("--is_continue")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.time()
        runner = exp_runner.main(argv, device=device)
        seconds = time.time() - t0
    finally:
        os.chdir(cwd)
    err_file = os.path.join(work, "exp/SYN_ori/ours",
                            "error_during_progressive_learning.txt")
    if os.path.exists(err_file):
        with open(err_file) as f:
            print("PHASE-1 ERROR FILE:\n" + f.read()[:2000])
    return runner, seconds


def _angle_deg(R):
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.rad2deg(np.arccos(cos)))


def per_frame_errors(est, gt):
    """Per-frame errors after ATE alignment (the JAX package's
    ``scripts/seed2_postmortem.py``): rows (frame, absolute rotation error
    in degrees after the best global rotation offset, translation error,
    relative rotation error in degrees of the transition to the next frame,
    0 for the last), and the aligned poses [N, 4, 4]."""
    from fmov_pose_torch.pipeline import evalpose
    est_aligned = evalpose.align_ate_c2b_use_a2b(est, gt)
    # global rotation offset: R* = argmin_R sum ||R Rest_i - Rgt_i||_F
    M = sum(gt[i, :3, :3] @ est_aligned[i, :3, :3].T for i in range(len(gt)))
    U, _, Vt = np.linalg.svd(M)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R_star = U @ S @ Vt
    rows = []
    for i in range(len(gt)):
        dt = float(np.linalg.norm(est_aligned[i, :3, 3] - gt[i, :3, 3]))
        rot_abs = _angle_deg(R_star @ est_aligned[i, :3, :3] @ gt[i, :3, :3].T)
        if i + 1 < len(gt):
            rel_est = est_aligned[i, :3, :3].T @ est_aligned[i + 1, :3, :3]
            rel_gt = gt[i, :3, :3].T @ gt[i + 1, :3, :3]
            rot_rel = _angle_deg(rel_est @ rel_gt.T)
        else:
            rot_rel = 0.0
        rows.append((i, rot_abs, dt, rot_rel))
    return rows, est_aligned


def orbit_errors(est, gt):
    """What ``per_frame_errors`` says of a trajectory, as the JAX package's
    round-5 post-mortem read it: {"rel_rot_deg": each transition's relative
    rotation error, "median_rel_rot_deg", "est_deg_per_frame" and
    "gt_deg_per_frame" (the angle each transition turns, learned after the
    alignment and true), "est_radius" and "gt_radius" (the mean distance of
    the camera centres from the origin, where the object sits)}."""
    rows, aligned = per_frame_errors(est, gt)
    gt = np.asarray(gt, np.float64)

    def turns(p):
        return [_angle_deg(p[i, :3, :3].T @ p[i + 1, :3, :3]) for i in range(len(p) - 1)]

    rel = [r for _, _, _, r in rows[:-1]]
    return {"rel_rot_deg": [round(r, 3) for r in rel],
            "median_rel_rot_deg": round(float(np.median(rel)), 3),
            "est_deg_per_frame": round(float(np.mean(turns(aligned))), 3),
            "gt_deg_per_frame": round(float(np.mean(turns(gt))), 3),
            "est_radius": round(float(np.linalg.norm(aligned[:, :3, 3], axis=-1).mean()), 4),
            "gt_radius": round(float(np.linalg.norm(gt[:, :3, 3], axis=-1).mean()), 4)}


def sphere_chamfer(verts):
    """Chamfer distance of mesh vertices to the synthetic sphere, after
    moving their centre to the origin and their mean radius to the
    sphere's (the JAX script's alignment and samples)."""
    from fmov_pose_torch.data.synthetic import SPHERE_RADIUS
    from fmov_pose_torch.pipeline.chamfer import chamfer_distance
    center = verts.mean(axis=0)
    v = verts - center
    v = v * (SPHERE_RADIUS / np.linalg.norm(v, axis=-1).mean())
    rng = np.random.default_rng(0)
    d = rng.normal(size=(20000, 3))
    gt_pts = d / np.linalg.norm(d, axis=-1, keepdims=True) * SPHERE_RADIUS
    if len(v) > 20000:
        v = v[rng.choice(len(v), 20000, replace=False)]
    return chamfer_distance(v, gt_pts)[0]


def read_run(work, device):
    """What a finished run in ``work`` gives the evaluation, read through
    Runners on its latest checkpoints: phase 1's ``validate_poses``
    (ate, rpe_trans, rpe_rot, gt, est), phase 2's PSNR on frame 0 at half
    resolution, its learned poses and frame names, and the final mesh's
    path (None without one)."""
    from fmov_pose_torch.train.runner import Runner
    cwd = os.getcwd()
    os.chdir(work)
    try:
        r1 = Runner(P1_CONF, mode="validate_poses", case="SYN_ori", is_continue=True,
                    has_global_conf=True, device=device)
        if r1.current_image != r1.dataset.n_images:
            print(f"WARNING: phase 1 admitted only {r1.current_image}/"
                  f"{r1.dataset.n_images} frames (iter {r1.iter_step})")
        p1 = r1.validate_poses()
        del r1
        p2_dir = os.path.join(work, "exp/SYN_ori/ours/ho3d_global")
        r2 = Runner(P2_CONF, mode="validate", case="SYN", is_continue=True,
                    exp_dir=p2_dir, has_global_conf=True, device=device)
        psnr = r2.validate_image(idx=0, resolution_level=2)
        learned = r2.query_poses(r2.dataset.n_images)
        names = [r2.dataset.index_to_frame[i] for i in range(r2.dataset.n_images)]
        del r2
    finally:
        os.chdir(cwd)
    mesh_dir = os.path.join(p2_dir, "meshes")
    plys = sorted(os.listdir(mesh_dir)) if os.path.isdir(mesh_dir) else []
    return {"p1": p1, "psnr": float(psnr), "learned": learned, "names": names,
            "ply": os.path.join(mesh_dir, plys[-1]) if plys else None}


def metrics(run, gt):
    """The harness's numbers from ``read_run``'s output and the orbit's
    ground truth: {"p1_ate", "p2_psnr", "p2_ate", "p2_rpe_trans",
    "p2_rpe_rot" (radians), "chamfer", "mesh_verts"}."""
    from fmov_pose_torch.pipeline import evalpose
    from fmov_pose_torch.pipeline.meshio import read_ply
    name_to_gt = {n: p for n, p in zip(gt["names"], gt["poses"])}
    est = [run["learned"][i] for i, n in enumerate(run["names"]) if n in name_to_gt]
    gtp = [name_to_gt[n] for n in run["names"] if n in name_to_gt]
    ate2 = rpe_t2 = rpe_r2 = float("nan")
    if len(est) >= 3:
        est, gtp = np.stack(est), np.stack(gtp)
        aligned = evalpose.align_ate_c2b_use_a2b(est, gtp)
        ate2 = evalpose.compute_ATE(gtp, aligned)
        rpe_t2, rpe_r2 = evalpose.compute_rpe(gtp, aligned)
    cd, n_verts = float("nan"), 0
    if run["ply"] is not None:
        verts, _ = read_ply(run["ply"])
        n_verts = len(verts)
        if n_verts > 100:
            cd = sphere_chamfer(verts)
    p1 = run["p1"]
    return {"p1_ate": None if p1 is None else float(p1[0]), "p2_psnr": run["psnr"],
            "p2_ate": float(ate2), "p2_rpe_trans": float(rpe_t2),
            "p2_rpe_rot": float(rpe_r2), "chamfer": float(cd), "mesh_verts": n_verts}


def evaluate(work, gt, device):
    """``metrics`` of the finished run in ``work``."""
    return metrics(read_run(work, device), gt)


def card(device):
    """(device name, power limit) as nvidia-smi gives them, or ("cpu", None)."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu", None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    name, limit = (s.strip() for s in out[index].split(",", 1))
    return name, limit


def result(args, m, seconds, dispatch, device, work):
    """The JSON result: the JAX script's keys, then ``p2_dispatch``,
    ``device`` and ``power_limit``."""
    name, limit = card(device)
    return {
        "frames": args.frames, "res": args.res, "span_deg": args.span,
        "p1_occupancy": args.occupancy,
        "fused": args.fused,
        "p1_iters": args.p1_iters, "p2_iters": args.p2_iters,
        "p2_batch": args.p2_batch, "p2_lr": args.p2_lr,
        "pipeline_time_s": round(seconds, 1),
        "p1_ate": None if m["p1_ate"] is None else round(m["p1_ate"], 5),
        "p2_psnr": round(m["p2_psnr"], 2),
        "p2_ate": round(m["p2_ate"], 5),
        "p2_rpe_trans": round(m["p2_rpe_trans"], 5),
        "p2_rpe_rot_deg": round(float(np.rad2deg(m["p2_rpe_rot"])), 4),
        "mesh_chamfer_aligned": round(m["chamfer"], 6),
        "mesh_verts": m["mesh_verts"],
        "workdir": work,
        "p2_dispatch": dispatch,
        "device": name, "power_limit": limit,
    }


def train_setting(key, value):
    """The ``shrink_conf`` substitution that sets ``train.<key>`` in a conf
    (a line added at the top of its train block)."""
    return {r"(?m)^train\s*\{": f"train {{\n    {key} = {value}"}


def main(argv=None, device=None, seed=2024, conf_subs=None, init=None):
    """Run the harness from ``seed``; prints phase 1's orbit errors
    (``orbit_errors``, a line "phase1 {...}") and then the JSON result, and
    returns (the result, the orbit errors).  ``device`` overrides
    ``--device``; ``conf_subs`` (``shrink_conf``'s) edit both confs after
    the harness's own edits, e.g. ``train_setting("compute_dtype",
    "bfloat16")``; ``init`` as ``run``'s."""
    args = parse_args(argv)
    if device is None:
        from fmov_pose_torch.device import require_cuda
        device = args.device or require_cuda()
    work = args.work or tempfile.mkdtemp(prefix="fmov_pipeq_")
    gt = make_data(work, args)
    for path in write_confs(work, args):
        if conf_subs:
            shrink_conf(path, path, conf_subs)
    runner, seconds = run(work, device, seed=seed, init=init)
    dispatch = runner.dispatch
    del runner
    ran = read_run(work, device)
    _, _, _, p1_gt, p1_est = ran["p1"]
    orbit = None if p1_gt is None else orbit_errors(p1_est[:len(p1_gt)], p1_gt)
    print("phase1 " + json.dumps({"seed": seed, **(orbit or {})}))
    out = result(args, metrics(ran, gt), seconds, dispatch, device, work)
    print(json.dumps(out))
    return out, orbit


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
