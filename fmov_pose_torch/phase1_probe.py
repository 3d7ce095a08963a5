"""Phase 1 of the quality harness alone, cut to size, and the harness over
several seeds: the runs that narrow down where the port's phase-1 poses
stop following the orbit.

    python -m fmov_pose_torch.phase1_probe [--frames 6] [--res 64] [--span 68]
        [--max_pro 60] [--mesh_warmup 120] [--d_hidden 256] [--seeds 2024 1 2]
        [--compute_dtype bfloat16] [--init DIR] [--device cpu] [--out FILE]
    python -m fmov_pose_torch.phase1_probe --harness --seeds 2024 1 2 3 \\
        [--device cpu] [--out FILE] -- [the harness's flags]

The first form writes the harness's data and confs (``quality.make_data``,
``quality.write_confs``: the JAX script's edits) at the sizes given, sets
the SDF's and the color network's ``d_hidden`` (the only width cut; 256 as
shipped) and optionally ``train.compute_dtype``, and trains phase 1 alone
through the port's ``Runner`` for each seed, until every frame is
admitted.  Each seed prints one JSON line: the phase-1 ATE and RPE of
``validate_poses``, ``quality.orbit_errors`` (the relative rotation
error of each transition, the degrees a frame the learned and the true
orbit turn, their radii), the steps, the seconds of ``train()`` and, on
CUDA, the median ms a step.  ``--init DIR`` starts each seed's phase 1
from ``DIR/init_<seed>.ckpt`` (a checkpoint the Runner loads, e.g. the JAX
Runner's state before its first step, written by the tool below) instead
of the port's own initial state, in both forms.  ``--harness`` runs the whole harness
(``quality.main``) once a seed instead, with ``--compute_dtype`` set in
both phases' confs.  ``--out`` also writes every line's object to a JSON
file.

The JAX package's Runner trains the same data and confs on the CPU in the
tests' tool ``tests/phase1_probe_jax.py``, which reuses ``prepare`` here
and also writes its initial states for ``--init``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from fmov_pose_torch import quality


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--span", type=int, default=68,
                    help="degrees of the orbit (68 over 6 frames: the harness's 13.6 a frame)")
    ap.add_argument("--max_pro", type=int, default=60)
    ap.add_argument("--mesh_warmup", type=int, default=120)
    ap.add_argument("--d_hidden", type=int, default=256)
    ap.add_argument("--compute_dtype", type=str, default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2024])
    ap.add_argument("--init", type=str, default=None,
                    help="a directory of init_<seed>.ckpt start states")
    ap.add_argument("--harness", action="store_true",
                    help="the whole harness (quality.main) once a seed")
    ap.add_argument("--device", type=str, default=None)
    ap.add_argument("--work", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("rest", nargs="*", help="--harness: the harness's flags, after --")
    return ap.parse_args(argv)


def prepare(work, args):
    """The harness's data and phase-1 conf under ``work`` at ``args``'s
    sizes, with the width and compute dtype set.  Returns (the orbit's
    ground truth, the phase-1 conf's path relative to ``work``)."""
    h = quality.parse_args([
        "--frames", str(args.frames), "--res", str(args.res), "--span", str(args.span),
        "--max_pro", str(args.max_pro), "--mesh_warmup", str(args.mesh_warmup),
        # past the last admission: phase 1 ends there
        "--p1_iters", str(args.mesh_warmup + (args.frames + 1) * args.max_pro)])
    gt = quality.make_data(work, h)
    p1, _ = quality.write_confs(work, h)
    subs = {r'"d_hidden" = 256': f'"d_hidden" = {args.d_hidden}'}
    if args.compute_dtype:
        subs.update(quality.train_setting("compute_dtype", args.compute_dtype))
    quality.shrink_conf(p1, p1, subs)
    return gt, quality.P1_CONF


def summary(seed, validate, steps, seconds, step_ms):
    """One run's JSON object from ``validate_poses``'s output."""
    ate, rpe_t, rpe_r, gt, est = validate
    out = {"seed": seed, "p1_ate": float(ate), "p1_rpe_trans": float(rpe_t),
           "p1_rpe_rot_deg": float(np.rad2deg(rpe_r)), "steps": int(steps),
           "seconds": round(seconds, 1),
           "ms_per_step": round(float(np.median(step_ms)), 3) if len(step_ms) else None}
    if gt is not None:
        out.update(quality.orbit_errors(est[:len(gt)], gt))
    return out


def run_phase1(work, conf, seed, device, init=None):
    """Phase 1 from ``seed`` in ``work`` through the port's Runner, from
    the checkpoint ``init`` when given."""
    from fmov_pose_torch.train.runner import Runner
    cwd = os.getcwd()
    os.chdir(work)
    try:
        runner = Runner(conf, mode="train", case="SYN_ori", has_global_conf=True,
                        seed=seed, device=device)
        if init is not None:
            runner.load_checkpoint(init)
        t0 = time.perf_counter()
        runner.train()
        seconds = time.perf_counter() - t0
        return summary(seed, runner.validate_poses(), runner.iter_step, seconds,
                       runner.step_ms)
    finally:
        os.chdir(cwd)


def main(argv=None):
    args = parse_args(argv)
    device = args.device
    if device is None:
        from fmov_pose_torch.device import disable_tf32, require_cuda
        device = require_cuda()
        disable_tf32()
    rows = []
    for seed in args.seeds:
        work = tempfile.mkdtemp(prefix=f"fmov_p1_{seed}_", dir=args.work)
        init = (os.path.abspath(os.path.join(args.init, f"init_{seed}.ckpt"))
                if args.init else None)
        if args.harness:
            subs = (quality.train_setting("compute_dtype", args.compute_dtype)
                    if args.compute_dtype else None)
            res, orbit = quality.main(args.rest + ["--work", work], device=device,
                                      seed=seed, conf_subs=subs, init=init)
            row = {"seed": seed, "compute_dtype": args.compute_dtype,
                   "init": init and os.path.basename(init), **res, "phase1": orbit}
        else:
            gt, conf = prepare(work, args)
            row = run_phase1(work, conf, seed, device, init)
            row.update(d_hidden=args.d_hidden, frames=args.frames,
                       max_pro=args.max_pro, compute_dtype=args.compute_dtype,
                       init=init and os.path.basename(init),
                       device=quality.card(device)[0])
        print("probe " + json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    sys.path.insert(0, quality.REPO)
    main()
