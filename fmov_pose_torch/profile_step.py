"""Where the phase-2 training step's time goes on an NVIDIA GPU.

    python -m fmov_pose_torch.profile_step [--steps 15] [--trace PATH]

Trains ``confs/ho3d_global_womask.conf`` as written (its widths, batch,
samples and gf pose; ``warm_up_end`` = 0 so the learning rate is not ~0)
on the in-memory 8-frame 480x640 orbit scene of ``data/scene.py``, and
prints one JSON line per phase:

* ``ab``: K1 in the up-sampler against the f32 network there, alternating
  K1, f32, f32, K1 in this one process, ``--steps`` steps each.  Per round,
  the median step time on the device timeline (CUDA events between steps)
  and the median host time to enqueue a step (no sync inside a step).
* ``profile``: 5 steps with K1 under ``torch.profiler``.  From that one run,
  the step time (CUDA events), the device busy time (the union of the
  kernel, memcpy and memset intervals of the trace), the device's idle
  share of the step, and the device kernels launched per step.  The
  profiler's own host cost lengthens the step, so this idle share
  describes the profiled run; the ``ab`` step times are the unprofiled
  ones.
* ``top``: the ops with the most device self time per step.

Needs CUDA; raises without it.  ``--trace`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "confs", "ho3d_global_womask.conf")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_us(trace_events) -> tuple[float, int]:
    """(union of the device activity intervals in us, number of kernels)
    of a Chrome trace's ``traceEvents``."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    n_kernels = sum(1 for e in trace_events if e.get("cat") == "kernel")
    return total, n_kernels


def _steps(runner, perm, n, fused):
    """n steps; (per-step device-timeline ms, per-step host enqueue ms)."""
    import torch
    runner.model_cfg["sdf"]["use_fused"] = fused
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host = []
    events[0].record()
    for i in range(n):
        t0 = time.perf_counter()
        img_id, scalars = runner._plan_step(perm)
        runner.state, _ = runner.photo_step(runner.state, scalars, img_id)
        runner.iter_step += 1
        host.append((time.perf_counter() - t0) * 1e3)
        events[i + 1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])], host


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", type=str, default=None)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fmov_pose_torch.data.scene import make_orbit_scene
    from fmov_pose_torch.device import disable_tf32, require_cuda
    from fmov_pose_torch.train.runner import Runner

    dev = require_cuda()
    disable_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    scene = make_orbit_scene(n_frames=8, H=480, W=640, seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        runner = Runner(CONF, case="profile", exp_dir=os.path.join(tmp, "exp"),
                        seed=args.seed, device=dev, scene=scene)
        runner.end_iter, runner.warm_up_end = 10 ** 6, 0.0
        perm = runner.get_image_perm()
        _steps(runner, perm, 5, True)  # warm-up

        ab = []
        for fused in (True, False, False, True):
            dev_ms, host_ms = _steps(runner, perm, args.steps, fused)
            ab.append({"k1": fused, "step_ms": statistics.median(dev_ms),
                       "host_enqueue_ms": statistics.median(host_ms)})
        print(json.dumps({"phase": "ab", "card": card, "steps": args.steps,
                          "rounds": ab}), flush=True)

        n_prof = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dev_ms, host_ms = _steps(runner, perm, n_prof, True)
        trace = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            busy, n_kernels = busy_us(json.load(f)["traceEvents"])
        step_ms = sum(dev_ms) / n_prof
        busy_ms = busy / 1e3 / n_prof
        print(json.dumps({
            "phase": "profile", "card": card, "steps": n_prof,
            "step_ms": step_ms, "host_enqueue_ms": sum(host_ms) / n_prof,
            "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
            "kernels_per_step": n_kernels / n_prof,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}),
            flush=True)
        top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
        print(json.dumps({"phase": "top", "card": card, "ops": [
            {"name": e.key, "device_ms_per_step": e.self_device_time_total / 1e3 / n_prof,
             "calls_per_step": e.count / n_prof}
            for e in top[:15]]}), flush=True)


if __name__ == "__main__":
    main()
