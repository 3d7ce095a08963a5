"""Where a training step's time goes on an NVIDIA GPU.

    python -m fmov_pose_torch.profile_step [CONF] [--steps 15] [--trace PATH]

Trains a conf as written (its widths, batch, samples and pose mode;
``warm_up_end`` = 0 so the learning rate is not ~0) on the in-memory
8-frame 480x640 orbit scene of ``data/scene.py``, and prints one JSON line
per phase.  ``CONF`` defaults to ``confs/ho3d_global_womask.conf``, whose
kernel is K1 in the up-sampler; with ``confs/ho3d_global_womask_tpu_fast.conf``
the kernels are K4/K5 and K8/K9 (``use_fused_train``) on the occupancy grid;
with the phase-1 ``confs/ho3d_virtual_tpu_fast.conf`` they are K2/K3, and
the steps are the progressive curriculum's photo and flow steps from its
start, its depth cut as ``chip_smoke.py`` cuts it (``PROGRESSIVE_CUT``: a
5-step mesh warm-up, a frame admitted every 8 steps), so that the
measured steps train the segment poses, admit frames and take flow steps.
``--n_outside N`` trains a copy of the conf with ``n_outside = N`` (the
NeRF++ background; with the fast phase-2 conf and 32, slice 4 of the port:
K4/K5 and the per-sample K6/K7, the background blocking K8/K9).

* ``ab``: the conf's kernels against the f32 networks in their place,
  alternating kernels, f32, f32, kernels in this one process, ``--steps``
  steps each.  Per round, the median step time on the device timeline
  (CUDA events between steps) and the median host time to enqueue a step
  (no sync inside a step).
* ``profile``: 5 steps with the kernels under ``torch.profiler``.  From
  that one run, the step time (CUDA events), the device busy time (the
  union of the kernel, memcpy and memset intervals of the trace), the
  device's idle share of the step, and the device kernels launched per
  step.  The profiler's own host cost lengthens the step, so this idle
  share describes the profiled run; the ``ab`` step times are the
  unprofiled ones.
* ``top``: the ops with the most device self time per step.
* ``kernels``: the ``fmov::K1..K9`` profiler ranges around the launches of
  the port's kernels (their helper launches included; with the default
  conf the up-sampler's four K1 launches), each with its device time per
  step, its share of the busy time and its rank among the ops of ``top``.
* ``split``: each range's device time per step by kernel name (e.g. K9's
  per-point ``color_bwd_kernel``, its ``atb_kernel`` and its
  ``reduce_kernel``), the kernels tied to the range through the
  correlation ids of the launches made inside it.

Needs CUDA; raises without it.  ``--trace`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "confs", "ho3d_global_womask.conf")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROGRESSIVE_CUT = {"mesh_warmup_step": 5, "max_pro_iteration": 8, "pro_warm_up_end": 4}


def conf_with_outside(conf: str, n_outside: int, out_dir: str) -> str:
    """A copy of ``conf`` in ``out_dir`` with ``n_outside`` (the NeRF++
    background's samples a ray) set; its path."""
    with open(conf) as f:
        text, n = re.subn(r"(\bn_outside\s*=\s*)\d+", rf"\g<1>{n_outside}", f.read())
    if n != 1:
        raise ValueError(f"{conf}: {n} n_outside settings, expected one")
    name = os.path.basename(conf).replace(".conf", f"_outside{n_outside}.conf")
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(text)
    return path


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


def _short(kernel):
    """A device kernel's own name: ``void ns::(anonymous namespace)::k<T>(A)``
    -> ``k``."""
    name, depth, plain = kernel.replace("(anonymous namespace)", "anon"), 0, ""
    for ch in name:  # drop template arguments, nested ones included
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch != ">":
            plain += ch
    return plain.split("(", 1)[0].rsplit("::", 1)[-1].split()[-1]


def range_split(trace_events, prefix="fmov::") -> dict:
    """{range: {kernel: device us}} over a Chrome trace: a kernel belongs
    to a ``prefix`` range when the runtime call that launched it (same
    correlation id) lies inside the range on the host thread that ran
    it."""
    ranges = [e for e in trace_events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(prefix) and "dur" in e]
    owner = {}
    for e in trace_events:
        if e.get("cat") != "cuda_runtime" or "correlation" not in e.get("args", {}):
            continue
        for r in ranges:
            if (r["tid"] == e["tid"] and r["pid"] == e["pid"]
                    and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]):
                owner[e["args"]["correlation"]] = r["name"]
                break
    out = {}
    for e in trace_events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") == "kernel" and corr in owner:
            per = out.setdefault(owner[corr], {})
            name = _short(e["name"])
            per[name] = per.get(name, 0.0) + e["dur"]
    return out


def _steps(runner, n, switch, fused):
    """n steps of the Runner's loop (plan, dispatch, the progressive
    bookkeeping) with the SDF config's ``switch`` set to ``fused``;
    (per-step device-timeline ms, per-step host enqueue ms)."""
    import torch
    runner.model_cfg["sdf"][switch] = fused
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host = []
    events[0].record()
    for i in range(n):
        t0 = time.perf_counter()
        runner._dispatch(*runner._plan_step()[:3])
        runner.iter_step += 1
        runner._progressive_update()
        runner._maybe_regen_perms()
        host.append((time.perf_counter() - t0) * 1e3)
        events[i + 1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])], host


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("conf", nargs="?", default=CONF)
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", type=str, default=None)
    parser.add_argument("--n_outside", type=int, default=None,
                        help="train a copy of CONF with this n_outside")
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
        conf_path = (args.conf if args.n_outside is None
                     else conf_with_outside(args.conf, args.n_outside, tmp))
        runner = Runner(conf_path, case="profile", exp_dir=os.path.join(tmp, "exp"),
                        seed=args.seed, device=dev, scene=scene)
        runner.end_iter, runner.warm_up_end = 10 ** 6, 0.0
        if runner.progressive:
            for key, value in PROGRESSIVE_CUT.items():
                setattr(runner, key, value)
                runner.conf.put(f"train.{key}", value)
        switch = ("use_fused_train" if runner.model_cfg["sdf"].get("use_fused_train")
                  else "use_fused")
        conf = os.path.relpath(args.conf, ROOT) + (
            "" if args.n_outside is None else f" n_outside={args.n_outside}")
        runner._init_perms()
        _steps(runner, 5, switch, True)  # warm-up

        ab = []
        for fused in (True, False, False, True):
            dev_ms, host_ms = _steps(runner, args.steps, switch, fused)
            ab.append({"kernels": fused, "step_ms": statistics.median(dev_ms),
                       "host_enqueue_ms": statistics.median(host_ms)})
        print(json.dumps({"phase": "ab", "card": card, "conf": conf, "switch": switch,
                          "steps": args.steps, "rounds": ab,
                          "flow_steps": runner.flow_steps,
                          "current_image": runner.current_image}), flush=True)

        n_prof = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dev_ms, host_ms = _steps(runner, n_prof, switch, True)
        trace = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        busy, n_kernels = busy_us(events)
        step_ms = sum(dev_ms) / n_prof
        busy_ms = busy / 1e3 / n_prof
        print(json.dumps({
            "phase": "profile", "card": card, "conf": conf, "steps": n_prof,
            "step_ms": step_ms, "host_enqueue_ms": sum(host_ms) / n_prof,
            "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
            "kernels_per_step": n_kernels / n_prof, "flow_steps": runner.flow_steps,
            "current_image": runner.current_image,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}),
            flush=True)
        # the fmov:: ranges appear twice (host range, device annotation)
        # and would count their kernels' time again: kept out of ``top``
        averages = prof.key_averages()
        top = sorted((e for e in averages if not e.key.startswith("fmov::")),
                     key=lambda e: -e.self_device_time_total)
        print(json.dumps({"phase": "top", "card": card, "conf": conf, "ops": [
            {"name": e.key, "device_ms_per_step": e.self_device_time_total / 1e3 / n_prof,
             "calls_per_step": e.count / n_prof}
            for e in top[:15]]}), flush=True)
        # each port kernel's range (all its launches), placed among the ops
        # of ``top``: its rank is 1 + the ops with more device self time
        ranges = {}
        for e in averages:
            if e.key.startswith("fmov::"):
                ranges[e.key] = max(ranges.get(e.key, 0.0), e.device_time_total)
        selfs = [e.self_device_time_total for e in top]
        print(json.dumps({"phase": "kernels", "card": card, "conf": conf, "ranges": [
            {"name": k, "device_ms_per_step": t / 1e3 / n_prof,
             "share_of_busy": t / 1e3 / n_prof / busy_ms,
             "rank": 1 + sum(s > t for s in selfs)}
            for k, t in sorted(ranges.items())]}), flush=True)
        print(json.dumps({"phase": "split", "card": card, "conf": conf, "ranges": {
            r: {k: us / 1e3 / n_prof for k, us in sorted(per.items())}
            for r, per in sorted(range_split(events).items())}}), flush=True)


if __name__ == "__main__":
    main()
