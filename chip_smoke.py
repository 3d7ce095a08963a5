#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases, each printing a line as it ends:
  1. device  -- require CUDA; the card, its power limit, CUDA and nvcc
  2. build   -- compile K1 (ops/csrc/sdf_fwd.cu) from this checkout
  3. kernels -- K1 through its entries sdf_only_fused / sdf_apply_fused
                against its plain PyTorch version at the full width of
                confs/ho3d_global_womask.conf, M = 32,768 / 8,192 / 1,000,
                with CUDA-event timings of the entry, the bare launch and
                the plain version
  4. slice   -- fmov_pose_torch.train.runner.Runner trains that conf for 50
                steps on an in-memory 8-frame 480x640 orbit scene; the
                losses must be finite and the color loss must fall, and K1
                must have launched 4 times per step
Then one JSON line of kernel results, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.  Any failure raises: there is no CPU
fallback and no switch to the plain version.  Imports nothing of JAX and
nothing of the JAX package, and checks that at the end.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(ROOT, "confs", "ho3d_global_womask.conf")
STEPS = 50
SEED = 0
TIMING_REPS = 20


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _line(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps=TIMING_REPS):
    import torch
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device():
    import torch
    from fmov_pose_torch.device import disable_tf32, require_cuda
    from fmov_pose_torch.ops import build
    dev = require_cuda()
    disable_tf32()
    smi = _smi()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    _line("device", name=repr(torch.cuda.get_device_name(dev)),
          smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count(),
          nvcc=repr(nvcc.splitlines()[-1]))
    return dev, smi


def phase_build():
    from fmov_pose_torch.ops import build, fused_sdf
    t0 = time.perf_counter()
    fused_sdf._lib()
    info = build.BUILD_INFO["sdf_fwd"]
    regs = [l.strip() for l in info["log"].splitlines()
            if "registers" in l or "spill" in l]
    _line("build", kernel="sdf_fwd", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=f"{info['seconds']:.2f}", ptxas=repr(" | ".join(regs)))


def sdf_cfg():
    from fmov_pose_torch.data import hocon
    cfg = hocon.parse_file(CONF)["model.sdf_network"].as_plain_dict()
    cfg["skip_in"] = tuple(cfg["skip_in"])
    return cfg


def phase_kernels(dev):
    """K1 through the entries the up-sampler calls (``sdf_only_fused`` /
    ``sdf_apply_fused``: weight materialisation, packing, launch) against
    the plain version on the same weights; times the entry, the bare
    launch on pre-packed weights, and the plain version with its
    materialisation."""
    import numpy as np
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_sdf
    cfg = sdf_cfg()
    params = convert.to_torch(convert.to_numpy(
        nets.init_sdf(np.random.default_rng(SEED), cfg)), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    main = None
    with torch.no_grad():  # as the up-sampler calls K1
        for M in (32768, 8192, 1000):
            # points where the up-sampler queries them: inside the unit sphere
            x = (torch.rand((M, 3), generator=gen, device=dev) * 2 - 1) * 0.9
            for want_feature in (False, True):
                entry = (fused_sdf.sdf_apply_fused if want_feature
                         else fused_sdf.sdf_only_fused)

                def plain():
                    ws, bs = fused_sdf.materialize(params, cfg)
                    return fused_sdf.sdf_forward_plain(ws, bs, x, cfg, want_feature)

                before = fused_sdf.LAUNCHES
                got = entry(params, cfg, x)
                torch.cuda.synchronize()
                _require(fused_sdf.LAUNCHES == before + 1,
                         f"{entry.__name__} did not launch K1 once")
                err = fused_sdf.tolerance_check(plain(), got)
                packed = fused_sdf.pack(*fused_sdf.materialize(params, cfg), cfg,
                                        want_feature)
                entry_ms = _median_ms(lambda: entry(params, cfg, x))
                kernel_ms = _median_ms(
                    lambda: fused_sdf.launch(packed, x, float(cfg["scale"])))
                plain_ms = _median_ms(plain)
                _line("kernels", name="sdf_fwd", entry=entry.__name__, M=M,
                      ok=err["ok"], errors=json.dumps(err, sort_keys=True),
                      tol=(f"sdf median<={fused_sdf.SDF_MEDIAN_TOL} "
                           f"max<={fused_sdf.SDF_MAX_TOL}; feature/max|f| "
                           f"median<={fused_sdf.FEAT_MEDIAN_TOL} "
                           f"max<={fused_sdf.FEAT_MAX_TOL}").replace(" ", "_"),
                      entry_ms=f"{entry_ms:.4f}", kernel_only_ms=f"{kernel_ms:.4f}",
                      plain_ms=f"{plain_ms:.4f}",
                      kernel_tflops=f"{M * _flops_per_point(cfg, want_feature) / kernel_ms / 1e9:.2f}")
                _require(err["ok"], f"{entry.__name__} disagrees with the plain "
                                    f"version at M={M}: {err}")
                if M == 32768 and not want_feature:
                    main = {"max_abs_err": err["sdf_max"], "ms": entry_ms,
                            "plain_ms": plain_ms}
    return main


def _flops_per_point(cfg, want_feature):
    from fmov_pose_torch.fields import nets
    dims = nets.sdf_dims(cfg)
    n_lin = len(dims) - 1
    skip = cfg["skip_in"][0]
    fl = 0
    for l in range(n_lin):
        out = dims[l + 1] - dims[0] if (l + 1) == skip else dims[l + 1]
        if l == n_lin - 1 and not want_feature:
            out = 1
        fl += 2 * dims[l] * out
    return fl


def phase_slice(dev, smi):
    import numpy as np
    import torch
    from fmov_pose_torch.data import rays as raygen
    from fmov_pose_torch.data.scene import make_orbit_scene
    from fmov_pose_torch.ops import fused_sdf
    from fmov_pose_torch.train import step as step_mod
    from fmov_pose_torch.train.runner import Runner

    t0 = time.perf_counter()
    scene = make_orbit_scene(n_frames=8, H=480, W=640, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        runner = Runner(CONF, mode="train", case="orbit_smoke",
                        exp_dir=os.path.join(tmp, "exp"), seed=SEED,
                        device=dev, scene=scene)
        # the only overrides: a short run, and no LR warm-up (lr ~ 0 there)
        runner.end_iter, runner.warm_up_end = STEPS, 0.0
        _line("slice", scene="orbit_8x480x640",
              scene_seconds=f"{time.perf_counter() - t0:.1f}",
              conf=os.path.relpath(CONF, ROOT),
              overrides=f"end_iter={STEPS},warm_up_end=0")
        r = runner.model_cfg["renderer"]
        _require(runner.model_cfg["sdf"]["use_fused"], "the conf path runs K1")
        _line("slice", pose_mode=runner.pose_mode, batch=runner.batch_size,
              samples=f"{r.n_samples}+{r.n_importance}",
              up_sample_steps=r.up_sample_steps, perturb=r.perturb,
              n_params=runner.state.layout.size)

        # one ray batch rendered with the kernel and with the f32 network
        # in the up-sampler: the losses agree to K1's bf16 sample placement
        with torch.no_grad():
            g = torch.Generator(device=dev).manual_seed(SEED)
            st = runner.state
            data = raygen.gen_random_rays(
                g, runner.images_dev, runner.masks_dev, runner.intr_inv_dev,
                torch.as_tensor(scene.crop_poses[0][:3], device=dev), 0,
                runner.batch_size, runner.bbox_dev, runner.mask_guided_patch_size,
                True, scene.H, scene.W)
            scalars = step_mod.StepScalars(lr=0.0, cos_anneal=1.0)
            cfg_k = runner.step_cfg
            cfg_f = dataclasses.replace(cfg_k, model_cfg=dict(
                cfg_k.model_cfg, sdf=dict(cfg_k.model_cfg["sdf"], use_fused=False)))
            # the same seed for both: the same stratified perturbation
            lk, _ = step_mod._render_and_losses(
                cfg_k, torch.Generator(device=dev).manual_seed(SEED + 1),
                st.params, st.pose_static, data, scalars)
            lf, _ = step_mod._render_and_losses(
                cfg_f, torch.Generator(device=dev).manual_seed(SEED + 1),
                st.params, st.pose_static, data, scalars)
            rel = abs(float(lk) - float(lf)) / abs(float(lf))
        _line("slice", check="loss_kernel_vs_f32_upsampler", loss_kernel=f"{float(lk):.6f}",
              loss_f32=f"{float(lf):.6f}", rel=f"{rel:.2e}", tol="1e-2")
        _require(rel < 1e-2, f"K1 up-sampling changes the loss by {rel:.2e}")

        torch.cuda.reset_peak_memory_stats(dev)
        fused_sdf.LAUNCHES = 0
        runner.train()
        launches = fused_sdf.LAUNCHES
        peak = torch.cuda.max_memory_allocated(dev)

    h = runner.history
    losses = np.asarray(h["loss"])
    color = np.asarray(h["color_loss"])
    step_ms = statistics.median(runner.step_ms)
    _line("slice", steps=len(losses), loss_first=f"{losses[0]:.5f}",
          loss_last=f"{losses[-1]:.5f}",
          color_first10=f"{color[:10].mean():.5f}", color_last10=f"{color[-10:].mean():.5f}",
          psnr_last=f"{h['psnr'][-1]:.2f}", k1_launches=launches)
    _line("slice", median_step_ms=f"{step_ms:.2f}",
          rays_per_s=f"{runner.batch_size / (step_ms / 1e3):.0f}",
          wall_s=f"{runner.train_seconds:.2f}", peak_mem_gib=f"{peak / 2**30:.3f}",
          card=repr(smi))
    _require(len(losses) == STEPS and np.all(np.isfinite(losses)),
             f"non-finite or missing losses: {losses}")
    _require(color[-10:].mean() < color[:10].mean(),
             f"color loss did not fall: {color[:10]} -> {color[-10:]}")
    _require(launches == 4 * STEPS, f"K1 launched {launches} times in {STEPS} steps")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev, smi = phase_device()
    phase_build()
    k1 = phase_kernels(dev)
    launches = phase_slice(dev, smi)
    leaked = [m for m in ("jax", "fmov_pose_tpu") if m in sys.modules]
    _require(not leaked, f"the port's path imported {leaked}")
    print(json.dumps({"kernels": [{
        "name": "sdf_fwd", "route": "cuda",
        "source": "fmov_pose_torch/ops/csrc/sdf_fwd.cu",
        "replaces": "fmov_pose_tpu/ops/fused_sdf.py:326",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
