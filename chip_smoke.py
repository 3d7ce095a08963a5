#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU
    python3 chip_smoke.py train-kernels flat-kernels wgrad   # device, build
                                 # and the named kernel phases only, no result line
    python3 chip_smoke.py planned scan quality dp   # those run phases only,
                                 # no result line

Phases, each printing lines as it ends:
  1. device   -- require CUDA; the card, its power limit, CUDA and nvcc
  2. build    -- compile every kernel source of this checkout, one nvcc
                 each, all started together (K1 sdf_fwd.cu, K2/K3
                 sdf_flat.cu, K4 sdf_fwd_grad.cu, K5 sdf_bwd.cu, K6/K7
                 color_sample.cu, K8/K9 color_ray.cu), and print ptxas's
                 registers and spills (by name for the nine per-point
                 kernels on the pipeline: K1's, K4's, K2's, K5's, K3's,
                 K8's, K6's, K9's and K7's)
  3. kernels  -- K1 through its entries sdf_only_fused / sdf_apply_fused
                 and through the pre-packed launch the up-sampler and the
                 mesh take against its plain PyTorch version at the full
                 width of confs/ho3d_global_womask.conf, M = 262,144 (a
                 mesh chunk, 64^3) / 32,768 / 8,192 / 1,000 (all but the
                 last also bitwise equal over two launches), and at a
                 small width with the skip at the last linear; CUDA-event
                 times of the entry, the pre-packed launch and the plain
                 version
  4. train-kernels -- K4, K5, K8 and K9 through their entries against their
                 plain versions at the full width of
                 confs/ho3d_global_womask_tpu_fast.conf, M = 512 x 128 and
                 3 x 128 (ragged), K4, K5, K8 and K9 also against themselves:
                 two launches on the same inputs bitwise equal; CUDA-event
                 times of the entry, the kernel alone and the plain version
  5. flat-kernels -- K2 and K3 through their entry sdf_apply_grad_fused
                 (forward and every gradient leaf, x included) against the
                 same entry on CPU copies (the plain versions) at the full
                 width of confs/ho3d_virtual_tpu_fast.conf, M = 1,024 x 32
                 and a ragged 1,000, K2 and K3 also bitwise equal over two
                 launches; CUDA-event times of the wrapper, the kernel alone
                 and the plain version
  6. color-kernels -- K6 and K7 through their entry color_fused (forward
                 and every gradient leaf, xc included) against the same
                 entry on CPU copies (the plain versions) at the full width
                 of the fast conf, M = 512 x 128 and a ragged 1,000, xc
                 built from K4's outputs, K6 and K7 also bitwise equal over
                 two launches; CUDA-event times of the wrapper, the kernel alone
                 and the plain version
     wgrad    -- the weight-gradient stage of K5, K3, K9 and K7 (wgrad.cu)
                 alone at their shapes (M = 65,536 / 32,768 / 65,536 /
                 65,536) on the workspace their per-point pass filled:
                 twice bitwise, against its plain version (WGRAD_TOL),
                 also on positive operands; CUDA-event times of the stage,
                 the plain version and one torch.mm a layer (the library
                 yardstick), and its bound
  7. slice    -- Runner trains confs/ho3d_global_womask.conf for 50 steps on
                 an in-memory 8-frame 480x640 orbit scene: finite losses, a
                 falling color loss, K1 launched 4 times per step
  8. slice2   -- Runner trains confs/ho3d_global_womask_tpu_fast.conf for 50
                 steps on the same scene (occupancy grid refreshed after
                 steps 25 and 50): finite losses, a falling color loss, K4,
                 K5, K8 and K9 launched once per step and K1 never, a grid
                 that is no longer all ones.  Before and after the run, one
                 batch through the kernels, their plain versions (on CPU
                 copies) and the f32 networks: the loss within 1e-2 of
                 f32's, every gradient leaf within the leaf rule of the
                 plain versions', and the leaves against f32 reported
  9. slice3   -- Runner trains the progressive phase 1 of
                 confs/ho3d_virtual_tpu_fast.conf (segment poses, flow steps,
                 512 + 512 rays x 32 samples) for 50 steps on the same scene,
                 with the schedule's depth cut (mesh warm-up 10 steps, a
                 frame admitted every 8): finite losses, a falling color
                 loss, K2 and K3 launched once per step and no other kernel,
                 flow steps taken, at least 4 frames admitted and their
                 segments initialised; the same batch check before and after
 10. planned  -- the planned phase-1 dispatch (train.plan_chunk = 20) on a
                 copy of confs/ho3d_virtual_tpu_fast.conf cut in depth (mesh
                 warm-up 40, a frame admitted every 40 steps, warm-up end
                 20, every frequency a multiple of 20, 320 steps): the
                 photo and the flow step captured into a CUDA graph each
                 and replayed row by row; the per-step run from the same
                 seed; both admit all 8 frames with the same curriculum,
                 flow steps and host RNG, the states within the leaf rule,
                 K2 and K3 once a replay and a step, finite losses, frame
                 0's color loss falling; 40 graphed steps (photo and flow,
                 from a run at step 120) bitwise the same 40 eager ones;
                 ms a step planned against per-step, launches a replay,
                 peak memory; then the same planned run with
                 model.pixel_level = true (the deep pose bank), all its
                 segments initialised, its checkpoint read back bitwise
 11. slice4   -- Runner trains the fast phase-2 conf with n_outside = 32
                 (the NeRF++ background; a copy of the conf written to a
                 temporary directory) for 50 steps on the same scene: finite
                 losses, a falling color loss, K4, K5, K6 and K7 launched
                 once per step and no other kernel, the background
                 network's parameters moved, a refreshed grid; the batch
                 check before and after, the nerf.* leaves included
 12. mesh     -- the CLI's final mesh on slice 1's Runner after its 50
                 steps: validate_mesh(resolution=512, use_norml_color=True),
                 the 512^3 grid through K1 in chunks of 262,144 points on
                 one pack (K1 launched exactly 512 times, no other kernel),
                 a non-empty mesh inside the bounds that read_ply reads back
                 as written; the seconds of the grid, the copies back, the
                 marching cubes, the normals and the write
 13. resume   -- a second Runner on the exp dir of slice 1 and of slice 3
                 with is_continue: every checkpoint leaf (parameters, Adam
                 moments, segment bank and its Adam, pose buffers), the
                 generator's state and the host counters bitwise the first
                 Runner's; one fixed batch's loss bitwise equal through both;
                 5 more steps with finite losses on the path's kernels
 14. two_phase -- the CLI's two-phase command (exp_runner.main with
                 --global_conf, in-process, the cwd a temporary work dir)
                 on an 8-frame 480x640 orbit written to disk in the HO3D
                 layout (SYN_ori with crop and matches, SYN, ann/SYN.npz),
                 copies of the fast virtual and global confs cut in depth
                 (phase 1 with slice 3's schedule until all 8 frames are
                 admitted, phase 2 50 steps), the final mesh at 256^3: no
                 phase-1 error file, every frame admitted before end_iter,
                 finite aligned poses, 8 world and scale mats in the
                 phase-2 dataset, phase 2's 50 finite losses and falling
                 color loss, a non-empty final mesh and the poses file;
                 K2/K3 once a phase-1 step, K1 once for the 64^3
                 transition mesh and 64 times for the final one,
                 K4/K5/K8/K9 once a phase-2 step, K6/K7 never; the
                 alignment's ATE/RPE, phase 2's poses against the true
                 orbit, and each stage's seconds
 15. eval     -- the eval and export methods on the two-phase command's
                 Runners in its work dir, each called directly (uncaught):
                 on phase 2 (K1 in the up-sampler, K4, K8: the eval render
                 under no_grad, 512-ray chunks) validate_image at levels 1
                 (480x640, 600 chunks) and 4, render_poses (8 frames with
                 their normal maps), interpolate_view (6 frames, an mp4
                 read back), save_alignment_materials, the textured 64^3
                 mesh at tex_size 1024 (8,192-ray chunks: K4 and K8 at M =
                 1,048,576, K1 at 524,288), the gradient report (K4/K5/K8
                 3 times, K9 once); the CLI's validate_poses on phase 1's
                 checkpoint (ATE/RPE against the orbit), its
                 validate_image at level 4 (K2) and save_poses; the
                 slice-4 conf (n_outside = 32) on phase 2's checkpoint,
                 validate_image at level 4 (K1, K4, K6).  Each call: its
                 seconds, launches by kernel and M, chunks, peak memory,
                 output checks and file sizes.  Then 4 chunks of the eval
                 render through the kernels against the plain versions
                 (CPU copies of the state), K4/K8's entries against the
                 kernels alone at M = 1,048,576, and a profile of 8 chunks
 16. scan     -- the JAX Runner's default phase-2 dispatch (100 steps a
                 dispatch, on the card one step captured into a CUDA graph
                 and replayed) on confs/ho3d_global_womask.conf (K1 4 a
                 step) and on the fast conf without the grid (the
                 harness's --fused phase 2: K1 4, K4/K5/K8/K9 1 a step),
                 from step 0 with no LR warm-up: a graphed chunk bitwise
                 an eager one from the same state and generator state (or
                 the leaf rule on the parameter moves, reported), the
                 chunk's frames over [0, 8) and a second chunk's differing,
                 each kernel's launches a replay equal to an eager step's;
                 a 3-chunk run (checkpoints at the edges) and a Runner
                 loading its second edge's checkpoint bitwise equal after
                 the third chunk, its launches (warm-up and replays); ms a
                 step graphed (chunk events / 100) against the per-step
                 loop (train.scan_steps = False, 200 steps)
 17. bf16     -- confs/ho3d_global_womask.conf with train.compute_dtype =
                 bfloat16 (a copy of the conf in a temporary directory):
                 the bf16 fields at the conf's width on the card against
                 the same functions on CPU copies; 50 per-step steps and
                 a 300-step scanned run (3 chunks of 100) on the scene:
                 finite losses, a falling color loss, K1 4 launches a
                 step (1,208 in the scanned run), ms a step and peak
                 memory beside the f32 runs of slice and scan in the same
                 call
 18. quality  -- python -m fmov_pose_torch.quality at a short schedule
                 (6 frames, 128x128, phase 1 400 steps until all frames
                 are admitted, phase 2 200): finite ATE, RPE, PSNR and
                 Chamfer distance, a mesh, phase 2 on "scan x100"; phase
                 1's orbit errors (``quality.orbit_errors``: each
                 transition's relative rotation error, the degrees a frame
                 learned and true, the radii)
 19. dp       -- data parallelism (parallel/dp.py) in child processes of
                 this script, so that no process group outlives the phase:
                 (a) two ranks on the one card over gloo (NCCL refuses two
                 ranks on one device): one data-parallel step on a given
                 global batch of pixels (perturbation 0, each rank its
                 rows) against one process on the whole batch, the loss
                 within 1e-3 and the Adam moments by the leaf rule, on the
                 fast phase-2 conf as shipped (512 rays, 256 a rank: below
                 the rays gate, so each rank takes K2/K3 and the f32
                 color; the loss within 1e-2, the leaf rule reported), on
                 a copy with 1,024 rays (512 a rank: K4/K5/K8/K9) and on
                 the fast phase-1 conf (a photo and a flow step, segment
                 bank, maintain_shape, K2/K3); then Runner.train 50 steps
                 on each rank of the 1,024-ray copy (grid refreshed after
                 steps 25 and 50) and of phase 1 with slice 3's schedule:
                 finite, falling losses, the ranks' states bitwise equal,
                 the same frame on both in every step and different rays,
                 rank 1 wrote no file, the kernels once a step on each
                 rank; (b) one rank over NCCL on confs/ho3d_global_womask.conf:
                 50 data-parallel scanned steps captured into one graph
                 with their all-reduces (K1 4 a replay), bitwise the same
                 chunk eager and the captured chunk without a group;
                 all-reduces a step, ms a step and peak memory per rank
The phases before "scan" but "planned" run the per-step loop (slice 1
sets train.scan_steps off; the other confs are not scan-eligible as cut).
Then one JSON line of kernel results (each with its launches in its
paths' runs, its time, its plain version's, and its bound on the card;
the weight-gradient stage's entry "weight_grads" with its library time,
its launches those of K3, K5, K7 and K9, and each shape under "shapes"),
the nvidia-smi line, and the last line {"ok": true, "device": {...}}.  Any failure raises: there is no CPU
fallback and no switch to the plain version.  Imports nothing of JAX and
nothing of the JAX package, and checks that at the end.
"""

import collections
import dataclasses
import json
import math
import os
import statistics
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(ROOT, "confs", "ho3d_global_womask.conf")
FAST_CONF = os.path.join(ROOT, "confs", "ho3d_global_womask_tpu_fast.conf")
VIRTUAL_CONF = os.path.join(ROOT, "confs", "ho3d_virtual_tpu_fast.conf")
STEPS = 50
# slice 3's schedule, cut in depth only
SLICE3_SCHEDULE = {"mesh_warmup_step": 10, "max_pro_iteration": 8, "pro_warm_up_end": 4}
OCC_UPDATE_FREQ = 25
SEED = 0
TIMING_REPS = 20
SOURCES = ("sdf_fwd", "sdf_flat", "sdf_fwd_grad", "sdf_bwd", "color_ray",
           "color_sample", "wgrad")
# slice 4: the fast phase-2 conf with the NeRF++ background's samples a ray
# of the public NeuS womask conf and of scripts/parity_check.py's "p2_bg"
N_OUTSIDE = 32
# the card's peaks for the bounds (NVIDIA's H100 SXM data sheet)
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# rows: max |err| and median |err| relative to max|ref| (K1's rule)
ROW_MEDIAN_TOL, ROW_MAX_TOL = 1e-5, 1e-2
# the mesh: the CLI's final resolution, evaluated in chunks of 64^3 points
MESH_RES, MESH_CHUNK = 512, 64 ** 3
RESUME_STEPS = 5
# the two-phase command on an 8-frame 480x640 orbit written to disk, the
# confs cut in depth only: phase 1 with slice 3's schedule until all frames
# are admitted (10 + 8 x 8 = 74 steps, well before its end_iter), phase 2 for
# STEPS; the final mesh at 256^3 (the mesh phase runs the default 512^3)
TWO_PHASE_FRAMES = 8
TWO_PHASE_P1 = {"end_iter": 200, "warm_up_end": 0, **SLICE3_SCHEDULE}
TWO_PHASE_P2 = {"end_iter": STEPS, "warm_up_end": 0}
TWO_PHASE_MESH_RES = 256


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


T0 = time.perf_counter()


def _line(phase, **kw):
    """One result line, stamped with the seconds since the script began."""
    print(f"[{phase}] t={time.perf_counter() - T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


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
    from fmov_pose_torch.ops import build, fused_color, fused_sdf, wgrad
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    fused_sdf._lib()
    fused_sdf._flat_lib()
    fused_sdf._rays_lib()
    fused_color._lib()
    fused_color._sample_lib()
    wgrad._lib()
    total = time.perf_counter() - t0
    for name in SOURCES:
        info = build.BUILD_INFO[name]
        regs = [l.strip() for l in info["log"].splitlines()
                if "registers" in l or "spill" in l]
        per_point = {k: v for k, v in _ptxas_entries(info["log"]).items()
                     if k in PER_POINT + STAGE}
        _line("build", kernel=name, nvcc_seconds=f"{info['seconds']:.2f}",
              ptxas=repr(" | ".join(regs)),
              **{k: json.dumps(v).replace(" ", "") for k, v in per_point.items()})
    _line("build", all_seconds=f"{total:.2f}")


# the per-point kernels on the pipeline (K1, K4, K2, K5, K3, K8, K6, K9,
# K7), whose registers and spills the build line names
PER_POINT = ("sdf_fwd_kernel", "sdf_fwd_grad_kernel", "sdf_fwd_grad_flat_kernel",
             "sdf_bwd_kernel",
             "sdf_bwd_flat_kernel", "color_fwd_kernel", "color_sample_fwd_kernel",
             "color_bwd_kernel", "color_sample_bwd_kernel")
# the weight-gradient stage of K3/K5/K7/K9 (wgrad.cu), also on the build line
STAGE = ("wgrad_kernel",)


def _kernel_name(mangled):
    """The function's own name in an Itanium-mangled name: the last
    length-prefixed piece before the nested name ends (``_ZN...E``)."""
    i, name = 0, mangled
    while i < len(mangled):
        if mangled[i].isdigit():
            j = i
            while j < len(mangled) and mangled[j].isdigit():
                j += 1
            n = int(mangled[i:j])
            name, i = mangled[j:j + n], j + n
        elif mangled[i] == "E" and i > 2:
            break
        else:
            i += 1
    return name


def _ptxas_entries(log):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from ptxas -v."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            cur = _kernel_name(m.group(1))
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def model_cfg(conf, section):
    from fmov_pose_torch.data import hocon
    cfg = hocon.parse_file(conf)[f"model.{section}"].as_plain_dict()
    if "skip_in" in cfg:
        cfg["skip_in"] = tuple(cfg["skip_in"])
    return cfg


def phase_kernels(dev):
    """K1 through its entries (``sdf_only_fused`` / ``sdf_apply_fused``:
    weight materialisation, packing, launch) and through the launch on a
    pack built once (``FwdPack``, ``launch``: the up-sampler's route, which
    must give the entry's bits) against the plain version on the same
    weights, at the slice-1 conf's full width; at the up-sampler's M =
    32,768 and 8,192 also bitwise run to run.  Times the entry, the
    pre-packed launch, and the plain version with its materialisation.
    Then a small width with the skip concat at the last linear
    (``skip_in = (n_layers,)``, which K1 takes and K2-K5 do not) at a
    ragged M = 1,000."""
    import numpy as np
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_sdf
    cfg = model_cfg(CONF, "sdf_network")
    params = convert.to_torch(convert.to_numpy(
        nets.init_sdf(np.random.default_rng(SEED), cfg)), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    main, mesh_chunk = None, None
    with torch.no_grad():  # as the up-sampler calls K1
        for M in (MESH_CHUNK, 32768, 8192, 1000):
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
                pk = fused_sdf.FwdPack(params, cfg, want_feature)
                same_route = bool(torch.equal(fused_sdf.launch(pk, x), got))
                _require(same_route, f"K1 on a pack built once and {entry.__name__} "
                                     f"differ at M={M}")
                if M != 1000:
                    _same_twice("kernels", f"sdf_fwd_{entry.__name__}", M,
                                lambda: (fused_sdf.launch(pk, x),))
                entry_ms = _median_ms(lambda: entry(params, cfg, x))
                kernel_ms = _median_ms(lambda: fused_sdf.launch(pk, x))
                plain_ms = _median_ms(plain)
                _line("kernels", name="sdf_fwd", entry=entry.__name__, M=M,
                      prepacked_equals_entry=same_route,
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
                            "plain_ms": plain_ms, **_bound(*_sdf_work(cfg, M, "K1"))}
                if M == MESH_CHUNK and not want_feature:
                    mesh_chunk = {"M": M, "max_abs_err": err["sdf_max"], "ms": entry_ms,
                                  "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                                  **_bound(*_sdf_work(cfg, M, "K1"))}
        # the skip concat at the last linear, at a small width
        small = dict(cfg, d_out=33, d_hidden=64, n_layers=4, skip_in=(4,), multires=4,
                     scale=0.8)
        sp = convert.to_torch(convert.to_numpy(
            nets.init_sdf(np.random.default_rng(SEED + 1), small)), dev)
        x = (torch.rand((1000, 3), generator=gen, device=dev) * 2 - 1) * 0.9
        for want_feature in (False, True):
            pk = fused_sdf.FwdPack(sp, small, want_feature)
            got = fused_sdf.launch(pk, x)
            err = fused_sdf.tolerance_check(
                fused_sdf.sdf_forward_plain(pk.ws, pk.bs, x, small, want_feature), got)
            _line("kernels", name="sdf_fwd", width="4x64_skip_at_last_linear", M=1000,
                  want_feature=want_feature, ok=err["ok"],
                  errors=json.dumps(err, sort_keys=True).replace(" ", ""))
            _require(err["ok"], f"K1 with the skip at the last linear disagrees with "
                                f"the plain version: {err}")
    main["mesh_chunk"] = mesh_chunk
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


def _bound(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}  # no one PyTorch call computes a fused MLP


def _sdf_work(cfg, M, kind):
    """(FLOPs, bytes) of one SDF kernel call on M points, from the shapes:
    2 in x out a point per linear product (forward, gradient chain, Phase
    A with its weight product, Phase B with its weight product); bytes
    count each input once (the points, the bf16 weights, the cotangents)
    and each output once (out, d_inputs or grad, xbar or xebar, the f32
    weight gradients).  kind: K1 (sdf only), K2, K3, K4 or K5."""
    from fmov_pose_torch.fields import nets
    dims = nets.sdf_dims(cfg)
    skip = cfg["skip_in"][0]
    n_lin = len(dims) - 1
    outs = [dims[l + 1] - dims[0] if l + 1 == skip else dims[l + 1]
            for l in range(n_lin)]
    prods = [dims[l] * outs[l] for l in range(n_lin)]
    hidden, full = sum(prods[:-1]), sum(prods)
    pe, d_out = dims[0], cfg["d_out"]
    w_bytes = 2 * full + 4 * sum(outs)
    g_bytes = 4 * full + 4 * sum(outs)
    if kind == "K1":
        return 2 * (hidden + dims[-2]) * M, M * (12 + 4) + w_bytes
    if kind in ("K2", "K4"):
        io = 4 * (pe + d_out + pe) if kind == "K2" else 12 + 4 * d_out + 4 + 12
        return 2 * (full + hidden) * M, M * io + w_bytes
    io = 4 * (3 * pe + d_out) if kind == "K3" else 12 + 4 * d_out + 4 + 12 + 12
    return 2 * (4 * hidden + 2 * full) * M, M * io + w_bytes + g_bytes


def _color_work(cfg, M, B, backward):
    """(FLOPs, bytes) of K8 (backward False) or K9 on M samples of B rays:
    the color MLP's products (K9: recomputed forward, input and weight
    gradients) and its inputs (SDF output, points, directions, normals,
    weights) and outputs (colors, or their cotangents' images)."""
    from fmov_pose_torch.fields import nets
    dims = nets.color_dims(cfg)
    prods = sum(dims[l] * dims[l + 1] for l in range(len(dims) - 1))
    per_sample = 4 * (cfg["d_feature"] + 1) + 12 * 3 + 4
    w_bytes = 2 * prods + 4 * sum(dims[1:])
    if not backward:
        return 2 * prods * M, M * per_sample + B * 12 + w_bytes
    return (3 * 2 * prods * M, 2 * M * per_sample + B * 12 + w_bytes
            + 4 * prods + 4 * sum(dims[1:]))


def _color_sample_work(cfg, M, backward):
    """(FLOPs, bytes) of K6 (backward False) or K7 on M samples: the color
    MLP's products (K7: recomputed forward, input and weight gradients);
    K6 reads xc and writes rgb, K7 reads xc and ct and writes xcbar and the
    f32 weight gradients; both read the bf16 weights and f32 biases."""
    from fmov_pose_torch.fields import nets
    dims = nets.color_dims(cfg)
    prods = sum(dims[l] * dims[l + 1] for l in range(len(dims) - 1))
    w_bytes = 2 * prods + 4 * sum(dims[1:])
    if not backward:
        return 2 * prods * M, M * 4 * (dims[0] + 3) + w_bytes
    return (3 * 2 * prods * M, M * 4 * (2 * dims[0] + 3) + w_bytes
            + 4 * prods + 4 * sum(dims[1:]))


def _rows(ref, got):
    """Errors of rows ``got`` against ``ref`` relative to max|ref|."""
    d = (got.double() - ref.double()).abs()
    scale = max(float(ref.abs().max()), 1e-30)
    res = {"max_abs": float(d.max()), "max_rel": float(d.max()) / scale,
           "median_rel": float(d.median()) / scale}
    res["ok"] = (res["max_rel"] <= ROW_MAX_TOL and res["median_rel"] <= ROW_MEDIAN_TOL
                 and bool(got.isfinite().all()))
    return res


def _leaves(prefix_names, values):
    """{name: tensor} of a kernel's gradient outputs (lists flattened)."""
    out = {}
    for name, v in zip(prefix_names, values):
        if isinstance(v, (list, tuple)):
            out.update({f"{name}{l}": t for l, t in enumerate(v)})
        else:
            out[name] = v
    return out


def _leaf_check(ref, got):
    """The leaf rule (fused_sdf.leaf_rule) plus the largest |error|."""
    from fmov_pose_torch.ops import fused_sdf
    res = fused_sdf.leaf_rule(ref, got)
    res["max_abs"] = max(float((got[k].double() - r.double()).abs().max())
                         for k, r in ref.items())
    return res


LEAF_TOL = "rel_L2<1e-2_or_abs_L2<1e-4*global_norm"
ROW_TOL = f"median/max|ref|<={ROW_MEDIAN_TOL}_max/max|ref|<={ROW_MAX_TOL}"
# the eval render through the kernels against the plain versions, per
# output, each ray's max |err| over max|ref|: its median, the share of rays
# beyond the rows rule's max, and the largest.  A ray's outputs composite
# 128 samples whose alphas, sigmoids of s * sdf, carry the K4 rows' f32
# sums in another order and K1's bf16 rounding flips in the up-sampled
# z-values: on the H100 medians 5.3e-5 to 1.1e-4, at most 0.1% of the
# rays beyond 1e-2, the largest 1.35e-2 (PERF.md, section 6)
EVAL_MEDIAN_TOL, EVAL_OUTSIDE_SHARE, EVAL_MAX_TOL = 3e-4, 0.005, 5e-2
EVAL_TOL = (f"median/max|ref|<={EVAL_MEDIAN_TOL}_share_of_rays_with_max/max|ref|"
            f">{ROW_MAX_TOL}<={EVAL_OUTSIDE_SHARE}_max/max|ref|<={EVAL_MAX_TOL}")
# K4's feature columns at the bake chunk: its samples crowd a short
# segment across the surface, where max|feature| is small, so the bf16
# operands' rounding (as large on the plain version as on the kernel
# against an f64 forward) stands out against it: max 1.4e-2 - 2.0e-2 of
# max|feature| on the H100 (PERF.md, section 6).  The sdf column and the
# median keep K1's rule; the max and the share bound gross faults
BAKE_FEAT_MAX_TOL, BAKE_FEAT_SHARE = 5e-2, 1e-3
BAKE_OUT_TOL = (f"sdf_and_feature_median:K1_rule_feature_max/max|f|<={BAKE_FEAT_MAX_TOL}"
                f"_share_of_rows_beyond_{ROW_MAX_TOL}<={BAKE_FEAT_SHARE}")


def _same_twice(phase, name, M, launch):
    """Two launches on the same inputs give bitwise the same outputs (the
    design's fixed-order sums promise it)."""
    import torch
    first, second = launch(), launch()
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(first, second))
    _line(phase, name=name, M=M, check="bitwise_run_to_run", ok=same)
    _require(same, f"{name} gave other bits on a second launch at M={M}")


def _bwd_plan_line(phase, name, pk, M, dev):
    """The launch plan of K5/K3's per-point pass, as its library computes
    it (fused_sdf.bwd_launch_plan): blocks, threads, ring stages, shared
    memory and passes a tile."""
    from fmov_pose_torch.ops import fused_sdf, packing
    plan = fused_sdf.bwd_launch_plan(pk)
    _line(phase, name=f"{name}_plan", M=M,
          blocks=fused_sdf._grid(dev, packing.round_up(M, packing.TILE_M) // packing.TILE_M),
          threads=plan["threads"], stages=plan["stages"], smem=plan["smem"],
          passes=plan["passes"])


def phase_train_kernels(dev):
    """K4, K5, K8 and K9 through their entries (packing, launch, and for
    K5/K9 the unpacking of the weight gradients) against their plain
    versions on the same weights and inputs, at the shapes of the fast
    conf's step (512 rays x 128 samples) and a ragged 3 x 128.  K8/K9 take
    K4's outputs as their SDF features and normals.  Times the entry, the
    kernel alone on pre-packed weights, and the plain version."""
    import numpy as np
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_color, fused_sdf
    cfg_s = model_cfg(FAST_CONF, "sdf_network")
    cfg_c = model_cfg(FAST_CONF, "rendering_network")
    rng = np.random.default_rng(SEED)
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        nets.init_sdf(rng, cfg_s)), dev), cfg_s)
    cws, cbs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        nets.init_color(rng, cfg_c)), dev), cfg_c)
    pk = fused_sdf.RaysPack(ws, bs, cfg_s)
    cpk = fused_color.RayPack(cws, cbs, cfg_c)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    main = {}

    work = {"sdf_fwd_grad": lambda B, N: _sdf_work(cfg_s, B * N, "K4"),
            "sdf_bwd": lambda B, N: _sdf_work(cfg_s, B * N, "K5"),
            "color_ray_fwd": lambda B, N: _color_work(cfg_c, B * N, B, False),
            "color_ray_bwd": lambda B, N: _color_work(cfg_c, B * N, B, True)}

    def report(name, B, N, err, tol, entry, kernel, plain, counter):
        before = counter()
        got = entry()
        torch.cuda.synchronize()
        _require(counter() == before + 1, f"{name}'s entry did not launch it once")
        res = err(got, plain())
        t_entry, t_kernel, t_plain = (_median_ms(f) for f in (entry, kernel, plain))
        _line("train-kernels", name=name, B=B, N=N, M=B * N, ok=res["ok"],
              errors=json.dumps(res, sort_keys=True), tol=tol,
              entry_ms=f"{t_entry:.4f}", kernel_only_ms=f"{t_kernel:.4f}",
              plain_ms=f"{t_plain:.4f}")
        _require(res["ok"], f"{name} disagrees with its plain version at "
                            f"{B}x{N}: {res}")
        if B * N == 65536:
            main[name] = {"max_abs_err": res["max_abs"], "ms": t_entry,
                          "plain_ms": t_plain, **_bound(*work[name](B, N))}
        return got

    with torch.no_grad():
        for B, N in ((512, 128), (3, 128)):
            M = B * N
            rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
            randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
            x = (rand(M, 3) * 2 - 1) * 0.9

            def k4_err(got, ref):
                (out, sdf, grad), (ro, rg) = got, ref
                e = fused_sdf.tolerance_check(ro, out)
                g = _rows(rg, grad)
                return {"out": e, "grad": g, "sdf_is_out0": bool(torch.equal(sdf, out[:, 0])),
                        "max_abs": max(float((out - ro).abs().max()), g["max_abs"]),
                        "ok": e["ok"] and g["ok"] and bool(torch.equal(sdf, out[:, 0]))}

            _same_twice("train-kernels", "sdf_fwd_grad", M,
                        lambda: fused_sdf.launch_fwd_grad(pk, x))
            out, _, grad = report(
                "sdf_fwd_grad", B, N, k4_err,
                f"out:K1_rule;grad:{ROW_TOL};sdf==out[:,0]",
                lambda: fused_sdf.sdf_fwd_grad(ws, bs, x, cfg_s),
                lambda: fused_sdf.launch_fwd_grad(pk, x),
                lambda: fused_sdf.sdf_fwd_grad_plain(ws, bs, x, cfg_s),
                lambda: fused_sdf.LAUNCHES_K4)

            ct_out, ct_sdf, ct_grad = randn(M, ws[-1].shape[1]), randn(M), randn(M, 3)
            _bwd_plan_line("train-kernels", "sdf_bwd", pk, M, dev)
            _same_twice("train-kernels", "sdf_bwd", M,
                        lambda: fused_sdf.launch_bwd(pk, x, ct_out, ct_sdf, ct_grad))
            names5 = ("x", "w", "b")
            report("sdf_bwd", B, N,
                   lambda got, ref: _leaf_check(_leaves(names5, ref), _leaves(names5, got)),
                   LEAF_TOL,
                   lambda: fused_sdf.sdf_bwd(ws, bs, x, ct_out, ct_sdf, ct_grad, cfg_s),
                   lambda: fused_sdf.launch_bwd(pk, x, ct_out, ct_sdf, ct_grad),
                   lambda: fused_sdf.sdf_bwd_plain(ws, bs, x, ct_out, ct_sdf, ct_grad,
                                                   cfg_s),
                   lambda: fused_sdf.LAUNCHES_K5)

            d = randn(M, 3)
            dirs = d / d.norm(dim=-1, keepdim=True)
            weights = rand(B, N) / N
            geo = (out, x, dirs, grad, weights)
            _same_twice("train-kernels", "color_ray_fwd", M,
                        lambda: (fused_color.launch_fwd(cpk, *geo),))
            report("color_ray_fwd", B, N, lambda got, ref: _rows(ref, got), ROW_TOL,
                   lambda: fused_color.color_ray_fwd(cws, cbs, *geo, cfg_c),
                   lambda: fused_color.launch_fwd(cpk, *geo),
                   lambda: fused_color.color_ray_fwd_plain(cws, cbs, *geo, cfg_c),
                   lambda: fused_color.LAUNCHES_K8)

            ct = randn(B, 3)
            _same_twice("train-kernels", "color_ray_bwd", M,
                        lambda: fused_color.launch_bwd(cpk, *geo, ct))
            names9 = ("sdf_out", "pts", "dirs", "normals", "weights", "w", "b")
            report("color_ray_bwd", B, N,
                   lambda got, ref: _leaf_check(_leaves(names9, ref), _leaves(names9, got)),
                   LEAF_TOL,
                   lambda: fused_color.color_ray_bwd(cws, cbs, *geo, ct, cfg_c),
                   lambda: fused_color.launch_bwd(cpk, *geo, ct),
                   lambda: fused_color.color_ray_bwd_plain(cws, cbs, *geo, ct, cfg_c),
                   lambda: fused_color.LAUNCHES_K9)
    return main


def phase_flat_kernels(dev):
    """K2 and K3 through their entry ``sdf_apply_grad_fused`` (weight
    materialisation, the encoding and its derivatives, packing, launch,
    unpacking), forward and backward, against the same entry on CPU copies
    of the same weights, points and cotangents, where it takes the plain
    versions: the rows of out and grad by the row rule, every gradient
    leaf (the weight-norm leaves and x) by the leaf rule.  At the phase-1
    step's M = 1,024 rays x 32 samples and a ragged 1,000.  Times the
    wrappers (K2: ``sdf_fwd_grad_flat``, K3: ``sdf_bwd_flat``, packing
    included), the kernels alone on pre-packed weights, and the plain
    versions on the card."""
    import numpy as np
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_sdf
    cfg = model_cfg(VIRTUAL_CONF, "sdf_network")
    params_np = convert.to_numpy(nets.init_sdf(np.random.default_rng(SEED), cfg))
    names = [n for n, _ in convert.flatten(params_np)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    main = {}
    for M in (32768, 1000):
        x = (torch.rand((M, 3), generator=gen, device=dev) * 2 - 1) * 0.9
        ct_out = torch.randn((M, cfg["d_out"]), generator=gen, device=dev)
        ct_grad = torch.randn((M, 3), generator=gen, device=dev)
        res = {}
        for where, d in (("kernels", dev), ("plain", torch.device("cpu"))):
            leaves = [torch.as_tensor(v, device=d).requires_grad_(True)
                      for _, v in convert.flatten(params_np)]
            xr = x.to(d).requires_grad_(True)
            before = (fused_sdf.LAUNCHES_K2, fused_sdf.LAUNCHES_K3)
            out, grad = fused_sdf.sdf_apply_grad_fused(
                convert.unflatten(zip(names, leaves)), cfg, xr)
            gs = torch.autograd.grad((out, grad), [xr] + leaves,
                                     (ct_out.to(d), ct_grad.to(d)))
            if d.type == "cuda":
                torch.cuda.synchronize()
            launched = (fused_sdf.LAUNCHES_K2 - before[0], fused_sdf.LAUNCHES_K3 - before[1])
            _require(launched == ((1, 1) if d.type == "cuda" else (0, 0)),
                     f"sdf_apply_grad_fused on {d} launched (K2, K3) {launched}")
            res[where] = (out.detach().cpu(), grad.detach().cpu(),
                          dict(zip(["x"] + names, (g.cpu() for g in gs))))
        rows = fused_sdf.tolerance_check(res["plain"][0], res["kernels"][0])
        grad_rows = _rows(res["plain"][1], res["kernels"][1])
        leaves_res = _leaf_check(res["plain"][2], res["kernels"][2])

        ws, bs = fused_sdf.materialize(convert.to_torch(params_np, dev), cfg)
        pk = fused_sdf.RaysPack(ws, bs, cfg)
        xe, jac, _, dims = fused_sdf.pe_parts(x * cfg["scale"], cfg["multires"])
        ybar = torch.cat([ct_out[:, :1] / cfg["scale"], ct_out[:, 1:]], -1)
        gbar = ct_grad[:, dims] * jac
        _same_twice("flat-kernels", "sdf_fwd_grad_flat", M,
                    lambda: fused_sdf.launch_fwd_grad_flat(pk, xe))
        _bwd_plan_line("flat-kernels", "sdf_bwd_flat", pk, M, dev)
        _same_twice("flat-kernels", "sdf_bwd_flat", M,
                    lambda: fused_sdf.launch_bwd_flat(pk, xe, ybar, gbar))
        times = {
            "K2": [_median_ms(f) for f in (
                lambda: fused_sdf.sdf_fwd_grad_flat(ws, bs, xe, cfg),
                lambda: fused_sdf.launch_fwd_grad_flat(pk, xe),
                lambda: fused_sdf.sdf_fwd_grad_flat_plain(ws, bs, xe, cfg))],
            "K3": [_median_ms(f) for f in (
                lambda: fused_sdf.sdf_bwd_flat(ws, bs, xe, ybar, gbar, cfg),
                lambda: fused_sdf.launch_bwd_flat(pk, xe, ybar, gbar),
                lambda: fused_sdf.sdf_bwd_flat_plain(ws, bs, xe, ybar, gbar, cfg))]}
        for key, name, err in (("K2", "sdf_fwd_grad_flat", {"out": rows, "grad": grad_rows}),
                               ("K3", "sdf_bwd_flat", leaves_res)):
            t_entry, t_kernel, t_plain = times[key]
            ok = (rows["ok"] and grad_rows["ok"]) if key == "K2" else leaves_res["ok"]
            _line("flat-kernels", name=name, M=M, ok=ok,
                  errors=json.dumps(err, sort_keys=True).replace(" ", ""),
                  tol=(f"out:K1_rule;grad:{ROW_TOL}" if key == "K2" else
                       f"x_and_every_leaf:{LEAF_TOL}"),
                  entry_ms=f"{t_entry:.4f}", kernel_only_ms=f"{t_kernel:.4f}",
                  plain_ms=f"{t_plain:.4f}")
            _require(ok, f"{name} through sdf_apply_grad_fused disagrees with "
                         f"the plain versions at M={M}: {err}")
            if M == 32768:
                max_abs = (max(float((res["kernels"][0] - res["plain"][0]).abs().max()),
                               grad_rows["max_abs"]) if key == "K2"
                           else leaves_res["max_abs"])
                main[name] = {"max_abs_err": max_abs, "ms": t_entry, "plain_ms": t_plain,
                              **_bound(*_sdf_work(cfg, M, key))}
    return main


def phase_color_kernels(dev):
    """K6 and K7 through their entry ``color_fused`` (packing, launch,
    unpacking), forward and backward, against the same entry on CPU copies
    of the same weights, input rows and cotangent, where it takes the
    plain versions: the rgb rows by the row rule, every gradient leaf (xc
    and every dense weight and bias) by the leaf rule.  The entry gets the
    weights dense (``w``, materialised once from the weight norm on the
    card): materialised on each device, a few weights would round to other
    bf16 values on the two sides.  xc is built as the render builds it,
    [pts, PE(dirs), normals, feature], from K4's outputs at the fast conf's
    full width, and the cotangent as the composite hands it to K7, ct[b]
    w[b, j] over rays of 128 samples; at the slice-4 step's M = 512 x 128
    and a ragged 1,000.  Times the wrappers (``color_fwd`` /
    ``color_bwd``, packing included), the kernels alone on pre-packed
    weights, and the plain versions on the card."""
    import numpy as np
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.core.embedder import positional_encode
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_color, fused_sdf
    cfg_s = model_cfg(FAST_CONF, "sdf_network")
    cfg_c = model_cfg(FAST_CONF, "rendering_network")
    rng = np.random.default_rng(SEED + 4)
    ws_s, bs_s = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        nets.init_sdf(rng, cfg_s)), dev), cfg_s)
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        nets.init_color(rng, cfg_c)), dev), cfg_c)
    dense = convert.flatten({"layers": {f"lin{l}": {"w": w.T.contiguous(), "b": b}
                                        for l, (w, b) in enumerate(zip(ws, bs))}})
    names = [n for n, _ in dense]
    pk_s = fused_sdf.RaysPack(ws_s, bs_s, cfg_s)
    pk = fused_color.RayPack(ws, bs, cfg_c)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    main = {}
    for M in (65536, 1000):
        with torch.no_grad():
            x = (torch.rand((M, 3), generator=gen, device=dev) * 2 - 1) * 0.9
            out, _, grad = fused_sdf.launch_fwd_grad(pk_s, x)
            d = torch.randn((M, 3), generator=gen, device=dev)
            dirs = d / d.norm(dim=-1, keepdim=True)
            xc = torch.cat([x, positional_encode(dirs, cfg_c["multires_view"]), grad,
                            out[:, 1:]], -1).contiguous()
            n_rays = -(-M // 128)
            ct = (torch.randn((n_rays, 1, 3), generator=gen, device=dev)
                  * torch.rand((n_rays, 128, 1), generator=gen, device=dev) / 128
                  ).reshape(-1, 3)[:M].contiguous()
        res = {}
        for where, dv in (("kernels", dev), ("plain", torch.device("cpu"))):
            leaves = [t.detach().to(dv).clone().requires_grad_(True) for _, t in dense]
            xr = xc.to(dv).requires_grad_(True)
            before = (fused_color.LAUNCHES_K6, fused_color.LAUNCHES_K7)
            rgb = fused_color.color_fused(convert.unflatten(zip(names, leaves)), cfg_c, xr)
            gs = torch.autograd.grad(rgb, [xr] + leaves, ct.to(dv))
            if dv.type == "cuda":
                torch.cuda.synchronize()
            launched = (fused_color.LAUNCHES_K6 - before[0],
                        fused_color.LAUNCHES_K7 - before[1])
            _require(launched == ((1, 1) if dv.type == "cuda" else (0, 0)),
                     f"color_fused on {dv} launched (K6, K7) {launched}")
            res[where] = (rgb.detach().cpu(), dict(zip(["xc"] + names,
                                                       (g.cpu() for g in gs))))
        rows = _rows(res["plain"][0], res["kernels"][0])
        leaves_res = _leaf_check(res["plain"][1], res["kernels"][1])
        _same_twice("color-kernels", "color_fwd", M,
                    lambda: (fused_color.launch_fwd_sample(pk, xc),))
        _same_twice("color-kernels", "color_bwd", M,
                    lambda: fused_color.launch_bwd_sample(pk, xc, ct))
        with torch.no_grad():
            times = {
                "K6": [_median_ms(f) for f in (
                    lambda: fused_color.color_fwd(ws, bs, xc, cfg_c),
                    lambda: fused_color.launch_fwd_sample(pk, xc),
                    lambda: fused_color.color_fwd_plain(ws, bs, xc))],
                "K7": [_median_ms(f) for f in (
                    lambda: fused_color.color_bwd(ws, bs, xc, ct, cfg_c),
                    lambda: fused_color.launch_bwd_sample(pk, xc, ct),
                    lambda: fused_color.color_bwd_plain(ws, bs, xc, ct))]}
        for key, name, err, ok, tol, max_abs in (
                ("K6", "color_fwd", rows, rows["ok"], ROW_TOL, rows["max_abs"]),
                ("K7", "color_bwd", leaves_res, leaves_res["ok"],
                 f"xc_and_every_leaf:{LEAF_TOL}", leaves_res["max_abs"])):
            t_entry, t_kernel, t_plain = times[key]
            _line("color-kernels", name=name, M=M, ok=ok,
                  errors=json.dumps(err, sort_keys=True).replace(" ", ""), tol=tol,
                  entry_ms=f"{t_entry:.4f}", kernel_only_ms=f"{t_kernel:.4f}",
                  plain_ms=f"{t_plain:.4f}")
            _require(ok, f"{name} through color_fused disagrees with the plain "
                         f"versions at M={M}: {err}")
            if M == 65536:
                main[name] = {"max_abs_err": max_abs, "ms": t_entry, "plain_ms": t_plain,
                              **_bound(*_color_sample_work(cfg_c, M, key == "K7"))}
    return main

# The weight-gradient stage against its plain version: f32 sums of the same
# bf16 products in another order over up to 131,072 rows.  Each element's
# |error| over S = sum_r |a_r b_r| (the sum of the magnitudes): a correct
# sum in any order stays within (adds a split, ~1,200 at K5) x 2^-23 of S,
# 1.4e-4 even with every rounding one way; on positive operands, where S
# is |dW| itself, a missing or repeated 64-row stage moves dW by >= 4.9e-4
# of S (64 of at most 131,072 rows).  The bias sums add in the same order
# on both sides: bitwise.
WGRAD_TOL = 2e-4
WGRAD_TOL_DESC = (f"max|err|/sum_r|a_r*b_r|<={WGRAD_TOL}_on_the_pass's_operands_"
                  f"and_on_positive_operands;db_bitwise")
# K5's and K9's shape (the fast phase-2 conf, 512 rays x 128 samples), K3's
# (the fast phase-1 conf, 1,024 rays x 32) and K7's (the fast conf's
# samples with the background); the stage's times at these shapes
WGRAD_SHAPES = (("K5", 65536), ("K3", 32768), ("K9", 65536), ("K7", 65536))


def _wgrad_work(stage):
    """(FLOPs, bytes) of the stage: 2 rows ni nj a job; bytes: each bf16
    operand read once, the f32 partials of the bias and column-0 sums read
    once, dw and db written once."""
    flops = sum(2 * j.a.shape[0] * j.ni * j.nj for j in stage.jobs)
    nbytes = sum(2 * j.a.shape[0] * (j.ni + j.nj) for j in stage.jobs)
    nbytes += 4 * (stage.total + stage.dbpart.numel() + stage.dbpart.shape[1])
    if stage.cbpart is not None:
        nbytes += 4 * stage.cbpart.numel()
    return flops, nbytes


def _wgrad_scale(stage):
    """S = |A|^T |B| per element of dw (plus the column-0 partials')."""
    import torch
    from fmov_pose_torch.ops import wgrad
    absd = wgrad.Stage([wgrad.Job(j.a.abs(), j.b.abs(), j.ni, j.nj) for j in stage.jobs],
                       stage.KS, stage.dwpart, stage.dbpart.abs(),
                       None if stage.cbpart is None else stage.cbpart.abs(),
                       stage.cb_off, stage.cb_ld)
    return torch.clamp(wgrad.weight_grads_plain(absd)[0], min=1e-30)


def _wgrad_check(name, stage, what):
    """The stage twice (bitwise) against its plain version: the errors."""
    import torch
    from fmov_pose_torch.ops import wgrad
    dw, db = wgrad.launch(stage)
    dw2, db2 = wgrad.launch(stage)
    torch.cuda.synchronize()
    same = torch.equal(dw, dw2) and torch.equal(db, db2)
    rdw, rdb = wgrad.weight_grads_plain(stage)
    err = (dw.double() - rdw.double()).abs()
    rel = float((err / _wgrad_scale(stage).double()).max())
    res = {"max_abs": float(err.max()), "max_over_S": rel,
           "max_rel_to_max_ref": float(err.max()) / max(float(rdw.abs().max()), 1e-30),
           "db_bitwise": bool(torch.equal(db, rdb)), "bitwise_run_to_run": same,
           "finite": bool(dw.isfinite().all())}
    res["ok"] = (rel <= WGRAD_TOL and res["db_bitwise"] and same and res["finite"])
    _line("wgrad", name=name, operands=what, errors=json.dumps(res, sort_keys=True),
          tol=WGRAD_TOL_DESC, ok=res["ok"])
    _require(res["ok"], f"the weight-gradient stage at {name}'s shape ({what}) "
                        f"disagrees with its plain version: {res}")
    return res


def _loop_ms(fn, n=10, reps=5):
    """CUDA-event median over reps of n back-to-back calls, per call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def phase_wgrad(dev):
    """The weight-gradient stage of K5, K3, K9 and K7 at their main-path
    shapes: the backward's per-point pass once fills the workspace
    (random cotangents on seeded weights), then the stage alone, twice
    bitwise, against its plain version (and once more on positive
    operands written over the same workspace); CUDA-event times of the
    stage, its plain version and the library yardstick (one
    ``torch.mm(A.t(), B, out_dtype=float32)`` a layer on the same bf16
    operands, summed; ``torch.mm`` in bf16 if out_dtype is refused), and
    its bound.  Launch counts are restored: these launches compare, they
    are no path's."""
    import numpy as np
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_color, fused_sdf, wgrad
    launches = wgrad.LAUNCHES
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731

    def sdf_pack(conf):
        cfg = model_cfg(conf, "sdf_network")
        ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
            nets.init_sdf(rng, cfg)), dev), cfg)
        return cfg, fused_sdf.RaysPack(ws, bs, cfg)

    def color_pack():
        cfg = model_cfg(FAST_CONF, "rendering_network")
        cws, cbs = fused_color.materialize(convert.to_torch(convert.to_numpy(
            nets.init_color(rng, cfg)), dev), cfg)
        return cfg, fused_color.RayPack(cws, cbs, cfg)

    def fill(key, M):
        x = (rand(M, 3) * 2 - 1) * 0.9
        if key == "K5":
            _, pk = sdf_pack(FAST_CONF)
            return fused_sdf.bwd_pass(pk, x, randn(M, pk.n_out), randn(M),
                                      randn(M, 3))[-1]
        if key == "K3":
            cfg, pk = sdf_pack(VIRTUAL_CONF)
            xe = fused_sdf.pe_parts(x * pk.scale, pk.multires)[0].contiguous()
            return fused_sdf.bwd_flat_pass(pk, xe, randn(M, pk.n_out),
                                           randn(M, xe.shape[1]))[-1]
        _, cpk = color_pack()
        if key == "K7":
            return fused_color.bwd_sample_pass(cpk, randn(M, cpk.d_in),
                                               randn(M, 3))[-1]
        B, N = M // 128, 128
        d = randn(M, 3)
        return fused_color.bwd_pass(cpk, randn(M, 257), x, d / d.norm(dim=-1, keepdim=True),
                                    randn(M, 3), rand(B, N) / N, randn(B, 3))[-1]

    def library(stage):
        try:
            for j in stage.jobs[:1]:
                torch.mm(j.a[:, :j.ni].t(), j.b[:, :j.nj], out_dtype=torch.float32)
            kw, how = {"out_dtype": torch.float32}, "torch.mm_bf16_in_f32_out"
        except (TypeError, RuntimeError):
            kw, how = {}, "torch.mm_bf16_in_bf16_out"
        return (lambda: [torch.mm(j.a[:, :j.ni].t(), j.b[:, :j.nj], **kw)
                         for j in stage.jobs]), how

    res = {}
    with torch.no_grad():
        for key, M in WGRAD_SHAPES:
            stage = fill(key, M)
            torch.cuda.synchronize()
            err = _wgrad_check(key, stage, "pass")
            lib_fn, how = library(stage)
            t_kernel = _loop_ms(lambda: wgrad.launch(stage))
            t_plain = _loop_ms(lambda: wgrad.weight_grads_plain(stage), n=2)
            t_lib = _loop_ms(lib_fn)
            flops, nbytes = _wgrad_work(stage)
            bound = _bound(flops, nbytes)
            bound["library_ms"] = t_lib
            plan = wgrad.plan(wgrad.job_dims(stage.jobs), stage.KS)
            _line("wgrad", name=key, M=M, KS=stage.KS, blocks=len(plan["blocks"]),
                  stages=plan["stages"], kernel_ms=f"{t_kernel:.4f}",
                  plain_ms=f"{t_plain:.4f}", library_ms=f"{t_lib:.4f}", library=how,
                  bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"],
                  share_of_bound=f"{bound['bound_ms'] / t_kernel:.3f}",
                  operand_GB=f"{nbytes / 1e9:.4f}", GFLOP=f"{flops / 1e9:.2f}",
                  max_abs_err=f"{err['max_abs']:.3e}", tol=WGRAD_TOL_DESC)
            for j in stage.jobs:  # positive operands in place: S = |dW|
                j.a.copy_(rand(*j.a.shape))
                j.b.copy_(rand(*j.b.shape))
            _wgrad_check(key, stage, "positive")
            res[key] = {"M": M, "max_abs_err": err["max_abs"], "ms": t_kernel,
                        "plain_ms": t_plain, "library": how, **bound}
            del stage
    wgrad.LAUNCHES = launches
    return res


def _history_lines(phase, runner, smi, fallback=None, **extra):
    """The run's loss lines; requires finite losses and a color loss whose
    last 10 steps average below its first 10.  ``fallback``: the color
    losses of a subset of the steps held to the same rule where the whole
    run's are not (slice 3: frame 0's photo steps, since every admission
    adds a new, unfitted frame)."""
    import numpy as np
    h = runner.history
    losses = np.asarray(h["loss"])
    color = np.asarray(h["color_loss"])
    step_ms = statistics.median(runner.step_ms)
    _line(phase, steps=len(losses), loss_first=f"{losses[0]:.5f}",
          loss_last=f"{losses[-1]:.5f}",
          color_first10=f"{color[:10].mean():.5f}", color_last10=f"{color[-10:].mean():.5f}",
          psnr_last=f"{h['psnr'][-1]:.2f}", **extra)
    _require(len(losses) == STEPS and np.all(np.isfinite(losses)),
             f"non-finite or missing losses: {losses}")
    falls = color[-10:].mean() < color[:10].mean()
    if not falls and fallback is not None:
        _line(phase, color_gate="fallback", first10=f"{fallback[:10].mean():.5f}",
              last10=f"{fallback[-10:].mean():.5f}", steps=len(fallback))
        color = fallback
        falls = len(fallback) >= 20 and fallback[-10:].mean() < fallback[:10].mean()
    _require(falls, f"color loss did not fall: {color[:10]} -> {color[-10:]}")
    return step_ms


def _perf_line(phase, runner, step_ms, peak, smi, rays_per_step=None):
    rays = rays_per_step or runner.batch_size
    _line(phase, median_step_ms=f"{step_ms:.2f}", rays_per_step=rays,
          rays_per_s=f"{rays / (step_ms / 1e3):.0f}",
          wall_s=f"{runner.train_seconds:.2f}", peak_mem_gib=f"{peak / 2**30:.3f}",
          card=repr(smi))


def _ray_batch(runner, scene, dev, n_rays=None):
    import torch
    from fmov_pose_torch.data import rays as raygen
    g = torch.Generator(device=dev).manual_seed(SEED)
    return raygen.gen_random_rays(
        g, runner.images_dev, runner.masks_dev, runner.intr_inv_dev,
        torch.as_tensor(scene.crop_poses[0][:3], device=dev), 0,
        n_rays or runner.batch_size, runner.bbox_dev, runner.mask_guided_patch_size,
        True, scene.H, scene.W)


def phase_slice(dev, smi, scene, tmp):
    import torch
    from fmov_pose_torch.ops import fused_sdf
    from fmov_pose_torch.train import step as step_mod
    from fmov_pose_torch.train.runner import Runner

    runner = Runner(CONF, mode="train", case="orbit_smoke",
                    exp_dir=os.path.join(tmp, "exp1"), seed=SEED,
                    device=dev, scene=scene)
    # the only overrides: a short run, no LR warm-up (lr ~ 0 there), and
    # the per-step loop (the scan phase runs the conf's default, the scan)
    runner.end_iter, runner.warm_up_end = STEPS, 0.0
    runner.conf.put("train.scan_steps", False)
    r = runner.model_cfg["renderer"]
    _require(runner.model_cfg["sdf"]["use_fused"], "the conf path runs K1")
    _line("slice", conf=os.path.relpath(CONF, ROOT),
          overrides=f"end_iter={STEPS},warm_up_end=0,scan_steps=False",
          pose_mode=runner.pose_mode,
          batch=runner.batch_size, samples=f"{r.n_samples}+{r.n_importance}",
          up_sample_steps=r.up_sample_steps, perturb=r.perturb,
          n_params=runner.state.layout.size)

    # one ray batch rendered with the kernel and with the f32 network
    # in the up-sampler: the losses agree to K1's bf16 sample placement
    with torch.no_grad():
        st = runner.state
        data = _ray_batch(runner, scene, dev)
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
    _zero_counters()
    runner.train()
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev)

    step_ms = _history_lines("slice", runner, smi,
                             launches=json.dumps(counts).replace(" ", ""))
    _perf_line("slice", runner, step_ms, peak, smi)
    _require(counts["K1"] == 4 * STEPS,
             f"K1 launched {counts['K1']} times in {STEPS} steps")
    _require(all(v == 0 for k, v in counts.items() if k != "K1"),
             f"kernels other than K1 launched on the slice-1 path: {counts}")
    return counts["K1"], runner


def _counters():
    """K1-K9's launch counts since the last ``_zero_counters``; requires
    the weight-gradient stage's count (``wgrad.LAUNCHES``) to equal K3 +
    K5 + K7 + K9's, so that every run's stage launches are its backward
    kernels' (the kernels line reports them so)."""
    from fmov_pose_torch.ops import fused_color, fused_sdf, wgrad
    counts = {"K1": fused_sdf.LAUNCHES, "K2": fused_sdf.LAUNCHES_K2,
              "K3": fused_sdf.LAUNCHES_K3, "K4": fused_sdf.LAUNCHES_K4,
              "K5": fused_sdf.LAUNCHES_K5, "K6": fused_color.LAUNCHES_K6,
              "K7": fused_color.LAUNCHES_K7, "K8": fused_color.LAUNCHES_K8,
              "K9": fused_color.LAUNCHES_K9}
    backward = sum(counts[k] for k in STAGE_OF)
    _require(wgrad.LAUNCHES == backward,
             f"the weight-gradient stage launched {wgrad.LAUNCHES} times against "
             f"{backward} launches of K3/K5/K7/K9")
    return counts


# the kernels whose backward launches the weight-gradient stage once each
STAGE_OF = ("K3", "K5", "K7", "K9")


def _zero_counters():
    from fmov_pose_torch.ops import fused_color, fused_sdf, wgrad
    wgrad.LAUNCHES = 0
    fused_sdf.LAUNCH_SIZES.clear()
    fused_sdf.LAUNCHES = fused_sdf.LAUNCHES_K2 = fused_sdf.LAUNCHES_K3 = 0
    fused_sdf.LAUNCHES_K4 = fused_sdf.LAUNCHES_K5 = 0
    fused_color.LAUNCHES_K6 = fused_color.LAUNCHES_K7 = 0
    fused_color.LAUNCHES_K8 = fused_color.LAUNCHES_K9 = 0


def _require_launches(counts, once, phase):
    """Each kernel of ``once`` launched once a step, every other never."""
    for k, v in counts.items():
        want = STEPS if k in once else 0
        _require(v == want, f"{k} launched {v} times in {STEPS} steps on the "
                            f"{phase} path (expected {want})")


def _check_batch(runner, scene, dev, when, phase="slice2", n_rays=None):
    """One ray batch of the fast conf's step, on the same weights, grid
    and z-values (perturbation 0, so that both devices place the samples
    alike), three ways: through the kernels; through their plain versions
    (the same step on CPU copies, where each wrapper takes its plain
    version); through the f32 networks (``use_fused_train`` off).  Gated:
    the loss against f32 within 1e-2, and every gradient leaf of the
    kernels against the plain versions by the leaf rule.  Reported: the
    leaves against f32, where the bf16 contract itself moves the
    gradient (PERF.md, section 6)."""
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.ops import fused_sdf
    from fmov_pose_torch.train import step as step_mod
    st = runner.state
    data = _ray_batch(runner, scene, dev, n_rays)
    cfg_k = runner.step_cfg
    cfg_k = dataclasses.replace(cfg_k, model_cfg=dict(
        cfg_k.model_cfg, renderer=cfg_k.model_cfg["renderer"]._replace(perturb=0.0)))
    cfg_f = dataclasses.replace(cfg_k, model_cfg=dict(
        cfg_k.model_cfg, sdf=dict(cfg_k.model_cfg["sdf"], use_fused_train=False)))
    cpu = torch.device("cpu")
    res = {}
    for name, cfg, d in (("kernels", cfg_k, dev), ("f32", cfg_f, dev),
                         ("plain", cfg_k, cpu)):
        flat = st.flat.detach().to(d).requires_grad_(True)
        loss, _ = step_mod._render_and_losses(
            cfg, None, st.layout.views(flat),
            {k: v.to(d) for k, v in st.pose_static.items()}, data.to(d),
            step_mod.StepScalars(lr=0.0, cos_anneal=1.0))
        g = torch.autograd.grad(loss, flat)[0].cpu()
        res[name] = (float(loss.detach()), dict(convert.flatten(st.layout.views(g))))
    rel = abs(res["kernels"][0] - res["f32"][0]) / abs(res["f32"][0])
    vs_plain = fused_sdf.leaf_rule(res["plain"][1], res["kernels"][1])
    vs_f32 = fused_sdf.leaf_rule(res["f32"][1], res["kernels"][1])
    plain_vs_f32 = fused_sdf.leaf_rule(res["f32"][1], res["plain"][1])
    brief = lambda r: json.dumps({k: r[k] for k in (  # noqa: E731
        "ok", "worst", "worst_rel", "worst_abs_over_gnorm", "failed")}).replace(" ", "")
    _line(phase, check=f"batch_{when}", rays=data.shape[0],
          loss_kernels=f"{res['kernels'][0]:.6f}",
          loss_plain=f"{res['plain'][0]:.6f}", loss_f32=f"{res['f32'][0]:.6f}",
          rel_vs_f32=f"{rel:.2e}", loss_tol="1e-2", leaf_tol=LEAF_TOL,
          leaves_vs_plain=brief(vs_plain), leaves_vs_f32=brief(vs_f32),
          plain_vs_f32=brief(plain_vs_f32))
    _require(rel < 1e-2, f"the kernels change the loss by {rel:.2e} ({when})")
    _require(vs_plain["ok"], f"gradient leaves disagree with the plain "
                             f"versions ({when}): {vs_plain}")


def phase_slice2(dev, smi, scene, tmp):
    import torch
    from fmov_pose_torch.train.runner import Runner

    runner = Runner(FAST_CONF, mode="train", case="orbit_smoke",
                    exp_dir=os.path.join(tmp, "exp2"), seed=SEED,
                    device=dev, scene=scene)
    # a short run, no LR warm-up, and a grid refresh twice in the run
    runner.end_iter, runner.warm_up_end = STEPS, 0.0
    runner.occ_update_freq = OCC_UPDATE_FREQ
    r = runner.model_cfg["renderer"]
    _require(runner.model_cfg["sdf"]["use_fused_train"] and runner.occupancy_sampling,
             "the fast conf runs the fused training kernels and the grid")
    _line("slice2", conf=os.path.relpath(FAST_CONF, ROOT),
          overrides=f"end_iter={STEPS},warm_up_end=0,occ_update_freq={OCC_UPDATE_FREQ}",
          pose_mode=runner.pose_mode, batch=runner.batch_size,
          samples=f"{r.n_samples}+{r.n_importance}", perturb=r.perturb,
          occ_grid_res=runner.occ_grid_res, n_params=runner.state.layout.size)
    grid0 = runner.state.pose_static["occ_grid"]
    _require(bool((grid0 == 1).all()), "the grid starts all ones")

    # one batch through the kernels, their plain versions and the f32
    # networks, at the initial weights (where slice 1 checks K1)
    _check_batch(runner, scene, dev, "initial")

    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    runner.train()
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev)
    grid = runner.state.pose_static["occ_grid"]
    occ_mean = float(grid.mean())

    step_ms = _history_lines(
        "slice2", runner, smi, launches=json.dumps(counts).replace(" ", ""),
        occ_refreshes=runner.occ_refreshes, occ_update_freq=runner.occ_update_freq,
        occ_grid_res=runner.occ_grid_res, occ_mean=f"{occ_mean:.4f}")
    _perf_line("slice2", runner, step_ms, peak, smi)
    _require_launches(counts, ("K4", "K5", "K8", "K9"), "slice-2")
    _require(runner.occ_refreshes == STEPS // OCC_UPDATE_FREQ,
             f"{runner.occ_refreshes} grid refreshes")
    _require(0.0 < occ_mean < 1.0, f"grid mean {occ_mean} after the refreshes")
    # the same after 50 steps, on the refreshed grid
    _check_batch(runner, scene, dev, "after_training")

    return counts


def phase_slice3(dev, smi, scene, tmp):
    """The progressive phase 1 of the fast virtual conf, as written but for
    the depth of its schedule (``SLICE3_SCHEDULE`` and 50 steps)."""
    import numpy as np
    import torch
    from fmov_pose_torch.train.runner import Runner

    runner = Runner(VIRTUAL_CONF, mode="train", case="orbit_smoke",
                    exp_dir=os.path.join(tmp, "exp3"), seed=SEED,
                    device=dev, scene=scene)
    runner.end_iter, runner.warm_up_end = STEPS, 0.0
    for key, value in SLICE3_SCHEDULE.items():
        setattr(runner, key, value)
        runner.conf.put(f"train.{key}", value)  # what reset_neus re-reads
    r = runner.model_cfg["renderer"]
    _require(runner.model_cfg["sdf"]["use_fused_train"] and runner.pose_mode == "seg"
             and runner.progressive and runner.maintain_shape and runner.flow_weight > 0
             and r.n_importance == 0,
             "the phase-1 fast conf runs the fused kernels, seg poses, flow and "
             "maintain_shape")
    rays = 2 * runner.batch_size  # the frame's batch and the maintain_shape batch
    overrides = ",".join([f"end_iter={STEPS}", "warm_up_end=0"]
                         + [f"{k}={v}" for k, v in SLICE3_SCHEDULE.items()])
    _line("slice3", conf=os.path.relpath(VIRTUAL_CONF, ROOT), overrides=overrides,
          pose_mode=runner.pose_mode, n_segments=runner.n_segments,
          batch=f"{runner.batch_size}+{runner.batch_size}",
          samples=f"{r.n_samples}+{r.n_importance}", perturb=r.perturb,
          M=rays * r.n_samples, n_params=runner.state.layout.size,
          n_bank=runner.state.bank_layout.size, frames=scene.n_images,
          flow_pairs=len(scene.loftr_flows))

    _check_batch(runner, scene, dev, "initial", phase="slice3", n_rays=rays)

    plans = []
    plan_step = runner._plan_step

    def recorded():
        out = plan_step()
        plans.append((out[3], out[1]))  # (img_id, use_flow)
        return out

    runner._plan_step = recorded
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    runner.train()
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev)
    runner._plan_step = plan_step

    color = np.asarray(runner.history["color_loss"])
    frame0 = np.asarray([c for c, (img, flow) in zip(color, plans)
                         if img == 0 and not flow])
    initialized = runner.state.bank_static["initialized"]
    step_ms = _history_lines(
        "slice3", runner, smi, fallback=frame0,
        launches=json.dumps(counts).replace(" ", ""),
        flow_steps=runner.flow_steps, current_image=runner.current_image,
        segment=runner.current_pose_mlp_index,
        initialized="".join("1" if v else "0" for v in initialized),
        resets=runner.reset_count,
        frame0_photo_steps=len(frame0),
        frame0_color_first10=f"{frame0[:10].mean():.5f}",
        frame0_color_last10=f"{frame0[-10:].mean():.5f}")
    _perf_line("slice3", runner, step_ms, peak, smi, rays_per_step=rays)
    _require_launches(counts, ("K2", "K3"), "slice-3")
    _require(runner.flow_steps >= 1, "no flow step in the slice-3 run")
    _require(runner.current_image >= 4, f"{runner.current_image} frames admitted")
    _require(runner.current_pose_mlp_index >= 3
             and bool(initialized[:runner.current_pose_mlp_index + 1].all()),
             f"lazy segment inits: {initialized} at segment "
             f"{runner.current_pose_mlp_index}")
    _check_batch(runner, scene, dev, "after_training", phase="slice3", n_rays=rays)
    return counts, runner


# the planned dispatch (train.plan_chunk) on a copy of the fast virtual conf
# cut in depth only: chunks of PLAN_K steps, the curriculum and every
# frequency on a chunk edge, all 8 frames admitted at step PLANNED_STEPS
PLAN_K = 20
PLANNED_STEPS = 320
PLANNED_EDITS = {"end_iter": PLANNED_STEPS, "warm_up_end": 0, "mesh_warmup_step": 40,
                 "max_pro_iteration": 40, "pro_warm_up_end": 20, "report_freq": 100,
                 "val_mesh_freq": 100, "save_freq": 100, "pose_freq": 1000,
                 "val_freq": 1000}
# a Runner trained PLANNED_START planned steps (3 frames admitted), then
# PLANNED_BITWISE steps (two chunks) graphed and eagerly from one state
PLANNED_START, PLANNED_BITWISE = 120, 40


def _planned_conf(tmp, name, plan_chunk, pixel_level=False):
    path = os.path.join(tmp, f"{name}.conf")
    _conf_copy(VIRTUAL_CONF, path, PLANNED_EDITS)
    with open(path) as f:
        text = f.read()
    add = [("maintain_shape = True", f"plan_chunk = {plan_chunk}")]
    if pixel_level:
        add.append(("pose_type = seg", "pixel_level = True"))
    for after, line in add:
        text, n = re.subn(rf"(?m)^(\s*){after}\s*$", rf"\g<0>\n\g<1>{line}", text)
        _require(n == 1, f"{path}: {n} lines {after!r}")
    with open(path, "w") as f:
        f.write(text)
    return path


def _planned_run(conf, name, scene, dev, tmp):
    """A Runner on ``conf`` trained to its end: (runner, launches, peak
    memory, seconds, the (frame, flow) of every step in order)."""
    import torch
    from fmov_pose_torch.train.runner import Runner
    runner = Runner(conf, mode="train", case="orbit_smoke", exp_dir=os.path.join(tmp, name),
                    seed=SEED, device=dev, scene=scene)
    plans, plan_step = [], runner._plan_step

    def recorded():
        out = plan_step()
        plans.append((out[3], out[1]))
        return out

    runner._plan_step = recorded
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del runner._plan_step  # the class's again: no cycle keeps the Runner alive
    return runner, _counters(), torch.cuda.max_memory_allocated(dev), seconds, plans


def _planned_state(runner):
    """Every tensor a planned step writes, cloned, the generator's state
    and the host counts."""
    from fmov_pose_torch.train import step as step_mod
    st = runner.state
    written, _ = step_mod.state_buffers(st)
    return ([t.detach().clone() for t in written], st.generator.get_state(),
            st.iter_step, st.opt.step)


def _set_planned_state(runner, saved):
    import torch
    from fmov_pose_torch.train import step as step_mod
    tensors, gen, it, adam_step = saved
    st = runner.state
    with torch.no_grad():
        for t, v in zip(step_mod.state_buffers(st)[0], tensors):
            t.copy_(v)
    st.generator.set_state(gen)
    st.iter_step, st.opt.step = it, adam_step


def _planned_bitwise(conf, scene, dev, tmp):
    """PLANNED_BITWISE planned steps (photo and flow) from one state and
    generator state, through the captured steps and eagerly: bitwise the
    same state, generator and metrics.  Returns the launches a replay."""
    import numpy as np
    import torch
    from fmov_pose_torch.train import graph as graph_mod
    from fmov_pose_torch.train import step as step_mod
    from fmov_pose_torch.train.runner import Runner
    runner = Runner(conf, mode="train", case="orbit_smoke",
                    exp_dir=os.path.join(tmp, "planned_bitwise"), seed=SEED,
                    device=dev, scene=scene)
    runner.end_iter = PLANNED_START
    runner.train()
    runner.end_iter = PLANNED_STEPS
    chunks = []  # the host side alone: the planned rows of two chunks
    while sum(len(c) for c in chunks) < PLANNED_BITWISE:
        plan, _ = runner._plan_chunk(PLAN_K)
        if len(plan) == PLAN_K:
            chunks.append(plan)
    before = _planned_state(runner)
    res = {}
    for mode in ("eager", "graph"):
        _set_planned_state(runner, before)
        steps = runner.planned_steps(PLAN_K, capture=(mode == "graph"))
        zero_pix = np.zeros(steps.rows.shape[1] - steps.n_packed, np.float32)
        metrics = []
        _zero_counters()
        for plan in chunks:
            rows = np.stack([np.concatenate([p, x.reshape(-1) if uf else zero_pix])
                             for p, uf, x in plan])
            metrics.append(steps(runner.state, rows, [uf for _, uf, _ in plan]).clone())
        torch.cuda.synchronize()
        res[mode] = (_planned_state(runner), torch.cat(metrics), _counters(), steps)
    (s_e, m_e, c_e, _), (s_g, m_g, c_g, steps) = res["eager"], res["graph"]
    differ = [i for i, (a, b) in enumerate(zip(s_e[0], s_g[0])) if not torch.equal(a, b)]
    same_gen = bool(torch.equal(s_e[1], s_g[1]))
    same_metrics = bool(torch.equal(m_e, m_g))
    flows = sum(uf for plan in chunks for _, uf, _ in plan)
    per_replay = {uf: graph_mod.launches_by_kernel(g.per_replay)
                  for uf, g in steps.graphs.items()}
    _line("planned", check="graph_vs_eager", start=PLANNED_START, steps=PLANNED_BITWISE,
          flow_steps=flows, current_image=runner.current_image,
          state_tensors_differ=json.dumps(differ).replace(" ", ""),
          generator_equal=same_gen, metrics_bitwise=same_metrics,
          loss_eager=f"{float(m_e[:, 0].mean()):.6f}",
          loss_graph=f"{float(m_g[:, 0].mean()):.6f}",
          eager_launches=json.dumps(c_e).replace(" ", ""),
          graph_launches=json.dumps(c_g).replace(" ", ""),
          per_replay_photo=json.dumps(per_replay[False]).replace(" ", ""),
          per_replay_flow=json.dumps(per_replay[True]).replace(" ", ""))
    _require(0 < flows < PLANNED_BITWISE, f"{flows} flow steps in the {PLANNED_BITWISE}")
    _require(not differ and same_gen and same_metrics and s_e[2:] == s_g[2:],
             f"the graphed planned steps differ from the eager ones: tensors {differ}, "
             f"generator {same_gen}, metrics {same_metrics}")
    for uf, launches in per_replay.items():
        _require(launches.get("K2") == launches.get("K3") == 1
                 and all(v == 0 for k, v in launches.items() if k not in ("K2", "K3")),
                 f"the {'flow' if uf else 'photo'} graph launches {launches} a replay")
    _require(c_e["K2"] == c_e["K3"] == PLANNED_BITWISE,
             f"the eager steps launched {c_e}")
    return per_replay


def _planned_checks(name, runner, counts, plans):
    """The run's checks: K2/K3 once a step (each capture's warm-up steps
    too), finite losses, frame 0's color loss falling; returns the steps."""
    import numpy as np
    from fmov_pose_torch.train import graph as graph_mod
    losses = np.asarray(runner.history["loss"])
    steps = len(losses)
    color = np.asarray(runner.history["color_loss"])
    frame0 = np.asarray([c for c, (img, flow) in zip(color, plans) if img == 0 and not flow])
    planned = getattr(runner, "planned", None)
    warm = (graph_mod.WARMUP_STEPS * planned.captures * len(planned.graphs)
            if planned is not None else 0)
    _line("planned", run=name, dispatch=runner.dispatch, steps=steps,
          iter_step=runner.iter_step, flow_steps=runner.flow_steps,
          current_image=runner.current_image, segment=runner.current_pose_mlp_index,
          resets=runner.reset_count, captures=getattr(planned, "captures", 0),
          launches=json.dumps(counts).replace(" ", ""),
          loss_first=f"{losses[0]:.5f}", loss_last=f"{losses[-1]:.5f}",
          frame0_photo_steps=len(frame0), frame0_color_first10=f"{frame0[:10].mean():.5f}",
          frame0_color_last10=f"{frame0[-10:].mean():.5f}")
    _require(steps == len(plans) and bool(np.isfinite(losses).all()),
             f"{name}: {steps} losses for {len(plans)} steps, finite {np.isfinite(losses).all()}")
    _require(counts["K2"] == counts["K3"] == steps + warm,
             f"{name}: K2/K3 launched {counts['K2']}/{counts['K3']} times in {steps} "
             f"steps and {warm} warm-up steps")
    _require(all(v == 0 for k, v in counts.items() if k not in ("K1", "K2", "K3")),
             f"{name}: other kernels launched {counts}")
    _require(len(frame0) >= 20 and frame0[-10:].mean() < frame0[:10].mean(),
             f"{name}: frame 0's color loss did not fall: {frame0[:10]} -> {frame0[-10:]}")
    return steps


def _state_close(a, b, start):
    """The leaf rule on two runs' parameter moves from their common start
    ``start`` (the flat fields and the flat bank), and the fields' largest
    error relative to their largest value."""
    from fmov_pose_torch import convert
    from fmov_pose_torch.ops import fused_sdf
    moves = []
    for r in (a, b):
        st = r.state
        moves.append({**{f"f.{n}": v for n, v in convert.flatten(
            st.layout.views((st.flat.detach() - start.flat.detach()).cpu()))},
                      **{f"b.{n}": v for n, v in convert.flatten(st.bank_layout.views(
                          (st.bank_flat.detach() - start.bank_flat.detach()).cpu()))}})
    fa, fb = a.state.flat.detach(), b.state.flat.detach()
    rel = float((fa - fb).abs().max() / fb.abs().max())
    return fused_sdf.leaf_rule(*moves), rel


def phase_planned(dev, smi, scene, tmp):
    """The planned phase-1 dispatch on the fast virtual conf cut in depth
    (``PLANNED_EDITS``, chunks of PLAN_K): a graphed planned run and the
    per-step run from the same seed (the same curriculum, the state
    within the leaf rule, ms a step), PLANNED_BITWISE graphed steps
    bitwise the eager ones, then the same planned run with the deep pose
    bank (``model.pixel_level``) and its checkpoint read back bitwise."""
    import gc
    import numpy as np
    import torch
    from fmov_pose_torch.train import graph as graph_mod
    from fmov_pose_torch.train.runner import Runner
    allocated = torch.cuda.memory_allocated(dev)
    conf_p = _planned_conf(tmp, "planned", PLAN_K)
    conf_s = _planned_conf(tmp, "per_step", 1)
    conf_x = _planned_conf(tmp, "planned_pixel", PLAN_K, pixel_level=True)
    _line("planned", conf=os.path.relpath(VIRTUAL_CONF, ROOT),
          overrides=",".join(f"{k}={v}" for k, v in PLANNED_EDITS.items()),
          plan_chunk=PLAN_K)
    out = {}
    runs = {}
    for name, conf in (("planned", conf_p), ("per_step", conf_s)):
        r, counts, peak, seconds, plans = _planned_run(conf, name, scene, dev, tmp)
        runs[name] = (r, counts, peak, seconds, plans)
        _planned_checks(name, r, counts, plans)
    (p, cp, peak_p, sec_p, plans_p), (s, cs, peak_s, sec_s, plans_s) = (
        runs["planned"], runs["per_step"])
    _require(p.dispatch == f"planned x{PLAN_K}" and s.dispatch == "per-step",
             f"dispatch {p.dispatch} / {s.dispatch}")
    same_host = [k for k in ("iter_step", "current_image", "pro_iteration",
                             "current_pose_mlp_index", "flow_steps", "reset_count")
                 if getattr(p, k) != getattr(s, k)]
    same_host += [k for k in ("seg_progress", "seg_frozen")
                  if not np.array_equal(getattr(p, k), getattr(s, k))]
    same_rng = p.rng.integers(1 << 30) == s.rng.integers(1 << 30)
    _require(plans_p == plans_s and not same_host and same_rng,
             f"the planned run's curriculum differs from the per-step run's: {same_host}, "
             f"the plans equal {plans_p == plans_s}, the host RNG {same_rng}")
    _require(p.current_image == s.current_image == scene.n_images
             and bool(p.state.bank_static["initialized"].all()),
             f"{p.current_image} frames admitted")
    # the two runs from one seed start from one state: their moves
    start = Runner(conf_s, mode="train", case="orbit_smoke",
                   exp_dir=os.path.join(tmp, "planned_start"), seed=SEED, device=dev,
                   scene=scene)
    rule, rel = _state_close(p, s, start.state)
    del start
    differ = [i for i, (a, b) in enumerate(zip(_planned_state(p)[0], _planned_state(s)[0]))
              if not torch.equal(a, b)]
    same_gen = bool(torch.equal(p.state.generator.get_state(), s.state.generator.get_state()))
    same_losses = p.history["loss"] == s.history["loss"]
    per_replay = {uf: graph_mod.launches_by_kernel(g.per_replay)
                  for uf, g in p.planned.graphs.items()}
    planned_ms = statistics.median(p.step_ms)
    per_ms = statistics.median(s.step_ms)
    _line("planned", check="planned_vs_per_step",
          state_tensors_differ=json.dumps(differ).replace(" ", ""),
          generator_equal=same_gen, losses_equal=same_losses,
          leaf_rule=json.dumps({k: rule[k] for k in ("ok", "worst", "worst_rel", "failed")
                                }).replace(" ", ""),
          flat_max_rel=f"{rel:.3e}", leaf_tol=LEAF_TOL)
    _require(rule["ok"] and same_gen,
             f"the planned run's state is off the per-step run's: {rule}")
    _line("planned", check="ms_a_step", planned_ms=f"{planned_ms:.3f}",
          per_step_ms=f"{per_ms:.3f}", speedup=f"{per_ms / planned_ms:.2f}",
          chunk_step_ms=json.dumps([round(v, 3) for v in p.step_ms]).replace(" ", ""),
          per_replay_photo=json.dumps(per_replay[False]).replace(" ", ""),
          per_replay_flow=json.dumps(per_replay[True]).replace(" ", ""),
          planned_wall_s=f"{sec_p:.2f}", per_step_wall_s=f"{sec_s:.2f}",
          planned_peak_gib=f"{peak_p / 2**30:.3f}", per_step_peak_gib=f"{peak_s / 2**30:.3f}",
          card=repr(smi))
    out["planned"], out["per_step"] = cp, cs
    out["planned_ms"], out["per_step_ms"] = planned_ms, per_ms
    del p, s, r, runs
    out["per_replay"] = _planned_bitwise(conf_p, scene, dev, tmp)

    # the deep pose bank on the planned path, and its checkpoint
    x, cx, peak_x, sec_x, plans_x = _planned_run(conf_x, "planned_pixel", scene, dev, tmp)
    _planned_checks("planned_pixel", x, cx, plans_x)
    _require(x.pose_mode == "seg_pixel" and x.current_image == scene.n_images
             and bool(x.state.bank_static["initialized"].all()),
             f"seg_pixel: {x.pose_mode}, {x.current_image} frames, initialized "
             f"{x.state.bank_static['initialized']}")
    y = Runner(conf_x, mode="train", case="orbit_smoke",
               exp_dir=os.path.join(tmp, "planned_pixel"), seed=SEED, device=dev,
               scene=scene, is_continue=True)
    differ = [n for (n, a), (_, b) in zip(x.state_leaves(), y.state_leaves())
              if a.dtype != b.dtype or not np.array_equal(a, b)]
    same_gen = bool(torch.equal(x.state.generator.get_state(), y.state.generator.get_state()))
    _line("planned", run="planned_pixel", check="checkpoint", leaves=len(x.state_leaves()),
          leaves_differ=json.dumps(differ).replace(" ", ""), generator_equal=same_gen,
          n_bank=x.state.bank_layout.size, ms_a_step=f"{statistics.median(x.step_ms):.3f}",
          wall_s=f"{sec_x:.2f}", peak_gib=f"{peak_x / 2**30:.3f}")
    _require(not differ and same_gen and y.iter_step == x.iter_step,
             f"seg_pixel: the checkpoint read back differs in {differ}")
    out["planned_pixel"] = cx
    del x, y
    gc.collect()
    # what the phase leaves allocated would count in every later phase's peak
    _line("planned", check="memory_left", allocated_before_gib=f"{allocated / 2**30:.3f}",
          allocated_after_gib=f"{torch.cuda.memory_allocated(dev) / 2**30:.3f}")
    return out


def phase_slice4(dev, smi, scene, tmp):
    """The fast phase-2 conf with the NeRF++ background (``N_OUTSIDE``
    samples a ray), as written but for the depth of the run: the color
    gate is met and the background blocks K8/K9, so the color MLP runs
    through K6/K7, and the background network in f32."""
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.profile_step import conf_with_outside
    from fmov_pose_torch.train.runner import Runner

    conf = conf_with_outside(FAST_CONF, N_OUTSIDE, tmp)
    runner = Runner(conf, mode="train", case="orbit_smoke",
                    exp_dir=os.path.join(tmp, "exp4"), seed=SEED,
                    device=dev, scene=scene)
    runner.end_iter, runner.warm_up_end = STEPS, 0.0
    runner.occ_update_freq = OCC_UPDATE_FREQ
    r = runner.model_cfg["renderer"]
    _require(runner.model_cfg["sdf"]["use_fused_train"] and runner.occupancy_sampling
             and r.n_outside == N_OUTSIDE, "the slice-4 conf runs the fused kernels, "
                                           "the grid and the background")
    nerf_cfg = runner.model_cfg["nerf"]
    _line("slice4", conf=os.path.relpath(FAST_CONF, ROOT),
          overrides=(f"n_outside={N_OUTSIDE},end_iter={STEPS},warm_up_end=0,"
                     f"occ_update_freq={OCC_UPDATE_FREQ}"),
          pose_mode=runner.pose_mode, batch=runner.batch_size,
          samples=f"{r.n_samples}+{r.n_importance}+{r.n_outside}", perturb=r.perturb,
          nerf=f"D{nerf_cfg['D']}xW{nerf_cfg['W']}_pe{nerf_cfg['multires']}"
               f"_view{nerf_cfg['multires_view']}",
          occ_grid_res=runner.occ_grid_res, n_params=runner.state.layout.size)
    nerf0 = {n: t.detach().clone()
             for n, t in convert.flatten(runner.state.params["nerf"])}

    _check_batch(runner, scene, dev, "initial", phase="slice4")

    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    runner.train()
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev)
    occ_mean = float(runner.state.pose_static["occ_grid"].mean())
    nerf1 = dict(convert.flatten(runner.state.params["nerf"]))
    moved = min(float((nerf1[n].detach() - t).abs().max()) for n, t in nerf0.items())

    step_ms = _history_lines(
        "slice4", runner, smi, launches=json.dumps(counts).replace(" ", ""),
        occ_refreshes=runner.occ_refreshes, occ_mean=f"{occ_mean:.4f}",
        nerf_leaves=len(nerf0), nerf_min_max_move=f"{moved:.3e}")
    _perf_line("slice4", runner, step_ms, peak, smi)
    _require_launches(counts, ("K4", "K5", "K6", "K7"), "slice-4")
    _require(moved > 0, "a background network leaf did not move in training")
    _require(runner.occ_refreshes == STEPS // OCC_UPDATE_FREQ,
             f"{runner.occ_refreshes} grid refreshes")
    _require(0.0 < occ_mean < 1.0, f"grid mean {occ_mean} after the refreshes")
    _check_batch(runner, scene, dev, "after_training", phase="slice4")
    return counts


def phase_mesh(runner):
    """The CLI's final mesh on slice 1's trained Runner: the 512^3 grid
    through K1 on one pack, 262,144 points a launch; marching cubes on the
    host; normal colors; the PLY file, read back."""
    import numpy as np
    from fmov_pose_torch.pipeline import meshio
    written = {}
    write_ply = meshio.write_ply

    def recorded(path, vertices, faces, vertex_colors=None, binary=True):
        written.update(vertices=vertices, faces=faces, colors=vertex_colors)
        return write_ply(path, vertices, faces, vertex_colors=vertex_colors,
                         binary=binary)

    meshio.write_ply = recorded
    try:
        _zero_counters()
        t0 = time.perf_counter()
        path = runner.validate_mesh(resolution=MESH_RES, use_norml_color=True)
        total = time.perf_counter() - t0
        counts = _counters()
    finally:
        meshio.write_ply = write_ply
    verts, faces = meshio.read_ply(path)
    sec = runner.mesh_seconds
    lo, hi = runner.dataset.object_bbox_min, runner.dataset.object_bbox_max
    _line("mesh", resolution=MESH_RES, chunk=MESH_CHUNK, launches=json.dumps(counts)
          .replace(" ", ""), vertices=len(verts), triangles=len(faces),
          file_mib=f"{os.path.getsize(path) / 2**20:.1f}", total_s=f"{total:.3f}",
          **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
    expected = -(-MESH_RES ** 3 // MESH_CHUNK)
    _require(counts["K1"] == expected, f"the {MESH_RES}^3 mesh launched K1 "
                                       f"{counts['K1']} times, not {expected}")
    _require(all(v == 0 for k, v in counts.items() if k != "K1"),
             f"kernels other than K1 launched for the mesh: {counts}")
    _require(len(verts) > 0 and len(faces) > 0, "the mesh is empty")
    _require(np.array_equal(verts, written["vertices"])
             and np.array_equal(faces, written["faces"]),
             "read_ply does not return the mesh that was written")
    _require(bool((verts >= lo - 1e-6).all() and (verts <= hi + 1e-6).all()),
             "mesh vertices outside the object's bounds")
    colors = written["colors"]
    _require(colors is not None and colors.shape == verts.shape
             and bool(np.isfinite(colors).all()), "normal colors missing or not finite")
    return counts["K1"]


def _resume_one(phase, first, conf, exp, scene, dev, n_rays=None, overrides=()):
    """A Runner built with is_continue on ``first``'s exp dir restores it
    bitwise, gives one fixed batch's loss bitwise, and trains on."""
    import numpy as np
    import torch
    from fmov_pose_torch.train import step as step_mod
    from fmov_pose_torch.train.runner import Runner
    t0 = time.perf_counter()
    second = Runner(conf, mode="train", case="orbit_smoke", exp_dir=exp, seed=SEED,
                    device=dev, scene=scene, is_continue=True)
    load_s = time.perf_counter() - t0
    second.end_iter, second.warm_up_end = STEPS + RESUME_STEPS, 0.0
    for key, value in overrides:
        if key != "mesh_warmup_step":  # restored from the checkpoint
            setattr(second, key, value)
        second.conf.put(f"train.{key}", value)
    leaves_a, leaves_b = first.state_leaves(), second.state_leaves()
    differ = [n for (n, a), (_, b) in zip(leaves_a, leaves_b)
              if a.dtype != b.dtype or not np.array_equal(a, b)]
    meta_a, meta_b = first._host_meta(), second._host_meta()
    meta_differ = [k for k in meta_a
                   if (meta_a[k] is None) != (meta_b[k] is None)
                   or (meta_a[k] is not None and not np.array_equal(meta_a[k], meta_b[k]))]
    same_gen = bool(torch.equal(first.state.generator.get_state(),
                                second.state.generator.get_state()))
    cfg = dataclasses.replace(first.step_cfg, model_cfg=dict(
        first.step_cfg.model_cfg,
        renderer=first.step_cfg.model_cfg["renderer"]._replace(perturb=0.0)))
    data = _ray_batch(first, scene, dev, n_rays)
    losses = []
    with torch.no_grad():
        for r in (first, second):
            loss, _ = step_mod._render_and_losses(
                cfg, None, r.state.params, r.state.pose_static, data,
                step_mod.StepScalars(lr=0.0, cos_anneal=1.0))
            losses.append(loss)
    same_loss = bool(torch.equal(losses[0], losses[1]))
    _line("resume", slice=phase, checkpoint=os.path.basename(
        sorted(os.listdir(os.path.join(second.base_exp_dir, "checkpoints")))[-1]),
          leaves=len(leaves_a), leaves_differ=json.dumps(differ).replace(" ", ""),
          host_meta_differ=json.dumps(meta_differ).replace(" ", ""),
          generator_state_equal=same_gen, iter_step=second.iter_step,
          loss_first=f"{float(losses[0]):.8f}", loss_resumed=f"{float(losses[1]):.8f}",
          loss_bitwise_equal=same_loss, load_s=f"{load_s:.2f}")
    _require(len(leaves_a) == len(leaves_b) and not differ,
             f"{phase}: the resumed state differs in {differ}")
    _require(not meta_differ and same_gen,
             f"{phase}: host meta {meta_differ} or the generator differs")
    _require(same_loss, f"{phase}: one batch's loss differs after the resume")
    _zero_counters()
    second.train()
    counts = _counters()
    losses = np.asarray(second.history["loss"])
    _line("resume", slice=phase, steps=len(losses), iter_step=second.iter_step,
          losses=json.dumps([round(float(v), 6) for v in losses]).replace(" ", ""),
          launches=json.dumps(counts).replace(" ", ""))
    _require(len(losses) == RESUME_STEPS and bool(np.isfinite(losses).all())
             and second.iter_step == STEPS + RESUME_STEPS,
             f"{phase}: the resumed run's losses {losses}")
    return counts


def phase_resume(scene, dev, tmp, runner1, runner3):
    """Slice 1 (gf pose, K1) and slice 3 (segment bank, segment Adam,
    progressive counters, K2/K3) resumed from the checkpoints their runs
    wrote at the end."""
    counts1 = _resume_one("slice1", runner1, CONF, os.path.join(tmp, "exp1"), scene, dev)
    _require(counts1["K1"] == 4 * RESUME_STEPS
             and all(v == 0 for k, v in counts1.items() if k != "K1"),
             f"the resumed slice-1 steps launched {counts1}")
    counts3 = _resume_one("slice3", runner3, VIRTUAL_CONF, os.path.join(tmp, "exp3"),
                          scene, dev, n_rays=2 * runner3.batch_size,
                          overrides=tuple(SLICE3_SCHEDULE.items()))
    _require(counts3["K2"] == counts3["K3"] == RESUME_STEPS
             and all(v == 0 for k, v in counts3.items() if k not in ("K2", "K3")),
             f"the resumed slice-3 steps launched {counts3}")


def _conf_copy(src, dst, edits):
    """``src`` written to ``dst`` with each ``key = value`` line of ``edits``
    set (each key must occur once at the start of a line)."""
    with open(src) as f:
        text = f.read()
    for key, value in edits.items():
        text, n = re.subn(rf"(?m)^(\s*){key}\s*=\s*\S+", rf"\g<1>{key} = {value}", text)
        _require(n == 1, f"{src}: {n} lines set {key}")
    with open(dst, "w") as f:
        f.write(text)


def phase_two_phase(dev, smi, tmp):
    """The two-phase command as a user runs it, in-process through
    ``exp_runner.main`` with the cwd in a work dir that holds the HO3D
    layout the confs name, written by the port's ``make_orbit_sequence``:
    phase 1 on the fast virtual conf (K2/K3) until all frames are
    admitted, the alignment (the 64^3 mesh on K1, PnP, the
    normalization, the phase-2 dataset), phase 2 on the fast global conf
    (K4/K5/K8/K9), the final mesh (K1) and the poses."""
    import numpy as np
    import torch
    from fmov_pose_torch import exp_runner
    from fmov_pose_torch.data import dataset as dataset_mod
    from fmov_pose_torch.data.synthetic import make_orbit_sequence
    from fmov_pose_torch.pipeline import align, evalpose, meshio
    from fmov_pose_torch.train.runner import Runner

    work = os.path.join(tmp, "two_phase")
    data = os.path.join(work, "data", "HO3Dv3")
    t0 = time.perf_counter()
    gt = make_orbit_sequence(os.path.join(data, "SYN_ori"), n_frames=TWO_PHASE_FRAMES,
                             H=480, W=640)
    make_orbit_sequence(os.path.join(data, "SYN"), n_frames=TWO_PHASE_FRAMES, H=480,
                        W=640, with_matches=False, with_crop=False)
    os.makedirs(os.path.join(data, "ann"))
    shutil.copy(os.path.join(data, "SYN", "cameras_sphere.npz"),
                os.path.join(data, "ann", "SYN.npz"))
    data_s = time.perf_counter() - t0
    os.makedirs(os.path.join(work, "confs"))
    confs = []
    for src, edits in ((VIRTUAL_CONF, TWO_PHASE_P1), (FAST_CONF, TWO_PHASE_P2)):
        dst = os.path.join(work, "confs", os.path.basename(src))
        _conf_copy(src, dst, edits)
        confs.append("./confs/" + os.path.basename(src))
    argv = ["--mode", "train", "--conf", confs[0], "--case", "SYN_ori",
            "--global_conf", confs[1], "--final_mesh_resolution", str(TWO_PHASE_MESH_RES)]
    _line("two_phase", data=f"SYN_ori+SYN_{TWO_PHASE_FRAMES}x480x640+ann",
          data_s=f"{data_s:.2f}", argv=repr(" ".join(argv)),
          edits=",".join(f"{os.path.basename(c)}:{k}={v}" for c, e in
                         zip(confs, (TWO_PHASE_P1, TWO_PHASE_P2)) for k, v in e.items()))

    # record each stage: its arguments, result, seconds and launches
    calls = {}
    saved = [(owner, name, getattr(owner, name)) for owner, name in (
        (Runner, "train"), (Runner, "validate_mesh"), (Runner, "save_aligned_poses"),
        (dataset_mod.Dataset, "__init__"), (align, "pnp_pose_from_mesh"),
        (align, "get_normalization"), (align, "_write_phase2_dataset"))]

    def recorded(name, fn):
        def run(*a, **kw):
            c0, t = _counters(), time.perf_counter()
            out = fn(*a, **kw)
            c1 = _counters()
            calls.setdefault(name, []).append({
                "args": a, "kw": kw, "out": out, "s": time.perf_counter() - t,
                "launches": {k: c1[k] - c0[k] for k in c1}})
            return out
        return run

    for owner, name, fn in saved:
        setattr(owner, name, recorded(name, fn))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counters()
        t0 = time.perf_counter()
        runner2 = exp_runner.main(argv, device=dev)
        total_s = time.perf_counter() - t0
        counts = _counters()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        os.chdir(cwd)
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    trains, meshes = calls.get("train", []), calls.get("validate_mesh", [])
    aligns = calls.get("save_aligned_poses", [])

    p1_dir = os.path.join(work, "exp", "SYN_ori", "ours")
    err = os.path.join(p1_dir, "error_during_progressive_learning.txt")
    _require(not os.path.exists(err), "phase 1 raised: " + (
        open(err).read()[-2000:] if os.path.exists(err) else ""))
    _require(len(trains) == 2 and len(aligns) == 1 and len(meshes) == 2,
             f"{len(trains)} trains, {len(aligns)} alignments, {len(meshes)} meshes")
    p1, p2 = trains
    r1 = p1["args"][0]
    _require(r1 is not runner2 and p2["args"][0] is runner2,
             "the CLI did not reboot into a new Runner for phase 2")
    transition, final = meshes
    p1_steps = len(r1.history["loss"])
    p1_loss = np.asarray(r1.history["loss"])
    step_launches = {k: p1["launches"][k] - transition["launches"][k]
                     for k in p1["launches"]}
    _line("two_phase", stage="phase1", steps=p1_steps, iter_step=r1.iter_step,
          end_iter=r1.end_iter, current_image=r1.current_image,
          pro_iteration=r1.pro_iteration, resets=r1.reset_count,
          flow_steps=r1.flow_steps, loss_first=f"{p1_loss[0]:.5f}",
          loss_last=f"{p1_loss[-1]:.5f}",
          median_step_ms=f"{statistics.median(r1.step_ms):.2f}",
          loop_s=f"{r1.train_seconds:.2f}", seconds=f"{p1['s']:.2f}",
          launches=json.dumps(step_launches).replace(" ", ""))
    _require(r1.current_image == TWO_PHASE_FRAMES and r1.pro_iteration == -1
             and p1_steps < TWO_PHASE_P1["end_iter"],
             f"phase 1 ended with {r1.current_image} frames admitted after "
             f"{p1_steps} of {TWO_PHASE_P1['end_iter']} steps")
    _require(bool(np.isfinite(p1_loss).all()), "non-finite phase-1 losses")
    _require(step_launches["K2"] == step_launches["K3"] == p1_steps
             and all(v == 0 for k, v in step_launches.items() if k not in ("K2", "K3")),
             f"the phase-1 steps launched {step_launches} in {p1_steps} steps")

    ate = aligns[0]["out"]
    pnp_s = sum(c["s"] for c in calls["pnp_pose_from_mesh"])
    norm_s = sum(c["s"] for c in calls.get("get_normalization", []))
    write_s = calls["_write_phase2_dataset"][0]["s"] - norm_s
    _line("two_phase", stage="transition", mesh=os.path.basename(transition["out"]),
          mesh_s=f"{transition['s']:.3f}",
          mesh_launches=json.dumps(transition["launches"]).replace(" ", ""),
          align_s=f"{aligns[0]['s']:.3f}", pnp_s=f"{pnp_s:.3f}",
          pnp_frames=len(calls["pnp_pose_from_mesh"]), normalization_s=f"{norm_s:.3f}",
          writes_s=f"{write_s:.3f}",
          ate=f"{ate[0]:.5f}" if ate else None, rpe_trans=f"{ate[1]:.5f}" if ate else None,
          rpe_rot=f"{ate[2]:.5f}" if ate else None)
    _require(transition["kw"] == {} and transition["launches"]["K1"] == 1
             and all(v == 0 for k, v in transition["launches"].items() if k != "K1"),
             f"the transition mesh launched {transition['launches']}")
    _require(ate is not None and all(np.isfinite(ate)), f"alignment ATE {ate}")
    gposes = np.load(os.path.join(p1_dir, f"global_poses_{TWO_PHASE_FRAMES}_"
                                          f"{r1.iter_step}.npy"))
    _require(gposes.shape == (TWO_PHASE_FRAMES, 4, 4) and bool(np.isfinite(gposes).all()),
             "the aligned poses are missing or not finite")
    p2_dir = os.path.join(work, runner2.base_exp_dir)   # paths relative to work
    noise = np.load(os.path.join(p2_dir, "noise_cameras_sphere.npz"))
    _require(sorted(noise.files) == sorted(f"{k}_{i}" for i in range(TWO_PHASE_FRAMES)
                                           for k in ("world_mat", "scale_mat")),
             f"noise_cameras_sphere.npz holds {sorted(noise.files)}")
    p2_load = [c for c in calls["__init__"] if c["args"][2:] and c["args"][2] is not None]
    _require(len(p2_load) == 1, f"{len(p2_load)} phase-2 Dataset loads")

    step_ms = _history_lines("two_phase", runner2, smi, stage="phase2",
                             launches=json.dumps(p2["launches"]).replace(" ", ""),
                             dataset_load_s=f"{p2_load[0]['s']:.3f}",
                             seconds=f"{p2['s']:.2f}")
    _perf_line("two_phase", runner2, step_ms, peak, smi)
    _require(runner2.iter_step == STEPS and runner2.dataset.use_crop_init,
             f"phase 2 at {runner2.iter_step} steps")
    _require_launches(p2["launches"], ("K4", "K5", "K8", "K9"), "phase-2")

    verts, faces = meshio.read_ply(os.path.join(work, final["out"]))
    poses_path = os.path.join(p2_dir, f"poses_{runner2.iter_step}.npy")
    learned = np.load(poses_path, allow_pickle=True).item()
    est = np.stack([learned[n] for n in gt["names"]])
    aligned = evalpose.align_ate_c2b_use_a2b(est, gt["poses"])
    _line("two_phase", stage="final", mesh=os.path.basename(final["out"]),
          vertices=len(verts), triangles=len(faces), mesh_s=f"{final['s']:.3f}",
          **{f"mesh_{k}_s": f"{v:.3f}" for k, v in runner2.mesh_seconds.items()},
          launches=json.dumps(final["launches"]).replace(" ", ""),
          poses=os.path.basename(poses_path),
          phase2_ate_vs_orbit=f"{evalpose.compute_ATE(gt['poses'], aligned):.5f}",
          phase2_rpe_vs_orbit=json.dumps([round(v, 5) for v in evalpose.compute_rpe(
              gt["poses"], aligned)]).replace(" ", ""),
          total_s=f"{total_s:.2f}", launches_total=json.dumps(counts).replace(" ", ""))
    expected = -(-TWO_PHASE_MESH_RES ** 3 // MESH_CHUNK)
    _require(final["kw"].get("resolution") == TWO_PHASE_MESH_RES
             and final["launches"]["K1"] == expected
             and all(v == 0 for k, v in final["launches"].items() if k != "K1"),
             f"the final mesh launched {final['launches']} (expected K1 {expected})")
    _require(len(verts) > 0 and len(faces) > 0, "the final mesh is empty")
    _require(bool(np.isfinite(est).all()), "the learned poses are not finite")
    _require(counts["K6"] == counts["K7"] == 0 and counts["K1"] == 1 + expected,
             f"the two-phase run launched {counts}")
    launches = {"K1": counts["K1"], "K2": step_launches["K2"], "K3": step_launches["K3"],
                **{k: p2["launches"][k] for k in ("K4", "K5", "K8", "K9")}}
    return launches, {"runner": runner2, "work": work, "confs": confs}


# the eval phase: a chunk of the texture bake (8,192 rays of the fast
# global conf's 64 + 64 samples), its texture's size, and the rays of the
# render check
BAKE_RAYS, BAKE_TEX = 8192, 1024
BAKE_M = BAKE_RAYS * 128
EVAL_CHECK_CHUNKS = 4


def _sizes_text(sizes):
    return json.dumps({k: {str(m): n for m, n in sorted(v.items())}
                       for k, v in sorted(sizes.items())}).replace(" ", "")


def _eval_call(name, fn, dev, runner=None, **expect):
    """``fn()`` timed (host clock to a sync), its launches by kernel and
    size (the wrappers' ``LAUNCH_SIZES``), its chunks through
    ``render_rays_chunked``, and the device's peak memory over it;
    ``expect``: {kernel: launches} it must make (every other kernel
    none).  Returns (result, launches, sizes)."""
    import torch
    from fmov_pose_torch.ops import fused_sdf
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    c0, chunks0 = _counters(), runner.eval_chunks if runner is not None else 0
    s0 = collections.Counter(fused_sdf.LAUNCH_SIZES)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    c1 = _counters()
    launches = {k: c1[k] - c0[k] for k in c1}
    sizes = {}
    for (k, m), n in (fused_sdf.LAUNCH_SIZES - s0).items():
        sizes.setdefault(k, {})[m] = n
    _line("eval", call=name, seconds=f"{seconds:.3f}",
          chunks=(runner.eval_chunks - chunks0) if runner is not None else None,
          launches=json.dumps({k: v for k, v in launches.items() if v}).replace(" ", ""),
          sizes=_sizes_text(sizes),
          peak_mem_gib=f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f}")
    _require(all(sum(sizes.get(k, {}).values()) == v for k, v in launches.items()),
             f"eval {name}: launches {launches} and by size {sizes} disagree")
    if expect:
        wrong = {k: v for k, v in launches.items() if v != expect.get(k, 0)}
        _require(not wrong, f"eval {name}: launches {launches}, expected {expect}")
    return out, launches, sizes


def _files_line(call, paths):
    """The bytes of each file (of each dir's files, for a dir) a call wrote;
    none may be empty."""
    sizes = {}
    for p in paths:
        if os.path.isdir(p):
            sizes[os.path.basename(p) + "/"] = sum(
                os.path.getsize(os.path.join(p, f)) for f in os.listdir(p))
        else:
            sizes[os.path.basename(p)] = os.path.getsize(p)
    _line("eval", call=call, file_bytes=json.dumps(sizes).replace(" ", ""))
    _require(all(v > 0 for v in sizes.values()), f"eval {call}: an empty file in {sizes}")


def _check_psnr(call, psnr, exp_dir, level, runner):
    """A finite PSNR and the two PNGs of validate_image, read back."""
    import cv2 as cv
    import numpy as np
    H, W = runner.dataset.H // level, runner.dataset.W // level
    paths = [max((os.path.join(exp_dir, sub, f) for f in os.listdir(os.path.join(
        exp_dir, sub))), key=os.path.getmtime) for sub in ("validations_fine", "normals")]
    tags = [os.path.basename(p) for p in paths]
    shapes = [cv.imread(p).shape for p in paths]
    _line("eval", call=call, psnr=f"{psnr:.3f}", images=json.dumps(tags).replace(" ", ""),
          shapes=json.dumps(shapes).replace(" ", ""))
    _require(bool(np.isfinite(psnr)), f"eval {call}: PSNR {psnr}")
    _require(shapes == [(2 * H, W, 3), (H, W, 3)], f"eval {call}: images {shapes}")
    _files_line(call, paths)


def _middle_rays(runner, n_chunks):
    """n_chunks batches of frame 0's full-resolution rays around its
    centre (the object's rows), on the Runner's device."""
    ro, rd, H, W = runner._pose_rays_grid(0, runner.query_pose(0), 1)
    n, mid = n_chunks * runner.batch_size, (H // 2) * W
    return ro[mid - n // 2:mid + n // 2], rd[mid - n // 2:mid + n // 2]


def _ray_errors(ref, got):
    """Per output of the eval render, each ray's max |err| over max|ref|:
    its median and maximum, the share of rays beyond the rows rule's max,
    and whether ``EVAL_TOL`` holds."""
    import numpy as np
    res = {}
    for k in ("color_fine", "normal", "depth_fine", "weight_sum"):
        scale = float(np.abs(ref[k]).max())
        err = np.abs(got[k] - ref[k]).max(-1)
        r = {"max_ref": scale, "median_rel": float(np.median(err)) / scale,
             "max_rel": float(err.max()) / scale,
             "share_outside": float((err > ROW_MAX_TOL * scale).mean())}
        r["ok"] = bool(np.isfinite(got[k]).all() and r["median_rel"] <= EVAL_MEDIAN_TOL
                       and r["share_outside"] <= EVAL_OUTSIDE_SHARE
                       and r["max_rel"] <= EVAL_MAX_TOL)
        res[k] = r
    return res


def _eval_route_check(runner, cpu_runner, dev):
    """``render_rays_chunked`` on EVAL_CHECK_CHUNKS chunks of frame 0's
    middle rows, through the kernels on the card and through their plain
    versions on CPU copies of the same state, held to ``EVAL_TOL``.  Also
    printed, for the rule's margin, the readings of two faults made in a
    copy of the kernels' outputs (never gated): the last 64 rays of the
    chunk whose last 64 rays hold the most weight (the object, not the
    background) left at zero (a tail never written), and the same rays
    given their left neighbours' outputs (a shift by one ray)."""
    ro, rd = _middle_rays(runner, EVAL_CHECK_CHUNKS)
    n = len(ro)
    c0 = _counters()
    got = runner.render_rays_chunked(ro, rd)
    c1 = _counters()
    ref = cpu_runner.render_rays_chunked(ro.cpu(), rd.cpu())
    res = _ray_errors(ref, got)
    weight = ref["weight_sum"][:, 0]
    edge = max(range(runner.batch_size, n + 1, runner.batch_size),
               key=lambda e: float(weight[e - 64:e].sum()))
    faults = {}
    for fault in ("zeroed_tail", "shifted_by_one"):
        bad = {k: v.copy() for k, v in got.items()}
        for v in bad.values():
            v[edge - 64:edge] = 0 if fault == "zeroed_tail" else v[edge - 65:edge - 1]
        faults[fault] = {k: {m: r[m] for m in ("median_rel", "max_rel", "share_outside",
                                               "ok")}
                         for k, r in _ray_errors(ref, bad).items()}
    _line("eval", check="render_kernels_vs_plain", rays=n, chunks=EVAL_CHECK_CHUNKS,
          fault_rays=f"{edge - 64}-{edge - 1}",
          launches=json.dumps({k: c1[k] - c0[k] for k in c1 if c1[k] - c0[k]}).replace(" ", ""),
          tol=EVAL_TOL, results=json.dumps(res, sort_keys=True).replace(" ", ""),
          simulated_faults=json.dumps(faults, sort_keys=True).replace(" ", ""))
    for k, r in res.items():
        _require(r["ok"], f"the eval render through the kernels disagrees with the "
                          f"plain versions on {k}: {r}")


def _bake_chunk(runner, ply_path):
    """The first chunk of the texture bake of mesh ``ply_path`` at
    tex_size BAKE_TEX: BAKE_RAYS ray origins and directions on the card
    (near 0, far raylen), and raylen."""
    import torch
    from fmov_pose_torch.pipeline import meshio, textured
    vertices, faces = meshio.read_ply(ply_path)
    normals = textured._vertex_normals(runner, vertices)
    o, d, _, _, raylen = textured.bake_rays(vertices, faces, normals, BAKE_TEX)
    _require(len(o) >= BAKE_RAYS, f"the bake has {len(o)} rays, under one chunk")
    return (torch.as_tensor(o[:BAKE_RAYS], dtype=torch.float32, device=runner.device),
            torch.as_tensor(d[:BAKE_RAYS], dtype=torch.float32, device=runner.device),
            float(raylen))


def _bake_out_rule(ref, got):
    """K4's out at the bake chunk against its plain version: the sdf
    column and the features' median by K1's rule, the features' max and
    the share of rows beyond 1e-2 of max|feature| by ``BAKE_FEAT_*``."""
    import torch
    from fmov_pose_torch.ops import fused_sdf
    res = fused_sdf.tolerance_check(ref, got)
    d = (got[:, 1:].double() - ref[:, 1:].double()).abs().amax(1)
    scale = float(ref[:, 1:].abs().max())
    res["feat_scale"] = scale
    res["feat_share_outside"] = float((d > ROW_MAX_TOL * scale).double().mean())
    res["ok"] = (res["sdf_max"] <= fused_sdf.SDF_MAX_TOL
                 and res["sdf_median"] <= fused_sdf.SDF_MEDIAN_TOL
                 and res["feat_median_rel"] <= fused_sdf.FEAT_MEDIAN_TOL
                 and res["feat_max_rel"] <= BAKE_FEAT_MAX_TOL
                 and res["feat_share_outside"] <= BAKE_FEAT_SHARE
                 and bool(torch.isfinite(got).all()))
    return res


def _double(tree):
    """A parameter tree's tensors in float64."""
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    return tree.double()


def _same_in_chunks(full, launch, M, step):
    """The outputs ``full`` of one launch on M rows are bitwise those of
    ``launch(a, b)`` on rows [a, b) in chunks of ``step``, concatenated."""
    import torch
    parts = [launch(a, min(a + step, M)) for a in range(0, M, step)]
    return all(torch.equal(f, torch.cat(p)) for f, p in zip(full, zip(*parts)))


def _bake_size_check(runner, dev, ply_path):
    """The kernels of the bake's eval render at the bake chunk's sizes,
    on the phase-2 weights, each against its plain version on the same
    inputs on the card, on the samples of the first chunk of the bake's
    rays (near 0 to far raylen, evenly spaced): K1 (the up-sampler's pack,
    sdf only) at the coarse pass's BAKE_RAYS x 64 and an up-sampling
    step's x 16 by K1's rule; K4 (``sdf_apply_grad_fused_rays``) at
    BAKE_RAYS x 128 by ``_bake_out_rule`` and the rows rule on grad; K8
    (``color_fused_ray``, on K4's outputs and seeded softmax weights) by
    the rows rule.  Each kernel's launch at the bake's M is also bitwise
    its launches on chunks of 65,536 rows (512 whole rays), the train
    step's M.  Printed, not gated: the rule's reading of the kernel's
    output with one 128-row tile (one ray for K8) zeroed.  Times the
    entry, the kernel alone on a pack built once, and the plain version
    (CUDA-event medians), beside the bound.  Returns {kernel: its
    ``bake_chunk`` entries of the kernels line}."""
    import torch
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_color, fused_sdf
    params, cfg = runner.eval_params(), runner.model_cfg
    r = cfg["renderer"]
    n_samples = r.n_samples + r.n_importance
    ro, rd, raylen = _bake_chunk(runner, ply_path)
    B = ro.shape[0]
    step_rows = 512 * n_samples

    def samples(z):
        return (ro[:, None, :] + rd[:, None, :] * z[None, :, None]).reshape(-1, 3)

    def zeroed(t, rows):
        bad = t.clone()
        bad[len(t) // 2:len(t) // 2 + rows] = 0
        return bad

    gen = torch.Generator(device=dev).manual_seed(SEED)
    reps, checks, out = 5, [], {}
    with torch.no_grad():
        pk1 = fused_sdf.FwdPack(params["sdf"], cfg["sdf"], False)
        step = r.n_importance // r.up_sample_steps
        for z in (torch.linspace(0, raylen, r.n_samples, device=dev),
                  (torch.arange(step, device=dev) + 0.5) / step * raylen):
            x1 = samples(z).contiguous()
            got, ref = (fused_sdf.sdf_forward(pk1, x1),
                        fused_sdf.sdf_forward_plain(pk1.ws, pk1.bs, x1, cfg["sdf"], False))
            err = fused_sdf.tolerance_check(ref, got)
            err["same_in_chunks"] = _same_in_chunks(
                (got,), lambda a, b, x1=x1: (fused_sdf.sdf_forward(pk1, x1[a:b]),),
                len(x1), step_rows)
            checks.append(("K1", len(x1), "K1_rule", err,
                           err["ok"] and err["same_in_chunks"], err["sdf_max"],
                           fused_sdf.tolerance_check(ref, zeroed(got, 128)), (
                lambda x1=x1: fused_sdf.sdf_forward(fused_sdf.FwdPack(
                    params["sdf"], cfg["sdf"], False), x1),
                lambda x1=x1: fused_sdf.sdf_forward(pk1, x1),
                lambda x1=x1: fused_sdf.sdf_forward_plain(pk1.ws, pk1.bs, x1, cfg["sdf"],
                                                          False))))
        x = samples(torch.linspace(0, raylen, n_samples, device=dev)).contiguous()
        M = len(x)
        dirs = rd[:, None, :].expand(B, n_samples, 3).reshape(-1, 3).contiguous()
        weights = torch.softmax(torch.randn((B, n_samples), generator=gen, device=dev), -1)
        ws, bs = fused_sdf.materialize(params["sdf"], cfg["sdf"])
        sdf_out, _, grad = fused_sdf.sdf_apply_grad_fused_rays(
            params["sdf"], cfg["sdf"], x, n_samples)
        ref_out, ref_grad = fused_sdf.sdf_fwd_grad_plain(ws, bs, x, cfg["sdf"])
        err = {"out": _bake_out_rule(ref_out, sdf_out), "grad": _rows(ref_grad, grad)}
        # the 8 rows of the largest feature error, kernel and plain version
        # each against the f32 network's forward in f64 (no bf16 rounding)
        worst = (sdf_out[:, 1:] - ref_out[:, 1:]).abs().amax(1).topk(8).indices
        exact = nets.sdf_apply(_double(params["sdf"]), cfg["sdf"], x[worst].double())
        scale = float(ref_out[:, 1:].abs().max())
        err["worst_rows_vs_f64"] = {
            name: [float(v) / scale for v in (o[worst, 1:].double() - exact[:, 1:]).abs()
                   .amax(1)] for name, o in (("kernel", sdf_out), ("plain", ref_out))}
        pk4 = fused_sdf.RaysPack(ws, bs, cfg["sdf"])
        err["same_in_chunks"] = _same_in_chunks(
            fused_sdf.launch_fwd_grad(pk4, x),
            lambda a, b: fused_sdf.launch_fwd_grad(pk4, x[a:b]), M, step_rows)
        checks.append(("K4", M, f"out:{BAKE_OUT_TOL};grad:{ROW_TOL}", err,
                       err["out"]["ok"] and err["grad"]["ok"] and err["same_in_chunks"],
                       max(float((sdf_out - ref_out).abs().max()), err["grad"]["max_abs"]),
                       _bake_out_rule(ref_out, zeroed(sdf_out, 128)), (
            lambda: fused_sdf.sdf_apply_grad_fused_rays(params["sdf"], cfg["sdf"], x,
                                                        n_samples),
            lambda: fused_sdf.launch_fwd_grad(pk4, x),
            lambda: fused_sdf.sdf_fwd_grad_plain(ws, bs, x, cfg["sdf"]))))
        del ref_out, ref_grad
        cws, cbs = fused_color.materialize(params["color"], cfg["color"])
        geo = (sdf_out, x, dirs, grad, weights)
        pk8 = fused_color.RayPack(cws, cbs, cfg["color"])
        got = fused_color.color_fused_ray(params["color"], cfg["color"], *geo)
        ref = fused_color.color_ray_fwd_plain(cws, cbs, *geo, cfg["color"])
        err = _rows(ref, got)
        err["same_in_chunks"] = _same_in_chunks(
            (fused_color.launch_fwd(pk8, *geo),),
            lambda a, b: (fused_color.launch_fwd(
                pk8, *(t[a:b] for t in geo[:4]),
                weights[a // n_samples:b // n_samples]),), M, step_rows)
        checks.append(("K8", M, ROW_TOL, err, err["ok"] and err["same_in_chunks"],
                       err["max_abs"], _rows(ref, zeroed(got, 1)), (
            lambda: fused_color.color_fused_ray(params["color"], cfg["color"], *geo),
            lambda: fused_color.launch_fwd(pk8, *geo),
            lambda: fused_color.color_ray_fwd_plain(cws, cbs, *geo, cfg["color"]))))
        for kind, M, tol, err, ok, max_abs, fault, fns in checks:
            entry, kernel, plain = (_median_ms(f, reps) for f in fns)
            work = (_color_work(cfg["color"], M, B, False) if kind == "K8"
                    else _sdf_work(cfg["sdf"], M, kind))
            bound = _bound(*work)
            _line("eval", check="kernel_vs_plain_at_bake_size", name=kind, M=M,
                  raylen=f"{raylen:.5f}", ok=ok,
                  errors=json.dumps(err, sort_keys=True).replace(" ", ""), tol=tol,
                  zeroed_tile_fault=json.dumps(fault, sort_keys=True).replace(" ", ""),
                  entry_ms=f"{entry:.3f}", kernel_only_ms=f"{kernel:.3f}",
                  wrapper_ms=f"{entry - kernel:.3f}", plain_ms=f"{plain:.3f}",
                  bound_ms=f"{bound['bound_ms']:.3f}", bound_by=bound["bound_by"])
            _require(ok, f"{kind} disagrees with its plain version at the bake's "
                         f"M = {M}: {err}")
            out.setdefault(kind, []).append({
                "M": M, "max_abs_err": max_abs, "ms": entry, "kernel_ms": kernel,
                "plain_ms": plain, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"]})
    return out


def _profile_chunks(runner, dev, n_chunks=8):
    """``render_rays_chunked`` on n_chunks chunks of frame 0 under
    torch.profiler: per chunk, the CUDA-event time, the device busy time
    (the union of the device intervals) and each kernel range's device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fmov_pose_torch.profile_step import busy_us, range_split
    ro, rd = _middle_rays(runner, n_chunks)
    runner.render_rays_chunked(ro, rd)  # warm-up
    with tempfile.TemporaryDirectory() as d:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            a.record()
            runner.render_rays_chunked(ro, rd)
            b.record()
            b.synchronize()
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    busy, n_kernels = busy_us(events)
    chunk_ms = a.elapsed_time(b) / n_chunks
    ranges = {r: round(sum(per.values()) / 1e3 / n_chunks, 4)
              for r, per in sorted(range_split(events).items())}
    _line("eval", profile="render_rays_chunked", chunks=n_chunks,
          chunk_ms=f"{chunk_ms:.3f}", device_busy_ms=f"{busy / 1e3 / n_chunks:.3f}",
          idle_share=f"{1 - busy / 1e3 / n_chunks / chunk_ms:.3f}",
          kernels_per_chunk=n_kernels / n_chunks,
          ranges_device_ms=json.dumps(ranges).replace(" ", ""))


def phase_eval(dev, smi, tmp, two):
    """The eval and export methods on the two-phase command's Runners, in
    its work dir, each called directly (uncaught): the phase-2 Runner
    (fast global conf: K1 in the up-sampler, K4 and K8) renders
    validate_image at levels 1 and 4, render_poses, interpolate_view,
    save_alignment_materials, the textured 64^3 mesh (tex_size 1024: K4
    and K8 at M = 1,048,576) and the gradient report (K4/K5/K8 three
    times, K9 once: only the color loss reaches the color network); the
    CLI's validate_poses on phase 1's checkpoint, then that Runner's
    validate_image at level 4 (K2) and save_poses; the slice-4
    conf (n_outside = 32) on phase 2's checkpoint, validate_image at level
    4 (K1, K4, K6).  Then the eval render through the kernels against the
    plain versions on CPU copies, K1, K4 and K8 against their plain
    versions at the bake chunk's sizes, and a profile of 8 chunks.
    Returns the launches by kernel and the bake-size entries of the
    kernels line."""
    import cv2 as cv
    import numpy as np
    import torch
    from fmov_pose_torch import exp_runner
    from fmov_pose_torch.pipeline import textured
    from fmov_pose_torch.profile_step import conf_with_outside
    from fmov_pose_torch.train.runner import Runner
    r2, work, confs = two["runner"], two["work"], two["confs"]
    p2_dir = r2.base_exp_dir  # relative to the work dir
    r = r2.model_cfg["renderer"]
    per_chunk = r.n_samples + r.n_importance
    k1_per_chunk = r.up_sample_steps  # the coarse pass and all but the last step
    cwd = os.getcwd()
    os.chdir(work)
    try:
        _zero_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        _line("eval", runner="phase2", conf=confs[1], iter_step=r2.iter_step,
              batch=r2.batch_size, samples=f"{r.n_samples}+{r.n_importance}",
              m_per_chunk=r2.batch_size * per_chunk, perturb=r.perturb)
        for level in (1, 4):
            n = r2.dataset.H // level * (r2.dataset.W // level)
            ch = -(-n // r2.batch_size)
            psnr, _, _ = _eval_call(f"validate_image_level{level}",
                                    lambda: r2.validate_image(0, resolution_level=level),
                                    dev, r2, K1=k1_per_chunk * ch, K4=ch, K8=ch)
            _check_psnr(f"validate_image_level{level}", psnr, p2_dir, level, r2)
        pose_dir, launches, _ = _eval_call("render_poses", r2.render_poses, dev, r2)
        _require(launches["K4"] == launches["K8"] > 0
                 and launches["K1"] == k1_per_chunk * launches["K4"],
                 f"render_poses launched {launches}")
        gif = os.path.join(p2_dir, f"poses_{r2.iter_step}.gif")
        _files_line("render_poses", [pose_dir, os.path.join(p2_dir, "normal_vis")]
                    + ([gif] if os.path.exists(gif) else []))
        _require(len(os.listdir(pose_dir)) == len(os.listdir(os.path.join(
            p2_dir, "normal_vis"))) == TWO_PHASE_FRAMES, "render_poses wrote too few frames")
        _line("eval", call="render_poses", gif_written=os.path.exists(gif))
        mp4, launches, _ = _eval_call("interpolate_view_0_7_6",
                                      lambda: r2.interpolate_view(0, TWO_PHASE_FRAMES - 1,
                                                                  n_frames=6), dev, r2)
        cap = cv.VideoCapture(mp4)
        frames = 0
        while cap.read()[0]:
            frames += 1
        cap.release()
        _line("eval", call="interpolate_view_0_7_6", mp4_frames=frames)
        _files_line("interpolate_view_0_7_6", [mp4])
        _require(frames == 12, f"the video has {frames} frames, not 12")
        pts_path, _, _ = _eval_call("save_alignment_materials", r2.save_alignment_materials,
                                    dev, r2)
        pts = np.load(pts_path)
        _line("eval", call="save_alignment_materials", points=list(pts.shape))
        _require(pts.ndim == 2 and pts.shape[1] == 4 and len(pts) > 0
                 and bool(np.isfinite(pts).all()), f"world points {pts.shape}")
        _files_line("save_alignment_materials", [pts_path])

        ply = []

        def bake():
            ply.append(r2.validate_mesh(resolution=64))
            return textured.textured_mesh(ply[0], r2, tex_size=BAKE_TEX)
        tex_dir, launches, sizes = _eval_call("validate_textured_mesh_64_tex1024", bake,
                                              dev, r2)
        bake_chunks = sizes.get("K4", {}).get(BAKE_M, 0)
        _require(bake_chunks > 0 and sizes.get("K8", {}).get(BAKE_M, 0) == bake_chunks,
                 f"the bake did not launch K4 and K8 at M = {BAKE_M}: {sizes}")
        tex = cv.imread(os.path.join(tex_dir, "material_0.png"))
        _line("eval", call="validate_textured_mesh_64_tex1024", texture=list(tex.shape),
              texels_filled=f"{float((tex > 0).any(-1).mean()):.4f}",
              bake_chunks=bake_chunks)
        _require(tex.shape == (BAKE_TEX, BAKE_TEX, 3) and (tex > 0).any(),
                 "an empty texture")
        _files_line("validate_textured_mesh_64_tex1024",
                    [os.path.join(tex_dir, f) for f in sorted(os.listdir(tex_dir))])
        # K9 once: only the color loss reaches the color network
        report, _, _ = _eval_call("gradient_analysis_report",
                                  lambda: r2.gradient_analysis_report(0), dev, r2,
                                  K4=3, K5=3, K8=3, K9=1)
        _line("eval", call="gradient_analysis_report", report=json.dumps(
            {k: {n: [float(f"{v:.4g}") for v in t] for n, t in st.items()}
             for k, st in report.items()}).replace(" ", ""))
        _require(all(np.isfinite(t).all() for st in report.values() for t in st.values()),
                 "non-finite gradient statistics")

        argv = ["--mode", "validate_poses", "--conf", confs[0], "--case", "SYN_ori",
                "--global_conf", confs[1], "--is_continue"]
        r1, _, _ = _eval_call("cli_validate_poses_phase1",
                              lambda: exp_runner.main(argv, device=dev), dev)
        stats = os.path.join(r1.base_exp_dir, "poses", f"stats_{r1.iter_step:06d}.json")
        with open(stats) as f:
            st = json.load(f)
        _line("eval", call="cli_validate_poses_phase1", argv=repr(" ".join(argv)),
              iter_step=r1.iter_step, current_image=r1.current_image,
              ate_vs_orbit=f"{st['ate_rmse']:.5f}", rpe_trans=f"{st['rpe_trans']:.5f}",
              rpe_rot_deg=f"{st['rpe_rot_deg']:.4f}")
        _require(r1.current_image == TWO_PHASE_FRAMES and np.isfinite(st["ate_rmse"]),
                 f"phase 1's validate_poses: {st}")
        _files_line("cli_validate_poses_phase1", [stats])
        n4 = -(-(r1.dataset.H // 4) * (r1.dataset.W // 4) // r1.batch_size)
        psnr, _, _ = _eval_call("phase1_validate_image_level4",
                                lambda: r1.validate_image(resolution_level=4), dev, r1,
                                K2=n4)
        _check_psnr("phase1_validate_image_level4", psnr, r1.base_exp_dir, 4, r1)
        pose_out, _, _ = _eval_call("phase1_save_poses", r1.save_poses, dev)
        _files_line("phase1_save_poses", [os.path.join(pose_out, f)
                                          for f in sorted(os.listdir(pose_out))
                                          if f.endswith(".npy")])
        del r1

        conf4 = conf_with_outside(confs[1], N_OUTSIDE, "confs")
        r4 = Runner(conf4, mode="train", case="SYN", exp_dir=p2_dir, has_global_conf=True,
                    is_continue=True, seed=SEED, device=dev)
        _require(r4.iter_step == r2.iter_step, "the slice-4 conf did not resume phase 2")
        ch = -(-(r4.dataset.H // 4) * (r4.dataset.W // 4) // r4.batch_size)
        psnr, _, _ = _eval_call("slice4_conf_validate_image_level4",
                                lambda: r4.validate_image(resolution_level=4), dev, r4,
                                K1=k1_per_chunk * ch, K4=ch, K6=ch)
        _check_psnr("slice4_conf_validate_image_level4", psnr, p2_dir, 4, r4)
        del r4
        counts = _counters()
        peak = torch.cuda.max_memory_allocated(dev)
        _line("eval", launches_total=json.dumps(counts).replace(" ", ""),
              peak_mem_gib=f"{peak / 2**30:.3f}", card=repr(smi))

        # the same state on the CPU (a CUDA generator's checkpoint does not
        # load there): phase 2's parameters copied into a fresh CPU Runner
        cpu = Runner(confs[1], mode="eval", case="SYN", exp_dir=p2_dir,
                     has_global_conf=True, seed=SEED, device="cpu")
        with torch.no_grad():
            cpu.state.flat.copy_(r2.state.flat.detach().cpu())
        cpu.iter_step = r2.iter_step
        _eval_route_check(r2, cpu, dev)
        del cpu
        bake_chunk = _bake_size_check(r2, dev, ply[0])
        _profile_chunks(r2, dev)
    finally:
        os.chdir(cwd)
    return counts, bake_chunk


# the scanned phase-2 dispatch: k = train.scan_chunk's default, 3 chunks a
# Runner (checkpoints at each chunk edge), the per-step loop timed beside it
SCAN_K = 100
SCAN_CHUNKS = 3
PER_STEP_STEPS = 200
# the quality harness at a short schedule: every frame admitted in phase 1
# (mesh warm-up 50, then one frame every 30 steps), phase 2 two chunks
QUALITY_ARGS = ["--frames", "6", "--res", "128", "--p1_iters", "400",
                "--max_pro", "30", "--mesh_warmup", "50", "--p2_iters", "200"]


def _scan_runner(conf, exp, scene, dev):
    """A Runner on ``conf`` trained SCAN_CHUNKS chunks of SCAN_K steps from
    step 0 (no LR warm-up, a checkpoint at every chunk edge), on the scan
    path."""
    from fmov_pose_torch.train.runner import Runner
    runner = Runner(conf, mode="train", case="orbit_smoke", exp_dir=exp, seed=SEED,
                    device=dev, scene=scene)
    runner.end_iter, runner.warm_up_end = SCAN_K * SCAN_CHUNKS, 0.0
    runner.save_freq = SCAN_K
    return runner


def _scan_state(runner):
    """The tensors a scanned step writes, the generator's state and the counts."""
    st = runner.state
    return ({"flat": st.flat.detach().clone(), "mu": st.opt.mu.clone(),
             "nu": st.opt.nu.clone()}, st.generator.get_state(), st.iter_step,
            st.opt.step)


def _set_scan_state(runner, saved):
    import torch
    tensors, gen, it, adam_step = saved
    st = runner.state
    with torch.no_grad():
        st.flat.copy_(tensors["flat"])
        st.opt.mu.copy_(tensors["mu"])
        st.opt.nu.copy_(tensors["nu"])
    st.generator.set_state(gen)
    st.iter_step, st.opt.step = it, adam_step


def _state_differ(a, b):
    """The names among flat, mu, nu and the generator's state that are not
    bitwise equal."""
    import torch
    out = [k for k in a[0] if not torch.equal(a[0][k], b[0][k])]
    if not torch.equal(a[1], b[1]):
        out.append("generator")
    if a[2:] != b[2:]:
        out.append("counts")
    return out


def _chunk_leaf_rule(runner, before, a, b):
    """The leaf rule on two chunks' parameter moves from ``before``."""
    from fmov_pose_torch import convert
    from fmov_pose_torch.ops import fused_sdf
    layout = runner.state.layout
    moves = [dict(convert.flatten(layout.views((s[0]["flat"] - before[0]["flat"]).cpu())))
             for s in (a, b)]
    return fused_sdf.leaf_rule(*moves)


def _graph_vs_eager(name, runner, per_step):
    """One chunk eagerly and one through the captured step, from the same
    state and generator state: bitwise equal (or the leaf rule, reported),
    the same frames, each kernel launched per step in the graph as in the
    eager step; two replays' frames."""
    import torch
    from fmov_pose_torch.train import graph as graph_mod
    n_cur = runner.current_image
    before = _scan_state(runner)
    res = {}
    for mode in ("eager", "graph"):
        _set_scan_state(runner, before)
        scan = runner.scan_steps(SCAN_K, capture=(mode == "graph"))
        _zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = scan(runner.state, n_cur)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        res[mode] = (_scan_state(runner), mean.clone(), scan.carry.frames.clone(),
                     _counters(), seconds, scan)
    (s_e, m_e, f_e, c_e, t_e, _), (s_g, m_g, f_g, c_g, t_g, scan) = res["eager"], res["graph"]
    g = scan.graph
    per_replay = graph_mod.launches_by_kernel(g.per_replay)
    warmup = graph_mod.launches_by_kernel(g.warmup_launches)
    differ = _state_differ(s_e, s_g)
    metrics_equal = bool(torch.equal(m_e, m_g))
    frames_equal = bool(torch.equal(f_e, f_g))
    rule = None if not differ else _chunk_leaf_rule(runner, before, s_e, s_g)
    frames = f_g.cpu().tolist()
    # two replays: the frames drawn by consecutive steps of the chunk, and
    # a second chunk of replays against the first
    scan(runner.state, n_cur)
    frames2 = scan.carry.frames.cpu().tolist()
    repeats = sum(a == b for a, b in zip(frames[:-1], frames[1:]))
    hist = collections.Counter(frames)
    _line("scan", conf=name, check="graph_vs_eager", k=SCAN_K,
          state_differ=json.dumps(differ).replace(" ", ""),
          metrics_bitwise=metrics_equal, frames_equal=frames_equal,
          leaf_rule=None if rule is None else json.dumps(
              {k: rule[k] for k in ("ok", "worst", "worst_rel", "failed")}).replace(" ", ""),
          eager_launches=json.dumps(c_e).replace(" ", ""),
          graph_launches=json.dumps(c_g).replace(" ", ""),
          per_replay=json.dumps(per_replay).replace(" ", ""),
          warmup=json.dumps(warmup).replace(" ", ""),
          frames_first10=json.dumps(frames[:10]).replace(" ", ""),
          frames_second_chunk_first10=json.dumps(frames2[:10]).replace(" ", ""),
          frame_hist=json.dumps(dict(sorted(hist.items()))).replace(" ", ""),
          consecutive_repeats=repeats, eager_s=f"{t_e:.3f}", graph_s=f"{t_g:.3f}",
          loss_eager=f"{float(m_e[0]):.6f}", loss_graph=f"{float(m_g[0]):.6f}")
    _require(frames_equal and (not differ or rule["ok"]) and (metrics_equal or rule),
             f"{name}: the graphed chunk differs from the eager one: {differ} {rule}")
    _require(min(frames) >= 0 and max(frames) < n_cur and len(hist) >= n_cur // 2
             and repeats < SCAN_K // 2 and frames2 != frames,
             f"{name}: the replays' frames {frames} then {frames2}")
    for key, n in per_replay.items():
        want = per_step.get(key, 0)
        _require(n == want and c_e[key] == SCAN_K * want,
                 f"{name}: {key} launched {n} times a replay, {c_e[key]} in the "
                 f"eager chunk of {SCAN_K} (expected {want} a step)")
        _require(c_g[key] == warmup[key] + SCAN_K * n,
                 f"{name}: {key} counted {c_g[key]} in the graphed chunk")
    return per_replay


def _scan_resume(name, conf, tmp, scene, dev, per_step):
    """Runner A trains 3 chunks through the graph, a checkpoint at each
    edge; runner B loads A's checkpoint of the second edge and trains the
    third chunk through its own capture: A's and B's states bitwise equal.
    Returns A (its launches, chunk times and peak memory read)."""
    import torch
    from fmov_pose_torch.train import graph as graph_mod
    a = _scan_runner(conf, os.path.join(tmp, f"scan_{name}_a"), scene, dev)
    _require(a._scan_eligible() == SCAN_K, f"{name}: not on the scan path")
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    t0 = time.perf_counter()
    a.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev)
    ckpts = sorted(os.listdir(os.path.join(a.base_exp_dir, "checkpoints")))
    edge = os.path.join(a.base_exp_dir, "checkpoints",
                        f"ckpt_{a.current_image:06d}_{(SCAN_CHUNKS - 1) * SCAN_K:06d}.ckpt")
    warmup = graph_mod.launches_by_kernel(a.scan.graph.warmup_launches)
    b = _scan_runner(conf, os.path.join(tmp, f"scan_{name}_b"), scene, dev)
    b.load_checkpoint(edge)
    b.train()
    differ = _state_differ(_scan_state(a), _scan_state(b))
    history = a.history["loss"]
    _line("scan", conf=name, check="train_and_resume", dispatch=a.dispatch,
          iter_step=a.iter_step, chunks=len(history),
          chunk_losses=json.dumps([round(v, 6) for v in history]).replace(" ", ""),
          checkpoints=json.dumps(ckpts).replace(" ", ""),
          resumed_from=os.path.basename(edge), resumed_iter=b.iter_step,
          resumed_differ=json.dumps(differ).replace(" ", ""),
          launches=json.dumps(counts).replace(" ", ""),
          wall_s=f"{wall:.2f}", peak_mem_gib=f"{peak / 2**30:.3f}")
    _require(a.dispatch == f"scan x{SCAN_K}" and a.iter_step == SCAN_K * SCAN_CHUNKS
             and len(history) == SCAN_CHUNKS and all(math.isfinite(v) for v in history),
             f"{name}: the scanned run {a.dispatch} {a.iter_step} {history}")
    _require(b.iter_step == a.iter_step and not differ,
             f"{name}: the run resumed at a chunk edge differs in {differ}")
    for key, n in counts.items():
        want = per_step.get(key, 0) * SCAN_K * SCAN_CHUNKS + warmup[key]
        _require(n == want, f"{name}: {key} launched {n} times in the scanned run "
                            f"(expected {want}: the warm-up's {warmup[key]} and "
                            f"{per_step.get(key, 0)} in each of "
                            f"{SCAN_K * SCAN_CHUNKS} replays)")
    _require(all(warmup[k] == graph_mod.WARMUP_STEPS * n for k, n in per_step.items()),
             f"{name}: the warm-up launched {warmup}")
    return a, counts, wall, peak


def _per_step_ms(name, conf, tmp, scene, dev):
    """The per-step loop (``train.scan_steps = False``) on the same conf:
    its median step time from events."""
    runner = _scan_runner(conf, os.path.join(tmp, f"scan_{name}_p"), scene, dev)
    runner.end_iter = PER_STEP_STEPS
    runner.conf.put("train.scan_steps", False)
    runner.train()
    _require(runner.dispatch == "per-step", f"{name}: {runner.dispatch}")
    return statistics.median(runner.step_ms), runner.train_seconds


def phase_scan(dev, smi, scene, tmp):
    """The JAX Runner's default phase-2 dispatch, 100 steps a dispatch as
    one captured step replayed: on the reference conf (K1 4 times a step)
    and on the fast conf without the grid (the harness's --fused phase 2:
    K4, K5, K8, K9 once a step, K1 4 times in the up-sampler).  Each: a graphed chunk against an eager
    one, a 3-chunk run resumed bitwise at a chunk edge, ms a step graphed
    and per-step."""
    fused = os.path.join(tmp, "fused_no_grid.conf")
    _conf_copy(FAST_CONF, fused, {"occupancy_sampling": "False"})
    out = {}
    for name, conf, per_step in (
            ("reference", CONF, {"K1": 4}),
            ("fused", fused, {"K1": 4, "K4": 1, "K5": 1, "K8": 1, "K9": 1})):
        runner = _scan_runner(conf, os.path.join(tmp, f"scan_{name}_g"), scene, dev)
        per_replay = _graph_vs_eager(name, runner, per_step)
        del runner
        a, counts, wall, peak = _scan_resume(name, conf, tmp, scene, dev, per_step)
        graph_ms = statistics.median(a.step_ms) / SCAN_K
        per_ms, per_wall = _per_step_ms(name, conf, tmp, scene, dev)
        _line("scan", conf=name, check="ms_a_step", graphed_ms=f"{graph_ms:.3f}",
              chunk_ms=json.dumps([round(v, 3) for v in a.step_ms]).replace(" ", ""),
              per_step_ms=f"{per_ms:.3f}", speedup=f"{per_ms / graph_ms:.2f}",
              graphed_wall_s=f"{wall:.2f}", per_step_wall_s=f"{per_wall:.2f}",
              per_step_steps=PER_STEP_STEPS, card=repr(smi))
        out[name] = {"launches": counts, "per_replay": per_replay, "graph_ms": graph_ms,
                     "per_step_ms": per_ms}
        del a
    return out


def phase_quality(dev, smi, tmp):
    """The quality harness (``python -m fmov_pose_torch.quality``) at a
    short schedule, all frames admitted: finite metrics, phase 2 on the
    scan path."""
    import contextlib
    from fmov_pose_torch import quality
    t0 = time.perf_counter()
    # the harness prints its JSON result: to stderr here, so that standard
    # output keeps one JSON object before the last line, the kernels'
    with contextlib.redirect_stdout(sys.stderr):
        res, orbit = quality.main(QUALITY_ARGS + ["--work", os.path.join(tmp, "quality")],
                                  device=dev)
    keys = ("p1_ate", "p2_psnr", "p2_ate", "p2_rpe_trans", "p2_rpe_rot_deg",
            "mesh_chamfer_aligned")
    _line("quality", args=json.dumps(QUALITY_ARGS).replace(" ", ""),
          seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: res[k] for k in keys + ("mesh_verts", "p2_dispatch", "pipeline_time_s")})
    _require(orbit is not None, "quality: phase 1 has no annotated poses to evaluate")
    _line("quality", check="phase1_orbit",
          **{k: json.dumps(v).replace(" ", "") for k, v in orbit.items()})
    _require(all(res[k] is not None and math.isfinite(res[k]) for k in keys)
             and res["mesh_verts"] > 100, f"quality: non-finite metrics {res}")
    _require(res["p2_dispatch"] == f"scan x{SCAN_K}",
             f"quality: phase 2 ran {res['p2_dispatch']}")
    return res


def _bf16_fields_check(runner, dev):
    """The bf16 SDF (value and input gradient) and color network at the
    conf's width on the card against the same functions on CPU copies:
    both round to bf16 between layers, so they differ where their f32
    sums straddle a bf16 rounding boundary; max error at most 2e-2 of
    max|ref|, the median at most 1e-3 of it."""
    import torch
    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    g = torch.Generator(device="cpu").manual_seed(SEED)
    x = (torch.rand((8192, 3), generator=g) - 0.5) * 1.6
    sdf_cfg, color_cfg = runner.model_cfg["sdf"], runner.model_cfg["color"]
    out = {}
    for where in ("cuda", "cpu"):
        p = runner.state.params
        if where == "cpu":
            p = convert.unflatten((n, t.detach().cpu()) for n, t in convert.flatten(p))
        xd = x.to(dev if where == "cuda" else "cpu")
        with torch.no_grad():
            sdf_out, grad = nets.sdf_apply_with_gradient(p["sdf"], sdf_cfg, xd)
            color = nets.color_apply(p["color"], color_cfg, xd, grad, -xd,
                                     sdf_out[:, 1:])
        out[where] = [t.float().cpu() for t in (sdf_out, grad, color)]
    errs = {}
    for name, ref, got in zip(("sdf", "sdf_grad", "color"), out["cpu"], out["cuda"]):
        d = (got - ref).abs() / ref.abs().max()
        errs[name] = (float(d.max()), float(d.median()))
    _line("bf16", check="fields_card_vs_cpu", points=len(x),
          **{k: f"max={v[0]:.2e},median={v[1]:.2e}" for k, v in errs.items()},
          tol="max<2e-2,median<1e-3")
    _require(all(m < 2e-2 and med < 1e-3 for m, med in errs.values()),
             f"bf16 fields on the card against the CPU: {errs}")


def phase_bf16(dev, smi, scene, tmp, f32_step_ms, f32_graph_ms):
    """Slice 1's conf with bf16 activations (``train.compute_dtype``): the
    fields on the card against CPU copies, 50 per-step steps and one
    300-step scanned run, against the f32 runs of this call (slice's
    per-step median, scan's graphed reference conf)."""
    import torch
    from fmov_pose_torch import quality
    from fmov_pose_torch.train.runner import Runner
    conf = os.path.join(tmp, "ho3d_global_womask_bf16.conf")
    quality.shrink_conf(CONF, conf, quality.train_setting("compute_dtype", "bfloat16"))
    runner = Runner(conf, mode="train", case="orbit_smoke",
                    exp_dir=os.path.join(tmp, "bf16_step"), seed=SEED, device=dev,
                    scene=scene)
    _require(all(runner.model_cfg[k]["compute_dtype"] == "bfloat16"
                 for k in ("sdf", "color", "nerf")), "the conf copy sets bf16")
    runner.end_iter, runner.warm_up_end = STEPS, 0.0
    runner.conf.put("train.scan_steps", False)
    _bf16_fields_check(runner, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    runner.train()
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = _history_lines("bf16", runner, smi,
                             launches=json.dumps(counts).replace(" ", ""))
    _perf_line("bf16", runner, step_ms, peak, smi)
    _line("bf16", check="per_step_vs_f32", bf16_ms=f"{step_ms:.3f}",
          f32_ms=f"{f32_step_ms:.3f}", ratio=f"{f32_step_ms / step_ms:.3f}")
    _require(counts["K1"] == 4 * STEPS
             and all(v == 0 for k, v in counts.items() if k != "K1"),
             f"bf16 per-step launches: {counts}")
    del runner
    scan = _scan_runner(conf, os.path.join(tmp, "bf16_scan"), scene, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    scan.train()
    scan_counts = _counters()
    scan_peak = torch.cuda.max_memory_allocated(dev)
    loss = [float(v) for v in scan.history["loss"]]
    color = scan.history["color_loss"]
    graph_ms = statistics.median(scan.step_ms) / SCAN_K
    _line("bf16", check="scan", dispatch=scan.dispatch, chunks=len(loss),
          loss=json.dumps([round(v, 5) for v in loss]).replace(" ", ""),
          launches=json.dumps(scan_counts).replace(" ", ""),
          graphed_ms=f"{graph_ms:.3f}", f32_graphed_ms=f"{f32_graph_ms:.3f}",
          ratio=f"{f32_graph_ms / graph_ms:.3f}",
          chunk_ms=json.dumps([round(v, 3) for v in scan.step_ms]).replace(" ", ""),
          peak_mem_gib=f"{scan_peak / 2**30:.3f}", card=repr(smi))
    _require(scan.dispatch == f"scan x{SCAN_K}" and len(loss) == SCAN_CHUNKS
             and all(math.isfinite(v) for v in loss) and color[-1] < color[0],
             f"bf16 scanned run: {scan.dispatch}, losses {loss}, color {color}")
    n_k1 = 4 * (SCAN_K * SCAN_CHUNKS + 2)  # 2 warm-up steps, then the replays
    _require(scan_counts["K1"] == n_k1
             and all(v == 0 for k, v in scan_counts.items() if k != "K1"),
             f"bf16 scanned launches: {scan_counts}, K1 should be {n_k1}")
    return {"per_step": counts["K1"], "scan": scan_counts["K1"]}


# data parallelism (parallel/dp.py) on the one card: two ranks in child
# processes over gloo (NCCL refuses two ranks on one device), then one
# rank over NCCL with the all-reduces captured into the scanned step
DP_WORLD = 2
DP_SCAN_K = 50
DP_CHILD_TIMEOUT_S = 400
DP_LOSS_TOL = 1e-3    # a data-parallel step against one process, same kernels
DP_ROUTE_TOL = 1e-2   # the same where the ranks' smaller batch takes other kernels


def _clone_state(st):
    """A copy of a training state: its own tensors and generator."""
    import torch
    from fmov_pose_torch.train import optim
    gen = torch.Generator(device=st.flat.device)
    gen.set_state(st.generator.get_state())
    out = dataclasses.replace(
        st, flat=st.flat.detach().clone().requires_grad_(True),
        opt=optim.AdamState(st.opt.step, st.opt.mu.clone(), st.opt.nu.clone()),
        pose_static={k: v.clone() for k, v in st.pose_static.items()},
        generator=gen, ray_generator=None)
    if st.bank_flat is not None:
        po = st.pose_opt
        out.bank_flat = st.bank_flat.detach().clone().requires_grad_(True)
        out.bank_static = dict(st.bank_static)
        out.pose_opt = optim.SegAdamState(po.step.clone(), po.mu.clone(), po.nu.clone())
    return out


def _state_digest(st):
    """sha256 of every tensor a step writes or reads (``state_buffers``)."""
    import hashlib
    from fmov_pose_torch.train import step as step_mod
    written, read = step_mod.state_buffers(st)
    h = hashlib.sha256()
    for t in written + read:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _moment_rule(runner, ref, got):
    """The leaf rule on the first Adam moments of two states (after a first
    step, 0.1 x the gated gradient), the flat leaves and the bank's."""
    from fmov_pose_torch import convert
    from fmov_pose_torch.ops import fused_sdf
    pairs = [(runner.state.layout, ref.opt.mu, got.opt.mu)]
    if got.bank_flat is not None:
        pairs.append((runner.state.bank_layout, ref.pose_opt.mu, got.pose_opt.mu))
    ref_l, got_l = {}, {}
    for i, (layout, a, b) in enumerate(pairs):
        ref_l.update({f"{i}.{n}": t for n, t in convert.flatten(layout.views(a.cpu()))})
        got_l.update({f"{i}.{n}": t for n, t in convert.flatten(layout.views(b.cpu()))})
    return fused_sdf.leaf_rule(ref_l, got_l)


class _CountCollectives:
    """Counts ``torch.distributed.all_reduce`` calls inside the block."""

    def __enter__(self):
        import torch.distributed as dist
        self.n, self._real = 0, dist.all_reduce

        def counted(*a, **kw):
            self.n += 1
            return self._real(*a, **kw)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_reduce = self._real


def _dp_runner(conf, scene, dev, exp, schedule=None):
    from fmov_pose_torch.train.runner import Runner
    runner = Runner(conf, mode="train", case="orbit_smoke", exp_dir=exp, seed=SEED,
                    device=dev, scene=scene)
    runner.end_iter, runner.warm_up_end = STEPS, 0.0
    runner.conf.put("train.scan_steps", False)
    for key, value in (schedule or {}).items():
        setattr(runner, key, value)
        runner.conf.put(f"train.{key}", value)
    _require(runner.use_dp, f"{conf}: no data parallelism over {DP_WORLD} ranks")
    return runner


def _dp_step_check(name, conf, scene, dev, tmp, rank, flow, tol, once, schedule=None):
    """One data-parallel photo step (and with ``flow`` one flow step after
    it) on a given global batch of pixels, perturbation 0, each rank its
    rows, launching each kernel of ``once`` once and no other; rank 0 also
    runs the one-process step on the whole batch from the same state.
    Returns the rank's result (the state's digest, and on rank 0 the
    losses and the leaf rule on the moments)."""
    import numpy as np
    import torch
    from fmov_pose_torch.train import step as step_mod
    runner = _dp_runner(conf, scene, dev, os.path.join(tmp, f"dp_rank{rank}", name),
                        schedule)
    runner.model_cfg["renderer"] = runner.model_cfg["renderer"]._replace(perturb=0.0)
    runner.current_image = scene.n_images
    st = runner.state
    ref = _clone_state(st) if rank == 0 else None
    bufs = (runner.images_dev, runner.masks_dev, runner.intr_inv_dev, runner.bbox_dev)
    B, img_id = runner.batch_size, 0
    rng = np.random.default_rng(SEED)
    y0, y1, x0, x1 = (int(v) for v in scene.mask_bboxes[img_id])
    px, py, apx, apy = (torch.as_tensor(rng.integers(lo, hi, B), device=dev)
                        for lo, hi in ((x0, x1), (y0, y1), (x0, x1), (y0, y1)))
    n = B // DP_WORLD
    mine = slice(rank * n, (rank + 1) * n)
    S = runner.n_segments
    scalars = step_mod.StepScalars(
        lr=runner.learning_rate, cos_anneal=1.0, seg_touch=np.ones(S, np.float32),
        seg_freeze=np.ones(S, np.float32),
        seg_lr=np.full(S, runner.pose_lr, np.float32))
    add = (apx[mine], apy[mine]) if runner.maintain_shape else None
    add_all = (apx, apy) if runner.maintain_shape else None
    steps = [("photo", lambda s, fn: fn(s, scalars, img_id, 1, pixels=(px[mine], py[mine]),
                                        add_pixels=add),
              lambda s, fn: fn(s, scalars, img_id, 1, pixels=(px, py), add_pixels=add_all))]
    if flow:
        pair = runner._sample_flow_pair(1)  # the host RNG: the same on both ranks
        _require(pair is not None, "no match pairs for frame 1")
        img, pixels, pixels_corr = pair
        pp_ = np.concatenate([pixels_corr, pixels], -1)
        steps.append(("flow", lambda s, fn: fn(s, scalars, img, 1, 0, pp_, add),
                      lambda s, fn: fn(s, scalars, img, 1, 0, pp_, add_all)))
    out = {"steps": []}
    ref_photo = step_mod.make_photo_step(runner.step_cfg, *bufs)
    ref_flow = step_mod.make_flow_step(runner.step_cfg, *bufs)
    with torch.no_grad():
        grid = st.pose_static.get("occ_grid")
    for kind, dp_call, ref_call in steps:
        fn = runner.flow_step if kind == "flow" else runner.photo_step
        _zero_counters()
        with _CountCollectives() as cc:
            _, m = dp_call(st, fn)
        loss = float(m["loss"])
        res = {"kind": kind, "loss": loss, "digest": _state_digest(st),
               "collectives": cc.n, "launches": _counters()}
        _require(all(v == (k in once) for k, v in res["launches"].items()),
                 f"{name} {kind}: launches {res['launches']}, expected {once} once")
        if rank == 0:
            _, mr = ref_call(ref, ref_flow if kind == "flow" else ref_photo)
            rel = abs(loss - float(mr["loss"])) / abs(float(mr["loss"]))
            rule = _moment_rule(runner, ref, st)
            res.update(loss_one_process=float(mr["loss"]), rel=rel,
                       leaf_rule={k: rule[k] for k in ("ok", "worst", "worst_rel",
                                                         "failed")})
            _line("dp", part="gloo", check=f"{name}_{kind}_step_vs_one_process",
                  rays_per_rank=n, loss_dp=f"{loss:.6f}", loss_one=f"{float(mr['loss']):.6f}",
                  rel=f"{rel:.2e}", tol=tol, collectives=cc.n,
                  dp_launches=json.dumps(res["launches"]).replace(" ", ""),
                  leaf_rule=json.dumps(res["leaf_rule"]).replace(" ", ""))
            _require(math.isfinite(loss) and rel < tol,
                     f"{name} {kind}: the data-parallel loss {loss} against {mr['loss']}")
            _require(rule["ok"] or tol != DP_LOSS_TOL,
                     f"{name} {kind}: the leaf rule on the moments: {rule}")
        out["steps"].append(res)
    out["grid_all_ones"] = bool(grid is None or (grid == 1).all())
    return out


def _dp_train(name, conf, scene, dev, tmp, rank, schedule=None, occ_update_freq=None):
    """``Runner.train`` of STEPS steps on this rank; its launches (counts
    zeroed just before), the frames it planned, the first ray batches'
    digests, the state's digest, the files it wrote, times and memory."""
    import hashlib
    import torch
    from fmov_pose_torch.data import rays as raygen
    exp = os.path.join(tmp, f"dp_rank{rank}", f"train_{name}")
    runner = _dp_runner(conf, scene, dev, exp, schedule)
    if occ_update_freq:
        runner.occ_update_freq = occ_update_freq
    plans, rays = [], []
    plan_step, gen_random_rays = runner._plan_step, raygen.gen_random_rays

    def recorded_plan():
        out = plan_step()
        plans.append((out[3], bool(out[1])))
        return out

    def recorded_rays(*a, **kw):
        data = gen_random_rays(*a, **kw)
        if len(rays) < 5:
            rays.append(hashlib.sha256(data.detach().cpu().numpy().tobytes()).hexdigest())
        return data

    runner._plan_step, raygen.gen_random_rays = recorded_plan, recorded_rays
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    try:
        with _CountCollectives() as cc:
            runner.train()
    finally:
        raygen.gen_random_rays = gen_random_rays
    counts = _counters()
    peak = torch.cuda.max_memory_allocated(dev)
    h = runner.history
    files = [os.path.relpath(os.path.join(d, f), exp)
             for d, _, fs in os.walk(runner.base_exp_dir) for f in fs]
    step_ms = statistics.median(runner.step_ms)
    _line("dp", part="gloo", check=f"train_{name}", rank=rank, dispatch=repr(runner.dispatch),
          steps=len(h["loss"]), loss_first=f"{h['loss'][0]:.5f}",
          loss_last=f"{h['loss'][-1]:.5f}", flow_steps=runner.flow_steps,
          current_image=runner.current_image, occ_refreshes=runner.occ_refreshes,
          launches=json.dumps(counts).replace(" ", ""),
          all_reduces_per_step=f"{cc.n / len(h['loss']):.2f}",
          median_step_ms=f"{step_ms:.2f}", peak_mem_gib=f"{peak / 2**30:.3f}",
          files_written=len(files))
    return {"losses": h["loss"], "color": h["color_loss"], "plans": plans, "rays": rays,
            "digest": _state_digest(runner.state), "files": files, "counts": counts,
            "step_ms": step_ms, "peak": peak, "collectives": cc.n,
            "flow_steps": runner.flow_steps, "current_image": runner.current_image,
            "occ_refreshes": runner.occ_refreshes, "dispatch": runner.dispatch}


def _dp_gloo(dev, scene, tmp, rank):
    """Part (a), on each of the two ranks."""
    fast_1024 = os.path.join(tmp, f"fast_1024_rank{rank}.conf")
    _conf_copy(FAST_CONF, fast_1024, {"batch_size": 2 * 512})
    out = {
        # the fast phase-2 conf as shipped: 256 rays x 128 samples a rank,
        # below the rays gate, so each rank takes K2/K3 and the f32 color
        "check_phase2_512": _dp_step_check("phase2_512", FAST_CONF, scene, dev, tmp, rank,
                                           False, DP_ROUTE_TOL, ("K2", "K3")),
        # 512 rays a rank, the one-card batch: K4/K5/K8/K9 on every rank
        "check_phase2_1024": _dp_step_check("phase2_1024", fast_1024, scene, dev, tmp,
                                            rank, False, DP_LOSS_TOL,
                                            ("K4", "K5", "K8", "K9")),
        "check_phase1": _dp_step_check("phase1", VIRTUAL_CONF, scene, dev, tmp, rank,
                                       True, DP_LOSS_TOL, ("K2", "K3"), SLICE3_SCHEDULE),
        "train_phase2": _dp_train("phase2_1024", fast_1024, scene, dev, tmp, rank,
                                  occ_update_freq=OCC_UPDATE_FREQ),
        "train_phase1": _dp_train("phase1", VIRTUAL_CONF, scene, dev, tmp, rank,
                                  SLICE3_SCHEDULE),
    }
    return out


def _dp_nccl(dev, scene, tmp):
    """Part (b): one rank over NCCL, the data-parallel scanned step on the
    reference conf captured with its all-reduces, against the same chunk
    eager and against the scanned chunk without a group, from one state."""
    import torch
    runner = _scan_runner(CONF, os.path.join(tmp, "dp_nccl"), scene, dev)
    n_cur = runner.current_image
    before = _scan_state(runner)
    res, times = {}, {}
    for mode in ("eager", "graph", "no_group"):
        _set_scan_state(runner, before)
        runner.use_dp = mode != "no_group"  # a group of one, which use_dp's rule leaves off
        # the captured modes as the backend decides (dp.capturable: NCCL on CUDA)
        scan = runner.scan_steps(DP_SCAN_K, capture=False if mode == "eager" else None)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counters()
        with _CountCollectives() as cc:
            mean = scan(runner.state, n_cur)
        torch.cuda.synchronize()
        counts = _counters()
        peak = torch.cuda.max_memory_allocated(dev)
        res[mode] = (_scan_state(runner), mean.clone(), scan.carry.frames.clone(), counts,
                     cc.n, peak, scan)
        if mode != "eager":  # a second chunk, timed
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            scan(runner.state, n_cur)
            b.record()
            b.synchronize()
            times[mode] = a.elapsed_time(b) / DP_SCAN_K
    (s_e, m_e, f_e, c_e, n_e, _, _), (s_g, m_g, f_g, c_g, n_g, peak_g, scan_g) = \
        res["eager"], res["graph"]
    s_n, m_n, f_n, c_n, _, peak_n, _ = res["no_group"]
    from fmov_pose_torch.train import graph as graph_mod
    per_replay = graph_mod.launches_by_kernel(scan_g.graph.per_replay)
    differ_eager, differ_plain = _state_differ(s_e, s_g), _state_differ(s_g, s_n)
    line = dict(part="nccl", check="captured_dp_scan", conf=os.path.relpath(CONF, ROOT),
                k=DP_SCAN_K, backend="nccl", world=1, captured=scan_g.capture,
                graph_vs_eager_differ=json.dumps(differ_eager).replace(" ", ""),
                graph_vs_no_group_differ=json.dumps(differ_plain).replace(" ", ""),
                metrics_bitwise=bool(torch.equal(m_e, m_g) and torch.equal(m_g, m_n)),
                frames_equal=bool(torch.equal(f_e, f_g) and torch.equal(f_g, f_n)),
                all_reduces_per_step=f"{n_e / DP_SCAN_K:.2f}",
                per_replay=json.dumps(per_replay).replace(" ", ""),
                launches=json.dumps(c_g).replace(" ", ""),
                dp_graph_ms_per_step=f"{times['graph']:.3f}",
                no_group_graph_ms_per_step=f"{times['no_group']:.3f}",
                peak_mem_gib_dp=f"{peak_g / 2**30:.3f}",
                peak_mem_gib_no_group=f"{peak_n / 2**30:.3f}")
    _line("dp", **line)
    _require(scan_g.capture and per_replay.get("K1") == 4,
             f"the NCCL scanned step was not captured with K1 4 a replay: {per_replay}")
    _require(not differ_eager and not differ_plain and line["metrics_bitwise"]
             and line["frames_equal"],
             f"the captured data-parallel chunk differs: {differ_eager} {differ_plain}")
    _require(n_e == 2 * DP_SCAN_K, f"{n_e} all-reduces in {DP_SCAN_K} eager steps")
    return {"counts": c_g, "per_replay": per_replay, "ms": times, "peak": peak_g,
            "collectives_per_step": n_e / DP_SCAN_K}


def _dp_child(argv):
    """``chip_smoke.py _dp_rank PART RANK WORLD PORT TMP``: one rank of the
    dp phase (PART gloo or nccl); writes its result to TMP."""
    import pickle
    import torch
    part, rank, world, port, tmp = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    sys.path.insert(0, ROOT)
    from fmov_pose_torch.device import disable_tf32
    from fmov_pose_torch.parallel import dp
    disable_tf32()
    dp.initialize(f"localhost:{port}", world, rank, part)
    try:
        dev = dp.local_device()
        torch.cuda.set_device(dev)
        with open(os.path.join(tmp, "scene.pkl"), "rb") as f:
            scene = pickle.load(f)
        out = _dp_gloo(dev, scene, tmp, rank) if part == "gloo" else _dp_nccl(dev, scene, tmp)
        with open(os.path.join(tmp, f"dp_{part}_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dp.shutdown()
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_spawn(part, world, tmp):
    """The ranks of ``part`` as child processes of this script, started
    together; their results.  A rank that fails or outlives
    DP_CHILD_TIMEOUT_S fails the phase."""
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "_dp_rank", part,
                               str(r), str(world), str(port), tmp], cwd=ROOT)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=DP_CHILD_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    _require(all(p.returncode == 0 for p in procs),
             f"dp {part}: ranks exited {[p.returncode for p in procs]}")
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"dp_{part}_rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs, time.perf_counter() - t0


def phase_dp(dev, smi, scene, tmp):
    """Data parallelism on the card: (a) two ranks over gloo, each its own
    process on the one H100; (b) one rank over NCCL, the scanned step
    captured with its all-reduces.  Returns the launches of each run."""
    import pickle
    import numpy as np
    with open(os.path.join(tmp, "scene.pkl"), "wb") as f:
        pickle.dump(scene, f)
    outs, seconds = _dp_spawn("gloo", DP_WORLD, tmp)
    for check in ("check_phase2_512", "check_phase2_1024", "check_phase1"):
        d = [[s["digest"] for s in o[check]["steps"]] for o in outs]
        _require(d[0] == d[1], f"dp {check}: the ranks' states differ after a step")
    counts = {}
    for name, once in (("train_phase2", ("K4", "K5", "K8", "K9")),
                       ("train_phase1", ("K2", "K3"))):
        r0, r1 = outs[0][name], outs[1][name]
        frames_equal = [p[0] for p in r0["plans"]] == [p[0] for p in r1["plans"]]
        rays_differ = all(a != b for a, b in zip(r0["rays"], r1["rays"]))
        _line("dp", part="gloo", check=f"{name}_ranks", ranks=DP_WORLD,
              bitwise_equal_state=r0["digest"] == r1["digest"],
              frames_equal=frames_equal, rays_differ=rays_differ,
              rank1_files=len(r1["files"]), rank0_files=len(r0["files"]),
              ms_per_step=json.dumps([round(r["step_ms"], 3) for r in (r0, r1)]),
              peak_mem_gib=json.dumps([round(r["peak"] / 2**30, 3) for r in (r0, r1)]),
              all_reduces_per_step=r0["collectives"] / STEPS,
              timing="two ranks time-slice one card: no scaling figure", card=repr(smi))
        _require(r0["digest"] == r1["digest"], f"dp {name}: the ranks' states differ")
        _require(frames_equal and rays_differ and len(r0["rays"]) == 5,
                 f"dp {name}: frames {frames_equal}, rays differ {rays_differ}")
        _require(not r1["files"] and r0["files"], f"dp {name}: rank 1 wrote {r1['files']}")
        losses = np.asarray(r0["losses"])
        _require(len(losses) == STEPS and np.all(np.isfinite(losses)),
                 f"dp {name}: losses {losses}")
        color = np.asarray(r0["color"])
        if name == "train_phase1":  # frame 0's photo steps: admissions add new frames
            color = np.asarray([c for c, (img, fl) in zip(color, r0["plans"])
                                if img == 0 and not fl])
        _require(len(color) >= 20 and color[-10:].mean() < color[:10].mean(),
                 f"dp {name}: the color loss did not fall: {color}")
        for k, v in r0["counts"].items():
            want = STEPS if k in once else 0
            _require(v == want and r1["counts"][k] == want,
                     f"dp {name}: {k} launched {v} and {r1['counts'][k]} times")
        counts[f"dp_gloo_{DP_WORLD}_ranks_{name}_{STEPS}_steps"] = {
            k: r0["counts"][k] + r1["counts"][k] for k in r0["counts"]}
    _require(outs[0]["train_phase1"]["flow_steps"] >= 1
             and outs[0]["train_phase1"]["current_image"] >= 4,
             "dp phase 1: no flow step or too few admissions")
    (nccl,), seconds_b = _dp_spawn("nccl", 1, tmp)
    counts[f"dp_nccl_scan_{DP_SCAN_K}_steps"] = nccl["counts"]
    _line("dp", part="summary", gloo_seconds=f"{seconds:.1f}", nccl_seconds=f"{seconds_b:.1f}",
          nccl_dp_graph_ms=f"{nccl['ms']['graph']:.3f}",
          nccl_no_group_graph_ms=f"{nccl['ms']['no_group']:.3f}", card=repr(smi))
    return counts


KERNEL_PHASES = {"kernels": phase_kernels, "train-kernels": phase_train_kernels,
                 "flat-kernels": phase_flat_kernels, "color-kernels": phase_color_kernels,
                 "wgrad": phase_wgrad}


def _scene():
    from fmov_pose_torch.data.scene import make_orbit_scene
    t0 = time.perf_counter()
    scene = make_orbit_scene(n_frames=8, H=480, W=640, seed=SEED)
    _line("scene", scene="orbit_8x480x640", seconds=f"{time.perf_counter() - t0:.1f}",
          match_pairs=len(scene.loftr_flows) // 2)
    return scene


RUN_PHASES = ("planned", "scan", "bf16", "quality", "dp")


def main(argv):
    import torch
    if argv[:1] == ["_dp_rank"]:  # a rank of the dp phase, started by it
        return _dp_child(argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    unknown = [a for a in argv if a not in KERNEL_PHASES and a not in RUN_PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; "
              f"choose from {sorted(KERNEL_PHASES) + list(RUN_PHASES)}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev, smi = phase_device()
    phase_build()
    if argv:  # chosen phases only: no result line
        for name in argv:
            if name in KERNEL_PHASES:
                KERNEL_PHASES[name](dev)
        with tempfile.TemporaryDirectory() as tmp:
            if {"planned", "scan", "bf16", "dp"} & set(argv):
                scene = _scene()
            if "planned" in argv:
                phase_planned(dev, smi, scene, tmp)
            if "scan" in argv:
                phase_scan(dev, smi, scene, tmp)
            if "bf16" in argv:  # against an f32 slice-1 run of its own
                _, r1 = phase_slice(dev, smi, scene, tmp)
                f32_ms = statistics.median(r1.step_ms)
                del r1
                phase_bf16(dev, smi, scene, tmp, f32_ms, float("nan"))
            if "quality" in argv:
                phase_quality(dev, smi, tmp)
            if "dp" in argv:
                phase_dp(dev, smi, scene, tmp)
        return 0
    k1 = phase_kernels(dev)
    train_k = phase_train_kernels(dev)
    flat_k = phase_flat_kernels(dev)
    sample_k = phase_color_kernels(dev)
    stage_k = phase_wgrad(dev)
    scene = _scene()
    with tempfile.TemporaryDirectory() as tmp:
        k1_launches, runner1 = phase_slice(dev, smi, scene, tmp)
        slice1_ms = statistics.median(runner1.step_ms)
        counts = phase_slice2(dev, smi, scene, tmp)
        counts3, runner3 = phase_slice3(dev, smi, scene, tmp)
        planned = phase_planned(dev, smi, scene, tmp)
        counts4 = phase_slice4(dev, smi, scene, tmp)
        mesh_launches = phase_mesh(runner1)
        phase_resume(scene, dev, tmp, runner1, runner3)
        del runner1, runner3
        two, two_state = phase_two_phase(dev, smi, tmp)
        evals, bake_chunk = phase_eval(dev, smi, tmp, two_state)
        del two_state
        scans = phase_scan(dev, smi, scene, tmp)
        bf16 = phase_bf16(dev, smi, scene, tmp, slice1_ms,
                          scans["reference"]["graph_ms"])
        dps = phase_dp(dev, smi, scene, tmp)
        phase_quality(dev, smi, tmp)
    leaked = [m for m in ("jax", "fmov_pose_tpu") if m in sys.modules]
    _require(not leaked, f"the port's path imported {leaked}")
    csrc = "fmov_pose_torch/ops/csrc/"
    scan_ref = f"scan_reference_{SCAN_K * SCAN_CHUNKS}_steps"
    scan_fused = f"scan_fused_{SCAN_K * SCAN_CHUNKS}_steps"
    kernels = [{"name": "sdf_fwd", "route": "cuda", "source": csrc + "sdf_fwd.cu",
                "replaces": "fmov_pose_tpu/ops/fused_sdf.py:326",
                "launches": {f"slice1_{STEPS}_steps": k1_launches,
                             f"mesh_{MESH_RES}": mesh_launches,
                             "two_phase": two["K1"], "eval": evals["K1"],
                             scan_ref: scans["reference"]["launches"]["K1"],
                             scan_fused: scans["fused"]["launches"]["K1"],
                             f"bf16_slice1_{STEPS}_steps": bf16["per_step"],
                             f"bf16_scan_{SCAN_K * SCAN_CHUNKS}_steps": bf16["scan"]},
                **k1,
                "bake_chunk": bake_chunk["K1"]}]
    slice3, slice2 = f"slice3_{STEPS}_steps", f"slice2_{STEPS}_steps"
    planned_runs = {f"{run}_{PLANNED_STEPS}_steps": planned[run]
                    for run in ("planned", "per_step", "planned_pixel")}
    kernels[0]["launches"].update({k: v["K1"] for k, v in planned_runs.items()})
    for key, name, src, replaces, launches, res in (
            ("K2", "sdf_fwd_grad_flat", "sdf_flat.cu", "fused_sdf.py:343",
             {slice3: counts3["K2"], "two_phase": two["K2"], "eval": evals["K2"],
              **{k: v["K2"] for k, v in planned_runs.items()}}, flat_k),
            ("K3", "sdf_bwd_flat", "sdf_flat.cu", "fused_sdf.py:437",
             {slice3: counts3["K3"], "two_phase": two["K3"],
              **{k: v["K3"] for k, v in planned_runs.items()}}, flat_k),
            ("K4", "sdf_fwd_grad", "sdf_fwd_grad.cu", "fused_sdf.py:699",
             {slice2: counts["K4"], "two_phase": two["K4"], "eval": evals["K4"],
              scan_fused: scans["fused"]["launches"]["K4"]}, train_k),
            ("K5", "sdf_bwd", "sdf_bwd.cu", "fused_sdf.py:761",
             {slice2: counts["K5"], "two_phase": two["K5"], "eval": evals["K5"],
              scan_fused: scans["fused"]["launches"]["K5"]}, train_k),
            ("K6", "color_fwd", "color_sample.cu", "fused_color.py:93",
             {f"slice4_{STEPS}_steps": counts4["K6"], "eval": evals["K6"]}, sample_k),
            ("K7", "color_bwd", "color_sample.cu", "fused_color.py:108",
             {f"slice4_{STEPS}_steps": counts4["K7"]}, sample_k),
            ("K8", "color_ray_fwd", "color_ray.cu", "fused_color.py:375",
             {slice2: counts["K8"], "two_phase": two["K8"], "eval": evals["K8"],
              scan_fused: scans["fused"]["launches"]["K8"]}, train_k),
            ("K9", "color_ray_bwd", "color_ray.cu", "fused_color.py:407",
             {slice2: counts["K9"], "two_phase": two["K9"], "eval": evals["K9"],
              scan_fused: scans["fused"]["launches"]["K9"]}, train_k)):
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": "fmov_pose_tpu/ops/" + replaces,
                        "launches": launches, **res[name]})
        if key in bake_chunk:
            kernels[-1]["bake_chunk"] = bake_chunk[key]
    for key, kernel in zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9"), kernels):
        kernel["launches"].update({run: c[key] for run, c in dps.items()})
    # the weight-gradient stage: once a launch of K3/K5/K7/K9 in every run
    # (``_counters`` requires it), its numbers at K5's shape, each shape's
    # under "shapes"
    by_key = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9"), kernels))
    runs = {}
    for key in STAGE_OF:
        for run, n in by_key[key]["launches"].items():
            runs[run] = runs.get(run, 0) + n
    kernels.append({"name": "weight_grads", "route": "cuda", "source": csrc + "wgrad.cu",
                    "replaces": "fmov_pose_tpu/ops/fused_sdf.py:845",
                    "also_replaces": ["fmov_pose_tpu/ops/fused_sdf.py:499",
                                      "fmov_pose_tpu/ops/fused_color.py:139",
                                      "fmov_pose_tpu/ops/fused_color.py:452"],
                    "launches": runs,
                    **{k: v for k, v in stage_k["K5"].items() if k not in ("M", "library")},
                    "shapes": stage_k})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
