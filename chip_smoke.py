#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU
    python3 chip_smoke.py train-kernels flat-kernels   # device, build and
                                 # the named kernel phases only, no result line

Phases, each printing lines as it ends:
  1. device   -- require CUDA; the card, its power limit, CUDA and nvcc
  2. build    -- compile every kernel source of this checkout, one nvcc
                 each, all started together (K1 sdf_fwd.cu, K2/K3
                 sdf_flat.cu, K4 sdf_fwd_grad.cu, K5 sdf_bwd.cu, K6/K7
                 color_sample.cu, K8/K9 color_ray.cu), and print ptxas's
                 registers and spills (by name for the eight per-point
                 kernels on the pipeline: K4's, K2's, K5's, K3's, K8's,
                 K6's, K9's and K7's)
  3. kernels  -- K1 through its entries sdf_only_fused / sdf_apply_fused
                 against its plain PyTorch version at the full width of
                 confs/ho3d_global_womask.conf, M = 32,768 / 8,192 / 1,000
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
 10. slice4   -- Runner trains the fast phase-2 conf with n_outside = 32
                 (the NeRF++ background; a copy of the conf written to a
                 temporary directory) for 50 steps on the same scene: finite
                 losses, a falling color loss, K4, K5, K6 and K7 launched
                 once per step and no other kernel, the background
                 network's parameters moved, a refreshed grid; the batch
                 check before and after, the nerf.* leaves included
Then one JSON line of kernel results (each with its launches in its
path's run, its time, its plain version's, and its bound on the card),
the nvidia-smi line, and the last line {"ok": true, "device": {...}}.  Any failure raises: there is no CPU
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
FAST_CONF = os.path.join(ROOT, "confs", "ho3d_global_womask_tpu_fast.conf")
VIRTUAL_CONF = os.path.join(ROOT, "confs", "ho3d_virtual_tpu_fast.conf")
STEPS = 50
# slice 3's schedule, cut in depth only
SLICE3_SCHEDULE = {"mesh_warmup_step": 10, "max_pro_iteration": 8, "pro_warm_up_end": 4}
OCC_UPDATE_FREQ = 25
SEED = 0
TIMING_REPS = 20
SOURCES = ("sdf_fwd", "sdf_flat", "sdf_fwd_grad", "sdf_bwd", "color_ray",
           "color_sample")
# slice 4: the fast phase-2 conf with the NeRF++ background's samples a ray
# of the public NeuS womask conf and of scripts/parity_check.py's "p2_bg"
N_OUTSIDE = 32
# the card's peaks for the bounds (NVIDIA's H100 SXM data sheet)
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# rows: max |err| and median |err| relative to max|ref| (K1's rule)
ROW_MEDIAN_TOL, ROW_MAX_TOL = 1e-5, 1e-2


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
    from fmov_pose_torch.ops import build, fused_color, fused_sdf
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    fused_sdf._lib()
    fused_sdf._flat_lib()
    fused_sdf._rays_lib()
    fused_color._lib()
    fused_color._sample_lib()
    total = time.perf_counter() - t0
    for name in SOURCES:
        info = build.BUILD_INFO[name]
        regs = [l.strip() for l in info["log"].splitlines()
                if "registers" in l or "spill" in l]
        per_point = {k: v for k, v in _ptxas_entries(info["log"]).items()
                     if k in PER_POINT}
        _line("build", kernel=name, nvcc_seconds=f"{info['seconds']:.2f}",
              ptxas=repr(" | ".join(regs)),
              **{k: json.dumps(v).replace(" ", "") for k, v in per_point.items()})
    _line("build", all_seconds=f"{total:.2f}")


# the per-point kernels on the pipeline (K4, K2, K5, K3, K8, K6, K9, K7),
# whose registers and spills the build line names
PER_POINT = ("sdf_fwd_grad_kernel", "sdf_fwd_grad_flat_kernel", "sdf_bwd_kernel",
             "sdf_bwd_flat_kernel", "color_fwd_kernel", "color_sample_fwd_kernel",
             "color_bwd_kernel", "color_sample_bwd_kernel")


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
    cfg = model_cfg(CONF, "sdf_network")
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
                            "plain_ms": plain_ms, **_bound(*_sdf_work(cfg, M, "K1"))}
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


def _same_twice(phase, name, M, launch):
    """Two launches on the same inputs give bitwise the same outputs (the
    design's fixed-order sums promise it)."""
    import torch
    first, second = launch(), launch()
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(first, second))
    _line(phase, name=name, M=M, check="bitwise_run_to_run", ok=same)
    _require(same, f"{name} gave other bits on a second launch at M={M}")


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
    # the only overrides: a short run, and no LR warm-up (lr ~ 0 there)
    runner.end_iter, runner.warm_up_end = STEPS, 0.0
    r = runner.model_cfg["renderer"]
    _require(runner.model_cfg["sdf"]["use_fused"], "the conf path runs K1")
    _line("slice", conf=os.path.relpath(CONF, ROOT),
          overrides=f"end_iter={STEPS},warm_up_end=0", pose_mode=runner.pose_mode,
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
    return counts["K1"]


def _counters():
    from fmov_pose_torch.ops import fused_color, fused_sdf
    return {"K1": fused_sdf.LAUNCHES, "K2": fused_sdf.LAUNCHES_K2,
            "K3": fused_sdf.LAUNCHES_K3, "K4": fused_sdf.LAUNCHES_K4,
            "K5": fused_sdf.LAUNCHES_K5, "K6": fused_color.LAUNCHES_K6,
            "K7": fused_color.LAUNCHES_K7, "K8": fused_color.LAUNCHES_K8,
            "K9": fused_color.LAUNCHES_K9}


def _zero_counters():
    from fmov_pose_torch.ops import fused_color, fused_sdf
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
    return counts


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


KERNEL_PHASES = {"kernels": phase_kernels, "train-kernels": phase_train_kernels,
                 "flat-kernels": phase_flat_kernels, "color-kernels": phase_color_kernels}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    unknown = [a for a in argv if a not in KERNEL_PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; "
              f"choose from {sorted(KERNEL_PHASES)}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fmov_pose_torch.data.scene import make_orbit_scene
    dev, smi = phase_device()
    phase_build()
    if argv:  # a kernel check only: no training, no result line
        for name in argv:
            KERNEL_PHASES[name](dev)
        return 0
    k1 = phase_kernels(dev)
    train_k = phase_train_kernels(dev)
    flat_k = phase_flat_kernels(dev)
    sample_k = phase_color_kernels(dev)
    t0 = time.perf_counter()
    scene = make_orbit_scene(n_frames=8, H=480, W=640, seed=SEED)
    _line("scene", scene="orbit_8x480x640", seconds=f"{time.perf_counter() - t0:.1f}",
          match_pairs=len(scene.loftr_flows) // 2)
    with tempfile.TemporaryDirectory() as tmp:
        k1_launches = phase_slice(dev, smi, scene, tmp)
        counts = phase_slice2(dev, smi, scene, tmp)
        counts3 = phase_slice3(dev, smi, scene, tmp)
        counts4 = phase_slice4(dev, smi, scene, tmp)
    leaked = [m for m in ("jax", "fmov_pose_tpu") if m in sys.modules]
    _require(not leaked, f"the port's path imported {leaked}")
    csrc = "fmov_pose_torch/ops/csrc/"
    kernels = [{"name": "sdf_fwd", "route": "cuda", "source": csrc + "sdf_fwd.cu",
                "replaces": "fmov_pose_tpu/ops/fused_sdf.py:326",
                "launches": k1_launches, **k1}]
    for key, name, src, replaces, launches, res in (
            ("K2", "sdf_fwd_grad_flat", "sdf_flat.cu", "fused_sdf.py:343", counts3, flat_k),
            ("K3", "sdf_bwd_flat", "sdf_flat.cu", "fused_sdf.py:437", counts3, flat_k),
            ("K4", "sdf_fwd_grad", "sdf_fwd_grad.cu", "fused_sdf.py:699", counts, train_k),
            ("K5", "sdf_bwd", "sdf_bwd.cu", "fused_sdf.py:761", counts, train_k),
            ("K6", "color_fwd", "color_sample.cu", "fused_color.py:93", counts4, sample_k),
            ("K7", "color_bwd", "color_sample.cu", "fused_color.py:108", counts4, sample_k),
            ("K8", "color_ray_fwd", "color_ray.cu", "fused_color.py:375", counts, train_k),
            ("K9", "color_ray_bwd", "color_ray.cu", "fused_color.py:407", counts, train_k)):
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": "fmov_pose_tpu/ops/" + replaces,
                        "launches": launches[key], **res[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
