"""One rank of a data-parallel check on the CPU, for
``tests/test_torch_parallel.py``: a gloo process group over ``tcp://``,
one process a rank, the port's modules only (no JAX).

    python -m tests.torch_dp_worker CASE IN.pkl OUT_DIR --rank R --world N --port P

reads the case's inputs from ``IN.pkl``, runs ``CASES[CASE]`` as rank R
of N and writes what it returns to ``OUT_DIR/rank<R>.pkl``.  ``spawn``
launches the N ranks (each under a time limit, so that a hung rank fails
the test) and returns their outputs; the setup functions here (``tiny``,
``state_arrays``) also give the tests their one-process references.
"""

from __future__ import annotations

import argparse
import copy
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 100

SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
       "multires": 4, "bias": 0.5, "scale": 1.0, "geometric_init": True,
       "weight_norm": True}
COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2,
         "squeeze_out": True}
NERF = {"D": 2, "d_in": 4, "d_in_view": 3, "W": 32, "multires": 2,
        "multires_view": 2, "output_ch": 4, "skips": (1,), "use_viewdirs": True}
N_IMG, H, W = 4, 24, 32
LR = 5e-4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(case: str, inputs, world: int, tmp_dir) -> list:
    """Run ``case`` on ``world`` gloo ranks, one process each; returns
    their outputs in rank order.  A rank that fails or outlives
    ``RANK_TIMEOUT_S`` fails the caller, with its output."""
    os.makedirs(tmp_dir, exist_ok=True)
    in_path = os.path.join(tmp_dir, f"{case}_in.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("FMOV_DISTRIBUTED", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_worker", case, in_path, tmp_dir,
         "--rank", str(r), "--world", str(world), "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {case} failed (rc {p.returncode}):\n{log}")
    outs = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# setup shared with the tests' one-process references
# ---------------------------------------------------------------------------

def tiny(pose_mode="gf", n_samples=8, n_importance=8, batch=16, maintain_shape=False,
         flow_weight=0.0, use_fused_train=False, occupancy=False, device="cpu", seed=0):
    """(cfg, state, bufs, scene) of a tiny training setup on a 4-frame
    24x32 orbit: SDF 4x32, color 2x32, perturb 0, the gf pose net or the
    segment bank (``seg``, 2 frames a segment), weights from ``seed``."""
    from fmov_pose_torch import convert
    from fmov_pose_torch.data import scene as tscene
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.poses import picture_pose as pp
    from fmov_pose_torch.render import neus
    from fmov_pose_torch.train import optim, step as step_mod

    dev = torch.device(device)
    sc = tscene.make_orbit_scene(n_frames=N_IMG, H=H, W=W, span_deg=40.0,
                                 noise_deg=3.0, seed=1)
    rng = np.random.default_rng(seed)
    sdf_cfg = dict(SDF, use_fused_train=use_fused_train)
    params = {"sdf": nets.init_sdf(rng, sdf_cfg), "color": nets.init_color(rng, COLOR),
              "nerf": nets.init_nerf(rng, NERF),
              "variance": nets.init_variance({"init_val": 0.3})}
    model_cfg = {"sdf": sdf_cfg, "color": dict(COLOR), "nerf": dict(NERF),
                 "renderer": neus.RenderCfg(n_samples, n_importance, 0, 2, 0.0)}
    pose_cfg = pp.PoseCfg()
    pose_static, bank = {}, None
    n_seg = 1
    if pose_mode == "gf":
        gf = pp.init_gf(5, pose_cfg, sc.crop_poses)
        params["pose"] = gf["train"]
        pose_static = {k: v.to(dev) for k, v in gf["static"].items()}
    else:
        bank = pp.init_seg_bank(3, pose_cfg, N_IMG, 2, sc.crop_poses[0])
        n_seg = pp.num_segments(N_IMG, 2)
    if occupancy:
        pose_static["occ_grid"] = torch.ones((16,) * 3, device=dev)
    cfg = step_mod.make_step_config(
        model_cfg, batch_size=batch, H=H, W=W, pose_mode=pose_mode, n_segments=n_seg,
        segment_img_num=2, pose_cfg=pose_cfg, igr_weight=0.1, mask_weight=0.1,
        flow_weight=flow_weight, unit_sphere_weight=0.01, mask_guided_sampling=True,
        mask_guided_patch_size=3, maintain_shape=maintain_shape,
        occupancy_sampling=occupancy)
    layout = convert.ParamLayout(params)
    flat = layout.ravel(params, dev).requires_grad_(True)
    state = step_mod.TrainState(
        flat=flat, layout=layout, opt=optim.adam_init(flat.detach()),
        pose_static=pose_static, generator=torch.Generator(device=dev).manual_seed(7))
    if bank is not None:
        bl = convert.ParamLayout(bank["train"])
        state.bank_flat = bl.ravel(bank["train"], dev).requires_grad_(True)
        state.bank_layout = bl
        state.bank_static = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                             for k, v in bank["static"].items()}
        state.pose_opt = optim.seg_adam_init(state.bank_flat.detach(), bl.shapes, n_seg)
    bufs = tuple(torch.as_tensor(np.asarray(a), device=dev) for a in (
        sc.images_np, sc.masks_np[..., 0], sc.intrinsics_all_inv.astype(np.float32),
        np.asarray(sc.mask_bboxes, np.int32)))
    return cfg, state, bufs, sc


def state_arrays(state) -> dict:
    """The tensors a step writes, as numpy (bitwise comparable)."""
    out = {"flat": state.flat, "mu": state.opt.mu, "nu": state.opt.nu}
    if state.bank_flat is not None:
        po = state.pose_opt
        out.update(bank=state.bank_flat, bank_step=po.step, bank_mu=po.mu, bank_nu=po.nu)
    out.update({f"static.{k}": v for k, v in state.pose_static.items()})
    return {k: v.detach().cpu().numpy().copy() for k, v in out.items()}


def seg_scalars(cfg, lr=LR, **kw):
    from fmov_pose_torch.train import step as step_mod
    s = cfg.n_segments
    return step_mod.StepScalars(lr=lr, cos_anneal=1.0, seg_touch=np.ones(s, np.float32),
                                seg_freeze=np.ones(s, np.float32),
                                seg_lr=np.full(s, lr, np.float32), **kw)


def metric_floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def rows(n_global: int, world: int, rank: int) -> slice:
    """Rank ``rank``'s rows of ``n_global``."""
    k = n_global // world
    return slice(rank * k, (rank + 1) * k)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def case_losses(inp, group, world, rank):
    """``_render_and_losses`` with the group on this rank's rows of the
    batch (a flow batch: its rows of each half); the loss, the metrics
    and the gradient summed over the ranks."""
    import torch.distributed as dist
    from fmov_pose_torch import convert
    from fmov_pose_torch.render import neus
    from fmov_pose_torch.train import step as step_mod
    model = {"sdf": inp["sdf"], "color": inp["color"], "nerf": inp["nerf"],
             "renderer": neus.make_render_cfg(inp["render"])}
    cfg = step_mod.make_step_config(model, **inp["step_kw"])
    items = convert.flatten(convert.to_torch(inp["params"]))
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    params = convert.unflatten(zip([n for n, _ in items], leaves))
    static = convert.to_torch(inp["static"])
    flow_ctx = None
    if inp.get("flow") is None:
        data = torch.from_numpy(inp["data"][rows(len(inp["data"]), world, rank)])
    else:
        f = inp["flow"]
        mine = rows(len(f["pixels"]), world, rank)
        data = torch.from_numpy(np.concatenate([f["corr"][mine], f["img"][mine]]))
        flow_ctx = (f["img_id"], f["img_id_corr"], torch.from_numpy(f["pixels"][mine]),
                    torch.from_numpy(f["pixels_corr"][mine]), torch.from_numpy(f["K0"]),
                    torch.from_numpy(f["K1"]))
    scalars = step_mod.StepScalars(lr=LR, cos_anneal=inp["cos_anneal"])
    loss, metrics = step_mod._render_and_losses(cfg, None, params, static, data, scalars,
                                                flow_ctx=flow_ctx, group=group)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]
    for g in grads:
        dist.all_reduce(g, group=group)
    return {"metrics": metric_floats(metrics),
            "grads": {n: g.numpy() for (n, _), g in zip(items, grads)}}


def _given(inp, world, rank):
    """This rank's rows of the given photo and maintain_shape pixels."""
    px, py, apx, apy = (torch.from_numpy(inp[k]) for k in ("px", "py", "apx", "apy"))
    mine = rows(len(px), world, rank)
    return (px[mine], py[mine]), (apx[mine], apy[mine])


def photo_then_flow(inp, group, world, rank, dp_steps=True):
    """A photo step, then a flow step, on the tiny seg-bank setup with
    maintain_shape (given pixels: this rank's rows); the state and the
    metrics after each.  ``group`` None: the one-process steps."""
    from fmov_pose_torch.parallel import dp
    from fmov_pose_torch.train import step as step_mod
    cfg, state, bufs, _ = tiny(**inp["tiny"])
    if group is not None:
        dp.attach_rank_generator(state, 0, group)
        photo = dp.make_dp_photo_step(cfg, *bufs, group=group)
        flow = dp.make_dp_flow_step(cfg, *bufs, group=group)
    else:
        photo = step_mod.make_photo_step(cfg, *bufs)
        flow = step_mod.make_flow_step(cfg, *bufs)
    pixels, add = _given(inp, world, rank)
    out = []
    state, m = photo(state, seg_scalars(cfg), inp["img_id"], inp["add_img_id"],
                     pixels=pixels, add_pixels=add)
    out.append((state_arrays(state), metric_floats(m)))
    fadd = rows(len(inp["fapx"]), world, rank)
    state, m = flow(state, seg_scalars(cfg), inp["flow_img_id"], inp["flow_img_id_corr"],
                    inp["add_img_id"], inp["pixels_pair"],
                    add_pixels=(torch.from_numpy(inp["fapx"][fadd]),
                                torch.from_numpy(inp["fapy"][fadd])))
    out.append((state_arrays(state), metric_floats(m)))
    return out


def case_steps(inp, group, world, rank):
    return photo_then_flow(inp, group, world, rank)


SCHEDULE = {"learning_rate": LR, "learning_rate_alpha": 0.05, "warm_up_end": 2.0,
            "end_iter": 50.0, "anneal_end": 10.0, "mask_guided": 0.0}


def case_scan(inp, group, world, rank):
    """k data-parallel scanned steps (eager: gloo) against k per-step
    data-parallel dispatches from the same state, each drawing its frame
    from the shared generator as the scanned step does."""
    from fmov_pose_torch.parallel import dp
    from fmov_pose_torch.train import step as step_mod
    k = inp["k"]
    cfg, state, bufs, _ = tiny(batch=inp["batch"])
    dp.attach_rank_generator(state, 0, group)
    saved = copy.deepcopy((state_arrays(state), state.generator.get_state(),
                           state.ray_generator.get_state()))
    scan = dp.make_dp_scan_photo_steps(cfg, *bufs, SCHEDULE, k, group=group)
    mean = scan(state, N_IMG)
    frames = scan.carry.frames.tolist()
    after_scan = state_arrays(state)

    cfg, state, bufs, _ = tiny(batch=inp["batch"])
    dp.attach_rank_generator(state, 0, group)
    state.generator.set_state(saved[1])
    state.ray_generator.set_state(saved[2])
    photo = dp.make_dp_photo_step(cfg, *bufs, group=group)
    device_scalars = step_mod.make_device_scalars(SCHEDULE, state.flat.device)
    per_step, drawn = [], []
    for i in range(k):
        scalars = device_scalars(torch.tensor(float(i)))
        img_id = torch.randint(N_IMG, (1,), generator=state.generator)
        drawn.append(int(img_id))
        state, m = photo(state, scalars, img_id)
        per_step.append(torch.stack([m[n] for n in step_mod.METRIC_NAMES]))
    return {"scan": after_scan, "per_step": state_arrays(state), "frames": frames,
            "drawn": drawn, "scan_mean": mean.numpy(),
            "per_step_mean": torch.stack(per_step).mean(0).numpy(),
            "dispatch_capture": scan.capture, "iter": state.iter_step}


def _patch_fused_gates():
    """The rays and color gates at 0: the fused path (on the CPU the
    kernels' plain versions) at toy sizes."""
    from fmov_pose_torch.ops import fused_color, fused_sdf
    fused_sdf.MIN_SAMPLES_RAYS = 0
    fused_color.MIN_SAMPLES = 0


def case_fused(inp, group, world, rank):
    """One data-parallel photo step with the fused training path (the
    plain versions of K4/K5 and K8/K9, with f32 operands) and one without,
    from the same state and generator states, n_importance 8, with or
    without the grid."""
    from fmov_pose_torch.ops import fused_sdf
    from fmov_pose_torch.parallel import dp
    _patch_fused_gates()
    # f32 operands in the plain versions, as the JAX test's HIGHEST dots:
    # at toy widths the kernels' bf16 operands drown the comparison
    fused_sdf._bf16 = lambda t: t
    out = {}
    for fused in (True, False):
        cfg, state, bufs, _ = tiny(use_fused_train=fused, occupancy=inp["occupancy"])
        dp.attach_rank_generator(state, 0, group)
        photo = dp.make_dp_photo_step(cfg, *bufs, group=group)
        state, m = photo(state, seg_scalars(cfg, mask_guided=0.0), 1)
        out[fused] = (state_arrays(state), metric_floats(m))
    return out


def case_occ(inp, group, world, rank):
    """A data-parallel fused step with the grid, the grid refreshed from
    the replicated SDF as ``Runner.update_occ_grid`` does, another step
    on the new grid."""
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.parallel import dp
    from fmov_pose_torch.render import occupancy
    _patch_fused_gates()
    cfg, state, bufs, _ = tiny(use_fused_train=True, occupancy=True)
    dp.attach_rank_generator(state, 0, group)
    photo = dp.make_dp_photo_step(cfg, *bufs, group=group)
    state, m1 = photo(state, seg_scalars(cfg, mask_guided=0.0), 1)
    with torch.no_grad():
        pts = torch.as_tensor(occupancy.make_grid_points(16))
        sdf = nets.sdf_only(state.params["sdf"], cfg.model_cfg["sdf"], pts)
        state.pose_static["occ_grid"].copy_(occupancy.update_occ_grid(sdf, 16))
    grid = state.pose_static["occ_grid"].numpy().copy()
    state, m2 = photo(state, seg_scalars(cfg, mask_guided=0.0), 2)
    return {"grid": grid, "state": state_arrays(state), "m1": metric_floats(m1),
            "m2": metric_floats(m2), "iter": state.iter_step}


def case_world1(inp, group, world, rank):
    """A group of one: the data-parallel photo, flow and scanned steps
    against the one-device steps from the same state, bitwise."""
    from fmov_pose_torch.parallel import dp
    from fmov_pose_torch.train import step as step_mod
    out = {"dp": photo_then_flow(inp, group, 1, 0),
           "plain": photo_then_flow(inp, None, 1, 0)}
    for name in ("dp", "plain"):
        cfg, state, bufs, _ = tiny(batch=inp["tiny"]["batch"])
        if name == "dp":
            dp.attach_rank_generator(state, 0, group)
            out["ray_generator_of_one_rank"] = state.ray_generator
            scan = dp.make_dp_scan_photo_steps(cfg, *bufs, SCHEDULE, 3, group=group)
        else:
            scan = step_mod.ScanPhotoSteps(cfg, *bufs, SCHEDULE, 3)
        mean = scan(state, N_IMG)
        out[f"scan_{name}"] = (state_arrays(state), mean.numpy(), scan.carry.frames.tolist())
    return out


def case_resume(inp, group, world, rank):
    """A Runner on the scan path (the GT conf of
    ``parallel/multihost_runner_smoke.py``, 3 chunks of 5 steps, a
    checkpoint at every chunk edge, one exp dir for both ranks), and a
    second Runner that loads its checkpoint at step 10 and trains the last
    chunk: the two end states."""
    from fmov_pose_torch.data.scene import make_orbit_scene
    from fmov_pose_torch.parallel import multihost_runner_smoke as smoke
    from fmov_pose_torch.train.runner import Runner
    exp = os.path.join(inp["tmp"], "exp")
    conf = os.path.join(inp["tmp"], f"gt_{rank}.conf")
    with open(conf, "w") as f:
        f.write(smoke.conf_text(exp, inp["tmp"], scan=5).replace(
            "save_freq = 500", "save_freq = 5"))
    scene = make_orbit_scene(n_frames=4, H=24, W=32, seed=1)
    out = {}
    for name in ("a", "b"):
        runner = Runner(conf, case="x", has_global_conf=True, device="cpu", scene=scene)
        if name == "b":
            runner.load_checkpoint(os.path.join(
                runner.base_exp_dir, "checkpoints", "ckpt_000004_000010.ckpt"))
        runner.train()
        out[name] = (state_arrays(runner.state), runner.state.generator.get_state().numpy(),
                     runner.state.ray_generator.get_state().numpy(), runner.iter_step,
                     runner.dispatch)
    return out


CASES = {"losses": case_losses, "steps": case_steps, "scan": case_scan,
         "fused": case_fused, "occ": case_occ, "world1": case_world1,
         "resume": case_resume}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("inputs")
    ap.add_argument("out_dir")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from fmov_pose_torch.parallel import dp
    import torch.distributed as dist
    dp.initialize(f"localhost:{args.port}", args.world, args.rank, "gloo")
    try:
        with open(args.inputs, "rb") as f:
            inp = pickle.load(f)
        out = CASES[args.case](inp, dist.group.WORLD, args.world, args.rank)
        with open(os.path.join(args.out_dir, f"rank{args.rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dp.shutdown()


if __name__ == "__main__":
    main()
