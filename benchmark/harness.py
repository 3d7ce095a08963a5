"""One run of one cell: set-up, the timed window, the check.

Set-up builds the cell's training Runner (``fmov_pose_torch``) on the
benchmark's scene, writes the benchmark's weights into its buffers and
seeds its generator.  Then one ``Runner.train()`` runs the rest, as the
job runs it; the harness follows it through the Runner's hook after a
chunk (``_events_after``) and, on the planned path, records every chunk
the Runner plans (``_plan_chunk``):

* the first chunk (its capture) is set-up, and the checked chunk: its
  losses, and each leaf and its Adam first moment after it, are read;
* the window opens after it and closes at the first chunk edge past
  ``--seconds``, with a ``torch.cuda.synchronize()``; its throughput is
  every ray that its completed steps trained over all its seconds.  A
  traced run profiles ``profile_steps`` steps of whole chunks in it,
  after its first chunk.  On the scan path the loop ends there;
* on the planned path the loop runs on to the first chunk that starts
  with a flow step (the late chunk): the state the window reached is
  copied before it, and its first ``LATE_STEPS`` losses are read.

Once the loop has ended the program's state is freed and the reference
(``benchmark/reference``, f32, TF32 off) follows the checked chunk from
the benchmark's weights, scene and generator seed; on the planned path
with the learning rates and gates that it works out itself for every
step the Runner planned (``reference/plan.py``), the window's too, and
the late chunk's first steps from the copy of the program's state.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import cells, weights as weights_mod, work
from benchmark import scene as scene_mod
from benchmark import trace as trace_mod
from benchmark.reference import model as ref_model, plan as ref_plan, train as ref_train

FORBIDDEN = ("jax", "jaxlib", "flax", "fmov_pose_tpu")
FIELDS = ("sdf", "color", "nerf", "pose")  # what ``group`` returns


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def sub_seeds(seed: int) -> dict:
    """Independent seeds of the run's inputs, from ``--seed``."""
    s = np.random.SeedSequence(int(seed)).generate_state(4, dtype=np.uint32)
    return dict(zip(("scene", "weights", "runner", "generator"), map(int, s)))


# ---------------------------------------------------------------------------
# the conf a cell runs
# ---------------------------------------------------------------------------


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    return repr(v)


_SECTION = re.compile(r'^\s*"?([\w.\-/]+)"?\s*\{\s*$')
_KEYVAL = re.compile(r'^(\s*)"?([\w.\-/]+)"?\s*[=:]\s*(.*?)\s*$')


def conf_text(text: str, overrides: dict) -> str:
    """``text`` (a HOCON conf of ``name { key = value }`` sections) with each
    dotted ``overrides`` key set: its line replaced, or added at the top of
    its section."""
    lines = text.splitlines()
    path, present = [], set()
    for line in lines:
        body = line.split("#", 1)[0]
        if m := _SECTION.match(body):
            path.append(m.group(1))
        elif body.strip() == "}":
            path.pop()
        elif m := _KEYVAL.match(body):
            present.add(".".join(path + [m.group(2)]))
    out, path = [], []
    for line in lines:
        body = line.split("#", 1)[0]
        if m := _SECTION.match(body):
            path.append(m.group(1))
            out.append(line)
            prefix = ".".join(path) + "."
            for k, v in overrides.items():
                rest = k[len(prefix):]
                if k.startswith(prefix) and "." not in rest and k not in present:
                    out.append(f"    {rest} = {_fmt(v)}")
            continue
        if body.strip() == "}":
            path.pop()
        elif (m := _KEYVAL.match(body)) and ".".join(path + [m.group(2)]) in overrides:
            line = f"{m.group(1)}{m.group(2)} = {_fmt(overrides['.'.join(path + [m.group(2)])])}"
        out.append(line)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


def _check_conf(runner, config):
    """The Runner reads the configuration the config file states (the
    background's ``nerf`` block where ``n_outside`` > 0)."""
    rc = runner.model_cfg
    want = config["model"]
    nets = [("sdf", "sdf_network"), ("color", "rendering_network")]
    if want["neus_renderer"].get("n_outside", 0) > 0:
        nets.append(("nerf", "nerf"))
    for net, key in nets:
        for k, v in want[key].items():
            got = rc[net].get(k)
            if (list(got) if isinstance(got, tuple) else got) != v:
                raise ValueError(f"conf {key}.{k} = {got!r}, the config states {v!r}")
    for k, v in want["neus_renderer"].items():
        if getattr(rc["renderer"], k) != v:
            raise ValueError(f"conf neus_renderer.{k} = {getattr(rc['renderer'], k)!r}, "
                             f"the config states {v!r}")
    t = config["train"]
    for k in ("batch_size", "end_iter", "learning_rate", "learning_rate_alpha",
              "warm_up_end", "anneal_end", "igr_weight", "mask_weight", "flow_weight",
              "mask_guided_sampling", "mask_guided_patch_size", "maintain_shape"):
        if getattr(runner, k) != t[k]:
            raise ValueError(f"conf train.{k} = {getattr(runner, k)!r}, the config "
                             f"states {t[k]!r}")


def _write_leaves(flat, layout, values: dict):
    if set(layout.names) != set(values):
        raise ValueError(f"the program's leaves {sorted(set(layout.names) ^ set(values))} "
                         f"differ from the benchmark's")
    with torch.no_grad():
        for name, shape, off in zip(layout.names, layout.shapes, layout.offsets):
            v = values[name]
            if tuple(v.shape) != tuple(shape):
                raise ValueError(f"{name}: the program's {tuple(shape)}, the benchmark's "
                                 f"{tuple(v.shape)}")
            flat[off:off + v.numel()].copy_(v.reshape(-1))


def _leaves(flat, layout, prefix="") -> dict:
    return {prefix + n: flat[o:o + math.prod(s)].view(s).detach().clone()
            for n, s, o in zip(layout.names, layout.shapes, layout.offsets)}


def prepare(cell: dict, seed: int, device, workdir: str):
    """The cell's Runner with the benchmark's scene, weights and generator
    seed, and what the reference needs."""
    from fmov_pose_torch.train.runner import Runner

    config, traffic = cell["config"], cell["traffic"]
    seeds = sub_seeds(seed)
    scene = scene_mod.make_scene(config["scene"], seeds["scene"], device)
    with open(cells.ROOT / traffic["conf"]) as f:
        text = f.read()
    conf_path = os.path.join(workdir, "cell.conf")
    with open(conf_path, "w") as f:
        f.write(conf_text(text, {**config["overrides"], **traffic["overrides"],
                                 **cell.get("extra_overrides", {})}))
    runner = Runner(conf_path, case=cell["workload"], exp_dir=os.path.join(workdir, "exp"),
                    has_global_conf=True, seed=seeds["runner"], device=device, scene=scene)
    _check_conf(runner, config)
    pose = dict(config["pose"], segments=runner.n_segments)
    w = weights_mod.make(config["model"], pose, seeds["weights"], device)
    st = runner.state
    _write_leaves(st.flat, st.layout, w["fields"])
    if pose["mode"] == "gf":
        st.pose_static["b"].copy_(w["pose_bands"])
        ref_static = {"b": w["pose_bands"],
                      "init_c2w": torch.as_tensor(scene.crop_poses, device=device)}
    else:
        _write_leaves(st.bank_flat, st.bank_layout, w["bank"])
        st.bank_static["b"].copy_(w["pose_bands"])
        ref_static = {"b": w["pose_bands"], "init_c2w": torch.as_tensor(
            np.repeat(scene.max_mask_pose[None], runner.n_segments, 0), device=device)}
    st.generator.manual_seed(seeds["generator"])
    start = {"params": initial(w), "generator": (torch.device(device), seeds["generator"])}
    t = config["train"]
    ref_cell = {
        "model": {"sdf": config["model"]["sdf_network"],
                  "color": config["model"]["rendering_network"],
                  "nerf": config["model"]["nerf"],
                  "renderer": config["model"]["neus_renderer"]},
        "weights": {"igr": t["igr_weight"], "mask": t["mask_weight"], "flow": t["flow_weight"]},
        "batch_size": t["batch_size"], "patch": t["mask_guided_patch_size"],
        "mask_guided": t["mask_guided_sampling"], "maintain_shape": t["maintain_shape"],
        "emphasize_rot": config["pose"]["emphasize_rot"],
        "segment_img_num": t.get("image_interval", 1),
        "schedule": {k: float(t[k]) for k in ("learning_rate", "learning_rate_alpha",
                                              "warm_up_end", "end_iter")},
    }
    return SimpleNamespace(cell=cell, seeds=seeds, scene=scene, runner=runner, weights=w,
                           ref_static=ref_static, ref_cell=ref_cell, device=torch.device(device),
                           start=start, steps=None, plan_faults=[])


def initial(w: dict) -> dict:
    """The benchmark's weights by leaf name, a bank's under ``bank.``."""
    out = dict(w["fields"])
    out.update({f"bank.{k}": v for k, v in (w["bank"] or {}).items()})
    return out


def rays_per_step(config) -> int:
    """Rays a training step trains: the batch, and as many again with
    ``maintain_shape`` (a flow step: two half-batches of match rays and
    the same maintain_shape batch)."""
    t = config["train"]
    return t["batch_size"] * (2 if t["maintain_shape"] else 1)


# ---------------------------------------------------------------------------
# the program's readings
# ---------------------------------------------------------------------------


LATE_STEPS = 3  # the steps compared from the state the window reached


def readings(runner) -> dict:
    """The program's state after a chunk, copied: each leaf and its Adam
    first moment by name (a segment bank's under ``bank.``)."""
    st = runner.state
    out = {"mu": _leaves(st.opt.mu, st.layout), "final": _leaves(st.flat, st.layout)}
    if st.bank_flat is not None:
        out["mu"].update(_leaves(st.pose_opt.mu, st.bank_layout, "bank."))
        out["final"].update(_leaves(st.bank_flat, st.bank_layout, "bank."))
    return out


def snapshot(runner) -> dict:
    """A copy of a segment bank's state between two chunks, all that a
    step reads and writes: the leaves, Adam moments and step counts (the
    segments' too), the bank's init poses, the generator's state and the
    step count."""
    st = runner.state
    po = st.pose_opt
    snap = {"iter": int(runner.iter_step), "step": int(st.opt.step),
            "generator": (st.generator.device, st.generator.get_state()),
            "seg_step": po.step.detach().clone(),
            "init_c2w": st.bank_static["init_c2w"].detach().clone()}
    for key, flat, bank in (("params", st.flat, st.bank_flat), ("mu", st.opt.mu, po.mu),
                            ("nu", st.opt.nu, po.nu)):
        snap[key] = {**_leaves(flat, st.layout), **_leaves(bank, st.bank_layout, "bank.")}
    return snap


class Loop:
    """Follows one ``Runner.train()`` through set-up, the window and, on
    the planned path, the late chunk (see the module's docstring) by the
    Runner's hook after a chunk, and records every chunk the Runner plans;
    a traced run profiles ``profile_steps`` steps of whole chunks after
    the window's first chunk."""

    def __init__(self, ctx, seconds: float, profile_steps: int, t_process):
        self.runner = r = ctx.runner
        self.seconds, self.profile_steps, self.t_process = seconds, profile_steps, t_process
        self.scan = ctx.cell["traffic"]["dispatch"] == "scan"
        self.cuda = r.device.type == "cuda"
        self.phase = "setup"
        self.plans = []  # every chunk the Runner planned, in order
        self.pre = self.late = None
        self.prof = self.profiled = None
        self.excluded = 0.0
        self.chunks = 0
        after, plan_chunk = r._events_after, r._plan_chunk

        def after_chunk(done, rows, *args):
            after(done, rows, *args)
            self._after_chunk(done, rows)

        def planned_chunk(K):
            pre = snapshot(r) if self.phase == "late" else None
            out = plan_chunk(K)
            self.plans.append(out[0])
            if pre is not None and out[0] and out[0][0][1]:  # it starts with a flow step
                self.pre = pre
            return out

        r._events_after = after_chunk
        r._plan_chunk = planned_chunk

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _after_chunk(self, done, rows):
        r = self.runner
        if self.phase == "late":
            if self.pre is not None:
                k = len(self.plans[-1])
                self.late = {"loss": rows[done - k:done - k + LATE_STEPS, 0].tolist()}
                r.end_iter = r.iter_step  # the loop ends here
                self.phase = "done"
            return
        if self.phase == "setup":
            # the checked chunk: its losses (the mean of a scanned chunk,
            # each step's of a planned one) and the state after it
            k = 1 if self.scan else len(self.plans[-1])
            self.checked = {"loss": rows[done - k:done, 0].tolist(), "steps": r.iter_step,
                            **readings(r)}
            self._sync()
            self.t0 = time.perf_counter()
            self.step0 = r.iter_step
            self.setup_s = self.t_process()
            self.phase = "window"
            return
        self.chunks += 1
        if self.profile_steps and self.prof is None and self.chunks == 1:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self._sync()
            t = time.perf_counter()
            self.prof.start()
            self._sync()
            self.p0, self.pstep0 = time.perf_counter(), r.iter_step
            # the profiler's own start is left out of the window
            self.excluded += self.p0 - t
            self.profiler_s = [self.p0 - t]
        elif (self.prof is not None and self.profiled is None
              and r.iter_step - self.pstep0 >= self.profile_steps):
            self._sync()
            p1 = time.perf_counter()
            self.prof.stop()
            # the profiler's own stop is left out of the window
            self.excluded += time.perf_counter() - p1
            self.profiler_s.append(time.perf_counter() - p1)
            self.profiled = (p1 - self.p0, r.iter_step - self.pstep0)
        profiling = self.profile_steps and self.profiled is None
        if time.perf_counter() - self.t0 - self.excluded >= self.seconds and not profiling:
            self._sync()
            self.t1 = time.perf_counter()
            self.steps = r.iter_step - self.step0
            self.window_chunks = self.chunks
            if self.scan:
                r.end_iter = r.iter_step  # the loop ends here
                self.phase = "done"
            else:
                self.phase = "late"

    @property
    def seconds_measured(self) -> float:
        return self.t1 - self.t0 - self.excluded

    def trace(self):
        """The profiled sub-window, read once the window has closed."""
        window_s, steps = self.profiled
        return trace_mod.Trace(trace_mod.collect(self.prof), window_s, steps)


# ---------------------------------------------------------------------------
# the reference and the comparison
# ---------------------------------------------------------------------------


def precision(ctx, control=None):
    """The reference's precision: the up-sampler's queries at bf16 operands
    as the configs state them (K1), the rest f32; with ``control`` "fp8"
    (or "bf16") every product at that format, queries too; "color_bf16"
    the color network's products alone at bf16; "tf32" leaves the
    formats and turns TF32 on."""
    config = ctx.cell["config"]
    query = "bf16" if config["model"]["neus_renderer"]["n_importance"] > 0 else None
    if control in ("fp8", "bf16"):
        return ref_model.Precision(query=control if query else None, train=control)
    if control == "color_bf16":
        return ref_model.Precision(query=query, train=None, color="bf16")
    return ref_model.Precision(query=query, train=None)


def plan_check(ctx, loop):
    """On the planned path, the reference's own plan of every step the
    Runner planned (``ctx.steps``), and the steps whose planned row it
    does not confirm (``ctx.plan_faults``)."""
    if loop.scan:
        return
    rows = [row for chunk in loop.plans for row in chunk]
    ctx.steps, ctx.plan_faults = ref_plan.plan(ctx.cell["config"]["train"], ctx.scene, rows)
    ctx.flow_steps = sum(bool(uf) for _, uf, _ in rows)
    if loop.pre is None or len(ctx.steps) < loop.pre["iter"] + LATE_STEPS:
        ctx.plan_faults.append(f"{len(rows)} steps planned, no late chunk")


@contextlib.contextmanager
def _tf32(on: bool):
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def reference(ctx, n_steps: int, control=None, keep=1.0) -> dict:
    """The reference over the checked chunk, its first ``n_steps`` steps
    from the benchmark's weights and generator seed, on the cell's
    device; ``keep`` < 1 leaves out the rest of each ray batch (a
    fault)."""
    prec = precision(ctx, control)
    with _tf32(control == "tf32"):
        if ctx.cell["traffic"]["dispatch"] == "scan":
            return ref_train.scan_steps(ctx.ref_cell, ctx.scene_t, ctx.start["params"],
                                        ctx.ref_static, ctx.start["generator"], n_steps, prec,
                                        keep)
        return ref_train.planned_steps(ctx.ref_cell, ctx.scene_t, ctx.start["params"],
                                       ctx.ref_static, ctx.start["generator"],
                                       ctx.steps[:n_steps], prec, keep)


def late_reference(ctx, pre: dict, control=None, keep=1.0) -> dict:
    """The reference over the late chunk's first ``LATE_STEPS`` steps, from
    the copy ``pre`` of the program's state (the planned path)."""
    static = {"b": ctx.weights["pose_bands"], "init_c2w": pre["init_c2w"]}
    steps = ctx.steps[pre["iter"]:pre["iter"] + LATE_STEPS]
    with _tf32(control == "tf32"):
        return ref_train.planned_steps(ctx.ref_cell, ctx.scene_t, pre["params"], static,
                                       pre["generator"], steps, precision(ctx, control), keep,
                                       state=pre)


def loss_gap(got: list, ref: list) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, ref))


def group(leaf: str) -> str:
    """A leaf's field, one of ``FIELDS``: sdf (the variance with it),
    color, nerf (the NeRF++ background), pose (the pose net or bank)."""
    head = leaf.split(".")[0]
    return {"variance": "sdf", "bank": "pose"}.get(head, head)


def _norm(t) -> float:
    return float(t.double().norm())


def compare(got: dict, ref: dict, init: dict) -> dict:
    """The check's numbers of the checked chunk, the program's readings
    ``got`` against the reference's ``ref`` (each: the chunk's losses,
    the Adam first moments ``mu`` and the leaves ``final`` after it),
    both from the leaves ``init`` and zero moments.  A leaf's first
    moment is its gradients over the chunk as the optimizer got them
    (gated, the later steps weighing most); a leaf counts as moved where
    the reference's is at least a thousandth of the median leaf's (the
    others move by round-off alone under Adam):

    * ``loss``: the largest gap of a step's loss (on the scan path the
      chunk's mean), over |ref|;
    * ``grad_gap``, ``change_gap``: the gap of the norms of the first
      moment, and of the leaves' change over the chunk, by the worst
      moved leaf, over the larger of the reference's norm and the median
      leaf's;
    * ``grad.<field>``, ``change.<field>``: over a field's moved leaves
      (``group``), the median of the norm of the difference of the two,
      over the larger of the reference's norm and the field's median
      leaf's."""
    ref_loss = ref["loss"]
    if len(got["loss"]) == 1 and len(ref_loss) > 1:  # a scanned chunk's mean
        ref_loss = [sum(ref_loss) / len(ref_loss)]
    if len(got["loss"]) != len(ref_loss):
        raise ValueError(f"{len(got['loss'])} losses against {len(ref_loss)}")
    loss = loss_gap(got["loss"], ref_loss)

    def moment(side, n):
        return side["mu"][n].double()

    def change(side, n):
        p = side["final"][n].double()
        return p - init[n].double().to(p.device)

    names = sorted(ref["mu"])
    gr = {n: float(moment(ref, n).norm()) for n in names}
    med_g = statistics.median(gr.values())
    moved = [n for n in names if gr[n] >= 1e-3 * med_g]
    gp = {n: float(moment(got, n).norm()) for n in moved}
    dr = {n: float(change(ref, n).norm()) for n in moved}
    dp = {n: float(change(got, n).norm()) for n in moved}
    med_d = statistics.median(dr.values())
    g_gap = {n: abs(gp[n] - gr[n]) / max(gr[n], med_g, 1e-30) for n in moved}
    c_gap = {n: abs(dp[n] - dr[n]) / max(dr[n], med_d, 1e-30) for n in moved}
    g_worst, c_worst = max(g_gap, key=g_gap.get), max(c_gap, key=c_gap.get)
    out = {"loss": loss, "grad_gap": g_gap[g_worst], "change_gap": c_gap[c_worst]}
    for g in sorted({group(n) for n in moved}):
        mine = [n for n in moved if group(n) == g]
        mg = statistics.median(gr[n] for n in mine)
        md = statistics.median(dr[n] for n in mine)
        out[f"grad.{g}"] = statistics.median(
            _norm(moment(got, n) - moment(ref, n).to(got["mu"][n].device))
            / max(gr[n], mg, 1e-30) for n in mine)
        out[f"change.{g}"] = statistics.median(
            _norm(got["final"][n].double() - ref["final"][n].double().to(
                got["final"][n].device)) / max(dr[n], md, 1e-30) for n in mine)
    out["worst"] = {"grad_gap": g_worst, "change_gap": c_worst}
    return out


def numbers(ctx, loop, ref: dict, late_ref) -> dict:
    """The run's numbers: ``compare``'s of the checked chunk; on the
    planned path also ``plan``, the steps whose planned row the reference
    does not confirm, and ``late.loss``, the largest gap of the late
    chunk's first losses."""
    out = {k: v for k, v in compare(loop.checked, ref, ctx.start["params"]).items()
           if k != "worst"}
    if not loop.scan:
        out["plan"] = float(len(ctx.plan_faults))
        out["late.loss"] = (loss_gap(loop.late["loss"], late_ref["loss"]) if late_ref
                            else math.nan)
    return out


def control_readings(ctx, loop, ref: dict, late_ref, n_steps: int) -> dict:
    """Each control and fault against the reference: the traffic's control
    (the precision below the one the cell states), the reference at bf16
    operands and with the color network's alone at bf16, half of each ray
    batch left out, and a state left unchanged."""
    init = ctx.start["params"]
    runs = {"control": dict(control=ctx.cell["traffic"]["control"]), "bf16": dict(control="bf16"),
            "color_bf16": dict(control="color_bf16"), "half_batch": dict(keep=0.5)}
    out = {name: compare(reference(ctx, n_steps, **kw), ref, init) for name, kw in runs.items()}
    still = {"loss": ref["loss"], "final": init,
             "mu": {n: torch.zeros_like(m) for n, m in ref["mu"].items()}}
    out["state_unchanged"] = compare(still, ref, init)
    out = {name: {k: v for k, v in n.items() if k != "worst"} for name, n in out.items()}
    if late_ref:
        for name, kw in runs.items():
            out[name]["late.loss"] = loss_gap(late_reference(ctx, loop.pre, **kw)["loss"],
                                              late_ref["loss"])
    return out


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: dict, seed: int, seconds: float, traced: bool, device="cuda",
        t_process=None, controls=False) -> dict:
    """One run of ``cell``; returns the result line's fields and
    ``checks`` (name -> (value, limit)), ``numbers`` (every number the
    check computes, compared or not); with ``controls`` also
    ``readings``: the numbers of the program and of each control and
    fault (``control_readings``)."""
    t_process = process_seconds if t_process is None else t_process
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell["config"], cell["traffic"]
    with tempfile.TemporaryDirectory(prefix="fmov_bench_") as workdir:
        ctx = prepare(cell, seed, dev, workdir)
        loop = Loop(ctx, seconds, traffic.get("profile_steps", 100) if traced else 0, t_process)
        runner = ctx.runner
        runner.train()
        if loop.phase != "done":
            raise RuntimeError(f"the loop ended in its {loop.phase} phase")
        window_s = loop.seconds_measured
        steps = loop.steps
        rays = steps * rays_per_step(config)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        step_ms = list(runner.step_ms)[:loop.window_chunks]  # not the late chunks
        dispatch = runner.dispatch
        k = int(dispatch.split("x")[1].split()[0]) if dispatch.startswith("scan") else 1
        del runner
        ctx.runner = loop.runner = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        tr = loop.trace() if traced else None
        ctx.scene_t = scene_mod.device_tensors(ctx.scene, dev)
        plan_check(ctx, loop)
        n_checked = loop.checked["steps"]
        t = time.perf_counter()
        ref = reference(ctx, n_checked)
        late_ref = late_reference(ctx, loop.pre) if loop.late else None
        ref_s = time.perf_counter() - t
        nums = numbers(ctx, loop, ref, late_ref)
        extra = ({"program": nums, **control_readings(ctx, loop, ref, late_ref, n_checked)}
                 if controls else None)
    late = (f"; the late chunk from step {loop.pre['iter']}, {ctx.flow_steps} flow steps "
            f"planned" if loop.late else "")
    print(f"window: {steps} steps in {window_s:.3f} s; the checked chunk's {n_checked} "
          f"steps in the reference in {ref_s:.1f} s{late}", file=sys.stderr)
    for line in ctx.plan_faults[:5]:
        print(f"plan: {line}", file=sys.stderr)
    if step_ms:
        per = sorted(ms / k for ms in step_ms)
        print(f"ms a step by chunk: min {per[0]:.3f} median {statistics.median(per):.3f} "
              f"max {per[-1]:.3f}", file=sys.stderr)
    limits = cell["limits"]["limits"]
    checks = {name: (nums[name], limit) for name, limit in limits.items()}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    res = {"correct": correct, "attempted": steps, "failed": 0, "checks": checks,
           "peak": peak, "window_s": window_s, "numbers": nums, "readings": extra}
    if not traced:
        res["metrics"] = {"rays_per_s": {"value": rays / window_s, "unit": "rays/s"},
                          "setup_s": {"value": loop.setup_s, "unit": "s"}}
        return res
    run_info = SimpleNamespace(
        trace=tr, step_ms=[ms / k for ms in step_ms], window_s=window_s, window_steps=steps,
        model=config["model"], rays_per_step=rays_per_step(config), dispatch=dispatch,
        work=work, step_flops=work.step_flops(config["model"], rays_per_step(config)))
    metrics = {}
    for m in cell["per_layer"]:
        value = cells.reader(m["name"])(run_info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    res["metrics"] = metrics
    res["busy_s"], res["trace_window_s"] = tr.busy_s, tr.window_s
    print(f"profiled {tr.steps} steps in {tr.window_s:.3f} s; the profiler's start and "
          f"stop {loop.profiler_s} s, left out of the {window_s:.3f} s window",
          file=sys.stderr)
    res["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    return res


def result_line(res: dict, device_name: str, count: int) -> dict:
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": int(res["peak"])}
    if "busy_s" in res:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["trace_window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checked"] = {n: {"value": v, "limit": lim} for n, (v, lim) in res["checks"].items()}
    return line


def print_result(res: dict, device_name: str, count: int):
    line = result_line(res, device_name, count)
    print(json.dumps(line), flush=True)
    for n, (v, lim) in res["checks"].items():
        print(f"checked {n} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
