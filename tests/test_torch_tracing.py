"""The port's spans and device marks (``fmov_pose_torch/tracing.py``).

* ``span`` nests under a running profiler, fills ``SPANS`` (counts and
  host seconds, an exception's span too) and works as a decorator.
* ``mark`` on a CPU tensor does nothing and loads no library; an unknown
  phase raises.
* A tiny planned CPU Runner under ``torch.profiler``: one
  ``fmov::plan_chunk`` and one ``fmov::chunk`` event a chunk, the
  ``fmov::pack_rows`` of each whole chunk inside its chunk, the set-up
  spans, no ``fmov::capture`` (nothing is captured on the CPU), and the
  report line's rays/s from the end of the first whole chunk.
* On a card (marked ``cuda``): a tiny scanned step captured with
  ``StepGraph`` and replayed 3 times under the profiler shows the six
  marks in order, 3 times, and leaves the state bitwise equal to the same
  step captured without marks.

The file imports no JAX (a card's test stays apart from the JAX oracles);
the CPU Runner test imports its helpers inside.
"""

import collections
import json
import logging
import os
import tempfile
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmov_pose_torch import tracing
from fmov_pose_torch.ops import build

MARKS = [f"fmov_mark_{p}" for p in tracing.PHASES]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread runs them as fast, and keeps
    the workers of a parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def spans(monkeypatch):
    """A fresh ``tracing.SPANS`` for the test."""
    table = {}
    monkeypatch.setattr(tracing, "SPANS", table)
    return table


def _host_events(prof, prefix="fmov::"):
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda t: t[1])


def test_span_nests_and_fills_spans(spans):
    @tracing.span("fmov::deco")
    def work():
        time.sleep(0.002)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("fmov::outer"):
            with tracing.span("fmov::inner"):
                time.sleep(0.01)
            with tracing.span("fmov::inner"):
                work()
    with pytest.raises(KeyError):
        with tracing.span("fmov::raises"):
            raise KeyError("x")
    assert {k: v[0] for k, v in spans.items()} == {
        "fmov::outer": 1, "fmov::inner": 2, "fmov::deco": 1, "fmov::raises": 1}
    assert spans["fmov::outer"][1] >= spans["fmov::inner"][1] >= 0.012
    assert spans["fmov::inner"][1] >= spans["fmov::deco"][1] >= 0.002
    ev = _host_events(prof)
    assert [n for n, _, _ in ev] == ["fmov::outer", "fmov::inner", "fmov::inner",
                                     "fmov::deco"]
    (_, o0, o1), (_, a0, a1), (_, b0, b1), (_, d0, d1) = ev
    assert o0 <= a0 <= a1 <= b0 <= d0 <= d1 <= b1 <= o1  # nested on one clock
    line = tracing.summary()
    assert "fmov::inner=2x" in line and "\n" not in line


def test_mark_on_cpu_is_a_noop(monkeypatch):
    monkeypatch.delitem(build._LIBS, "mark", raising=False)
    x = torch.zeros(3)
    for phase in tracing.PHASES:
        assert tracing.mark(phase, x) is None
    assert "mark" not in build._LIBS and torch.equal(x, torch.zeros(3))
    with pytest.raises(ValueError):
        tracing.mark("forward", x)


@pytest.fixture(scope="module")
def planned_conf(tmp_path_factory):
    """The tiny progressive conf of ``tests/test_torch_planned.py`` at 26
    steps, chunks of 4 (cut at the curriculum's events), on a sequence
    the port's writer makes."""
    from fmov_pose_torch.data.synthetic import make_orbit_sequence
    from tests.test_torch_planned import K, _conf
    from tests.test_torch_progressive import HW, N
    from tests.test_torch_runner import _write_noise_cams
    root = tmp_path_factory.mktemp("tracing")
    gt = make_orbit_sequence(str(root / "SYN_ori"), n_frames=N, H=HW, W=HW, span_deg=40)
    _write_noise_cams(str(root / "SYN_ori"), gt["K"], gt["poses"])
    return _conf(root, root, "planned", end_iter=26, k=K), K


def test_planned_runner_spans(planned_conf, spans, caplog):
    from fmov_pose_torch.train.runner import Runner
    conf, k = planned_conf
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = Runner(conf, mode="train", case="SYN_ori", has_global_conf=True, device="cpu")
        chunks, plan_chunk = [], r._plan_chunk
        r._plan_chunk = lambda K: _recorded(plan_chunk, K, chunks)
        with caplog.at_level(logging.INFO, logger="fmov_pose_torch.train.runner"):
            r.train()
    assert r.dispatch == f"planned x{k}" and r.iter_step == 26
    names = [n for n, _, _ in _host_events(prof)]
    whole = sum(len(c) == k for c in chunks)
    assert 0 < whole < len(chunks)  # whole chunks and chunks cut short
    assert names.count("fmov::plan_chunk") == names.count("fmov::chunk") == len(chunks)
    assert names.count("fmov::pack_rows") == 2 * whole  # the stack and the copy
    assert "fmov::capture" not in names and "fmov::capture" not in spans
    assert names.count("fmov::runner_init") == names.count("fmov::file_backup") == 1
    assert names.count("fmov::events_after") == len(chunks)
    assert spans["fmov::chunk"][0] == len(chunks) and spans["fmov::checkpoint"][0] == 1
    assert spans["fmov::pro_events"][0] >= 1
    # every pack_rows inside a chunk
    ev = _host_events(prof)
    chunk_ev = [(a, b) for n, a, b in ev if n == "fmov::chunk"]
    for n, a, b in ev:
        if n == "fmov::pack_rows":
            assert any(c0 <= a and b <= c1 for c0, c1 in chunk_ev)
    reports = [m for m in caplog.messages if m.startswith("iter ")]
    assert reports and all("rays/s=" in m for m in reports)  # report_freq 20: past chunk 1
    assert any(m.startswith("spans: ") and "fmov::chunk=" in m for m in caplog.messages)


def _recorded(plan_chunk, K, chunks):
    plan, event = plan_chunk(K)
    chunks.append(plan)
    return plan, event


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
       "multires": 4, "bias": 0.5, "scale": 1.0, "geometric_init": True,
       "weight_norm": True, "use_fused": False}
COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2, "squeeze_out": True}
NERF = {"D": 2, "d_in": 4, "d_in_view": 3, "W": 32, "multires": 2,
        "multires_view": 2, "output_ch": 4, "skips": (4,), "use_viewdirs": True}
RENDER = {"n_samples": 16, "n_importance": 16, "n_outside": 0, "up_sample_steps": 4,
          "perturb": 1.0}
B, H, W, N_IMG = 64, 24, 32, 3


def _scan_world(dev, k):
    """A tiny gf-pose scanned step (``ScanPhotoSteps``, k steps a call) and
    its state on ``dev``, from fixed seeds."""
    from fmov_pose_torch import convert
    from fmov_pose_torch.data import scene as tscene
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.poses import picture_pose as pp
    from fmov_pose_torch.render import neus
    from fmov_pose_torch.train import optim, step as tstep
    sc = tscene.make_orbit_scene(n_frames=N_IMG, H=H, W=W, span_deg=40.0, noise_deg=3.0,
                                 seed=1)
    rng = np.random.default_rng(0)
    params = {"sdf": nets.init_sdf(rng, SDF), "color": nets.init_color(rng, COLOR),
              "nerf": nets.init_nerf(rng, NERF), "variance": nets.init_variance(
                  {"init_val": 0.3})}
    gf = pp.init_gf(5, pp.PoseCfg(), sc.crop_poses)
    params["pose"] = gf["train"]
    layout = convert.ParamLayout(params)
    flat = layout.ravel(params, dev).requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    state = tstep.TrainState(flat=flat, layout=layout, opt=optim.adam_init(flat.detach()),
                             pose_static={k_: v.to(dev) for k_, v in gf["static"].items()},
                             generator=gen)
    model_cfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
                 "renderer": neus.make_render_cfg(RENDER)}
    cfg = tstep.make_step_config(model_cfg, batch_size=B, H=H, W=W, pose_mode="gf",
                                 igr_weight=0.1, mask_weight=0.1, mask_guided_sampling=True,
                                 mask_guided_patch_size=3)
    schedule = {"learning_rate": 5e-4, "learning_rate_alpha": 0.05, "warm_up_end": 2.0,
                "end_iter": 100.0}
    scan = tstep.ScanPhotoSteps(
        cfg, torch.as_tensor(sc.images_np, device=dev),
        torch.as_tensor(sc.masks_np[..., 0], device=dev),
        torch.as_tensor(np.asarray(sc.intrinsics_all_inv, np.float32), device=dev),
        torch.as_tensor(np.asarray(sc.mask_bboxes, np.int32), device=dev), schedule, k)
    return scan, state


@pytest.mark.cuda
def test_marks_survive_graph_replays(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    k = 3

    def run(marked):
        if not marked:
            monkeypatch.setattr(tracing, "mark", lambda phase, like: None)
        scan, state = _scan_world(dev, k)
        scan(state, N_IMG)  # the capture, then k replays
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            means = scan(state, N_IMG)  # k replays
            torch.cuda.synchronize()
        monkeypatch.undo()
        return state, means, prof

    state, means, prof = run(True)
    names = _kernels(prof)
    marks = [n for n in names if n.startswith("fmov_mark_")]
    assert marks == MARKS * k
    i = names.index("fmov_mark_render")
    assert names.index("fmov_mark_loss", i) - i > 1  # the render's kernels between
    plain, plain_means, plain_prof = run(False)
    plain_names = _kernels(plain_prof)
    # the same kernels but the marks (CUDA's own memcpy32_post kernels run
    # only in the process's first graph replays)
    program = collections.Counter(n for n in names if not n.startswith("memcpy"))
    plain_program = collections.Counter(n for n in plain_names if not n.startswith("memcpy"))
    assert program - collections.Counter(MARKS * k) == plain_program
    for a, b in ((state.flat, plain.flat), (state.opt.mu, plain.opt.mu),
                 (state.opt.nu, plain.opt.nu), (means, plain_means)):
        assert torch.equal(a, b)
    assert torch.equal(state.generator.get_state(), plain.generator.get_state())


def _kernels(prof):
    """The names of the profiled device kernels, in the order they started
    (from the Chrome trace: its "kernel" events)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ev = [e for e in events if e.get("cat") == "kernel"]
    return [e["name"] for e in sorted(ev, key=lambda e: e["ts"])]
