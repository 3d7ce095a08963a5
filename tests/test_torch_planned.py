"""The planned phase-1 dispatch (``train.plan_chunk``) on the CPU: the
port's planned run against its per-step run, its plan against the JAX
Runner's, a chunk against the same steps one by one, and frame ids read
on the device.

* ``tests/test_planned.py``'s run in the port: the tiny progressive conf
  (``tests/test_train_e2e.py``'s ``VIRTUAL_CONF``, 75 steps: mesh
  warm-up, admissions, warm-up ends, mixed photo and flow chunks, and
  chunks cut short, since ``max_pro_iteration`` 15 is no multiple of the
  chunk of 4) planned and per step: the host counters and the host RNG's
  next draw equal, the device state within 1e-5 relative.
* The port's plan against the JAX Runner's ``_train_planned`` on the same
  conf and seed, with the steps replaced by recorders on both sides: the
  same chunks (their boundaries, the per-step tails), every packed row,
  flow flag and match pixel bitwise; as written and with rotation resets
  forced.
* ``PlannedSteps`` (eager, as on the CPU) against the per-step loop's
  photo and flow steps on the same rows and state, for the segment bank
  and the deep bank: bitwise equal metrics, state and generator.
* ``seg_apply`` / ``seg_deep_apply`` with the frame id an int64 tensor of
  one element: bitwise the host int's pose, of shape [3, 4], with no read
  of the id on the host (a tensor that raises on any host read); under
  CUDA's sync debug mode where a card is present.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from fmov_pose_torch.poses import picture_pose as tpp
from fmov_pose_torch.poses import pixel_pose as tpx
from fmov_pose_torch.train import step as tstep
from tests.test_torch_pixel_pose import small_deep_nets  # noqa: F401
from tests.test_torch_progressive import _virtual_conf, seq_root  # noqa: F401
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)

K = 4
# the JAX Runner plans only on one device (its rule): data_parallel off
PLAN = ("maintain_shape = True",
        "maintain_shape = True\n    plan_chunk = {k}\n    data_parallel = False")
PIXEL = ("pose_type = seg", "pose_type = seg\n    pixel_level = True")
RESETS = ("reset_based_on_rot = False",
          "reset_based_on_rot = True\n    reset_rot_threshold = 1e-3")


def _conf(root, tmp, name, end_iter=75, k=None, extra=()):
    sub = tmp / name
    sub.mkdir()
    if k is not None:
        extra = ((PLAN[0], PLAN[1].format(k=k)),) + tuple(extra)
    return _virtual_conf(root, sub, end_iter=end_iter, extra=extra)


def _runner(conf):
    from fmov_pose_torch.train.runner import Runner
    return Runner(conf, mode="train", case="SYN_ori", has_global_conf=True, device="cpu")


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_planned_matches_per_step(seq_root, tmp_path):  # noqa: F811
    a = _runner(_conf(seq_root, tmp_path, "per_step"))
    b = _runner(_conf(seq_root, tmp_path, "planned", k=K))
    assert (a._plan_eligible(), b._plan_eligible()) == (0, K)
    a.train()
    b.train()
    assert (a.dispatch, b.dispatch) == ("per-step", f"planned x{K}")
    # the same curriculum (host side)
    for key in ("iter_step", "current_image", "pro_iteration", "current_pose_mlp_index",
                "flow_steps", "mesh_warmup_step"):
        assert getattr(a, key) == getattr(b, key), key
    assert a.iter_step == 75 and a.current_image > 2 and a.flow_steps > 0
    np.testing.assert_array_equal(a.seg_progress, b.seg_progress)
    np.testing.assert_array_equal(a.seg_frozen, b.seg_frozen)
    np.testing.assert_array_equal(a.state.bank_static["initialized"],
                                  b.state.bank_static["initialized"])
    assert a.rng.integers(1 << 30) == b.rng.integers(1 << 30)  # the same host draws
    # the same device state
    sa, sb = a.state, b.state
    assert (sa.iter_step, sa.opt.step) == (sb.iter_step, sb.opt.step) == (75, 75)
    for name, x, y in (("flat", sa.flat, sb.flat), ("mu", sa.opt.mu, sb.opt.mu),
                       ("nu", sa.opt.nu, sb.opt.nu), ("bank", sa.bank_flat, sb.bank_flat),
                       ("bank_mu", sa.pose_opt.mu, sb.pose_opt.mu),
                       ("init_c2w", sa.bank_static["init_c2w"], sb.bank_static["init_c2w"])):
        assert _rel(y, x) <= 1e-5, name
    assert torch.equal(sa.pose_opt.step, sb.pose_opt.step)
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())
    assert len(a.history["loss"]) == len(b.history["loss"]) == 75
    np.testing.assert_allclose(b.history["loss"], a.history["loss"], rtol=1e-5)


EVENTS = ("validate_image", "validate_poses", "validate_mesh", "save_checkpoint")


def _record_events(runner, log):
    """Each event method of ``runner`` replaced by a recorder of its name
    and the step it ran at."""
    for name in EVENTS:
        setattr(runner, name, lambda *a, name=name, **k: log.append((name, runner.iter_step)))


def _record_jax(runner):
    """The JAX Runner's ``_train_planned`` with its chunk and per-step
    functions and its events replaced by recorders: [("chunk", packed
    [k, R], pixels [k, B/2, 4], flags [k]), ("step", packed, pixels or
    None) or (event, iter_step)]."""
    from fmov_pose_tpu.train import step as jstep
    log = []
    _record_events(runner, log)
    metrics = {"loss": 0.0, "psnr": 0.0}

    def make_chunk(*args, **kwargs):
        def chunk(state, packed, pixels, uses):
            log.append(("chunk", np.asarray(packed), np.asarray(pixels), np.asarray(uses)))
            return state, metrics
        return chunk

    def photo(state, packed):
        log.append(("step", np.asarray(packed), None))
        return state, metrics

    def flow(state, packed, pixels):
        log.append(("step", np.asarray(packed), np.asarray(pixels)))
        return state, metrics

    orig = jstep.make_planned_steps
    jstep.make_planned_steps = make_chunk
    runner.photo_step, runner.flow_step = photo, flow
    try:
        runner._train_planned(runner._plan_eligible())
    finally:
        jstep.make_planned_steps = orig
    return log


def _record_port(runner):
    """The port's ``_train_planned`` with ``PlannedSteps.__call__``, the
    per-step ``_dispatch`` and the events replaced by recorders, in
    ``_record_jax``'s form."""
    log = []
    _record_events(runner, log)
    zeros = torch.zeros((K, len(tstep.METRIC_NAMES)))

    class Chunk:
        def __init__(self, steps):
            self.rows, self.n_packed = steps.rows, steps.n_packed

        def __call__(self, state, rows, uses):
            n = self.n_packed
            log.append(("chunk", rows[:, :n], rows[:, n:].reshape(len(rows), -1, 4),
                        np.asarray(uses, np.float32)))
            return zeros[:len(uses)]

    def dispatch(packed, use_flow, pixels):
        log.append(("step", packed, pixels if use_flow else None))
        return {k: torch.zeros(()) for k in tstep.METRIC_NAMES}

    make = runner.planned_steps
    runner.planned_steps = lambda k, capture=None: Chunk(make(k, capture))
    runner._dispatch = dispatch
    runner._train_planned(runner._plan_eligible())
    return log


@pytest.mark.parametrize("extra", [pytest.param((), id="as_written"),
                                   pytest.param((RESETS,), id="rotation_resets")])
def test_plan_matches_jax(seq_root, tmp_path, extra):  # noqa: F811
    from fmov_pose_tpu.train.runner import Runner as JRunner
    conf = _conf(seq_root, tmp_path, "plan", end_iter=100, k=K, extra=extra)
    jr = JRunner(conf, mode="train", case="SYN_ori", has_global_conf=True)
    tr = _runner(conf)
    lj, lt = _record_jax(jr), _record_port(tr)
    assert [e[0] for e in lj] == [e[0] for e in lt]
    kinds = {e[0] for e in lt}
    assert {"chunk", "step", "validate_mesh", "save_checkpoint"} <= kinds
    n_flow = 0
    for i, (a, b) in enumerate(zip(lj, lt)):
        if a[0] in EVENTS:  # the same event at the same step
            assert a == b, i
            continue
        np.testing.assert_array_equal(a[1], b[1], err_msg=str(i))  # packed rows
        if a[0] == "chunk":
            np.testing.assert_array_equal(a[3], b[3], err_msg=str(i))  # flow flags
            np.testing.assert_array_equal(a[2], b[2], err_msg=str(i))  # pixels, 0 on photo rows
            n_flow += int(a[3].sum())
        else:
            assert (a[2] is None) == (b[2] is None), i
            if a[2] is not None:
                np.testing.assert_array_equal(a[2], b[2], err_msg=str(i))
                n_flow += 1
    assert n_flow > 0
    for key in ("iter_step", "current_image", "pro_iteration", "current_pose_mlp_index",
                "reset_count"):
        assert getattr(tr, key) == getattr(jr, key), key
    if extra:
        assert tr.reset_count > 0
    assert tr.rng.random() == jr.rng.random()


def _clone(st):
    """A copy of a TrainState with its own tensors and generator."""
    gen = torch.Generator().manual_seed(0)
    gen.set_state(st.generator.get_state())
    out = dataclasses.replace(
        st, flat=st.flat.detach().clone().requires_grad_(True),
        opt=dataclasses.replace(st.opt, mu=st.opt.mu.clone(), nu=st.opt.nu.clone()),
        generator=gen, pose_static={k: v.clone() for k, v in st.pose_static.items()},
        bank_flat=st.bank_flat.detach().clone().requires_grad_(True),
        bank_static={k: v.clone() if isinstance(v, torch.Tensor) else copy.copy(v)
                     for k, v in st.bank_static.items()},
        pose_opt=dataclasses.replace(st.pose_opt, step=st.pose_opt.step.clone(),
                                     mu=st.pose_opt.mu.clone(), nu=st.pose_opt.nu.clone()))
    return out


@pytest.mark.parametrize("extra", [pytest.param((), id="seg"),
                                   pytest.param((PIXEL,), id="seg_pixel")])
def test_chunk_is_the_per_step_steps(seq_root, tmp_path, extra, small_deep_nets):  # noqa: F811
    """Rows planned after two admissions run as one eager chunk and one by
    one through the per-step loop's steps: bitwise the same."""
    r = _runner(_conf(seq_root, tmp_path, "chunk", end_iter=40, extra=extra))
    r.train()
    assert r.current_image == 3
    r.end_iter = 100
    plan = []
    while len(plan) < 8:  # the host side alone: the events are not run
        plan += r._plan_chunk(8 - len(plan))[0]
    assert 0 < sum(uf for _, uf, _ in plan) < len(plan)  # photo and flow rows
    steps = r.planned_steps(len(plan))
    assert not steps.capture
    zero_pix = np.zeros(steps.rows.shape[1] - steps.n_packed, np.float32)
    rows = np.stack([np.concatenate([p, x.reshape(-1) if uf else zero_pix])
                     for p, uf, x in plan])
    a, b = _clone(r.state), r.state
    got = steps(a, rows, [uf for _, uf, _ in plan])
    for j, (packed, uf, pix) in enumerate(plan):
        r.state = b
        m = r._dispatch(packed, uf, pix)
        assert torch.equal(torch.stack([m[k] for k in tstep.METRIC_NAMES]), got[j]), j
    for name in ("flat", "bank_flat"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("mu", "nu"):
        assert torch.equal(getattr(a.opt, name), getattr(b.opt, name)), name
    for name in ("step", "mu", "nu"):
        assert torch.equal(getattr(a.pose_opt, name), getattr(b.pose_opt, name)), name
    assert (a.iter_step, a.opt.step) == (b.iter_step, b.opt.step)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


class _NoRead(torch.Tensor):
    """A tensor that raises on every read of its value by the host."""

    def _read(self, *args, **kwargs):
        raise AssertionError("a frame id was read on the host")

    __index__ = __int__ = __float__ = __bool__ = item = tolist = numpy = _read


def _device_ids_check(dev):
    cfg = tpp.PoseCfg(emphasize_rot=True)
    init = np.eye(4, dtype=np.float32)
    init[2, 3] = -2.0
    seg = tpp.init_seg_bank(3, cfg, 6, 2, init)
    deep_cfg = tpx.DeepPoseCfg(n_images=6, D=3, W=32, skips=(1,), x_multires=2,
                               t_multires=2, cam_id_encoding="embedding")
    deep = tpx.init_seg_deep_bank(3, deep_cfg, 6, 2, init)
    for bank in (seg, deep):
        for k, v in bank["static"].items():
            if isinstance(v, torch.Tensor):
                bank["static"][k] = v.to(dev)
        bank["train"] = {k: {n: t.to(dev) for n, t in p.items()}
                         for k, p in bank["train"].items()}
    calls = ((seg, lambda b, i: tpp.seg_apply(b, cfg, 2, i)),
             (deep, lambda b, i: tpx.seg_deep_apply(b, deep_cfg, 2, i)))
    for bank, apply in calls:
        for frame in range(6):
            host = apply(bank, frame)
            ids = torch.tensor([frame], device=dev).as_subclass(_NoRead)
            sync = torch.cuda.get_sync_debug_mode() if dev.type == "cuda" else None
            if sync is not None:
                torch.cuda.set_sync_debug_mode("error")
            try:
                on_device = apply(bank, ids)
            finally:
                if sync is not None:
                    torch.cuda.set_sync_debug_mode(sync)
            assert on_device.shape == host.shape == (3, 4)
            assert torch.equal(on_device.as_subclass(torch.Tensor), host), frame


def test_device_frame_ids_read_nothing_back():
    _device_ids_check(torch.device("cpu"))
    if torch.cuda.is_available():
        _device_ids_check(torch.device("cuda"))
