"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``harness.run`` on the CPU at a tiny
width, past the harness's look for a card) with the program broken in
one of the ways a training cell can be: a step that leaves its state
unchanged; half of each ray batch left out, the mean taken over the
rest; a gradient altered where it is produced, the color network's
alone zeroed (a minority of the leaves); on the planned path a plan
altered where it is made, each step's learning rate a tenth too high;
and with the NeRF++ background (``n_outside`` 4) the background
network's gradient zeroed.  The sound run beside them (the program's f32
path, which the reference follows to rounding) comes out correct under
the same limits."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

WORKLOADS = ["neus_global.fused", "neus_virtual.planned", "neus_global.autograd"]
F32 = {"train.use_fused_train_kernels": False}
SEED = 2 ** 31 + 101


def _run(cell):
    return harness.run(cell, SEED, 0.2, False, "cpu", t_process=lambda: 0.0)


# each cell, and the f32 cell with the NeRF++ background at 4 outside samples a ray
CASES = ([pytest.param(w, 0, id=w) for w in WORKLOADS]
         + [pytest.param("neus_global.autograd", 4, id="neus_global.autograd-background")])


@pytest.mark.parametrize("workload,n_outside", CASES)
def test_sound_run_is_correct(workload, n_outside):
    res = _run(tiny.cell(workload, n_outside, **F32))
    assert res["correct"], res["checks"]


def _unchanged(monkeypatch):
    from fmov_pose_torch.train import optim

    def flat(g, state, p, lr, step):
        step.add_(1)
        return state

    monkeypatch.setattr(optim, "adam_update_flat_dev_", flat)
    monkeypatch.setattr(optim, "seg_adam_update_flat_", lambda g, state, *a: state)


def _half_batch(monkeypatch):
    from fmov_pose_torch.train import step as step_mod
    orig = step_mod._render_and_losses

    def half(cfg, generator, params, pose_static, data, *a, **k):
        return orig(cfg, generator, params, pose_static, data[:data.shape[0] // 2], *a, **k)

    monkeypatch.setattr(step_mod, "_render_and_losses", half)


def _grad_zero(monkeypatch, field):
    from fmov_pose_torch.train import step as step_mod
    orig = step_mod._apply_updates

    def zeroed(cfg, state, flat_g, *a, **k):
        keep = torch.ones_like(flat_g)
        for name, shape, off in zip(state.layout.names, state.layout.shapes,
                                    state.layout.offsets):
            if name.startswith(field + "."):
                keep[off:off + math.prod(shape)] = 0.0
        return orig(cfg, state, flat_g * keep, *a, **k)

    monkeypatch.setattr(step_mod, "_apply_updates", zeroed)


def _color_grad_zero(monkeypatch):
    _grad_zero(monkeypatch, "color")


def _planner_lr(monkeypatch):
    from fmov_pose_torch.train import runner
    orig = runner.Runner.main_lr
    monkeypatch.setattr(runner.Runner, "main_lr", lambda self: 1.1 * orig(self))


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "color_grad_zero": _color_grad_zero}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(tiny.cell(workload, **F32))
    assert not res["correct"], res["checks"]


def test_planner_fault_is_not_correct(monkeypatch):
    _planner_lr(monkeypatch)
    res = _run(tiny.cell("neus_virtual.planned", **F32))
    assert not res["correct"] and res["checks"]["plan"][0] > 0, res["checks"]


def test_background_fault_is_not_correct(monkeypatch):
    """The background network's gradient zeroed where it is produced: its
    leaves stay put, which ``change_gap`` (the worst moved leaf's change)
    reads at about 1."""
    _grad_zero(monkeypatch, "nerf")
    res = _run(tiny.cell("neus_global.autograd", 4, **F32))
    assert not res["correct"] and res["checks"]["change_gap"][0] > 0.5, res["checks"]
