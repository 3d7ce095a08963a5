"""The reference's checked chunk against the program's CPU path at a
tiny width: on the f32 networks (the program's plain path) the two agree
to rounding in every cell's dispatch; on the cell's own kernels (their
plain bf16 versions on the CPU) within the bf16 gap.  A background case
(``n_outside`` 4) checks the NeRF++ field too: on the f32 path, and on
the route a background takes at the published size, K4/K5 and the
per-sample K6/K7 (their gates lowered to the tiny step)."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

WORKLOADS = ["neus_global.fused", "neus_virtual.planned", "neus_global.autograd"]
F32 = {"train.use_fused_train_kernels": False}
BACKGROUND = 4  # outside samples a ray


def _numbers(cell, seed):
    return harness.run(cell, seed, 0.2, False, "cpu", t_process=lambda: 0.0)["numbers"]


def _cases(workloads, background):
    return ([pytest.param(w, 0, id=w) for w in workloads]
            + [pytest.param(background, BACKGROUND, id=f"{background}-background")])


@pytest.mark.parametrize("workload,n_outside", _cases(WORKLOADS, "neus_global.autograd"))
def test_f32_path_matches(workload, n_outside):
    n = _numbers(tiny.cell(workload, n_outside, **F32), 2 ** 31 + 11)
    # f32 rounding over a chunk of steps: the worst leaf's moment within 1e-3
    assert n["loss"] < 1e-5 and n["grad_gap"] < 1e-3 and n["change_gap"] < 1e-3, n
    assert n.get("plan", 0) == 0 and n.get("late.loss", 0) < 1e-5, n
    if n_outside:
        assert "grad.nerf" in n and "change.nerf" in n, n


@pytest.mark.parametrize("workload,n_outside",
                         _cases(["neus_global.fused", "neus_virtual.planned"],
                                "neus_global.fused"))
def test_kernel_path_within_bf16(workload, n_outside, monkeypatch):
    if n_outside:
        from fmov_pose_torch.ops import fused_color, fused_sdf
        monkeypatch.setattr(fused_sdf, "MIN_SAMPLES_RAYS", 0)
        monkeypatch.setattr(fused_color, "MIN_SAMPLES", 0)
    n = _numbers(tiny.cell(workload, n_outside), 7)
    assert 0 < n["loss"] < 2e-2 and n["grad_gap"] < 1.0 and n["change_gap"] < 0.5, n
    if n_outside:
        assert "grad.nerf" in n and "change.nerf" in n, n


def test_same_seed_same_inputs(tmp_path):
    cell = tiny.cell("neus_global.autograd")
    for d in "abc":
        (tmp_path / d).mkdir()
    a = harness.prepare(cell, 3 * 10 ** 9, torch.device("cpu"), str(tmp_path / "a"))
    b = harness.prepare(cell, 3 * 10 ** 9, torch.device("cpu"), str(tmp_path / "b"))
    assert (a.scene.images_np == b.scene.images_np).all()
    for k, v in a.weights["fields"].items():
        assert torch.equal(v, b.weights["fields"][k])
    assert torch.equal(a.runner.state.flat, b.runner.state.flat)
    c = harness.prepare(cell, 3 * 10 ** 9 + 1, torch.device("cpu"), str(tmp_path / "c"))
    assert not torch.equal(a.runner.state.flat, c.runner.state.flat)


def test_conf_text_overrides():
    text = "train {\n    a = 1\n    b = True  # note\n}\nmodel {\n  x {\n    d = 2\n  }\n}\n"
    out = harness.conf_text(text, {"train.a": 5, "train.c": False, "model.x.d": [4],
                                   "model.x.e": 0.5})
    assert "    a = 5" in out and "    c = False" in out and "b = True" in out
    assert "    d = [4]" in out and "    e = 0.5" in out
