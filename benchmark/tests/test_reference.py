"""The reference's checked chunk against the program's CPU path at a
tiny width: on the f32 networks (the program's plain path) the two agree
to rounding in every cell's dispatch; on the cell's own kernels (their
plain bf16 versions on the CPU) within the bf16 gap."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

WORKLOADS = ["neus_global.fused", "neus_virtual.planned", "neus_global.autograd"]
F32 = {"train.use_fused_train_kernels": False}


def _numbers(cell, seed):
    return harness.run(cell, seed, 0.2, False, "cpu", t_process=lambda: 0.0)["numbers"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_f32_path_matches(workload):
    n = _numbers(tiny.cell(workload, **F32), 2 ** 31 + 11)
    # f32 rounding over a chunk of steps: the worst leaf's moment within 1e-3
    assert n["loss"] < 1e-5 and n["grad_gap"] < 1e-3 and n["change_gap"] < 1e-3, n
    assert n.get("plan", 0) == 0 and n.get("late.loss", 0) < 1e-5, n


@pytest.mark.parametrize("workload", ["neus_global.fused", "neus_virtual.planned"])
def test_kernel_path_within_bf16(workload):
    n = _numbers(tiny.cell(workload), 7)
    assert 0 < n["loss"] < 2e-2 and n["grad_gap"] < 1.0 and n["change_gap"] < 0.5, n


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
