"""The command's behaviour around a run, and a whole run's result line
(on the CPU at a tiny width, past the look for a card)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import cells, harness
from benchmark.tests import tiny

ROOT = str(cells.ROOT)


def _command(cwd, workload="neus_global.fused"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                           "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    cell = tiny.cell("neus_global.autograd", **{"train.use_fused_train_kernels": False})
    cell["traffic"]["profile_steps"] = 10
    res = harness.run(cell, 2 ** 31 + 9, 0.2, traced, "cpu", t_process=lambda: 1.5)
    line = json.loads(json.dumps(harness.result_line(res, "cpu", 1)))
    assert list(line)[-1] == "checked"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["correct"]
    assert set(line["checked"]) == set(cell["limits"]["limits"])
    if traced:
        assert "breakdown" in line and "busy_s" in line["device"]
        assert set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}
        assert line["metrics"]["step_mfu"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"rays_per_s", "setup_s"}
        assert line["metrics"]["setup_s"]["value"] == 1.5
        assert line["metrics"]["rays_per_s"]["value"] > 0
