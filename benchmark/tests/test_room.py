"""A cell with the NeRF++ background enters the benchmark by new files and
manifest entries alone.

In a copy of the benchmark's data (the manifest, ``configs``,
``traffic``, ``limits``, ``metrics`` and the confs), with ``cells.ROOT``
and ``cells.BENCH`` pointed at it, the test adds the configuration
``neus_background`` (``neus_global``'s with NeuS ``womask.conf``'s 32
outside samples a ray), the cell ``neus_background.fused`` on the fused
traffic, its limits file naming ``grad.nerf`` and ``change.nerf``, a
reader of a background sub-phase, and their entries; no file of the
copy is edited.  The cell passes the manifest's rules; its tiny run on
the CPU (the program's f32 path, a background of ``tiny.OUTSIDE``
samples) is correct and reports both background numbers under their
limits; with the background's gradient zeroed where it is produced, it
fails on ``change.nerf``."""

import json
import shutil

import pytest

from benchmark import cells, harness
from benchmark.tests import test_manifest as rules
from benchmark.tests import tiny
from benchmark.tests.test_faults import F32, _grad_zero

CELL = "neus_background.fused"
SEED = 2 ** 31 + 211
# lower^0.4 x upper^0.6 of the fused cell's readings with 32 outside samples on the H100
# (program / fp8 control): grad.nerf 1.2e-4 / 0.018, change.nerf 6.8e-4 / 0.076
NERF_LIMITS = {"grad.nerf": 0.0024, "change.nerf": 0.0115}
READER = '''from benchmark import phases


def read(run):
    return phases.phase_ms(run, "background")
'''


def _dump(path, data):
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


@pytest.fixture
def room(tmp_path, monkeypatch):
    """The copy with the background cell added; returns its manifest."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(cells.BENCH / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(cells.ROOT / "confs", tmp_path / "confs")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    man = json.loads((cells.ROOT / "BENCHMARK.json").read_text())

    config = json.loads((bench / "configs" / "neus_global.json").read_text())
    config["name"] = "neus_background"
    config["source"] = ("https://github.com/Totoro97/NeuS confs/womask.conf (arXiv 2106.10689): "
                        "NeuS with its NeRF++ background, on fmov_pose's phase 2")
    config["model"]["neus_renderer"]["n_outside"] = 32
    config["overrides"]["model.neus_renderer.n_outside"] = 32
    _dump(bench / "configs" / "neus_background.json", config)
    limits = json.loads((bench / "limits" / "neus_global.fused.json").read_text())
    limits["limits"].update(NERF_LIMITS)
    _dump(bench / "limits" / f"{CELL}.json", limits)
    (bench / "metrics" / "background_ms_per_step.py").write_text(READER)

    man["configs"].append({"name": "neus_background", "source": config["source"],
                           "file": "benchmark/configs/neus_background.json",
                           "reduced": config["reduced"],
                           "why": "phase-2 NeuS with the NeRF++ background: nerf 8x256 on "
                                  "32 outside samples a ray besides the fields of neus_global"})
    man["workloads"].append({"name": CELL, "config": "neus_background", "traffic": "fused",
                             "chips": 1, "why": "512 rays x (128 + 32) samples a step, "
                             "scanned: K4/K5, K6/K7 and the f32 background"})
    for m in man["per_layer"]:
        if "neus_global.fused" in m["workloads"]:
            m["workloads"].append(CELL)
    man["per_layer"].append({"name": "background_ms_per_step", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "Renderer",
                             "moves": "rays_per_s", "workloads": [CELL]})
    _dump(tmp_path / "BENCHMARK.json", man)

    after = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items()), "an existing file was edited"
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    monkeypatch.setattr(cells, "BENCH", bench)
    return cells.manifest()


def test_found_by_name(room):
    assert room["workloads"][-1]["name"] == CELL
    rules.check_top_level(room)
    for entry in rules.entries(room):
        rules.check_names(entry)
    rules.check_names_unique(room)
    rules.check_bounds(room)
    for w in room["workloads"]:
        rules.check_cell(w["name"], room)
    for config in room["configs"]:
        rules.check_config_file(config)
    rules.check_every_config_used(room)
    c = cells.cell(CELL)
    assert c["config"]["model"]["neus_renderer"]["n_outside"] == 32
    assert "background_ms_per_step" in {m["name"] for m in c["per_layer"]}


def _run(cell):
    return harness.run(cell, SEED, 0.2, False, "cpu", t_process=lambda: 0.0)


def test_background_held(room):
    cell = tiny.cell(CELL, **F32)
    assert cell["extra_overrides"]["model.neus_renderer.n_outside"] == tiny.OUTSIDE
    res = _run(cell)
    assert res["correct"], res["checks"]
    for name, limit in NERF_LIMITS.items():
        assert res["checks"][name] == (res["numbers"][name], limit)
        assert res["checks"][name][0] <= limit


def test_background_fault_fails_change_nerf(room, monkeypatch):
    _grad_zero(monkeypatch, "nerf")
    res = _run(tiny.cell(CELL, **F32))
    value, limit = res["checks"]["change.nerf"]
    assert not res["correct"] and value > limit, res["checks"]
