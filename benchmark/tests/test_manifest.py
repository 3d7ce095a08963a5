"""The manifest's names and units, and every cell's data found by name."""

import json
import re

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = cells.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in MAN["command"])
    assert MAN["paths"] == ["benchmark"]


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + MAN["end_to_end"]
                         + MAN["per_layer"], ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_found_by_name(workload):
    c = cells.cell(workload)
    assert c["config"]["name"] == workload.split(".")[0]
    assert c["traffic"]["name"] == workload.split(".")[1]
    number = re.compile(r"^(loss|grad_gap|change_gap|(grad|change)\.(sdf|color|pose)|plan"
                        r"|late\.loss)$")
    assert all(number.match(n) for n in c["limits"]["limits"])
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    with open(cells.ROOT / config["file"]) as f:
        data = json.load(f)
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    # no width is cut
    widths = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head)")
    assert not [k for k in config["reduced"] if widths.search(k)]


def test_every_config_used():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
