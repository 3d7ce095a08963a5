"""The manifest's names and units, and every cell's data found by name.

The rules are functions of a manifest (``check_*``), so that a copy of
the benchmark's data with a cell added is held to the same
(``test_room.py``)."""

import json
import re

import pytest

from benchmark import cells, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
# the check's numbers a limits file may name (``harness.numbers``), per field by ``FIELDS``
NUMBER = re.compile(r"^(loss|grad_gap|change_gap|(grad|change)\.(" + "|".join(harness.FIELDS)
                    + r")|plan|late\.loss)$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = cells.manifest()


def entries(man):
    return man["configs"] + man["workloads"] + man["end_to_end"] + man["per_layer"]


def check_top_level(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in man["command"])
    assert man["paths"] == ["benchmark"]


def check_names(entry):
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


def check_names_unique(man):
    for group in ("configs", "workloads"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))


def check_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def check_cell(workload, man):
    c = cells.cell(workload, man)
    assert c["config"]["name"] == workload.split(".")[0]
    assert c["traffic"]["name"] == workload.split(".")[1]
    assert all(NUMBER.match(n) for n in c["limits"]["limits"])
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))


def check_config_file(config):
    with open(cells.ROOT / config["file"]) as f:
        data = json.load(f)
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    # no width is cut
    widths = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head)")
    assert not [k for k in config["reduced"] if widths.search(k)]


def check_every_config_used(man):
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}


def test_top_level_keys():
    check_top_level(MAN)


@pytest.mark.parametrize("entry", entries(MAN), ids=lambda e: e["name"])
def test_names(entry):
    check_names(entry)


def test_names_unique():
    check_names_unique(MAN)


def test_bounds():
    check_bounds(MAN)


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_found_by_name(workload):
    check_cell(workload, MAN)


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    check_config_file(config)


def test_every_config_used():
    check_every_config_used(MAN)
