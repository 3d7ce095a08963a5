"""The benchmark's data, found by name: the manifest (``BENCHMARK.json``),
a cell's configuration, traffic mix and limits, and the metric readers.

* a configuration ``<name>``: the file the manifest's ``configs`` entry
  names (``benchmark/configs/<name>.json``);
* a traffic mix ``<name>``: ``benchmark/traffic/<name>.json``;
* a cell's limits: ``benchmark/limits/<cell>.json``;
* a per-layer metric ``<name>``: ``benchmark/metrics/<name>.py``, whose
  ``read(run)`` returns the metric's value or None.

A later cell or metric is added by adding such files and its manifest
entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def manifest(path=None) -> dict:
    """``BENCHMARK.json`` at ``ROOT``, or the manifest at ``path``."""
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str, man: dict = None) -> dict:
    """{"workload", "config", "traffic", "limits", "chips", "end_to_end",
    "per_layer"} of a manifest cell; the metrics are the manifest's entries
    that this cell reports."""
    man = man or manifest()
    entries = [w for w in man["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"workload {workload!r}: {len(entries)} manifest entries")
    w = entries[0]
    cfg_entry = next(c for c in man["configs"] if c["name"] == w["config"])
    config = _json(ROOT / cfg_entry["file"])
    if config["name"] != w["config"]:
        raise ValueError(f"{cfg_entry['file']} names {config['name']!r}, not {w['config']!r}")
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"workload": workload, "config": config, "traffic": traffic,
            "limits": _json(BENCH / "limits" / f"{workload}.json"), "chips": w["chips"],
            "end_to_end": mine(man["end_to_end"]), "per_layer": mine(man["per_layer"])}


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
