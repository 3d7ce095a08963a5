"""Metric stats writer: a copy of the JAX package's
``fmov_pose_tpu/pipeline/report.py`` (numpy and json only), so that the
port writes the same ``stats_*`` files without importing that package.

Computes summary statistics over error arrays and writes them as both
yaml-like text and json, the way the reference's trajectory evaluation
(`utils/ATE/results_writer.py`) records ATE/RPE stats.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["compute_statistics", "write_metrics"]


def compute_statistics(values) -> dict:
    v = np.asarray(values, np.float64).reshape(-1)
    if v.size == 0:
        return {"rmse": 0.0, "mean": 0.0, "median": 0.0, "std": 0.0,
                "min": 0.0, "max": 0.0, "num_samples": 0}
    return {
        "rmse": float(np.sqrt((v**2).mean())),
        "mean": float(v.mean()),
        "median": float(np.median(v)),
        "std": float(v.std()),
        "min": float(v.min()),
        "max": float(v.max()),
        "num_samples": int(v.size),
    }


def write_metrics(path: str, metrics: dict):
    """metrics: {name: stats-dict or scalar}. Writes <path>.txt + .json."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".json", "w") as f:
        json.dump(metrics, f, indent=2)
    with open(path + ".txt", "w") as f:
        for name, val in metrics.items():
            if isinstance(val, dict):
                f.write(f"{name}:\n")
                for k, v in val.items():
                    f.write(f"  {k}: {v}\n")
            else:
                f.write(f"{name}: {val}\n")
    return path + ".json"
