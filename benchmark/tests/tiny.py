"""A cell of the manifest cut to a size the CPU tests hold: the same
conf, dispatch and check at small widths, a small scene, short
dispatches and, on the planned path, a frame admitted every 15 steps
(so that a flow step comes within a test's run); the NeRF++ background
at a few outside samples where the configuration has one, or on
request."""

from __future__ import annotations

import copy

from benchmark import cells

SDF = {"d_hidden": 16, "n_layers": 4, "skip_in": [2], "multires": 2, "d_out": 17}
COLOR = {"d_hidden": 16, "n_layers": 2, "d_feature": 16, "multires_view": 2}
NERF = {"D": 2, "W": 16, "multires": 2, "multires_view": 2, "skips": [0]}
SCENE = {"n_frames": 4, "H": 24, "W": 32}
CURRICULUM = {"max_pro_iteration": 15, "pro_warm_up_end": 8}
BATCH = 16
OUTSIDE = 4  # a background's outside samples a ray


def cell(workload: str, n_outside: int | None = None, **extra) -> dict:
    """The tiny cell; ``n_outside`` outside samples a ray of the NeRF++
    background (None: ``OUTSIDE`` where the configuration has a background,
    else none), in the configuration and in the conf alike."""
    c = copy.deepcopy(cells.cell(workload))
    cfg = c["config"]
    model = cfg["model"]
    if n_outside is None:
        n_outside = OUTSIDE if model["neus_renderer"]["n_outside"] > 0 else 0
    model["sdf_network"].update(SDF)
    model["rendering_network"].update(COLOR)
    model["nerf"].update(NERF)
    r = model["neus_renderer"]
    r.update({"n_samples": 8, "n_importance": 8 if r["n_importance"] else 0,
              "up_sample_steps": 2, "n_outside": n_outside})
    cfg["train"]["batch_size"] = BATCH
    cfg["scene"].update(SCENE)
    over = {}
    for sec, vals in (("sdf_network", SDF), ("rendering_network", COLOR), ("nerf", NERF)):
        over.update({f"model.{sec}.{k}": v for k, v in vals.items()})
    over.update({f"model.neus_renderer.{k}": r[k]
                 for k in ("n_samples", "n_importance", "up_sample_steps", "n_outside")})
    over.update({"train.batch_size": BATCH, "train.scan_chunk": 5, "train.report_freq": 10})
    if c["traffic"]["dispatch"] == "planned":
        over["train.plan_chunk"] = 10
        cfg["train"].update(CURRICULUM)
        cfg["scene"]["n_frames"] = 8
        over.update({f"train.{k}": v for k, v in CURRICULUM.items()})
    over.update(extra)
    c["extra_overrides"] = over
    c["traffic"]["profile_steps"] = 0
    return c
