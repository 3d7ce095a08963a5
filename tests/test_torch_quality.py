"""The two-phase quality harness (``fmov_pose_torch/quality.py``) and the
port's Chamfer distance on the CPU, against the JAX package.

* ``pipeline/chamfer.py``: bitwise the JAX copy on the same points and
  seed (it is numpy in both).
* The harness's flags and defaults and its JSON keys are the JAX
  script's (``scripts/pipeline_quality.py``, read with ``ast``), plus
  ``p2_dispatch``, ``device`` and ``power_limit``.
* ``quality.per_frame_errors`` is the JAX package's
  ``scripts/seed2_postmortem.py`` function (bitwise, on the same arrays:
  an orbit that collapsed and one that tracked), and ``orbit_errors``
  reads it: the degrees a frame and radii of the orbits.
* ``run(init=...)`` starts phase 1 from a given checkpoint: the CLI gets
  ``--is_continue`` and finds the state as phase 1's step-0 checkpoint.
* A tiny run on the CPU through the port's CLI (4 frames at 32x32, the
  confs' widths cut by the test between ``write_confs`` and ``run``,
  phase 2 one chunk of 100 steps at a tiny learning rate so that the
  final mesh keeps its surface): phase 2 on the scan path; the
  harness's numbers from the run's files against the JAX package's
  ``evalpose``, ``chamfer`` and ``meshio`` applied to the same files and
  poses, within 1e-6.
"""

import ast
import os

import numpy as np
import pytest
import torch

from fmov_pose_tpu.data.synthetic import SPHERE_RADIUS as J_SPHERE_RADIUS
from fmov_pose_tpu.pipeline import chamfer as jchamfer
from fmov_pose_tpu.pipeline import evalpose as jevalpose
from fmov_pose_tpu.pipeline import meshio as jmeshio
from fmov_pose_torch import quality
from fmov_pose_torch.pipeline import chamfer as tchamfer
from fmov_pose_torch.pipeline import meshio as tmeshio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "pipeline_quality.py")
POSTMORTEM = os.path.join(REPO, "scripts", "seed2_postmortem.py")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's CPU work is many small ops: one intra-op thread runs
    it as fast, and keeps the workers of a parallel test run from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sizes", [(500, 300), (2049, 4100)], ids=["small", "chunked"])
def test_chamfer_is_the_jax_copy(sizes):
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(sizes[0], 3)), rng.normal(size=(sizes[1], 3)) * 0.7
    for squared in (False, True):
        assert (tchamfer.chamfer_distance(a, b, squared=squared)
                == jchamfer.chamfer_distance(a, b, squared=squared))
    verts = rng.normal(size=(40, 3))
    faces = rng.integers(0, 40, size=(60, 3))
    np.testing.assert_array_equal(tchamfer.sample_mesh_surface(verts, faces, 300, seed=2),
                                  jchamfer.sample_mesh_surface(verts, faces, 300, seed=2))


def _jax_script():
    with open(JAX_SCRIPT) as f:
        return ast.parse(f.read())


def test_harness_flags_and_keys_are_the_jax_scripts():
    tree = _jax_script()
    defaults = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            flag = node.args[0].value.lstrip("-")
            kw = {k.arg: k.value for k in node.keywords}
            defaults[flag] = (False if "action" in kw else ast.literal_eval(kw["default"]))
    args = vars(quality.parse_args([]))
    assert {k: args[k] for k in defaults} == defaults
    assert set(args) - set(defaults) == {"device", "work"}

    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "dumps"]
    jax_keys = [k.value for k in dumps[-1].args[0].keys]
    m = {"p1_ate": 0.1, "p2_psnr": 30.0, "p2_ate": 0.05, "p2_rpe_trans": 0.01,
         "p2_rpe_rot": 0.02, "chamfer": 0.1, "mesh_verts": 1000}
    out = quality.result(quality.parse_args([]), m, 1.0, "scan x100", "cpu", "w")
    assert list(out) == jax_keys + ["p2_dispatch", "device", "power_limit"]
    assert (out["device"], out["power_limit"]) == ("cpu", None)


def _orbit(n, deg_per_frame, radius, axis_tilt=0.0):
    """c2w [n, 4, 4] of cameras on a circle about the origin, looking at it."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = np.deg2rad(deg_per_frame * i)
        c = np.array([radius * np.sin(a), radius * np.sin(axis_tilt) * np.cos(a),
                      -radius * np.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        out[i, :3, :3] = np.stack([x, np.cross(z, x), z], 1)
        out[i, :3, 3] = c
    return out


def test_per_frame_errors_are_the_postmortem_scripts():
    import importlib.util
    spec = importlib.util.spec_from_file_location("seed2_postmortem", POSTMORTEM)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    gt = _orbit(12, 13.6, 1.62)
    rng = np.random.default_rng(2)
    # a collapsed orbit (4 degrees a frame about a tilted axis, radius
    # 0.61) and one that tracks, with noise
    for est in (_orbit(12, 4.0, 0.61, axis_tilt=0.5), gt + rng.normal(0, 1e-2, gt.shape)):
        est = est.astype(np.float32)
        rows_t, al_t = quality.per_frame_errors(est, gt)
        rows_j, al_j = script.per_frame_errors(est, gt)
        assert rows_t == rows_j
        np.testing.assert_array_equal(al_t, al_j)
    o = quality.orbit_errors(_orbit(12, 4.0, 0.61).astype(np.float32), gt)
    assert o["gt_deg_per_frame"] == pytest.approx(13.6, abs=1e-3)
    assert o["gt_radius"] == pytest.approx(1.62, abs=1e-4)
    assert o["est_deg_per_frame"] == pytest.approx(4.0, abs=1e-2)
    assert o["median_rel_rot_deg"] == pytest.approx(9.6, abs=1e-2)
    assert len(o["rel_rot_deg"]) == 11
    tracked = quality.orbit_errors(gt.astype(np.float32), gt)
    assert tracked["median_rel_rot_deg"] < 1e-2
    assert tracked["est_radius"] == pytest.approx(1.62, abs=1e-4)


def test_run_starts_phase1_from_a_given_state(tmp_path, monkeypatch):
    """``run(init=...)``: the CLI gets ``--is_continue`` and the seed, and
    phase 1's checkpoint directory holds the given state as its step-0
    checkpoint, which the phase-1 Runner then loads (``--is_continue``
    with a JAX checkpoint is ``tests/test_torch_checkpoint.py``'s)."""
    from fmov_pose_torch import exp_runner
    init = tmp_path / "start.ckpt"
    init.write_bytes(b"state")
    seen = {}

    def fake_main(argv, device):
        seen["argv"], seen["device"] = argv, device
        d = "exp/SYN_ori/ours/checkpoints"
        seen["files"] = {n: open(os.path.join(d, n), "rb").read()
                         for n in (os.listdir(d) if os.path.isdir(d) else ())}

        class R:
            dispatch = "per-step"
        return R()

    monkeypatch.setattr(exp_runner, "main", fake_main)
    quality.run(str(tmp_path), "cpu", seed=5, init=str(init))
    assert seen["argv"][-3:] == ["--seed", "5", "--is_continue"]
    assert seen["files"] == {"ckpt_000001_000000.ckpt": b"state"}
    os.makedirs(tmp_path / "w2")
    quality.run(str(tmp_path / "w2"), "cpu")
    assert "--is_continue" not in seen["argv"] and seen["argv"][-2:] == ["--seed", "2024"]
    assert seen["files"] == {}


# the confs cut to a CPU test's size (the test's own edits)
TINY = {r"d_out = 257": "d_out = 33", r'"d_hidden" = 256': '"d_hidden" = 32',
        r"d_feature = 256": "d_feature = 32", r"n_layers = 8": "n_layers = 4",
        r"skip_in = \[4\]": "skip_in = [2]", r"multires = 6": "multires = 4",
        r"W = 256": "W = 32", r"D = 8": "D = 2", r"n_samples = \d+": "n_samples = 16",
        r"n_importance = 64": "n_importance = 16",
        r"up_sample_steps = 4": "up_sample_steps = 2", r"batch_size = 512": "batch_size = 64"}
TINY_ARGS = ["--frames", "4", "--res", "32", "--p1_iters", "80", "--p2_iters", "100",
             "--max_pro", "10", "--mesh_warmup", "10", "--p2_batch", "64",
             "--p2_warmup", "20", "--p2_lr", "1e-6"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("quality"))
    args = quality.parse_args(TINY_ARGS)
    gt = quality.make_data(work, args)
    for path in quality.write_confs(work, args):
        quality.shrink_conf(path, path, TINY)
    runner, _ = quality.run(work, "cpu", final_mesh_resolution=32)
    return work, gt, runner.dispatch


def _jax_sphere_chamfer(verts):
    """The JAX script's mesh evaluation, verbatim."""
    center = verts.mean(axis=0)
    v = verts - center
    v = v * (J_SPHERE_RADIUS / np.linalg.norm(v, axis=-1).mean())
    rng = np.random.default_rng(0)
    d = rng.normal(size=(20000, 3))
    gt_pts = (d / np.linalg.norm(d, axis=-1, keepdims=True) * J_SPHERE_RADIUS)
    if len(v) > 20000:
        v = v[rng.choice(len(v), 20000, replace=False)]
    return jchamfer.chamfer_distance(v, gt_pts)[0]


def _jax_pose_errors(est, gt):
    aligned = jevalpose.align_ate_c2b_use_a2b(est, gt)
    return jevalpose.compute_ATE(gt, aligned), *jevalpose.compute_rpe(gt, aligned)


def test_harness_evaluation_matches_jax(tiny_run):
    work, gt, dispatch = tiny_run
    assert dispatch == "scan x100"
    run = quality.read_run(work, "cpu")
    m = quality.metrics(run, gt)

    _, _, _, p1_gt, p1_est = run["p1"]
    assert abs(m["p1_ate"] - _jax_pose_errors(p1_est, p1_gt)[0]) <= 1e-6

    name_to_gt = dict(zip(gt["names"], gt["poses"]))
    keep = [i for i, n in enumerate(run["names"]) if n in name_to_gt]
    assert len(keep) == 4
    ate, rpe_t, rpe_r = _jax_pose_errors(
        np.stack([run["learned"][i] for i in keep]),
        np.stack([name_to_gt[run["names"][i]] for i in keep]))
    for key, ref in (("p2_ate", ate), ("p2_rpe_trans", rpe_t), ("p2_rpe_rot", rpe_r)):
        assert np.isfinite(m[key]) and abs(m[key] - ref) <= 1e-6, key

    verts_j, faces_j = jmeshio.read_ply(run["ply"])
    verts_t, faces_t = tmeshio.read_ply(run["ply"])
    np.testing.assert_array_equal(verts_t, verts_j)
    np.testing.assert_array_equal(faces_t, faces_j)
    assert m["mesh_verts"] == len(verts_j) > 100
    assert abs(m["chamfer"] - _jax_sphere_chamfer(verts_j)) <= 1e-6
    assert np.isfinite(m["p2_psnr"])
