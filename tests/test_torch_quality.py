"""The two-phase quality harness (``fmov_pose_torch/quality.py``) and the
port's Chamfer distance on the CPU, against the JAX package.

* ``pipeline/chamfer.py``: bitwise the JAX copy on the same points and
  seed (it is numpy in both).
* The harness's flags and defaults and its JSON keys are the JAX
  script's (``scripts/pipeline_quality.py``, read with ``ast``), plus
  ``p2_dispatch``, ``device`` and ``power_limit``.
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
