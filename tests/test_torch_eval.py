"""The eval renders and the Runner's eval and export methods, port against
the JAX package on the CPU, from one converted state.

One tiny JAX Runner (the phase-2 gf conf of ``tests/test_torch_runner.py``
with ``perturb = 0``, batch 64, 8 + 8 samples, ``use_fused_kernels``
off, so that both sides run the f32 networks) trains 5 steps on a 4-frame
32x40 orbit written to disk and saves; a JAX Runner and a port Runner
(``device="cpu"``) each load that checkpoint with ``is_continue`` into
their own exp dir.  Every method runs on both and is held to JAX's:

* ``render_rays_chunked`` on 150 rays (chunks of 64, the last one
  padded): all four outputs within atol 1e-4 (measured ~3e-5: the f32
  networks in another order); on the fast conf through the plain versions
  (``use_fused_train``, the rays and color gates patched to 0, JAX's
  Pallas kernels in interpret mode, chunks of 8): K1 in the up-sampler,
  K4 and K8 on both sides, within atol 2e-2 on a few rays and a median
  within 1e-3 (the bf16 operands, rounded apart in a few samples);
* ``validate_image`` (the frame drawn from the host RNG on both sides):
  the PSNR within 1e-4 relative, the PNGs under JAX's names, equal up to
  +-1 in at most 1% of the pixels (truncation next to an integer);
* ``validate_poses``: ATE and RPE translation within 1e-5 relative, the
  RPE rotation within 1e-5 rad (an arccos near 1), the ``stats_*`` json
  alike, the same files; ``save_poses``' arrays within 1e-5;
* ``render_novel_image`` frames and ``interpolate_view``'s video: equal
  up to +-1; ``rays_from_mask`` arrays within 1e-6;
  ``save_alignment_materials``' points within 1e-3 (median 1e-5);
* ``render_poses``, with and without the normal maps, and
  ``validate_all_images``: the same files, their images within the JPEG
  or GIF coding of a +-1 pixel difference (mean |diff| < 0.5);
* ``gradient_analysis_report`` with the ray draw patched to one batch on
  both sides: every (min, max, mean) within 1e-3 relative of the
  largest;
* the texture bake (``bake_texture`` of each package on one mesh at
  ``tex_size`` 64, fed its Runner's eval render): the vertex normals
  within 1e-4, the atlas equal, the texture equal up to +-1.

The training loop's eval calls (``validate_image`` every ``val_freq``,
``validate_poses`` every ``pose_freq``, the gradient report at
``report_freq``) are checked on a short port run.

The CLI's eval and export modes: the work dir (the global conf's own exp
dir and the phase-2 dir of a two-phase run, both holding the trained
checkpoint) is copied once for each side and mode; the JAX CLI
(``exp_runner.py``) and the port's (``fmov_pose_torch.exp_runner.main(...,
device="cpu")``) run the same command in their copies.  Both must write
the same new files (the JAX package's tensorboard logs and the source
backups aside), compared by kind:

* ``.npy`` / ``.npz`` arrays within 1e-4 (the world points of
  ``save_alignment_materials`` 1e-3, as above), the ``stats_*.json``
  numbers within 1e-5 relative (the RPE rotation 1e-5 rad), pickled pose
  dicts key by key;
* PNGs equal up to +-1 in at most 1% of the pixels; JPEG, GIF and mp4
  frames (their bytes excepted) and the antialiased pose plot with the
  same frame counts and a mean |diff| < 0.5;
* PLY meshes (the 64^3 marching cubes of two f32 SDF grids): the same
  faces, vertices within 1e-4; the OBJ of a textured mesh likewise, its
  normals within 1e-3;
* text files (``stats_*.txt``, the MTL) line by line, numbers within
  1e-4 relative.

The bake's ``tex_size`` is cut from 1,024 to 128 on both sides (the
default renders ~60 chunks of 8,192 rays on the CPU; at 64 the 64^3
mesh's faces get no texel).  The normalization's unseeded draw is seeded
alike on both sides, as in ``tests/test_torch_pipeline.py``.
``--gradient_analysis`` is run on the port's CLI alone (the JAX report's
values are held above).

``pipeline/preprocess.py``: ``main`` on ``tests/test_pipeline.py``'s
sequence with depth, ``--ori`` and the 480 crop, through both packages:
the same files, the images byte for byte, the cameras within 1e-4 (the
port decomposes the annotation with ``scipy.linalg.rq``, JAX with
OpenCV).

One module, so that one worker trains the JAX Runner once and its
compiled functions serve both halves.
"""

import functools
import json
import logging
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.data import rays as jrays
from fmov_pose_tpu.data.synthetic import make_orbit_sequence
from fmov_pose_torch.data import rays as trays
from fmov_pose_torch.data.scene import noisy_poses
from fmov_pose_torch.ops import fused_color, fused_sdf
from tests.test_torch_pipeline import _seeded
from tests.test_torch_runner import CONF, _write_noise_cams
from tests.test_torch_step_fast import _count_calls, gates  # noqa: F401 (fixture)
from tests.test_train_e2e import VIRTUAL_CONF

N, H, W, BATCH, STEPS = 4, 32, 40, 64, 5
GLOBAL_NAME = "ho3d_global_tiny"
# the phase-2 Runner's dir of a two-phase run (exp_runner.py's reboot)
P2_DIR = os.path.join("exp", "SYN_ori", "ours", GLOBAL_NAME)
# the global conf's own exp dir, as --conf without --global_conf opens it
OWN_DIR = os.path.join("global_reset_exp", "SYN", "womask")


def _global_conf():
    text = CONF.format(exp_dir="./global_reset_exp/CASE_NAME/womask",
                       data_dir="./data/HO3Dv3/CASE_NAME")
    for old, new in (("batch_size = 256", f"batch_size = {BATCH}"),
                     ("perturb = 1.0", "perturb = 0.0"),
                     ("n_samples = 16, n_importance = 16", "n_samples = 8, n_importance = 8"),
                     ("end_iter = 40", f"end_iter = {STEPS}"),
                     ("mask_guided_sampling = True",
                      "mask_guided_sampling = True\n    use_fused_kernels = False"
                      "\n    data_parallel = False")):
        assert old in text, old
        text = text.replace(old, new)
    return text


def _state_dir(root, rel, src=None):
    """``rel`` under ``root`` (or an absolute path) holding the work dir's
    phase-2 cameras (and ``src``'s checkpoints)."""
    d = os.path.join(str(root), rel)
    os.makedirs(d, exist_ok=True)
    seq = os.path.join(str(root), "data", "HO3Dv3", "SYN")
    for name in ("cameras_sphere.npz", "noise_cameras_sphere.npz"):
        shutil.copy(os.path.join(seq, name), d)
    if src is not None:
        shutil.copytree(os.path.join(src, "checkpoints"), os.path.join(d, "checkpoints"))
    return d


def write_eval_work(root):
    """The HO3D layout under ``root`` (SYN_ori with crop and matches; SYN
    with the noisy phase-2 init), the tiny virtual and global confs, and
    the global conf trained STEPS steps by a JAX Runner in its own exp
    dir; the phase-2 dir of a two-phase run holds the same checkpoint."""
    from fmov_pose_tpu.train.runner import Runner as JRunner
    data = os.path.join(str(root), "data", "HO3Dv3")
    make_orbit_sequence(os.path.join(data, "SYN_ori"), n_frames=N, H=H, W=W, span_deg=40)
    gt = make_orbit_sequence(os.path.join(data, "SYN"), n_frames=N, H=H, W=W,
                             span_deg=40, with_matches=False, with_crop=False)
    _write_noise_cams(os.path.join(data, "SYN"), gt["K"], noisy_poses(gt["poses"], 5.0, 2))
    confs = os.path.join(str(root), "confs")
    os.makedirs(confs)
    with open(os.path.join(confs, "virtual_tiny.conf"), "w") as f:
        f.write(VIRTUAL_CONF.format(
            exp_dir="./exp/CASE_NAME/ours", data_dir="./data/HO3Dv3/CASE_NAME",
            flow_dir="./data/HO3Dv3/matches", end_iter=60, batch=BATCH))
    with open(os.path.join(confs, GLOBAL_NAME + ".conf"), "w") as f:
        f.write(_global_conf())
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        jr = JRunner(f"./confs/{GLOBAL_NAME}.conf", mode="train", case="SYN")
        assert jr.base_exp_dir == "./" + OWN_DIR
        jr.train()
    assert jr.iter_step == STEPS
    _state_dir(root, P2_DIR, os.path.join(str(root), OWN_DIR))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: with the
    suite's workers on every core, PyTorch's intra-op threads spin against
    each other (the 60-frame interpolation went from 3 s to 150 s of port
    time beside seven busy processes; 3 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    write_eval_work(root)
    return root


@pytest.fixture(scope="module")
def runners(work):
    """(JAX Runner, port Runner) on the saved state, each in its own exp
    dir; the cwd is the work dir while they live."""
    from fmov_pose_tpu.train.runner import Runner as JRunner
    from fmov_pose_torch.train.runner import Runner as TRunner
    root = work
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    conf = f"./confs/{GLOBAL_NAME}.conf"
    src = os.path.join(str(root), OWN_DIR)
    jr = JRunner(conf, mode="train", case="SYN", is_continue=True,
                 exp_dir=_state_dir(root, "jax", src), has_global_conf=True)
    tr = TRunner(conf, mode="train", case="SYN", is_continue=True,
                 exp_dir=_state_dir(root, "torch", src), has_global_conf=True,
                 device="cpu")
    assert jr.iter_step == tr.iter_step == STEPS
    yield jr, tr
    mp.undo()


def _rays(n=150, seed=0):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, -2.5]).astype(np.float32)
    rd = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, 1.0]).astype(np.float32)
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _new_files(jr, tr, sub):
    jd, td = (os.path.join(r.base_exp_dir, sub) for r in (jr, tr))
    assert _files(jd) == _files(td)
    return [(os.path.join(jd, f), os.path.join(td, f)) for f in _files(jd)]


def _close_images(a, b, exact_share=0.99):
    """uint8 images equal up to +-1, in all but 1% of the pixels exactly."""
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= exact_share, (d == 0).mean()


def _close_coded(a, b):
    """Decoded JPEG/GIF frames of images that differ by +-1 in a few
    pixels: mean |diff| < 0.5."""
    assert a.shape == b.shape
    assert np.abs(a.astype(np.float64) - b).mean() < 0.5


def test_render_rays_chunked_matches_jax(runners):
    jr, tr = runners
    ro, rd = _rays()
    oj = jr.render_rays_chunked(ro, rd)
    before = tr.eval_chunks
    ot = tr.render_rays_chunked(ro, rd)
    assert tr.eval_chunks - before == 3  # 150 rays in chunks of 64
    for k in ("color_fine", "normal", "depth_fine", "weight_sum"):
        assert ot[k].shape == oj[k].shape == ((150, 3) if k in ("color_fine", "normal")
                                              else (150, 1))
        np.testing.assert_allclose(ot[k], oj[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_render_rays_chunked_fast_conf_matches_jax(runners, gates, monkeypatch):  # noqa: F811
    """The fused route under no_grad: K1 in the up-sampler, K4 and K8 (the
    plain versions here, JAX's kernels in interpret mode)."""
    jr, tr = runners
    ro, rd = _rays(20, seed=1)
    calls = {n: _count_calls(monkeypatch, mod, n) for mod, n in (
        (fused_sdf, "sdf_forward_plain"), (fused_sdf, "sdf_fwd_grad_plain"),
        (fused_color, "color_ray_fwd_plain"))}
    saved = [(r, dict(r.model_cfg["sdf"])) for r in (jr, tr)]
    try:
        for r, sdf in saved:
            r.model_cfg["sdf"] = dict(sdf, use_fused_train=True)
        oj = jr.render_rays_chunked(ro, rd, chunk=8)
        ot = tr.render_rays_chunked(ro, rd, chunk=8)
    finally:
        for r, sdf in saved:
            r.model_cfg["sdf"] = sdf
    # 3 chunks: K1 twice each (the coarse pass and the first of the two
    # up-sampling steps; the last queries nothing), K4 and K8 once
    assert {n: len(c) for n, c in calls.items()} == {
        "sdf_forward_plain": 6, "sdf_fwd_grad_plain": 3, "color_ray_fwd_plain": 3}
    for k in ("color_fine", "normal", "depth_fine", "weight_sum"):
        d = np.abs(ot[k] - oj[k])
        assert d.max() < 2e-2 and np.median(d) < 1e-3, (k, d.max(), np.median(d))


@pytest.mark.parametrize("level", [1, 4])
def test_validate_image_matches_jax(runners, level):
    import cv2 as cv
    jr, tr = runners
    pj = jr.validate_image(resolution_level=level)
    pt = tr.validate_image(resolution_level=level)
    assert abs(pt - pj) <= 1e-4 * abs(pj), (pt, pj)
    for sub in ("validations_fine", "normals"):
        pairs = _new_files(jr, tr, sub)
        for a, b in pairs:
            _close_images(cv.imread(a), cv.imread(b))
    name = os.path.basename(pairs[-1][1])
    assert name.startswith(f"{tr.current_image:08d}_{tr.iter_step:08d}_0_")
    assert tr.rng.random() == jr.rng.random()  # the host RNGs in step


def test_validate_poses_matches_jax(runners):
    jr, tr = runners
    rj, rt = jr.validate_poses(save_pose=True), tr.validate_poses(save_pose=True)
    np.testing.assert_allclose(rt[:2], rj[:2], rtol=1e-5)
    # the RPE rotation is an arccos near 1: f32 poses 1e-7 apart move it ~1e-6
    np.testing.assert_allclose(rt[2], rj[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt[3], rj[3], atol=1e-6)
    np.testing.assert_allclose(rt[4], rj[4], atol=1e-5)
    pairs = _new_files(jr, tr, "poses") + _new_files(jr, tr, "poses_arr")
    stats = [p for p in pairs if p[0].endswith(".json")]
    assert [os.path.basename(p[0]) for p in stats] == [f"stats_{STEPS:06d}.json"]
    with open(stats[0][0]) as f:
        sj = json.load(f)
    with open(stats[0][1]) as f:
        st = json.load(f)
    assert sj.keys() == st.keys()
    np.testing.assert_allclose([st["ate_rmse"], st["rpe_trans"]],
                               [sj["ate_rmse"], sj["rpe_trans"]], rtol=1e-5)
    np.testing.assert_allclose(st["rpe_rot_deg"], sj["rpe_rot_deg"], rtol=0,
                               atol=np.rad2deg(1e-5))
    for k, v in sj["trans_error"].items():
        np.testing.assert_allclose(st["trans_error"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    for a, b in pairs:
        if a.endswith(".npy"):
            np.testing.assert_allclose(np.load(b), np.load(a), atol=1e-5)


def test_save_poses_matches_jax(runners):
    jr, tr = runners
    current = [r.current_image for r in (jr, tr)]
    try:
        jr.save_poses(), tr.save_poses()
        assert tr.current_image == jr.current_image == 1  # lowered by 10, at least 1
    finally:
        jr.current_image, tr.current_image = current
    for a, b in _new_files(jr, tr, "poses"):
        if a.endswith(".npy"):
            np.testing.assert_allclose(np.load(b), np.load(a), atol=1e-5, err_msg=a)


@pytest.mark.parametrize("ratio", [0.0, 0.3])
def test_render_novel_image_matches_jax(runners, ratio):
    jr, tr = runners
    a = jr.render_novel_image(0, N - 1, ratio, 2)
    b = tr.render_novel_image(0, N - 1, ratio, 2)
    assert b.dtype == np.uint8 and b.shape == (H // 2, W // 2, 3)
    _close_images(a, b)


def _video_frames(path):
    import cv2 as cv
    cap = cv.VideoCapture(path)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    return np.stack(frames)


def test_interpolate_view_matches_jax(runners):
    jr, tr = runners
    jr.interpolate_view(0, N - 1, n_frames=4)
    path = tr.interpolate_view(0, N - 1, n_frames=4)
    (a, b), = _new_files(jr, tr, "render")
    assert b == path and path.endswith(f"{STEPS:08d}_0_{N - 1}.mp4")
    fa, fb = _video_frames(a), _video_frames(b)
    assert fa.shape == fb.shape == (8, H // 4, W // 4, 3)
    _close_coded(fa, fb)


@pytest.mark.parametrize("idx,level", [(1, 1), (N - 1, 2)])
def test_rays_from_mask_matches_jax(runners, idx, level):
    jr, tr = runners
    pose = tr.query_pose(idx)
    a = jr.rays_from_mask(idx, pose, resolution_level=level)
    b = tr.rays_from_mask(idx, pose, resolution_level=level)
    for x, y, name in zip(a, b, ("rays_o", "rays_d", "ys", "xs", "p_norm")):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(y, np.asarray(x), atol=1e-6, err_msg=name)


def test_save_alignment_materials_matches_jax(runners, tmp_path):
    jr, tr = runners
    pa = jr.save_alignment_materials(align_dir=str(tmp_path))
    os.rename(pa, pa + ".jax.npy")
    pb = tr.save_alignment_materials(align_dir=str(tmp_path))
    assert pb == pa == os.path.join(str(tmp_path), "SYN_world_pts_3D.npy")
    a, b = np.load(pa + ".jax.npy"), np.load(pb)
    assert a.shape == b.shape and a.shape[1] == 4
    d = np.abs(a - b)
    assert d.max() < 1e-3 and np.median(d) < 1e-5, (d.max(), np.median(d))


@pytest.mark.parametrize("wo_normal", [False, True], ids=["normals", "pure"])
def test_render_poses_matches_jax(runners, wo_normal):
    import imageio
    import cv2 as cv
    jr, tr = runners
    for r in (jr, tr):
        shutil.rmtree(os.path.join(r.base_exp_dir, "normal_vis"), ignore_errors=True)
        r.render_poses(wo_normal=wo_normal)
    pairs = _new_files(jr, tr, "pose_vis") + _new_files(jr, tr, "normal_vis")
    assert len(pairs) == (N if wo_normal else 2 * N)
    for a, b in pairs:
        _close_coded(cv.imread(a), cv.imread(b))
    gifs = [os.path.join(r.base_exp_dir, f"poses_{STEPS}.gif") for r in (jr, tr)]
    _close_coded(np.stack(imageio.mimread(gifs[0])), np.stack(imageio.mimread(gifs[1])))


def test_validate_all_images_matches_jax(runners):
    import imageio
    jr, tr = runners
    jr.validate_all_images(), tr.validate_all_images()
    a, b = (np.stack(imageio.mimread(os.path.join(r.base_exp_dir, "imgs.gif")))
            for r in (jr, tr))
    assert a.shape == b.shape and a.shape[0] == N
    _close_coded(a, b)


def test_gradient_analysis_report_matches_jax(runners, monkeypatch):
    """One ray batch of frame 1 on both sides (the draws patched), the
    JAX gradients jitted for speed."""
    jr, tr = runners
    rng = np.random.default_rng(3)
    with torch.no_grad():
        data = trays.gen_random_rays(
            None, tr.images_dev, tr.masks_dev, tr.intr_inv_dev,
            torch.as_tensor(tr.query_pose(1)[:3]), 1, BATCH, None, 0, False, H, W,
            pixels=(torch.from_numpy(rng.integers(0, W, BATCH)),
                    torch.from_numpy(rng.integers(0, H, BATCH)))).numpy()
    monkeypatch.setattr(jrays, "gen_random_rays", lambda *a, **k: jnp.asarray(data))
    monkeypatch.setattr(trays, "gen_random_rays", lambda *a, **k: torch.from_numpy(data))
    grad = jax.grad
    monkeypatch.setattr(jax, "grad", lambda f: jax.jit(grad(f)))
    rj, rt = jr.gradient_analysis_report(1), tr.gradient_analysis_report(1)
    assert rj.keys() == rt.keys() == {"color_loss", "eikonal_loss", "mask_loss"}
    for name in rj:
        assert rj[name].keys() == rt[name].keys(), name
        for net, sj in rj[name].items():
            scale = max(abs(v) for v in sj)
            np.testing.assert_allclose(rt[name][net], sj, rtol=0,
                                       atol=1e-3 * scale + 1e-12, err_msg=f"{name} {net}")


def test_bake_texture_matches_jax(runners):
    """``bake_texture`` of each package on one 32^3 mesh, fed its Runner's
    eval render (64-ray chunks, the bake's near/far, cos-anneal 1) and its
    SDF-gradient normals; ``textured_mesh`` end to end is the CLI modes'
    (below)."""
    from fmov_pose_tpu.fields import nets as jn
    from fmov_pose_tpu.pipeline import textured as jtex
    from fmov_pose_torch.pipeline import meshio
    from fmov_pose_torch.pipeline import textured as ttex
    jr, tr = runners
    verts, faces = meshio.read_ply(tr.validate_mesh(resolution=32))
    assert len(faces) > 0
    nj = np.asarray(jn.sdf_gradient(jr.state.params["sdf"], jr.model_cfg["sdf"],
                                    jnp.asarray(verts, jnp.float32)))
    nt = ttex._vertex_normals(tr, verts)
    np.testing.assert_allclose(nt, nj, atol=1e-4)
    params_j = {k: v for k, v in jr.state.params.items()
                if k in ("sdf", "color", "nerf", "variance")}

    def render_j(o, d, near, far):
        out = jr._eval_render(jax.random.key(0), params_j, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(near), jnp.asarray(far), jnp.asarray(1.0))
        return np.asarray(out["color_fine"])

    def render_t(o, d, near, far):
        return tr.eval_render(o, d, near, far, 1.0)["color_fine"].cpu().numpy()

    tex_j, uvs_j = jtex.bake_texture(verts, faces, nj, render_j, 64, chunk=BATCH)
    tex_t, uvs_t = ttex.bake_texture(verts, faces, nt, render_t, 64, chunk=BATCH)
    np.testing.assert_array_equal(uvs_t, uvs_j)
    assert (tex_t > 0).any()
    _close_images(tex_j, tex_t)


def test_training_loop_runs_the_eval_calls(work, tmp_path, monkeypatch):
    """A port run with val_freq = pose_freq = 2 and the gradient report on
    (report_freq 10: at step 1) writes the validation images and pose
    stats where the JAX loop would, and draws the frames of
    validate_image from the host RNG."""
    from fmov_pose_torch.train.runner import Runner as TRunner
    root = work
    monkeypatch.chdir(root)
    text = _global_conf().replace("val_freq = 2500", "val_freq = 2").replace(
        "pose_freq = 10000", "pose_freq = 2")
    conf = tmp_path / "loop.conf"
    conf.write_text(text)
    tr = TRunner(str(conf), mode="train", case="SYN", gradient_analysis=True,
                 exp_dir=_state_dir(root, str(tmp_path / "loop")), has_global_conf=True,
                 device="cpu")
    reports = _count_calls(monkeypatch, tr, "gradient_analysis_report")
    tr.train()
    # the host RNG (seed 2024): the frame permutation, then a frame at
    # steps 2 and 4 (no flow coin: flow_weight is 0)
    draws = np.random.default_rng(2024)
    draws.permutation(N)
    expected = [int(draws.integers(N)), int(draws.integers(N))]
    names = sorted(os.listdir(os.path.join(tr.base_exp_dir, "validations_fine")))
    assert names == sorted({f"{N:08d}_{s:08d}_0_{i}.png" for s, i in zip((2, 4), expected)})
    assert sorted(os.listdir(os.path.join(tr.base_exp_dir, "normals"))) == names
    stats = sorted(f for f in os.listdir(os.path.join(tr.base_exp_dir, "poses"))
                   if f.startswith("stats_"))
    assert stats == ["stats_000002.json", "stats_000002.txt",
                     "stats_000004.json", "stats_000004.txt"]
    assert len(reports) == 1 and tr.iter_step == STEPS


# ----------------------------------------------------------------------
# the CLI's eval and export modes against the JAX CLI, and preprocessing
# ----------------------------------------------------------------------

G_ARGS = ["--conf", f"./confs/{GLOBAL_NAME}.conf", "--case", "SYN", "--is_continue"]
TWO_ARGS = ["--conf", "./confs/virtual_tiny.conf", "--case", "SYN_ori",
            "--global_conf", f"./confs/{GLOBAL_NAME}.conf"]
TEX_SIZE = 128


def _tree(root):
    return {os.path.relpath(os.path.join(r, f), root)
            for r, _, fs in os.walk(root) for f in fs
            if "recording" not in r.split(os.sep) and "logs" not in r.split(os.sep)}


def _jax_cli(argv):
    import exp_runner as jexp_runner
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["exp_runner.py"] + argv)
        jexp_runner.main()


def _port_cli(argv):
    from fmov_pose_torch import exp_runner
    return exp_runner.main(argv, device="cpu")


def _run_both(work, tmp_path, argv):
    """The command in a copy of the work dir per side; returns the two
    roots and the new files (the same on both sides)."""
    from fmov_pose_tpu.pipeline import textured as jtex
    from fmov_pose_torch.pipeline import textured as ttex
    before = _tree(work)
    roots = []
    for side, cli in (("jax", _jax_cli), ("torch", _port_cli)):
        root = tmp_path / side
        shutil.copytree(work, root)
        os.makedirs(root / "align")
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(root)
            _seeded(mp)
            for mod in (jtex, ttex):
                mp.setattr(mod, "textured_mesh",
                           functools.partial(mod.textured_mesh, tex_size=TEX_SIZE))
            cli(argv)
        roots.append(root)
    new = [sorted(_tree(r) - before) for r in roots]
    assert new[0] == new[1], (new[0], new[1])
    return roots, new[0]


def _numbers_close(a, b, rtol, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _numbers_close(a[k], b[k], rtol, f"{what}.{k}")
    elif "rpe_rot" in what:
        np.testing.assert_allclose(b, a, rtol=0, atol=np.rad2deg(1e-5), err_msg=what)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-7, err_msg=what)


def _text_close(a, b):
    with open(a) as f, open(b) as g:
        la, lb = f.read().split(), g.read().split()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            assert x == y
            continue
        np.testing.assert_allclose(fy, fx, rtol=1e-4, atol=1e-4 * ("rpe_rot" in a))


def _obj(path):
    rows = {"v": [], "vt": [], "vn": [], "f": []}
    with open(path) as f:
        for line in f:
            key, *vals = line.split()
            if key in rows:
                rows[key].append(vals)
    return rows


def _same_file(a, b):
    import cv2 as cv
    import imageio
    from fmov_pose_torch.pipeline import meshio
    ext = os.path.splitext(a)[1]
    if ext == ".npy":
        x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        if x.dtype == object:  # {frame: c2w}
            x, y = x.item(), y.item()
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_allclose(y[k], x[k], atol=1e-4, err_msg=k)
        else:
            tol = 1e-3 if a.endswith("world_pts_3D.npy") else 1e-4
            np.testing.assert_allclose(y, x, atol=tol, err_msg=a)
    elif ext == ".npz":
        x, y = np.load(a), np.load(b)
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_allclose(y[k], x[k], atol=1e-4, err_msg=k)
    elif ext == ".json":
        with open(a) as f, open(b) as g:
            _numbers_close(json.load(f), json.load(g), 1e-5, os.path.basename(a))
    elif ext == ".png" and not os.path.basename(a).startswith("aligned_pose_"):
        _close_images(cv.imread(a), cv.imread(b))
    elif ext in (".jpg", ".png"):  # JPEGs, and the antialiased pose plot
        _close_coded(cv.imread(a), cv.imread(b))
    elif ext == ".gif":
        _close_coded(np.stack(imageio.mimread(a)), np.stack(imageio.mimread(b)))
    elif ext == ".mp4":
        x, y = _video_frames(a), _video_frames(b)
        assert x.shape == y.shape
        _close_coded(x, y)
    elif ext == ".ply":
        (va, fa), (vb, fb) = meshio.read_ply(a), meshio.read_ply(b)
        np.testing.assert_array_equal(fb, fa)
        np.testing.assert_allclose(vb, va, atol=1e-4)
    elif ext == ".obj":
        x, y = _obj(a), _obj(b)
        assert x["f"] == y["f"] and len(x["vt"]) == len(y["vt"])
        for k, tol in (("v", 1e-4), ("vt", 1e-6), ("vn", 1e-3)):
            np.testing.assert_allclose(np.float64(y[k]), np.float64(x[k]), atol=tol,
                                       err_msg=k)
    elif ext in (".txt", ".mtl"):
        _text_close(a, b)
    else:
        raise AssertionError(f"no comparison for {a}")


# (mode argv, files the mode must write, relative to the work dir)
MODES = {
    "validate_poses": (["--mode", "validate_poses"] + G_ARGS,
                       [f"{OWN_DIR}/poses/stats_000005.json"]),
    "interpolate": (["--mode", "interpolate_0_3"] + G_ARGS,
                    [f"{OWN_DIR}/render/00000005_0_3.mp4"]),
    "validate_all_images": (["--mode", "validate_all_images"] + G_ARGS,
                            [f"{OWN_DIR}/imgs.gif"]),
    "save_poses": (["--mode", "save_poses"] + G_ARGS,
                   [f"{OWN_DIR}/poses/pred_poses_5.npy",
                    f"{OWN_DIR}/poses/intrinsics.npy"]),
    "save_poses_simple": (["--mode", "save_poses_simple", "--align_dir", "./align"]
                          + G_ARGS, ["align/SYN_poses.npy"]),
    "save_aligned_poses": (["--mode", "save_aligned_poses"] + G_ARGS,
                           [f"{OWN_DIR}/global_poses_4_5.npy"]),
    "render_poses": (["--mode", "render_poses"] + TWO_ARGS,
                     [f"exp/SYN_ori/ours/{GLOBAL_NAME}/normal_vis/0003.jpg",
                      f"exp/SYN_ori/ours/{GLOBAL_NAME}/pose_vis/0003.jpg"]),
    "pure_render_poses": (["--mode", "pure_render_poses"] + G_ARGS,
                          [f"{OWN_DIR}/pose_vis/0000.jpg", f"{OWN_DIR}/poses_5.gif"]),
    "save_alignment_materials": (["--mode", "save_alignment_materials", "--align_dir",
                                  "./align"] + G_ARGS, ["align/SYN_world_pts_3D.npy"]),
    "validate_textured_mesh": (
        ["--mode", "validate_textured_mesh"] + G_ARGS,
        [f"{OWN_DIR}/meshes/textured_00000004_00000000_64_validate_textured_mesh/"
         "material_0.png"]),
    "generate_textured_mesh": (
        ["--mode", "generate_textured_mesh"] + TWO_ARGS,
        [f"exp/SYN_ori/ours/{GLOBAL_NAME}/meshes/textured_00000004_00000000_64_train/"
         "mesh.obj"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_mode_writes_jax_files(work, tmp_path, mode):
    argv, must = MODES[mode]
    (jroot, troot), new = _run_both(work, tmp_path, argv)
    assert set(must) <= set(new), (must, new)
    for rel in new:
        _same_file(str(jroot / rel), str(troot / rel))


def test_cli_gradient_analysis(work, tmp_path, caplog):
    """--gradient_analysis on the port's CLI: the report at step 1 of the
    training run (report_freq 10), logged per loss and network."""
    root = tmp_path / "ga"
    shutil.copytree(work, root)
    with pytest.MonkeyPatch.context() as mp, caplog.at_level(logging.INFO):
        mp.chdir(root)
        runner = _port_cli(["--mode", "train", "--conf", f"./confs/{GLOBAL_NAME}.conf",
                            "--case", "SYN", "--gradient_analysis",
                            "--final_mesh_resolution", "8"])
    assert runner.gradient_analysis and runner.iter_step == 5
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("gradient_analysis ")]
    assert [ln.split()[1].rstrip(":") for ln in lines] == [
        "color_loss", "eikonal_loss", "mask_loss"], lines
    assert all("'sdf'" in ln and "'color'" in ln for ln in lines)


@pytest.fixture(scope="module")
def raw_seq(tmp_path_factory):
    """tests/test_pipeline.py's raw sequence with depth."""
    root = tmp_path_factory.mktemp("raw")
    gt = make_orbit_sequence(str(root / "SEQ"), n_frames=4, H=64, W=64, span_deg=30,
                             with_matches=False, with_crop=False)
    os.makedirs(root / "SEQ" / "depth")
    for i, (_, _, depth) in enumerate(gt["frames"]):
        np.save(str(root / "SEQ" / "depth" / f"{i:04d}.npy"), depth)
    return root


@pytest.mark.parametrize("flags", [["--ori"], ["--crop_resolution", "480"]],
                         ids=["ori", "crop480"])
def test_preprocess_main_matches_jax(raw_seq, tmp_path, flags):
    from fmov_pose_tpu.pipeline import preprocess as jpre
    from fmov_pose_torch.pipeline import preprocess as tpre
    out = {}
    for side, mod in (("jax", jpre), ("torch", tpre)):
        root = tmp_path / side
        shutil.copytree(raw_seq, root)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["preprocess.py", "--root", str(root), "--has_gt"]
                       + flags)
            mod.main()
        out[side] = root
    jt, tt = _tree(out["jax"]), _tree(out["torch"])
    assert jt == tt
    made = sorted(f for f in jt if not f.startswith("SEQ" + os.sep))
    new_dir = "SEQ_ori" if flags == ["--ori"] else "SEQ_480"
    assert made and all(f.startswith(new_dir + os.sep) for f in made), made
    for rel in made:
        a, b = str(out["jax"] / rel), str(out["torch"] / rel)
        if rel.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            assert sorted(x.files) == sorted(y.files) and len(x.files) == 8
            for k in x.files:
                np.testing.assert_allclose(y[k], x[k], rtol=1e-4, atol=1e-4, err_msg=k)
        elif rel.endswith(".npy"):
            x, y = np.load(a, allow_pickle=True).item(), np.load(b, allow_pickle=True).item()
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(y[k], x[k])
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), rel
