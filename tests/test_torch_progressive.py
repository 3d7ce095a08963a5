"""Slice 3 end to end on the CPU: the port's progressive Runner, its host
Dataset and in-memory scene, against the JAX package; and the port's
import hygiene.

* The Runner's plan (``_plan_step`` with the progressive bookkeeping of the
  training loop, no training) over the first 100 steps of
  ``tests/test_train_e2e.py``'s ``VIRTUAL_CONF`` equals the JAX Runner's:
  every packed row (learning rate, gates, frame ids, per-segment touch,
  freeze and LR), the flow coin, the match pixels and the admission
  events, exactly; with rotation-triggered resets forced, the resets too.
* A tiny progressive run trains through all 5 frames on the CPU.
* The port's ``Dataset`` reads a ``synthetic.py`` sequence like the JAX
  one: images, masks, boxes and matches exactly; cameras to the f32
  round-off of two decompositions (1e-4); and the in-memory scene's
  matches equal the written ones to their 3-decimal text format.
"""

import ast
import os

import numpy as np
import pytest
import torch

from fmov_pose_tpu.data import hocon as jhocon
from fmov_pose_tpu.data.dataset import Dataset as JDataset
from fmov_pose_tpu.data.synthetic import make_orbit_sequence
from fmov_pose_torch.data import hocon as thocon
from fmov_pose_torch.data import scene as tscene
from fmov_pose_torch.data.dataset import Dataset as TDataset
from fmov_pose_torch.data.dataset import load_K_Rt_from_P
from tests.test_torch_runner import _write_noise_cams
from tests.test_torch_step_fast import _count_calls
from tests.test_train_e2e import VIRTUAL_CONF, _write_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, HW = 5, 48


@pytest.fixture(scope="module")
def seq_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("prog")
    gt = make_orbit_sequence(str(root / "SYN_ori"), n_frames=N, H=HW, W=HW,
                             span_deg=40)
    _write_noise_cams(str(root / "SYN_ori"), gt["K"], gt["poses"])
    # the intrinsics-only camera sources (unknown_camera, ml_camera_intrinsics)
    np.save(str(root / "SYN_ori" / "K.npy"), gt["K"])
    np.savetxt(str(root / "K.txt"), gt["K"])
    return root


def _virtual_conf(root, tmp_path, end_iter=100, extra=()):
    text = VIRTUAL_CONF
    for old, new in extra:
        text = text.replace(old, new)
    return _write_conf(tmp_path / "virt.conf", text, exp_dir=str(tmp_path / "exp"),
                       data_dir=str(root / "SYN_ori"), flow_dir=str(root / "matches"),
                       end_iter=end_iter, batch=64)


def _plan(runner, n=100):
    """The training loop's host side without the steps."""
    rows = []
    runner._init_perms()
    for _ in range(n):
        packed, use_flow, pixels, img_id = runner._plan_step()
        runner.iter_step += 1
        if runner._pro_tick():
            rows.append(("event", runner.iter_step, runner.pro_iteration,
                         runner.current_image))
            runner._pro_events()
        runner._maybe_regen_perms()
        rows.append((packed, use_flow, pixels, img_id))
    return rows


@pytest.mark.parametrize("extra", [
    pytest.param((), id="as_written"),
    pytest.param((("reset_based_on_rot = False",
                   "reset_based_on_rot = True\n    reset_rot_threshold = 1e-3"),),
                 id="rotation_resets")])
def test_runner_plans_like_jax(seq_root, tmp_path, extra):
    from fmov_pose_tpu.train.runner import Runner as JRunner
    from fmov_pose_torch.train.runner import Runner as TRunner
    conf = _virtual_conf(seq_root, tmp_path, extra=extra)
    jr = JRunner(conf, mode="train", case="SYN_ori", has_global_conf=True)
    tr = TRunner(conf, mode="train", case="SYN_ori", has_global_conf=True,
                 device="cpu")
    assert (tr.pose_mode, tr.n_segments) == (jr.pose_mode, jr.n_segments) == ("seg", 5)
    pj, pt = _plan(jr), _plan(tr)
    n_flow = 0
    for step, (a, b) in enumerate(zip(pj, pt)):
        if isinstance(a[0], str):
            assert a == b, step
            continue
        np.testing.assert_array_equal(a[0], b[0], err_msg=str(step))
        assert (a[1], a[3]) == (b[1], b[3]), step
        assert (a[2] is None) == (b[2] is None), step
        if a[1]:
            n_flow += 1
            np.testing.assert_array_equal(a[2], b[2], err_msg=str(step))
    assert len(pj) == len(pt) and n_flow > 0
    assert (tr.current_image, tr.current_pose_mlp_index, tr.reset_count) == (
        jr.current_image, jr.current_pose_mlp_index, jr.reset_count)
    np.testing.assert_array_equal(tr.seg_frozen, jr.seg_frozen)
    np.testing.assert_array_equal(tr.seg_progress, jr.seg_progress)
    assert tr.rng.random() == jr.rng.random()  # the host RNG in step
    if extra:
        assert tr.reset_count > 0 and tr.iter_step == jr.iter_step
    np.testing.assert_array_equal(tr.state.bank_static["initialized"],
                                  np.asarray(jr.state.pose_bank["static"]["initialized"]))
    np.testing.assert_allclose(tr.query_poses(N), jr.query_poses(N), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["f32", "fused_flat"])
def test_progressive_cpu_run_reaches_all_frames(seq_root, tmp_path, fused, monkeypatch):
    """The port trains the tiny progressive conf through every admission
    (the JAX e2e test's checks); ``fused_flat`` takes the plain K2/K3."""
    from fmov_pose_torch.ops import fused_sdf
    from fmov_pose_torch.train.runner import Runner
    extra = ((("learning_rate = 5e-4",
               "learning_rate = 5e-4\n    use_fused_train_kernels = True"),)
             if fused else ())
    runner = Runner(_virtual_conf(seq_root, tmp_path, extra=extra), case="SYN_ori",
                    has_global_conf=True, device="cpu")
    assert runner.model_cfg["sdf"]["use_fused_train"] == fused
    calls = _count_calls(monkeypatch, fused_sdf, "sdf_apply_grad_fused")
    runner.train()
    steps = len(runner.history["loss"])
    assert len(calls) == (steps if fused else 0)
    # mesh warm-up 10 + 5 frames x 15 steps, then the early return
    assert runner.current_image == N and runner.pro_iteration == -1
    assert runner.current_pose_mlp_index == N - 1 and steps == 85
    assert bool(runner.state.bank_static["initialized"].all())
    assert runner.flow_steps > 0
    assert np.all(np.isfinite(runner.history["loss"]))
    poses = runner.query_poses(N)
    assert np.isfinite(poses).all()
    for p in poses:
        np.testing.assert_allclose(p[:3, :3].T @ p[:3, :3], np.eye(3), atol=1e-3)


DATASET_CONFS = {
    "phase1": """dataset {{
        data_dir = {d}/
        render_cameras_name = cameras_sphere.npz
        loftr_interval_flow_dir = {m}
        crop = True
        partial_ann = True
        mask_init = True
    }}""",
    "crop_init": """dataset {{
        data_dir = {d}/
        render_cameras_name = cameras_sphere.npz
        partial_ann = True
        use_crop_init = True
        wo_mask = True
        filter_match_outliers = True
        loftr_interval_flow_dir = {m}
    }}""",
    "full_annotation": """dataset {{
        data_dir = {d}/
        render_cameras_name = cameras_sphere.npz
        mask_init = True
    }}""",
    "unknown_camera": """dataset {{
        data_dir = {d}/
        unknown_camera = True
        mask_init = True
    }}""",
    "ml_camera_intrinsics": """dataset {{
        data_dir = {d}/
        render_cameras_name = none.npz
        ml_camera_intrinsics = {r}/K.txt
    }}""",
}


@pytest.mark.parametrize("name", sorted(DATASET_CONFS))
def test_dataset_matches_jax(seq_root, name):
    text = DATASET_CONFS[name].format(d=seq_root / "SYN_ori", m=seq_root / "matches",
                                      r=seq_root)
    dj = JDataset(jhocon.parse_string(text)["dataset"])
    dt = TDataset(thocon.parse_string(text)["dataset"])
    for key in ("images_np", "masks_np", "mask_bboxes"):
        np.testing.assert_array_equal(getattr(dt, key), getattr(dj, key), err_msg=key)
    assert (dt.H, dt.W, dt.n_images) == (dj.H, dj.W, dj.n_images)
    assert dt.index_to_frame == dj.index_to_frame
    assert dt.avai_ann_frame == dj.avai_ann_frame
    for key in ("intrinsics_all", "intrinsics_all_inv", "pose_all", "gt_poses"):
        np.testing.assert_allclose(getattr(dt, key), getattr(dj, key), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    for key in ("crop_poses", "max_mask_pose"):
        if getattr(dj, key) is None:
            assert getattr(dt, key) is None, key
        else:
            np.testing.assert_allclose(getattr(dt, key), getattr(dj, key), atol=1e-4,
                                       err_msg=key)
    assert dt.flow_pairs == dj.flow_pairs
    assert sorted(dt.loftr_flows) == sorted(dj.loftr_flows)
    for k, v in dj.loftr_flows.items():
        for a, b in zip(dt.loftr_flows[k], v):
            np.testing.assert_array_equal(a, b, err_msg=k)
    if name == "phase1":
        assert len(dt.loftr_flows) == 2 * (N - 1)


def test_scene_matches_written_sequence(seq_root):
    """The in-memory scene's matches, frame names and mask-init pose are
    the written sequence's as the Dataset reads it (matches to the 3
    decimals of the match files)."""
    text = DATASET_CONFS["phase1"].format(d=seq_root / "SYN_ori", m=seq_root / "matches")
    ds = TDataset(thocon.parse_string(text)["dataset"])
    sc = tscene.make_orbit_scene(n_frames=N, H=HW, W=HW, span_deg=40, crop=True)
    assert sc.index_to_frame == ds.index_to_frame
    assert sc.frame_to_index == ds.frame_to_index
    assert sc.flow_pairs == ds.flow_pairs
    for k, v in ds.loftr_flows.items():
        for a, b in zip(sc.loftr_flows[k], v):
            np.testing.assert_allclose(a, b, rtol=0, atol=1.5e-3, err_msg=k)
    np.testing.assert_allclose(sc.max_mask_pose, ds.max_mask_pose, atol=1e-5)
    np.testing.assert_array_equal(sc.mask_bboxes, ds.mask_bboxes)


def test_load_K_Rt_from_P_recovers_the_camera():
    """K [R | -R C] back to (K, c2w) with K's diagonal positive, for a
    camera whose decomposition needs the sign fix."""
    rng = np.random.default_rng(0)
    A = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R = A * np.sign(np.linalg.det(A))
    K = np.array([[300.0, 0.5, 60.0], [0.0, 280.0, 40.0], [0.0, 0.0, 1.0]])
    C = rng.normal(size=3)
    P = 2.5 * K @ np.concatenate([R, -R @ C[:, None]], 1)
    intr, pose = load_K_Rt_from_P(P)
    np.testing.assert_allclose(intr[:3, :3], K, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(pose[:3, :3], R.T, atol=1e-6)
    np.testing.assert_allclose(pose[:3, 3], C, atol=1e-5)


def test_no_module_imports_the_jax_package():
    """No import of jax or fmov_pose_tpu anywhere in the port's sources or
    chip_smoke.py, inside functions included (cv2 only inside functions)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fmov_pose_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "fmov_pose_tpu"), (path, mod)
                if top == "cv2":
                    assert node.col_offset > 0, (path, "cv2 at module level")


def test_runner_needs_cuda_by_default():
    """Runner() with no device asks for the CUDA device: no silent CPU run."""
    from fmov_pose_torch.train.runner import Runner
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runner("unused.conf")


def test_cli_trains_progressive_conf(seq_root, tmp_path):
    """The CLI takes a phase-1 conf and its flags (exp-dir suffixes, the
    conf overrides), on the device it is given."""
    from fmov_pose_torch import exp_runner
    conf = _virtual_conf(seq_root, tmp_path, end_iter=30)
    runner = exp_runner.main(["--mode", "train", "--conf", conf, "--case", "SYN_ori",
                              "--flow_interval", "2", "--reset_rot_degree", "45"],
                             device="cpu")
    assert runner.base_exp_dir.endswith("_wo_global_conf_m2_r45")
    assert (runner.flow_interval, runner.reset_rot_threshold) == (2, 45.0)
    assert runner.iter_step == 30 and runner.current_image > 1
    assert np.all(np.isfinite(runner.history["loss"]))
