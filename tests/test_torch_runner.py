"""The port's parameter conversion, in-memory scene, runner CLI and import
hygiene (no JAX)."""

import gc
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.data import hocon
from fmov_pose_tpu.data.dataset import Dataset
from fmov_pose_tpu.data.synthetic import make_orbit_sequence
from fmov_pose_tpu.fields import nets as jn
from fmov_pose_tpu.poses import picture_pose as jpp
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_torch import convert
from fmov_pose_torch.data import hocon as thocon
from fmov_pose_torch.data import scene as tscene
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tree():
    k1, k2 = jax.random.split(jax.random.key(0))
    cfg = {"d_out": 17, "d_in": 3, "d_hidden": 32, "n_layers": 4,
           "skip_in": (2,), "multires": 3, "bias": 0.5, "scale": 1.0}
    ccfg = {"d_feature": 16, "mode": "idr", "d_in": 9, "d_out": 3,
            "d_hidden": 16, "n_layers": 2, "multires_view": 2}
    tree = {"sdf": jn.init_sdf(k1, cfg), "color": jn.init_color(k2, ccfg),
            "variance": jn.init_variance({"init_val": 0.3}),
            "pose": jpp.init_gf(3, jpp.PoseCfg(emphasize_rot=True),
                                np.eye(4, dtype=np.float32))["train"]}
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "confs", "*.conf"))))
def test_hocon_reads_confs_like_the_jax_package(name):
    """The port's conf reader gives the JAX package's tree for every conf."""
    path = os.path.join(REPO, "confs", name)
    subs = {"CASE_NAME": "SYN", "DATA_SET": "HO3D"}
    ours = thocon.parse_file(path, subs)
    assert ours.as_plain_dict() == hocon.parse_file(path, subs).as_plain_dict()
    assert ours.get_int("model.sdf_network.d_hidden") == 256
    assert ours.get_list("model.sdf_network.skip_in") == [4]
    assert "model.neus_renderer.n_samples" in ours
    assert "model.no_such_key" not in ours


def test_hocon_syntax_like_the_jax_package():
    text = """
    a { b = 1, c = "x y"  # comment
        d: [1, 2.5,
            true, ]
    }
    e
    {
      f = 5e-4 // comment
      g { h = None }
    }
    """
    ours = thocon.parse_string(text)
    assert ours.as_plain_dict() == hocon.parse_string(text).as_plain_dict()
    assert ours["a.d"] == [1, 2.5, True] and ours.get_float("e.f") == 5e-4
    assert ours.get("e.g.h", 0) is None and ours.get("e.x", 7) == 7
    ours.put("e.g.k", 3)
    assert ours.get_int("e.g.k") == 3


def test_convert_round_trip():
    tree = _jax_tree()
    back = convert.to_numpy(convert.to_torch(tree))
    fj, fb = convert.flatten(tree), convert.flatten(back)
    assert [n for n, _ in fj] == [n for n, _ in fb]
    assert "sdf.layers.lin0.v" in dict(fj) and "pose.lin3_scale.b" in dict(fj)
    for (_, a), (_, b) in zip(fj, fb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_param_layout_is_ravel_pytree_order():
    """The flat buffer (and so the flat Adam's moments) has JAX's order."""
    tree = _jax_tree()
    layout = convert.ParamLayout(tree)
    flat = layout.ravel(tree)
    ref, _ = ravel_pytree(tree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref))
    assert layout.size == joptim.adam_init(tree).mu.shape[0]
    views = layout.views(flat)
    for (n, a), (m, b) in zip(convert.flatten(tree), convert.flatten(views)):
        assert n == m
        np.testing.assert_array_equal(b.numpy(), a)
    pose = layout.mask(lambda n: n.startswith("pose."))
    assert int(pose.sum()) == sum(a.size for n, a in convert.flatten(tree)
                                  if n.startswith("pose."))


def _write_noise_cams(data_dir, K, noisy):
    cams = {}
    for i, c2w in enumerate(noisy):
        wm = np.eye(4)
        wm[:3, :4] = K @ np.linalg.inv(c2w)[:3, :4]
        cams[f"world_mat_{i}"] = wm.astype(np.float32)
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(os.path.join(data_dir, "noise_cameras_sphere.npz"), **cams)


def _write_sequence(root, n, H, W, seed):
    """A synthetic.py sequence on disk plus the noisy phase-2 init poses
    the in-memory scene makes; returns (data_dir, K)."""
    data_dir = os.path.join(str(root), "SYN")
    gt = make_orbit_sequence(data_dir, n_frames=n, H=H, W=W, span_deg=60.0,
                             with_matches=False, with_crop=False)
    _write_noise_cams(data_dir, gt["K"], tscene.noisy_poses(gt["poses"], 5.0, seed))
    return data_dir, gt["K"]


def test_scene_matches_synthetic_dataset(tmp_path):
    n, H, W = 3, 40, 56
    data_dir, _ = _write_sequence(tmp_path, n, H, W, seed=4)
    conf = hocon.parse_string(f"""
    dataset {{
        data_dir = {data_dir}/
        render_cameras_name = cameras_sphere.npz
        partial_ann = True
        use_crop_init = True
        wo_mask = True
    }}""")
    ds = Dataset(conf["dataset"])
    sc = tscene.make_orbit_scene(n_frames=n, H=H, W=W, span_deg=60.0, seed=4)
    assert (sc.H, sc.W, sc.n_images) == (ds.H, ds.W, ds.n_images)
    np.testing.assert_array_equal(sc.images_np, ds.images_np)
    np.testing.assert_array_equal(sc.masks_np, ds.masks_np)
    np.testing.assert_array_equal(sc.mask_bboxes, ds.mask_bboxes)
    # the Dataset decomposes P = K [R|t] with OpenCV: f32 round-off
    np.testing.assert_allclose(sc.intrinsics_all_inv, ds.intrinsics_all_inv,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sc.crop_poses, ds.crop_poses, atol=1e-4)
    np.testing.assert_allclose(sc.pose_all, ds.pose_all, atol=1e-4)


CONF = """
general {{
    base_exp_dir = {exp_dir}
    recording = [ ./ ]
}}
dataset {{
    data_dir = {data_dir}/
    render_cameras_name = cameras_sphere.npz
    object_cameras_name = cameras_sphere.npz
    partial_ann = True
    use_crop_init = True
    wo_mask = True
}}
train {{
    learning_rate = 2e-3
    learning_rate_alpha = 0.05
    end_iter = 40
    batch_size = 256
    validate_resolution_level = 4
    warm_up_end = 0
    anneal_end = 0
    use_white_bkgd = False
    save_freq = 10000
    val_freq = 2500
    val_mesh_freq = 5000
    report_freq = 10
    pose_freq = 10000
    igr_weight = 0.1
    mask_weight = 0
    flow_weight = 0
    mask_guided_sampling = True
}}
model {{
    pose_type = gf
    barf = True
    nerf {{ D = 2, d_in = 4, d_in_view = 3, W = 32, multires = 2,
           multires_view = 2, output_ch = 4, skips=[4], use_viewdirs=True }}
    sdf_network {{ d_out = 65, d_in = 3, d_hidden = 64, n_layers = 4,
                  skip_in = [2], multires = 4, bias = 0.5, scale = 1.0,
                  geometric_init = True, weight_norm = True }}
    variance_network {{ init_val = 0.3 }}
    rendering_network {{ d_feature = 64, mode = idr, d_in = 9, d_out = 3,
                        d_hidden = 64, n_layers = 2, weight_norm = True,
                        multires_view = 2, squeeze_out = True }}
    neus_renderer {{ n_samples = 16, n_importance = 16, n_outside = 0,
                    up_sample_steps = 2, perturb = 1.0 }}
}}
"""


def test_cli_trains_phase2_gf_conf(tmp_path):
    from fmov_pose_torch import exp_runner
    from fmov_pose_torch.ops import fused_sdf
    data_dir, _ = _write_sequence(tmp_path, 4, 48, 64, seed=2)
    conf = tmp_path / "tiny_global.conf"
    conf.write_text(CONF.format(exp_dir=tmp_path / "exp", data_dir=data_dir))
    before = fused_sdf.LAUNCHES
    runner = exp_runner.main(["--mode", "train", "--conf", str(conf),
                              "--case", "SYN", "--final_mesh_resolution", "16"],
                             device="cpu")
    assert runner.iter_step == 40 and runner.pose_mode == "gf"
    assert runner.model_cfg["sdf"]["use_fused"]
    # a CPU run takes K1's plain version: no launch
    assert fused_sdf.LAUNCHES == before
    loss = np.asarray(runner.history["loss"])
    color = np.asarray(runner.history["color_loss"])
    assert loss.shape == (40,) and np.all(np.isfinite(loss))
    assert color[-10:].mean() < color[:10].mean()
    assert runner.base_exp_dir.endswith("_wo_global_conf")
    assert os.path.exists(os.path.join(runner.base_exp_dir, "recording",
                                       "config.conf"))


def test_cli_unknown_mode_raises(tmp_path):
    """A mode the JAX CLI does not have raises NotImplementedError naming
    it, after the Runner is built, as the JAX CLI's does."""
    from fmov_pose_torch import exp_runner
    with pytest.raises(NotImplementedError, match="^validate_everything$"):
        exp_runner.main(["--mode", "validate_everything", "--conf",
                         _tiny_conf(tmp_path, 3)], device="cpu")


def _tiny_conf(tmp_path, end_iter, name="tiny.conf", exp="exp"):
    """CONF on a 3-frame 32x40 sequence, trained for ``end_iter`` steps."""
    data_dir = os.path.join(str(tmp_path), "SYN")
    if not os.path.isdir(data_dir):
        _write_sequence(tmp_path, 3, 32, 40, seed=1)
    conf = tmp_path / name
    conf.write_text(CONF.format(exp_dir=tmp_path / exp, data_dir=data_dir)
                    .replace("end_iter = 40", f"end_iter = {end_iter}"))
    return str(conf)


def test_cli_train_writes_final_mesh(tmp_path):
    """--mode train ends in the mesh at --final_mesh_resolution with normal
    colors, after the last checkpoint."""
    from fmov_pose_torch import exp_runner
    from fmov_pose_torch.pipeline import meshio
    runner = exp_runner.main(["--mode", "train", "--conf", _tiny_conf(tmp_path, 3),
                              "--final_mesh_resolution", "24"], device="cpu")
    meshes = os.listdir(os.path.join(runner.base_exp_dir, "meshes"))
    assert meshes == ["00000003_00000000_24_train.ply"]
    verts, faces = meshio.read_ply(os.path.join(runner.base_exp_dir, "meshes", meshes[0]))
    assert len(verts) > 0 and len(faces) > 0
    assert verts.min() >= -1.01 and verts.max() <= 1.01
    with open(os.path.join(runner.base_exp_dir, "meshes", meshes[0]), "rb") as f:
        assert b"property uchar red" in f.read(400)
    assert os.listdir(os.path.join(runner.base_exp_dir, "checkpoints")) == [
        "ckpt_000003_000003.ckpt"]


def test_cli_is_continue_resumes_at_the_saved_step(tmp_path):
    """A second run with --is_continue starts at the first run's saved
    iter_step, trains to the new end_iter and saves again; without a
    checkpoint it starts afresh."""
    from fmov_pose_torch import exp_runner
    first = exp_runner.main(["--mode", "train", "--conf", _tiny_conf(tmp_path, 4),
                             "--final_mesh_resolution", "8"], device="cpu")
    assert first.iter_step == 4
    resumed = exp_runner.main(["--mode", "train", "--conf",
                               _tiny_conf(tmp_path, 6, "longer.conf"), "--is_continue",
                               "--final_mesh_resolution", "8"], device="cpu")
    assert resumed.base_exp_dir == first.base_exp_dir
    assert resumed.iter_step == 6 and len(resumed.history["loss"]) == 2
    assert resumed.state.opt.step == 6
    assert sorted(os.listdir(os.path.join(resumed.base_exp_dir, "checkpoints"))) == [
        "ckpt_000003_000004.ckpt", "ckpt_000003_000006.ckpt"]
    fresh = exp_runner.main(["--mode", "train", "--conf",
                             _tiny_conf(tmp_path, 2, "fresh.conf", exp="fresh"),
                             "--is_continue", "--final_mesh_resolution", "8"], device="cpu")
    assert fresh.iter_step == 2 and len(fresh.history["loss"]) == 2


def test_cli_validate_mesh_mode(tmp_path, monkeypatch):
    """--mode validate_mesh extracts the 512^3 normal-colored mesh of the
    resumed state, scaled by --mesh_scale, and trains nothing."""
    from fmov_pose_torch import exp_runner
    from fmov_pose_torch.train.runner import Runner
    exp_runner.main(["--mode", "train", "--conf", _tiny_conf(tmp_path, 3),
                     "--final_mesh_resolution", "8"], device="cpu")
    calls = []
    monkeypatch.setattr(Runner, "validate_mesh",
                        lambda self, **kw: calls.append((self.iter_step, self.mode, kw)))
    runner = exp_runner.main(["--mode", "validate_mesh", "--conf", _tiny_conf(tmp_path, 3),
                              "--is_continue", "--mesh_scale", "1.5",
                              "--mcube_threshold", "0.2"], device="cpu")
    assert calls == [(3, "validate_mesh", {"resolution": 512, "use_norml_color": True,
                                           "mesh_scale": 1.5})]
    assert runner.history == {}


def _live_tensors():
    gc.collect()
    return sum(1 for o in gc.get_objects() if issubclass(type(o), torch.Tensor))


def test_train_keeps_no_per_step_tensor(tmp_path):
    """The loop writes each step's metrics into its row of one buffer: the
    number of live tensors is the same after 8, 16 and 24 steps, and the
    history has every step's metrics."""
    from fmov_pose_torch.train import step as step_mod
    from fmov_pose_torch.train.runner import Runner
    runner = Runner(_tiny_conf(tmp_path, 24), device="cpu")
    counts = {}
    regen = runner._maybe_regen_perms

    def counted():
        regen()
        if runner.iter_step % 8 == 0:
            counts[runner.iter_step] = _live_tensors()

    runner._maybe_regen_perms = counted
    runner.train()
    assert sorted(counts) == [8, 16, 24]
    assert counts[8] == counts[16] == counts[24], counts
    assert sorted(runner.history) == sorted(step_mod.METRIC_NAMES)
    assert all(len(v) == 24 for v in runner.history.values())
    assert np.all(np.isfinite(runner.history["loss"]))


def test_cli_needs_cuda_unless_given_a_device():
    """No silent CPU run: without CUDA, --gpu raises."""
    from fmov_pose_torch import exp_runner
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_runner.main(["--mode", "train", "--conf", "unused.conf"])


def _precision_conf(tmp_path, value):
    conf = _tiny_conf(tmp_path, 2)
    if value is not None:
        with open(conf) as f:
            text = f.read().replace("train {", f"train {{\n    matmul_precision = {value}", 1)
        with open(conf, "w") as f:
            f.write(text)
    return conf


@pytest.mark.parametrize("value,setting", [("highest", "highest"), ("high", "high"),
                                           ("default", "medium"), (None, None)])
def test_matmul_precision_while_training(tmp_path, monkeypatch, value, setting):
    """``train.matmul_precision`` (the JAX Runner's values) sets PyTorch's
    f32 matmul precision by ``MATMUL_PRECISION`` while ``train`` and
    ``eval_render`` run, and restores the caller's after each; without
    the key the caller's setting stays."""
    from fmov_pose_torch.render import neus
    from fmov_pose_torch.train import runner as trunner
    seen = []
    render = neus.render

    def recorded(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        return render(*args, **kwargs)

    monkeypatch.setattr(neus, "render", recorded)
    saved = torch.get_float32_matmul_precision()
    caller = "medium" if setting == "high" else "high"
    try:
        torch.set_float32_matmul_precision(caller)
        runner = trunner.Runner(_precision_conf(tmp_path, value), device="cpu")
        assert runner.matmul_precision == setting
        assert torch.get_float32_matmul_precision() == caller
        runner.train()
        n_train = len(seen)
        rays = torch.tensor([[0.0, 0.0, -2.0]]), torch.tensor([[0.0, 0.0, 1.0]])
        runner.eval_render(*rays, torch.tensor([[1.0]]), torch.tensor([[3.0]]), 1.0)
        assert torch.get_float32_matmul_precision() == caller
    finally:
        torch.set_float32_matmul_precision(saved)
    assert n_train == 2 and len(seen) == 3
    assert seen == [setting or caller] * 3


def test_matmul_precision_rejects_other_values(tmp_path):
    """Any other value raises ValueError, as in the JAX Runner, and
    changes no setting."""
    from fmov_pose_torch.train.runner import Runner
    before = torch.get_float32_matmul_precision()
    with pytest.raises(ValueError, match="matmul_precision must be default/high/highest"):
        Runner(_precision_conf(tmp_path, "medium"), device="cpu")
    assert torch.get_float32_matmul_precision() == before


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, the JAX package and
    cv2."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fmov_pose_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    fmov_pose_torch.__path__, 'fmov_pose_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert len(mods) >= 20, mods\n"
        "bad = [m for m in ('jax', 'jaxlib', 'fmov_pose_tpu', 'cv2')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")


def test_profile_busy_time_is_the_union_of_device_intervals():
    from fmov_pose_torch.profile_step import busy_us
    events = [{"cat": "kernel", "ts": 0.0, "dur": 10.0},
              {"cat": "kernel", "ts": 5.0, "dur": 10.0},      # overlaps
              {"cat": "gpu_memcpy", "ts": 20.0, "dur": 2.0},
              {"cat": "kernel", "ts": 21.0, "dur": 0.5},      # inside
              {"cat": "cpu_op", "ts": 0.0, "dur": 100.0},     # host, ignored
              {"cat": "kernel", "ts": 30.0, "dur": 1.0}]
    assert busy_us(events) == (15.0 + 2.0 + 1.0, 4)


def test_profile_split_ties_kernels_to_their_ranges():
    """A kernel counts toward the fmov:: range whose host interval holds
    the runtime call that launched it, by correlation id, whenever the
    kernel itself ran; template arguments and namespaces leave the name."""
    from fmov_pose_torch.profile_step import range_split
    k9 = "void fmov_train::(anonymous namespace)::color_bwd_kernel(fmov_train::(anonymous namespace)::ColorArgs)"
    events = [
        {"cat": "user_annotation", "name": "fmov::K9_color_ray_bwd", "ts": 0.0,
         "dur": 10.0, "pid": 1, "tid": 2},
        {"cat": "user_annotation", "name": "other_range", "ts": 20.0, "dur": 10.0,
         "pid": 1, "tid": 2},
        {"cat": "cuda_runtime", "ts": 1.0, "pid": 1, "tid": 2, "args": {"correlation": 5}},
        {"cat": "cuda_runtime", "ts": 2.0, "pid": 1, "tid": 2, "args": {"correlation": 6}},
        {"cat": "cuda_runtime", "ts": 3.0, "pid": 1, "tid": 9, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "ts": 21.0, "pid": 1, "tid": 2, "args": {"correlation": 8}},
        {"cat": "kernel", "name": k9, "ts": 40.0, "dur": 3.0, "args": {"correlation": 5}},
        {"cat": "kernel", "name": "fmov_train::atb_kernel(fmov_train::AtbArgs)",
         "ts": 44.0, "dur": 1.5, "args": {"correlation": 6}},
        {"cat": "kernel", "name": "at::native::fill<float, int>(int)", "ts": 46.0,
         "dur": 1.0, "args": {"correlation": 7}},   # another thread
        {"cat": "kernel", "name": "gemm", "ts": 47.0, "dur": 1.0,
         "args": {"correlation": 8}}]                # outside fmov::
    assert range_split(events) == {
        "fmov::K9_color_ray_bwd": {"color_bwd_kernel": 3.0, "atb_kernel": 1.5}}


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
