"""The two-phase run of the port against the JAX package, on the CPU.

The host modules of the phase transition, each against its JAX original
on the same inputs:

* ``pipeline/evalpose.py``: the five cases of ``tests/test_evalpose.py``,
  every number within 1e-10 of the JAX module's;
* ``pipeline/norm.py``: ``normalization_from_masks`` bitwise with the
  same seeded generator; ``get_normalization``'s matrix and the npz it
  writes bitwise, with the unseeded draw of ``np.random.default_rng()``
  seeded alike on both sides (``_seeded``);
* ``data/synthetic.py``: the same files, PNGs and match files byte for
  byte, npz/npy arrays equal;
* ``pipeline/align.py``: ``pnp_pose_from_mesh``, ``align_poses`` (crop)
  and ``align_poses_wo_virtual``, without and with the annotation file,
  on one mesh file and one pose array: every npz array written equal,
  the aligned poses equal (within 1e-12 with the annotation, whose
  intrinsics the port decomposes with ``scipy.linalg.rq`` and the JAX
  package with OpenCV), the (ATE, RPE) tuple equal (within 1e-5 with the
  annotation: its ground-truth poses are f32, and one ulp of a rotation
  moves the RPE's arccos by ~2e-6).

Then the Runner and the CLI.  The JAX CLI runs the two-phase command on
a tiny sequence (``jax_cli``); the port's CLI runs it on the same
sequence (``torch_cli``): the same files in the same layout (the JAX
package's tensorboard logs aside), the phase-2 Runner at its end_iter; a
second call skips phase 1 and resumes phase 2; ``--mode validate_mesh
--global_conf`` writes the phase-2 Runner's 256-named mesh.  A port
Runner loads the JAX CLI's phase-1 checkpoint and runs
``save_aligned_poses`` beside a JAX Runner on the same checkpoint and
mesh: the poses it passes to the alignment within 1e-5 of JAX's, the
frame names and crop transforms equal, the intrinsics within rtol 1e-5
(the decomposition); fed the same poses and intrinsics, the phase-2
dataset it writes equal to JAX's; the port's ``Dataset`` reads it as the
JAX ``Dataset`` does (the fields of ``test_dataset_matches_jax``).
"""

import os
import shutil
import sys

import numpy as np
import pytest

from fmov_pose_tpu.data import hocon as jhocon
from fmov_pose_tpu.data import synthetic as jsyn
from fmov_pose_tpu.data.dataset import Dataset as JDataset
from fmov_pose_tpu.pipeline import align as jalign
from fmov_pose_tpu.pipeline import evalpose as jev
from fmov_pose_tpu.pipeline import norm as jnorm
from fmov_pose_torch.data import hocon as thocon
from fmov_pose_torch.data import synthetic as tsyn
from fmov_pose_torch.data.dataset import Dataset as TDataset
from fmov_pose_torch.data.scene import noisy_poses
from fmov_pose_torch.pipeline import align as talign
from fmov_pose_torch.pipeline import evalpose as tev
from fmov_pose_torch.pipeline import meshio
from fmov_pose_torch.pipeline import norm as tnorm
from tests.test_evalpose import make_traj
from tests.test_torch_runner import CONF
from tests.test_train_e2e import VIRTUAL_CONF
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)

NORM_SEED = 11


def _seeded(mp):
    """norm.py's unseeded ``np.random.default_rng()`` draws from one seed."""
    orig = np.random.default_rng
    mp.setattr(np.random, "default_rng",
               lambda seed=None: orig(NORM_SEED if seed is None else seed))


# ----------------------------------------------------------------------
# evalpose: the cases of tests/test_evalpose.py on both modules
# ----------------------------------------------------------------------
def _identical(ev):
    traj = make_traj()
    ate, (rpe_t, rpe_r) = ev.compute_ATE(traj, traj), ev.compute_rpe(traj, traj)
    assert ate < 1e-9 and rpe_t < 1e-9 and rpe_r < 1e-6
    return [ate, rpe_t, rpe_r]


def _sim3_gauge(ev):
    from scipy.spatial.transform import Rotation as Rot
    gt = make_traj(12)
    R = Rot.from_rotvec([0.2, -0.1, 0.4]).as_matrix()
    est = gt.copy()
    est[:, :3, :3] = R[None] @ gt[:, :3, :3]
    est[:, :3, 3] = 1.7 * (gt[:, :3, 3] @ R.T) + np.array([0.5, -1.0, 2.0])
    aligned = ev.align_ate_c2b_use_a2b(est, gt)
    ate, (rpe_t, rpe_r) = ev.compute_ATE(gt, aligned), ev.compute_rpe(gt, aligned)
    assert ate < 1e-4 and rpe_r < 1e-3
    return [aligned, ate, rpe_t, rpe_r]


def _translation_offset(ev):
    gt = make_traj(8)
    est = gt.copy()
    est[:, :3, 3] += np.array([0.1, 0.0, 0.0])
    ate = ev.compute_ATE(gt, est)
    assert abs(ate - 0.1) < 1e-9
    return [ate]


def _rpe_rotation(ev):
    from scipy.spatial.transform import Rotation as Rot
    gt = make_traj(5)
    est = gt.copy()
    extra = Rot.from_rotvec([0, 0, np.deg2rad(5)]).as_matrix()
    for i in range(1, 5, 2):
        est[i, :3, :3] = est[i, :3, :3] @ extra
    rpe_t, rpe_r = ev.compute_rpe(gt, est)
    assert 0 < np.rad2deg(rpe_r) <= 5.01
    return [rpe_t, rpe_r]


def _umeyama(ev):
    from scipy.spatial.transform import Rotation as Rot
    data = np.random.default_rng(1).normal(size=(40, 3))
    R = Rot.from_rotvec([0.3, 0.2, -0.4]).as_matrix()
    s, R_e, t = ev.align_umeyama(2.5 * data @ R.T + np.array([1.0, 2.0, 3.0]), data)
    assert abs(s - 2.5) < 1e-6
    np.testing.assert_allclose(R_e, R, atol=1e-6)
    return [s, R_e, t]


EVAL_CASES = {"identical": _identical, "sim3_gauge": _sim3_gauge,
              "translation_offset": _translation_offset,
              "rpe_rotation": _rpe_rotation, "umeyama": _umeyama}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_evalpose_matches_jax(name):
    ours, ref = EVAL_CASES[name](tev), EVAL_CASES[name](jev)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


# ----------------------------------------------------------------------
# norm
# ----------------------------------------------------------------------
def _norm_sequence(root):
    """tests/test_pipeline.py::test_norm_matrix_on_synthetic's sequence:
    8 frames, integer-keyed world mats without scale mats."""
    out = os.path.join(str(root), "SEQ")
    gt = tsyn.make_orbit_sequence(out, n_frames=8, H=64, W=64, span_deg=120,
                                  with_matches=False, with_crop=False)
    cams = {}
    for i, pose in enumerate(gt["poses"]):
        wm = np.eye(4)
        wm[:3, :4] = gt["K"] @ np.linalg.inv(pose)[:3, :4]
        cams[f"world_mat_{i}"] = wm
    np.savez(os.path.join(out, "cameras_sphere.npz"), **cams)
    return out


def test_normalization_from_masks_matches_jax(tmp_path):
    import cv2
    seq = _norm_sequence(tmp_path)
    cams = np.load(os.path.join(seq, "cameras_sphere.npz"))
    names = sorted(os.listdir(os.path.join(seq, "mask_obj")))
    pts, masks = [], []
    for n in names:
        m = cv2.imread(os.path.join(seq, "mask_obj", n), cv2.IMREAD_GRAYSCALE) / 255.0 > 0.5
        ys, xs = np.where(m)
        pts.append(np.stack((xs, ys, np.ones_like(xs))).astype(np.float64))
        masks.append(m)
    Ps = np.array([cams[f"world_mat_{i}"][:3] for i in range(len(names))])
    ours = tnorm.normalization_from_masks(Ps, pts, np.array(masks), 100,
                                          rng=np.random.default_rng(3))
    ref = jnorm.normalization_from_masks(Ps, pts, np.array(masks), 100,
                                         rng=np.random.default_rng(3))
    np.testing.assert_array_equal(ours, ref)
    assert np.linalg.norm(ours[:3, 3]) < 0.3 and 0.2 < ours[0, 0] < 2.5


def test_get_normalization_matches_jax(tmp_path, monkeypatch):
    _seeded(monkeypatch)
    seq = _norm_sequence(tmp_path)
    ref_dir = os.path.join(str(tmp_path), "SEQ_jax")
    shutil.copytree(seq, ref_dir)
    ours, ref = tnorm.get_normalization(seq), jnorm.get_normalization(ref_dir)
    np.testing.assert_array_equal(ours, ref)
    assert np.linalg.norm(ours[:3, 3]) < 0.3 and 0.2 < ours[0, 0] < 2.5
    _same_npz(os.path.join(seq, "cameras_sphere.npz"),
              os.path.join(ref_dir, "cameras_sphere.npz"))


# ----------------------------------------------------------------------
# the sequence writer
# ----------------------------------------------------------------------
def _same_npz(a, b):
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files), (a, b)
    for k in da.files:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_orbit_sequence_matches_jax(tmp_path):
    gts = {}
    for side, mod in (("jax", jsyn), ("torch", tsyn)):
        base = tmp_path / side
        gts[side] = (
            mod.make_orbit_sequence(str(base / "SYN_ori"), n_frames=4, H=40, W=56,
                                    span_deg=50),
            mod.make_orbit_sequence(str(base / "SYN"), n_frames=4, H=40, W=56,
                                    span_deg=50, with_matches=False, with_crop=False,
                                    ann_stride=2))
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "torch")
    assert sum(f.endswith("_matches.txt") for f in files) == 3
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "torch" / f
        if f.endswith(".npz"):
            _same_npz(a, b)
        elif f.endswith(".npy"):
            ta, tb = (np.load(p, allow_pickle=True).item() for p in (a, b))
            assert sorted(ta) == sorted(tb)
            for k in ta:
                np.testing.assert_array_equal(ta[k], tb[k])
        else:
            assert a.read_bytes() == b.read_bytes(), f
    for ours, ref in zip(gts["torch"], gts["jax"]):
        np.testing.assert_array_equal(ours["K"], ref["K"])
        np.testing.assert_array_equal(ours["poses"], ref["poses"])
        assert ours["names"] == ref["names"]
        for fa, fb in zip(ours["frames"], ref["frames"]):
            for x, y in zip(fa, fb):
                np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# align
# ----------------------------------------------------------------------
N_ALIGN, H_ALIGN, W_ALIGN = 5, 48, 64
ANN_TUPLE_TOL = 1e-5   # the (ATE, RPE) tuple against the annotation's f32 poses


@pytest.fixture(scope="module")
def align_inputs(tmp_path_factory):
    """A sequence on disk, a mesh file (seeded points on the sphere), the
    virtual-camera poses (the orbit turned by a seeded 3 degrees), and
    crop transforms that shift each frame: the virtual K is T @ K."""
    root = tmp_path_factory.mktemp("align")
    seq = str(root / "SYN")
    gt = tsyn.make_orbit_sequence(seq, n_frames=N_ALIGN, H=H_ALIGN, W=W_ALIGN,
                                  span_deg=40, with_matches=False, with_crop=False)
    pts = np.random.default_rng(2).normal(size=(3000, 3))
    pts = 0.5 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    mesh = str(root / "mesh.ply")
    meshio.write_ply(mesh, pts, np.array([[0, 1, 2], [0, 2, 3]]))
    T = np.tile(np.eye(3), (N_ALIGN, 1, 1))
    T[:, 0, 2] = np.arange(N_ALIGN) * 1.5
    T[:, 1, 2] = -np.arange(N_ALIGN)
    Ks = np.tile(np.eye(4), (N_ALIGN, 1, 1))
    Ks[:, :3, :3] = T @ gt["K"]
    poses = noisy_poses(gt["poses"], 3.0, seed=1)
    return {"root": root, "seq": seq, "mesh": mesh, "poses": poses, "Ks": Ks,
            "T": T, "names": gt["names"], "gt": gt["poses"]}


def test_pnp_pose_from_mesh_matches_jax(align_inputs):
    a = align_inputs
    pts, _ = meshio.read_ply(a["mesh"])
    for i in (0, N_ALIGN - 1):
        args = (pts, a["poses"][i], a["Ks"][i], a["T"][i], a["Ks"][0], H_ALIGN, W_ALIGN)
        ours = talign.pnp_pose_from_mesh(*args, np.random.default_rng(i))
        ref = jalign.pnp_pose_from_mesh(*args, np.random.default_rng(i))
        np.testing.assert_array_equal(ours, ref)
        # the crop is undone: the real-camera pose is the virtual one
        np.testing.assert_allclose(ours, a["poses"][i], atol=1e-4)
    away = a["poses"][0].copy()
    away[:3, 3] += np.array([10.0, 0.0, 0.0])   # the mesh projects off the image
    for mod in (talign, jalign):
        assert mod.pnp_pose_from_mesh(pts, away, a["Ks"][0], None, a["Ks"][0],
                                      H_ALIGN, W_ALIGN, np.random.default_rng(0),
                                      max_tries=3) is None


@pytest.mark.parametrize("ann", [False, True], ids=["no_ann", "ann"])
@pytest.mark.parametrize("fn", ["align_poses", "align_poses_wo_virtual"])
def test_align_matches_jax(align_inputs, tmp_path, monkeypatch, fn, ann):
    _seeded(monkeypatch)
    a = align_inputs
    ann_path = os.path.join(a["seq"], "cameras_sphere.npz") if ann else None
    crop = fn == "align_poses"
    out = {}
    for side, mod in (("jax", jalign), ("torch", talign)):
        exp = tmp_path / side
        exp.mkdir()
        res = getattr(mod, fn)(
            ann_path, a["mesh"], a["poses"], a["Ks"], a["T"] if crop else None,
            str(exp), a["names"], 17, "SYN", H=H_ALIGN, W=W_ALIGN, save_dataset=True,
            normalize_trans=True, tgt_dir=str(exp / "p2"), save_meta=False,
            global_mask_dir=os.path.join(a["seq"], "mask_obj"))
        out[side] = (exp, res)
    (je, jres), (te, tres) = out["jax"], out["torch"]
    assert _files(je) == _files(te)
    assert (tres is None) == (not ann)
    if ann:
        np.testing.assert_allclose(tres, jres, rtol=0, atol=ANN_TUPLE_TOL)
    got = np.load(te / f"global_poses_{N_ALIGN}_17.npy")
    np.testing.assert_allclose(got, np.load(je / f"global_poses_{N_ALIGN}_17.npy"),
                               rtol=0, atol=1e-12 if ann else 0.0)
    if crop:
        np.testing.assert_allclose(got, a["poses"], atol=1e-4)
    else:
        np.testing.assert_array_equal(got, a["poses"])
    for name in ("noise_cameras_sphere.npz", "cameras_sphere.npz"):
        _same_npz(je / "p2" / name, te / "p2" / name)


# ----------------------------------------------------------------------
# the Runner and the CLI: the two-phase command on a tiny sequence
# ----------------------------------------------------------------------
GLOBAL_NAME = "ho3d_global_tiny"
P1_STEPS = 17   # mesh warm-up 2 + 5 frames x 3 steps, then phase 1 ends
P2_STEPS = 10
ARGV = ["--mode", "train", "--conf", "./confs/virtual_tiny.conf", "--case", "SYN_ori",
        "--global_conf", f"./confs/{GLOBAL_NAME}.conf", "--final_mesh_resolution", "16"]
P1_DIR = os.path.join("exp", "SYN_ori", "ours")
P2_DIR = os.path.join(P1_DIR, GLOBAL_NAME)


def _write_work(root, make_orbit_sequence):
    """The HO3D layout the confs name, under ``root``: SYN_ori (crop,
    matches), SYN, and the tiny confs on tests/test_train_e2e.py's and
    tests/test_torch_runner.py's templates."""
    data = os.path.join(str(root), "data", "HO3Dv3")
    make_orbit_sequence(os.path.join(data, "SYN_ori"), n_frames=5, H=48, W=48,
                        span_deg=40)
    make_orbit_sequence(os.path.join(data, "SYN"), n_frames=5, H=48, W=48,
                        span_deg=40, with_matches=False, with_crop=False)
    os.makedirs(os.path.join(str(root), "confs"))
    virtual = VIRTUAL_CONF.format(
        exp_dir="./exp/CASE_NAME/ours", data_dir="./data/HO3Dv3/CASE_NAME",
        flow_dir="./data/HO3Dv3/matches", end_iter=60, batch=64)
    for old, new in (("max_pro_iteration = 15", "max_pro_iteration = 3"),
                     ("pro_warm_up_end = 8", "pro_warm_up_end = 2"),
                     ("mesh_warmup_step = 10", "mesh_warmup_step = 2")):
        assert old in virtual
        virtual = virtual.replace(old, new)
    with open(os.path.join(str(root), "confs", "virtual_tiny.conf"), "w") as f:
        f.write(virtual)
    glob_conf = CONF.format(exp_dir="./global_reset_exp/CASE_NAME/womask",
                            data_dir="./data/HO3Dv3/CASE_NAME")
    with open(os.path.join(str(root), "confs", GLOBAL_NAME + ".conf"), "w") as f:
        f.write(glob_conf.replace("end_iter = 40", f"end_iter = {P2_STEPS}"))


def _port_cli(argv):
    from fmov_pose_torch import exp_runner
    return exp_runner.main(argv, device="cpu")


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's two-phase command on the tiny sequence (the draw of
    the normalization seeded): its work dir."""
    import exp_runner as jexp_runner
    root = tmp_path_factory.mktemp("jax_cli")
    _write_work(root, jsyn.make_orbit_sequence)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        _seeded(mp)
        mp.setattr(sys, "argv", ["exp_runner.py"] + ARGV)
        jexp_runner.main()
    return root


@pytest.fixture(scope="module")
def torch_cli(tmp_path_factory):
    """The port's CLI on the same command and sequence: (work dir, the
    Runner it returns)."""
    root = tmp_path_factory.mktemp("torch_cli")
    _write_work(root, tsyn.make_orbit_sequence)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        _seeded(mp)
        runner = _port_cli(ARGV)
    return root, runner


def _layout(root):
    """The run's files, without the JAX package's tensorboard logs and the
    source backups."""
    return [f for f in _files(os.path.join(str(root), "exp"))
            if not f.split(os.sep)[-2:-1] == ["logs"] and "recording" not in f]


def test_cli_two_phase_layout_matches_jax(jax_cli, torch_cli):
    """The verify recipe's files, named as the JAX CLI names them: phase
    1's end (its 64^3 mesh, its checkpoint at the step it ended on), the
    aligned poses, the phase-2 dataset, phase 2's checkpoint, final mesh
    and poses."""
    root, runner = torch_cli
    rel = lambda *p: os.path.relpath(os.path.join(*p), "exp")  # noqa: E731
    expected = sorted([
        rel(P1_DIR, "checkpoints", f"ckpt_000005_{P1_STEPS:06d}.ckpt"),
        rel(P1_DIR, "meshes", "00000005_00000000_64_train.ply"),
        rel(P1_DIR, f"global_poses_5_{P1_STEPS}.npy"),
        rel(P2_DIR, "cameras_sphere.npz"), rel(P2_DIR, "noise_cameras_sphere.npz"),
        rel(P2_DIR, "checkpoints", f"ckpt_000005_{P2_STEPS:06d}.ckpt"),
        rel(P2_DIR, "meshes", "00000005_00000000_16_train.ply"),
        rel(P2_DIR, f"poses_{P2_STEPS}.npy")])
    assert _layout(root) == _layout(jax_cli) == expected
    assert runner.base_exp_dir == os.path.join(".", P2_DIR)
    assert runner.iter_step == runner.end_iter == P2_STEPS
    assert runner.pose_mode == "gf" and runner.dataset.use_crop_init
    assert len(runner.history["loss"]) == P2_STEPS
    assert np.all(np.isfinite(runner.history["loss"]))
    poses = np.load(os.path.join(str(root), P2_DIR, f"poses_{P2_STEPS}.npy"),
                    allow_pickle=True).item()
    assert sorted(poses) == ["0000", "0001", "0002", "0003", "0004"]
    assert all(p.shape == (4, 4) and np.isfinite(p).all() for p in poses.values())
    noise = np.load(os.path.join(str(root), P2_DIR, "noise_cameras_sphere.npz"))
    assert sorted(noise.files) == sorted([f"{k}_{i}" for i in range(5)
                                          for k in ("world_mat", "scale_mat")])
    assert not os.path.exists(os.path.join(str(root), P1_DIR,
                                           "error_during_progressive_learning.txt"))


def test_cli_second_call_skips_phase1_and_resumes(torch_cli, monkeypatch, capsys):
    """The same command again: the phase-2 directory exists, so phase 1 and
    the alignment are skipped, and the phase-2 Runner resumes from its
    checkpoint at end_iter."""
    from fmov_pose_torch.train.runner import Runner
    root, _ = torch_cli
    monkeypatch.chdir(root)
    trained, aligned = [], []
    train = Runner.train
    monkeypatch.setattr(Runner, "train", lambda self: (
        trained.append((self.base_exp_dir, self.iter_step)), train(self))[1])
    monkeypatch.setattr(Runner, "save_aligned_poses",
                        lambda self, **kw: aligned.append(kw))
    runner = _port_cli(ARGV)
    assert trained == [(os.path.join(".", P2_DIR), P2_STEPS)] and aligned == []
    assert "reboot the system for global training" in capsys.readouterr().out
    assert runner.iter_step == P2_STEPS and "loss" not in runner.history
    assert os.listdir(os.path.join(str(root), P1_DIR, "checkpoints")) == [
        f"ckpt_000005_{P1_STEPS:06d}.ckpt"]


def test_cli_validate_mesh_global_conf(torch_cli, monkeypatch):
    """--mode validate_mesh --global_conf: the phase-2 Runner, rebooted on
    its directory, writes its mesh named at 256 (extracted here at 12)."""
    from fmov_pose_torch.render import geometry
    root, _ = torch_cli
    monkeypatch.chdir(root)
    extract = geometry.extract_geometry
    monkeypatch.setattr(geometry, "extract_geometry",
                        lambda lo, hi, res, *a, **k: extract(lo, hi, 12, *a, **k))
    argv = list(ARGV)
    argv[1] = "validate_mesh"
    runner = _port_cli(argv)
    assert runner.base_exp_dir == os.path.join(".", P2_DIR)
    assert runner.iter_step == P2_STEPS and runner.mode == "train"
    assert os.path.exists(os.path.join(str(root), P2_DIR, "meshes",
                                       "00000005_00000000_256_train.ply"))


@pytest.fixture(scope="module")
def aligned(jax_cli, tmp_path_factory):
    """The JAX CLI's phase-1 checkpoint and mesh, reloaded by a JAX Runner
    and by a port Runner (CPU), each in its own copy of the work dir,
    without and with the HO3D annotation file; each side's
    ``save_aligned_poses`` as the CLI calls it, the draw seeded.  The port
    side's alignment is fed the JAX side's poses and intrinsics (the
    ones the port computed are recorded)."""
    from fmov_pose_tpu.train.runner import Runner as JRunner
    from fmov_pose_torch.train.runner import Runner as TRunner
    out = {}
    for ann in (False, True):
        res = {}
        for side, make, mod in (
                ("jax", lambda c: JRunner(c, case="SYN_ori", is_continue=True,
                                          has_global_conf=True), jalign),
                ("torch", lambda c: TRunner(c, case="SYN_ori", is_continue=True,
                                            has_global_conf=True, device="cpu"), talign)):
            root = tmp_path_factory.mktemp(f"aligned_{side}")
            for sub in ("data", "confs"):
                shutil.copytree(jax_cli / sub, root / sub)
            for sub in ("checkpoints", "meshes"):
                shutil.copytree(jax_cli / P1_DIR / sub, root / P1_DIR / sub)
            if ann:
                os.makedirs(root / "data" / "HO3Dv3" / "ann")
                shutil.copy(root / "data" / "HO3Dv3" / "SYN" / "cameras_sphere.npz",
                            root / "data" / "HO3Dv3" / "ann" / "SYN.npz")
            with pytest.MonkeyPatch.context() as mp:
                mp.chdir(root)
                _seeded(mp)
                calls = {}
                fns = {n: getattr(mod, n) for n in ("align_poses", "align_poses_wo_virtual")}

                def record(fn, *args, **kw):
                    calls["args"], calls["kw"] = [np.array(a) if isinstance(a, np.ndarray)
                                                  else a for a in args], dict(kw)
                    args = list(args)
                    if side == "torch":   # JAX's poses and intrinsics
                        args[2], args[3] = res["jax"]["args"][2], res["jax"]["args"][3]
                    calls["result"] = fns[fn](*args, **kw)
                    return calls["result"]

                for n in fns:
                    mp.setattr(mod, n, lambda *a, n=n, **k: record(n, *a, **k))
                runner = make("./confs/virtual_tiny.conf")
                runner.save_aligned_poses(
                    save_dataset=True, normalize_trans=True,
                    tgt_dir=os.path.join(".", P2_DIR), save_meta=False,
                    global_mask_dir="./data/HO3Dv3/SYN/mask_obj")
            res[side] = dict(calls, root=root, iter_step=runner.iter_step,
                             current_image=runner.current_image)
        out[ann] = res
    return out


ANN = pytest.mark.parametrize("ann", [False, True], ids=["no_ann", "ann"])


@ANN
def test_save_aligned_poses_reads_like_jax(aligned, ann):
    """Both Runners resume phase 1's end bitwise and hand the alignment the
    same inputs: the poses within 1e-5, the frame names, crop transforms,
    exp dir, step and mesh path equal, the intrinsics within rtol 1e-5."""
    j, t = aligned[ann]["jax"], aligned[ann]["torch"]
    assert (t["iter_step"], t["current_image"]) == (j["iter_step"], j["current_image"]) \
        == (P1_STEPS, 5)
    ja, ta = j["args"], t["args"]
    np.testing.assert_allclose(ta[2], ja[2], rtol=0, atol=1e-5)     # poses
    np.testing.assert_allclose(ta[3], ja[3], rtol=1e-5, atol=1e-6)  # Ks
    np.testing.assert_array_equal(ta[4], ja[4])                     # transforms
    assert ta[4].shape == (5, 3, 3)
    assert [ta[k] for k in (0, 1, 5, 6, 7, 8)] == [ja[k] for k in (0, 1, 5, 6, 7, 8)]
    assert ta[0] == "./data/HO3Dv3/ann/SYN.npz"
    assert t["kw"] == j["kw"]


@ANN
def test_save_aligned_poses_writes_jax_dataset(aligned, ann):
    """Fed the same poses and intrinsics, the port writes JAX's phase-2
    dataset and aligned poses, and reports JAX's (ATE, RPE)."""
    j, t = aligned[ann]["jax"], aligned[ann]["torch"]
    assert (t["result"] is None) == (j["result"] is None) == (not ann)
    if ann:
        np.testing.assert_allclose(t["result"], j["result"], rtol=0, atol=ANN_TUPLE_TOL)
    name = f"global_poses_5_{P1_STEPS}.npy"
    np.testing.assert_allclose(np.load(t["root"] / P1_DIR / name),
                               np.load(j["root"] / P1_DIR / name), rtol=0,
                               atol=1e-12 if ann else 0.0)
    for f in ("noise_cameras_sphere.npz", "cameras_sphere.npz"):
        _same_npz(j["root"] / P2_DIR / f, t["root"] / P2_DIR / f)


PHASE2_DATASET = """dataset {
    data_dir = ./data/HO3Dv3/SYN/
    render_cameras_name = cameras_sphere.npz
    partial_ann = True
    use_crop_init = True
    wo_mask = True
}"""


@ANN
def test_phase2_dataset_matches_jax(aligned, ann, monkeypatch):
    """The port's Dataset reads the aligned directory the port wrote as the
    JAX Dataset does (use_crop_init: the noise cameras as the initial
    poses; the annotation's ground truth where it exists)."""
    t = aligned[ann]["torch"]
    monkeypatch.chdir(t["root"])
    dj = JDataset(jhocon.parse_string(PHASE2_DATASET)["dataset"], P2_DIR)
    dt = TDataset(thocon.parse_string(PHASE2_DATASET)["dataset"], P2_DIR)
    for key in ("images_np", "masks_np", "mask_bboxes"):
        np.testing.assert_array_equal(getattr(dt, key), getattr(dj, key), err_msg=key)
    assert (dt.H, dt.W, dt.n_images) == (dj.H, dj.W, dj.n_images) == (48, 48, 5)
    assert dt.index_to_frame == dj.index_to_frame
    assert dt.avai_ann_frame == dj.avai_ann_frame == ([0, 1, 2, 3, 4] if ann else [])
    for a, b in zip(dt.scale_mats_np, dj.scale_mats_np):
        np.testing.assert_array_equal(a, b)
    for key in ("object_bbox_min", "object_bbox_max"):
        np.testing.assert_array_equal(getattr(dt, key), getattr(dj, key), err_msg=key)
    for key in ("intrinsics_all", "intrinsics_all_inv", "pose_all", "gt_poses"):
        np.testing.assert_allclose(getattr(dt, key), getattr(dj, key), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(dt.crop_poses, dj.crop_poses, atol=1e-4)
    assert dt.use_crop_init and dt.crop_poses.shape == (5, 4, 4)
