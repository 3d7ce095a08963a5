"""The scanned phase-2 dispatch (``train.scan_steps``) on the CPU, the port
against the JAX package.

* ``make_device_scalars``: the learning rate, cos-anneal ratio, gates and
  mask-guided flag of a device iteration count, within 1 ulp of f32 of the
  JAX function's (both compute in f32); the learning rate within 1 ulp
  plus what 1 ulp of its cosine moves it by: the two packages' f32 cosines
  round apart by 1 ulp in ~5% of arguments, and near the schedule's end,
  where (cos + 1) is small, that is ~8 ulps of the learning rate.
* ``Runner._scan_eligible``: the JAX Runner's rule, on every shipped conf
  and on variants (flow, seg, the grid refreshed every 250 or 100 steps,
  ``scan_steps = False``, ``scan_chunk = 50``, ``--gradient_analysis``, a
  mesh warm-up, a start off a chunk edge), read from the same Runner's
  attributes and the JAX package's parse of the same conf.
* A scanned chunk of k = 3 (small widths, gf pose, ``perturb`` 0, frame
  ids given as device tensors and pixels replayed from the JAX draws)
  against the JAX ``run_one`` chained with ``device_scalars``: the chunk's
  mean metrics within ``test_torch_step.py``'s rtol 1e-4 of the mean of
  JAX's; the Adam moments by the leaf rule; the parameters within 1e-3 of
  their move (3 x lr) where the gradients are settled.
* The frames a scanned run draws: uniform on [0, n_cur) by a loose
  chi-square (p > 1e-3).
* A Runner on ``tests/test_train_e2e.py``'s GT conf with ``scan_chunk =
  25`` and ``end_iter = 60``: the scan path, ending at step 50 as the JAX
  Runner does, with the same checkpoint files; a run resumed with
  ``is_continue`` from the checkpoint of its first chunk edge ends bitwise
  equal to the uninterrupted one.
* The per-step path: a frame id given as a device tensor, and gates and
  the Adam count on the device, give bitwise the results of the host ints
  and floats the per-step loop passes.
"""

import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.data import hocon as jhocon
from fmov_pose_tpu.fields import nets as jn
from fmov_pose_tpu.poses import picture_pose as jpp
from fmov_pose_tpu.render import neus as jneus
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_tpu.train import step as jstep
from fmov_pose_tpu.train.runner import Runner as JRunner
from fmov_pose_torch import convert
from fmov_pose_torch.data import rays as trays
from fmov_pose_torch.data import scene as tscene
from fmov_pose_torch.render import neus as tneus
from fmov_pose_torch.train import optim as toptim
from fmov_pose_torch.train import step as tstep
from fmov_pose_torch.train.runner import Runner as TRunner
from tests.test_train_e2e import GT_CONF, _write_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's CPU work is many small ops: one intra-op thread runs
    it as fast, and keeps the workers of a parallel test run from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCALAR_NAMES = ("lr", "cos_anneal", "main_update", "pose_update", "mask_guided",
                "trans_head_on")
SCHEDULES = [
    # the harness's phase 2 and the reference phase-2 conf (with an anneal)
    dict(learning_rate=5e-4, learning_rate_alpha=0.05, warm_up_end=200.0,
         end_iter=3000, anneal_end=0.0, mask_guided=1.0),
    dict(learning_rate=2e-3, learning_rate_alpha=0.1, warm_up_end=5000.0,
         end_iter=150000, anneal_end=50000.0, mask_guided=0.0),
]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=["harness_p2", "anneal"])
def test_device_scalars_match_jax(schedule):
    w, end = int(schedule["warm_up_end"]), schedule["end_iter"]
    jfun = jax.jit(jstep.make_device_scalars(schedule, 1))
    tfun = tstep.make_device_scalars(schedule, "cpu")
    for it in (0, 1, w - 1, w, (w + end) // 2, end - 1):
        sj = jfun(jnp.float32(it))
        st = tfun(torch.tensor(float(it), dtype=torch.float32))
        for name in SCALAR_NAMES:
            got, ref = getattr(st, name), np.asarray(getattr(sj, name))
            assert got.dtype == torch.float32 and got.dim() == 0, name
            if name == "lr":
                # what 1 ulp of the cosine moves the learning rate by: near the
                # end, (cos + 1) is small and 1 ulp of it many ulps of lr
                cos_ulp = schedule["learning_rate"] * 0.5 * (
                    1 - schedule["learning_rate_alpha"]) * np.spacing(np.float32(1))
                assert abs(float(got) - float(ref)) <= cos_ulp + np.spacing(ref), (it,)
            else:
                np.testing.assert_array_max_ulp(got.numpy(), ref, maxulp=1)


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

ELIGIBILITY_ATTRS = ("pose_mode", "flow_weight", "progressive", "maintain_shape",
                     "gradient_analysis", "reset_based_on_rot", "mesh_warmup_step",
                     "report_freq", "val_freq", "val_mesh_freq", "save_freq",
                     "pose_freq", "occupancy_sampling", "occ_update_freq", "iter_step")
GLOBAL = "ho3d_global_womask.conf"
FAST = "ho3d_global_womask_tpu_fast.conf"
TRAIN_KEY = "mask_guided_sampling = True"
# (name, conf, text edits, Runner kwargs, iter_step, expected k)
VARIANTS = [
    ("flow", GLOBAL, {"flow_weight = 0\n": "flow_weight = 0.1\n"}, {}, 0, 0),
    ("seg", GLOBAL, {"pose_type = gf": "pose_type = seg"}, {}, 0, 0),
    ("occ250", FAST, {}, {}, 0, 0),
    ("occ100", FAST, {TRAIN_KEY: TRAIN_KEY + "\n    occ_update_freq = 100"}, {}, 0, 100),
    ("scan_steps_false", GLOBAL, {TRAIN_KEY: TRAIN_KEY + "\n    scan_steps = False"},
     {}, 0, 0),
    ("chunk50", GLOBAL, {TRAIN_KEY: TRAIN_KEY + "\n    scan_chunk = 50"}, {}, 0, 50),
    ("gradient_analysis", GLOBAL, {}, {"gradient_analysis": True}, 0, 0),
    ("mesh_warmup", GLOBAL, {"mesh_warmup_step = 0": "mesh_warmup_step = 10"}, {}, 0, 0),
    ("off_edge", GLOBAL, {}, {}, 150, 0),
    ("on_edge", GLOBAL, {}, {}, 200, 100),
]
SHIPPED = sorted(f for f in os.listdir(os.path.join(REPO, "confs")) if f.endswith(".conf"))
# the shipped confs the JAX Runner scans: phase 2 without the grid's
# 250-step refresh, the GT and BARF baselines
SCANNED = {"ho3d_barf.conf", "ho3d_global_womask.conf", "ho3d_gt.conf",
           "ml_barf.conf", "ml_global_womask.conf"}


@pytest.fixture(scope="module")
def small_scene():
    return tscene.make_orbit_scene(n_frames=3, H=16, W=16, seed=0)


def _eligibility(tmp_path, scene, name, conf, edits, kwargs, iter_step):
    with open(os.path.join(REPO, "confs", conf)) as f:
        text = f.read()
    for old, new in edits.items():
        assert old in text, (conf, old)
        text = text.replace(old, new)
    path = tmp_path / f"{name}.conf"
    path.write_text(text)
    runner = TRunner(str(path), mode="validate", case="SYN", device="cpu", scene=scene,
                     exp_dir=str(tmp_path / f"exp_{name}"), **kwargs)
    runner.iter_step = iter_step
    stub = types.SimpleNamespace(
        conf=jhocon.parse_file(str(path), {"CASE_NAME": "SYN", "DATA_SET": "DTU"}),
        **{a: getattr(runner, a) for a in ELIGIBILITY_ATTRS})
    return runner._scan_eligible(), JRunner._scan_eligible(stub)


def test_scan_eligible_matches_jax(tmp_path, small_scene):
    cases = [(c[:-5], c, {}, {}, 0, 100 if c in SCANNED else 0) for c in SHIPPED]
    for name, conf, edits, kwargs, iter_step, want in cases + VARIANTS:
        got, ref = _eligibility(tmp_path, small_scene, name, conf, edits, kwargs,
                                iter_step)
        assert got == ref == want, (name, got, ref, want)


# ---------------------------------------------------------------------------
# a scanned chunk against JAX's run_one
# ---------------------------------------------------------------------------

SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
       "multires": 4, "bias": 0.5, "scale": 1.0, "geometric_init": True,
       "weight_norm": True}
COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2, "squeeze_out": True}
NERF = {"D": 2, "d_in": 4, "d_in_view": 3, "W": 32, "multires": 2, "multires_view": 2,
        "output_ch": 4, "skips": (4,), "use_viewdirs": True}
RENDER = {"n_samples": 16, "n_importance": 16, "n_outside": 0, "up_sample_steps": 4,
          "perturb": 0.0}
B, H, W, N_IMG = 32, 24, 32, 3
STEP_KW = dict(batch_size=B, H=H, W=W, pose_mode="gf", igr_weight=0.1, mask_weight=0.1,
               unit_sphere_weight=0.01, mask_guided_sampling=True,
               mask_guided_patch_size=3)
# a schedule whose three steps take three learning rates (0 in the first,
# warm_up_end 1) and a cos-anneal ratio below 1
SCHEDULE = dict(learning_rate=5e-4, learning_rate_alpha=0.05, warm_up_end=1.0,
                end_iter=10, anneal_end=4.0, mask_guided=1.0)
K = 3
FRAMES = (1, 0, 2)


@pytest.fixture(scope="module")
def world():
    sc = tscene.make_orbit_scene(n_frames=N_IMG, H=H, W=W, span_deg=40.0, noise_deg=3.0,
                                 seed=1)
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    params = {"sdf": jn.init_sdf(k1, SDF), "color": jn.init_color(k2, COLOR),
              "nerf": jn.init_nerf(k3, NERF),
              "variance": jn.init_variance({"init_val": 0.3})}
    gf = jpp.init_gf(5, jpp.PoseCfg(), sc.crop_poses)
    params["pose"] = gf["train"]
    images = np.round(sc.images_np * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    masks = np.round(sc.masks_np[..., 0] * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    bufs = (images, masks, sc.intrinsics_all_inv.astype(np.float32),
            np.asarray(sc.mask_bboxes, np.int32))
    return sc, params, gf["static"], bufs


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_pixels(key, bbox, img_id):
    """The JAX run_one's pixel draw replayed (step.py:445, :416-422,
    rays.py:85-98), the mask guide active."""
    _, sub = jax.random.split(key)
    k1, _, _ = jax.random.split(sub, 3)
    k_guide, k_x, k_y = jax.random.split(k1, 3)
    use_bbox = jax.random.uniform(k_guide) < 0.7
    y0, y1, x0, x1 = jnp.asarray(bbox)[img_id]
    p = STEP_KW["mask_guided_patch_size"]
    y_lo = jnp.where(use_bbox, jnp.maximum(y0 - p, 0), 0)
    y_hi = jnp.where(use_bbox, jnp.minimum(y1 + p, H), H)
    x_lo = jnp.where(use_bbox, jnp.maximum(x0 - p, 0), 0)
    x_hi = jnp.where(use_bbox, jnp.minimum(x1 + p, W), W)
    px = jax.random.randint(k_x, (B,), x_lo, x_hi)
    py = jax.random.randint(k_y, (B,), y_lo, y_hi)
    return torch.tensor(np.array(px)).long(), torch.tensor(np.array(py)).long()


def _torch_cfg():
    return tstep.make_step_config(
        {"sdf": dict(SDF, use_fused=False), "color": dict(COLOR), "nerf": dict(NERF),
         "renderer": tneus.make_render_cfg(RENDER)}, **STEP_KW)


def _torch_state(params_j, static_j, seed=0):
    tree = convert.to_torch(_np_tree(params_j))
    layout = convert.ParamLayout(tree)
    flat = layout.ravel(tree, "cpu").requires_grad_(True)
    return tstep.TrainState(flat=flat, layout=layout, opt=toptim.adam_init(flat.detach()),
                            pose_static=convert.to_torch(_np_tree(static_j), "cpu"),
                            generator=torch.Generator().manual_seed(seed))


def test_scan_chunk_matches_jax_run_one(world):
    sc, params_j, static_j, bufs = world
    images, masks, intr_inv, bbox = bufs
    jcfg = {"sdf": dict(SDF, use_fused=False), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": jneus.make_render_cfg(RENDER)}
    cfg_j = jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1, **STEP_KW)
    run_one = jax.jit(jstep.make_photo_step(
        cfg_j, jnp.asarray(images.transpose(3, 0, 1, 2)), jnp.asarray(masks),
        jnp.asarray(intr_inv), jnp.asarray(bbox)).run_one)
    device_scalars = jstep.make_device_scalars(SCHEDULE, 1)
    state_j = jstep.TrainState(
        params=params_j, opt=joptim.adam_init(params_j), pose_bank={}, pose_opt=(),
        pose_static=static_j, key=jax.random.key(11), iter_step=jnp.zeros((), jnp.int32))
    pixels, metrics_j = [], []
    for i, frame in enumerate(FRAMES):
        pixels.append(_jax_pixels(state_j.key, bbox, frame))
        state_j, m = run_one(state_j, device_scalars(jnp.float32(i)), jnp.int32(frame),
                             jnp.int32(0))
        metrics_j.append({k: float(v) for k, v in m.items()})

    scan = tstep.ScanPhotoSteps(
        _torch_cfg(), *(torch.from_numpy(a) for a in bufs), SCHEDULE, K)
    assert not scan.capture  # the CPU runs the step eagerly
    state_t = _torch_state(params_j, static_j)
    mean = scan(state_t, N_IMG, frames=[torch.tensor([f]) for f in FRAMES], pixels=pixels)
    assert state_t.iter_step == K and state_t.opt.step == K
    assert int(scan.carry.iter_step) == K and int(scan.carry.adam_step) == K

    got = dict(zip(tstep.METRIC_NAMES, mean.tolist()))
    for name in metrics_j[0]:
        want = np.mean([m[name] for m in metrics_j])
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-7, err_msg=name)

    # the moments: the leaf rule on mu / 0.1 (an EMA of the gated gradients)
    _, unravel = ravel_pytree(params_j)
    ref = dict(convert.flatten(_np_tree(jax.tree_util.tree_map(
        lambda m: m / 0.1, unravel(state_j.opt.mu)))))
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref.values()))
    for name, t in convert.flatten(state_t.layout.views(state_t.opt.mu / 0.1)):
        err = np.abs(t.numpy().astype(np.float64) - ref[name]).max()
        rel = err / max(np.abs(ref[name]).max(), 1e-30)
        assert rel < 1e-2 or err < 1e-4 * gnorm, (name, rel, err, gnorm)
    assert np.abs(ref["pose.lin1.w"]).max() > 0  # the pose net is trained

    old = dict(convert.flatten(_np_tree(params_j)))
    new_j = dict(convert.flatten(_np_tree(state_j.params)))
    lr_sum = SCHEDULE["learning_rate"] * K
    for name, t in convert.flatten(state_t.params):
        move_t = t.detach().numpy() - old[name]
        move_j = new_j[name] - old[name]
        settled = np.abs(ref[name]) > 1e-4 * gnorm
        np.testing.assert_allclose(move_t[settled], move_j[settled], rtol=0,
                                   atol=1e-3 * lr_sum + 1e-6, err_msg=name)
        assert np.abs(move_t).max() <= lr_sum * 1.001


TINY_RENDER = {"n_samples": 4, "n_importance": 0, "n_outside": 0, "up_sample_steps": 1,
               "perturb": 1.0}


def test_scan_frames_are_uniform(world):
    """Two chunks of 100 steps draw their frames iid uniform on [0, 3)
    from the state's generator: a loose chi-square (df 2, p > 1e-3)."""
    sc, params_j, static_j, bufs = world
    cfg = tstep.make_step_config(
        {"sdf": dict(SDF, use_fused=False), "color": dict(COLOR), "nerf": dict(NERF),
         "renderer": tneus.make_render_cfg(TINY_RENDER)}, **dict(STEP_KW, batch_size=4))
    scan = tstep.ScanPhotoSteps(cfg, *(torch.from_numpy(a) for a in bufs),
                                       SCHEDULE, 100)
    state = _torch_state(params_j, static_j, seed=3)
    frames = []
    for _ in range(2):
        scan(state, N_IMG)
        frames += scan.carry.frames.tolist()
    counts = np.bincount(frames, minlength=N_IMG)
    assert len(counts) == N_IMG and counts.sum() == 200
    expected = 200 / N_IMG
    assert ((counts - expected) ** 2 / expected).sum() < 13.8, counts


# ---------------------------------------------------------------------------
# the Runner's scan path against the JAX Runner's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gt_data(tmp_path_factory):
    from fmov_pose_tpu.data.synthetic import make_orbit_sequence
    root = tmp_path_factory.mktemp("scan_e2e")
    make_orbit_sequence(str(root / "SYN_ori"), n_frames=5, H=48, W=48, span_deg=40)
    return root


def _gt_conf(path, exp_dir, data_root):
    _write_conf(path, GT_CONF, exp_dir=str(exp_dir), data_dir=str(data_root / "SYN_ori"),
                end_iter=60, batch=96)
    text = path.read_text().replace(
        "save_freq = 100000", "save_freq = 25\n    scan_chunk = 25")
    path.write_text(text)
    return str(path)


def _files(exp_dir):
    """The run's files but the package's backup and JAX's tensorboard log."""
    out = set()
    for root, _, names in os.walk(exp_dir):
        rel = os.path.relpath(root, exp_dir)
        if rel.split(os.sep)[0] in ("recording", "logs"):
            continue
        out |= {os.path.join(rel, n) for n in names}
    return out


def _state(runner):
    st = runner.state
    return [st.flat.detach(), st.opt.mu, st.opt.nu, st.generator.get_state()]


def test_runner_scan_path_matches_jax_and_resumes(gt_data, tmp_path):
    conf_t = _gt_conf(tmp_path / "gt_t.conf", tmp_path / "exp_t", gt_data)
    runner = TRunner(conf_t, mode="train", case="SYN_ori", has_global_conf=True,
                     device="cpu")
    runner.train()
    assert runner.dispatch == "scan x25"
    # 60 is not a whole number of chunks: the last 10 steps are not run
    assert runner.iter_step == runner.state.iter_step == runner.state.opt.step == 50
    loss = np.asarray(runner.history["loss"])
    assert loss.shape == (2,) and np.all(np.isfinite(loss))

    conf_j = _gt_conf(tmp_path / "gt_j.conf", tmp_path / "exp_j", gt_data)
    jrunner = JRunner(conf_j, mode="train", case="SYN_ori", has_global_conf=True)
    jrunner.train()
    assert jrunner.iter_step == runner.iter_step
    files = _files(tmp_path / "exp_t")
    assert files == _files(tmp_path / "exp_j") == {
        "checkpoints/ckpt_000005_000025.ckpt", "checkpoints/ckpt_000005_000050.ckpt"}
    for exp in ("exp_t", "exp_j"):
        assert os.path.exists(tmp_path / exp / "recording" / "config.conf")

    # resumed from the first chunk edge with is_continue: bitwise the run
    ckpt_dir = tmp_path / "exp_r" / "checkpoints"
    os.makedirs(ckpt_dir)
    shutil.copy(tmp_path / "exp_t" / "checkpoints" / "ckpt_000005_000025.ckpt", ckpt_dir)
    conf_r = _gt_conf(tmp_path / "gt_r.conf", tmp_path / "exp_r", gt_data)
    resumed = TRunner(conf_r, mode="train", case="SYN_ori", has_global_conf=True,
                      device="cpu", is_continue=True)
    assert resumed.iter_step == 25 and resumed._scan_eligible() == 25
    resumed.train()
    assert resumed.iter_step == 50
    for a, b in zip(_state(runner), _state(resumed)):
        assert torch.equal(a, b)
    assert resumed.history["loss"] == runner.history["loss"][1:]


# ---------------------------------------------------------------------------
# the per-step path keeps its results
# ---------------------------------------------------------------------------

def test_device_ids_and_counts_keep_per_step_results(world):
    """The per-step step with host ints and floats against the same step
    with the frame as a device tensor, the gates as 0-d tensors and the
    Adam count on the device: bitwise the same draws, metrics and state."""
    sc, params_j, static_j, bufs = world
    cfg = _torch_cfg()
    tensors = [torch.from_numpy(x) for x in bufs]
    step = tstep.make_photo_step(cfg, *tensors)
    loss_fn = tstep.make_photo_loss(cfg, *tensors)
    host = tstep.StepScalars(lr=5e-4, cos_anneal=0.5)
    one = torch.tensor(1.0)
    dev = tstep.StepScalars(lr=torch.tensor(5e-4), cos_anneal=torch.tensor(0.5),
                            main_update=one, pose_update=one, mask_guided=one,
                            trans_head_on=one)
    a, b = _torch_state(params_j, static_j, seed=7), _torch_state(params_j, static_j, seed=7)
    count = torch.zeros((), dtype=torch.int32)
    for frame in (1, 2):
        _, ma = step(a, host, frame)
        mb = tstep._grads_and_update(
            cfg, b, dev, lambda params, bank: loss_fn(params, b, torch.tensor([frame]), dev),
            {}, adam_step=count)
        b.iter_step += 1
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    assert torch.equal(a.flat, b.flat) and torch.equal(a.opt.mu, b.opt.mu)
    assert torch.equal(a.opt.nu, b.opt.nu) and a.opt.step == int(count) == 2
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    # the pose of a frame: a host int and a device id alike
    for frame in range(N_IMG):
        assert torch.equal(
            tstep.pose_of_frame(cfg, a.params, None, a.pose_static, frame),
            tstep.pose_of_frame(cfg, a.params, None, a.pose_static, torch.tensor([frame])))
    rows = torch.from_numpy(bufs[3])
    assert torch.equal(trays.frame_row(rows, 2), trays.frame_row(rows, torch.tensor([2])))
