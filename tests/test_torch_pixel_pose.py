"""Pixel-level pose banks (``model.pixel_level``, pose mode ``seg_pixel``)
in the port, against the JAX package's ``poses/pixel_pose.py``.

* ``init_deep_pose`` and ``init_seg_deep_bank``: bitwise the JAX leaves,
  for every camera-id encoding, output init and rotation type.
* ``deep_pose_apply``: frame-level and per pixel (``input_pts``), for
  every encoding and output init, within 1e-5; ``rotation_from_ortho6d``
  within 1e-6.
* The bank: ``seg_deep_apply`` of every frame within 1e-5 of JAX's, and
  ``seg_deep_initialize`` (the lazy init of a segment from the previous
  one's last pose) within 1e-5, flagging the segment on the host.
* The ``seg_pixel`` photo and flow steps against JAX's ``make_photo_step``
  / ``make_flow_step`` on fixed rays, as
  ``tests/test_torch_step_seg.py::test_seg_step_matches_jax`` holds the
  ``seg`` steps: every metric rtol 1e-3, every gradient leaf of the
  fields and of the bank by the leaf rule, the moved parameters.
* ``tests/test_reset.py`` in the port, for the segment and the deep bank:
  an admission past the rotation threshold resets the fields and keeps
  the bank bitwise, below it nothing resets; a run whose learned
  rotation turns 40 degrees a frame resets and recovers (the ``seg``
  bank on the per-step loop, the deep bank on the planned path).
* A ``seg_pixel`` checkpoint in the JAX layout: a JAX Runner's file loads
  into the port bitwise, and the port's leaves, put into the JAX
  Runner's state tree and written by the JAX package, load back bitwise.

The deep nets are cut in width and depth (3 x 32, skip 1, 2 + 2
frequencies) wherever a Runner builds them, on both sides.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.poses import pixel_pose as jpx
from fmov_pose_tpu.render import neus as jneus
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_tpu.train import step as jstep
from fmov_pose_torch import convert
from fmov_pose_torch.ops import fused_sdf
from fmov_pose_torch.poses import pixel_pose as tpx
from fmov_pose_torch.render import neus as tneus
from fmov_pose_torch.train import checkpoint as tckpt
from fmov_pose_torch.train import optim as toptim
from fmov_pose_torch.train import step as tstep
from tests.test_torch_progressive import _virtual_conf, seq_root  # noqa: F401
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_step_fast import _count_calls
from tests.test_torch_step_seg import (COLOR, INTERVAL, LR, N_IMG, NERF, RENDER, SDF,
                                       SEG_LR, STEP_KW, B, _replay_pixels,
                                       _settled_steps, jax_interpret, world)  # noqa: F401

SMALL = dict(D=3, W=32, skips=(1,), x_multires=2, t_multires=2)
ENCODINGS = ("position", "fourier", "original_fourier", "embedding")
INITS = ("zero", "small_weight", "direct")
PIXEL = ("pose_type = seg", "pose_type = seg\n    pixel_level = True\n"
         "    data_parallel = False")


def _pose(deg=0.0, t=(0.1, 0.2, -2.0)):
    a = np.deg2rad(deg)
    p = np.eye(4, dtype=np.float32)
    p[0, 0] = p[2, 2] = np.cos(a)
    p[0, 2], p[2, 0] = np.sin(a), -np.sin(a)
    p[:3, 3] = t
    return p


def _flat(tree):
    return [(n, np.asarray(v)) for n, v in convert.flatten(tree)]


def _same_tree(tj, tt):
    a, b = _flat(tj), [(n, v.numpy()) for n, v in convert.flatten(tt)]
    assert [n for n, _ in a] == [n for n, _ in b]
    for (n, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, n
        np.testing.assert_array_equal(x, y, err_msg=n)


@pytest.mark.parametrize("rot_type", ["angle", "ortho6d"])
@pytest.mark.parametrize("enc", ENCODINGS)
def test_init_matches_jax(enc, rot_type):
    for init in INITS:
        cfg_kw = dict(SMALL, n_images=6, cam_id_encoding=enc, output_init=init,
                      rot_type=rot_type)
        jc, tc = jpx.DeepPoseCfg(**cfg_kw), tpx.DeepPoseCfg(**cfg_kw)
        _same_tree(jpx.init_deep_pose(7, jc, _pose(20.0)), tpx.init_deep_pose(7, tc, _pose(20.0)))
        jb = jpx.init_seg_deep_bank(7, jc, 6, 2, _pose(20.0))
        tb = tpx.init_seg_deep_bank(7, tc, 6, 2, _pose(20.0))
        _same_tree(jb["train"], tb["train"])
        static_j = {k: v for k, v in jb["static"].items() if k != "progress"}
        init_j = static_j.pop("initialized")
        static_t = dict(tb["static"])
        np.testing.assert_array_equal(static_t.pop("initialized"), np.asarray(init_j))
        _same_tree(static_j, static_t)


@pytest.mark.parametrize("init", INITS)
@pytest.mark.parametrize("enc", ENCODINGS)
def test_deep_pose_apply_matches_jax(enc, init):
    cfg_kw = dict(SMALL, n_images=6, cam_id_encoding=enc, output_init=init)
    jc, tc = jpx.DeepPoseCfg(**cfg_kw), tpx.DeepPoseCfg(**cfg_kw)
    init_c2w = np.stack([_pose(10.0 * i) for i in range(6)])
    pj, pt = jpx.init_deep_pose(3, jc, init_c2w), tpx.init_deep_pose(3, tc, init_c2w)
    # trained-looking output weights: the zero / direct inits start at 0
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.05, pj["train"]["out"]["w"].shape).astype(np.float32)
    pj["train"]["out"]["w"] = jnp.asarray(w)
    pt["train"]["out"]["w"] = torch.from_numpy(w.copy())
    for cam in range(6):
        want = np.asarray(jpx.deep_pose_apply(pj, jc, cam))
        got = tpx.deep_pose_apply(pt, tc, cam)
        assert got.shape == (3, 4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=str(cam))
        assert torch.equal(tpx.deep_pose_apply(pt, tc, torch.tensor([cam])), got)
    # per pixel, conditioned on camera-space points
    pts = rng.normal(size=(2, 5, 3)).astype(np.float32)
    jc, tc = jc._replace(disable_pts=False), tc._replace(disable_pts=False)
    want = np.asarray(jpx.deep_pose_apply(pj, jc, 2, input_pts=jnp.asarray(pts)))
    got = tpx.deep_pose_apply(pt, tc, 2, input_pts=torch.from_numpy(pts))
    assert got.shape == want.shape == (2, 5, 3, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_rotation_from_ortho6d_matches_jax():
    x = np.random.default_rng(0).normal(size=(7, 6)).astype(np.float32)
    want = np.asarray(jpx.rotation_from_ortho6d(jnp.asarray(x)))
    got = tpx.rotation_from_ortho6d(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (7, 3, 3)), atol=1e-5)


@pytest.mark.parametrize("enc", ["position", "embedding"])
def test_seg_deep_bank_matches_jax(enc):
    cfg_kw = dict(SMALL, n_images=7, cam_id_encoding=enc)
    jc, tc = jpx.DeepPoseCfg(**cfg_kw), tpx.DeepPoseCfg(**cfg_kw)
    jb = jpx.init_seg_deep_bank(11, jc, 7, 3, _pose(15.0))
    tb = tpx.init_seg_deep_bank(11, tc, 7, 3, _pose(15.0))
    for seg in (1, 2):
        jb = jpx.seg_deep_initialize(jb, jc, 3, seg)
        tpx.seg_deep_initialize(tb, tc, 3, seg)
        assert tb["static"]["initialized"][seg]
        np.testing.assert_allclose(tb["static"]["init_c2w"][seg].numpy(),
                                   np.asarray(jb["static"]["init_c2w"][seg]), atol=1e-5)
    before = tb["static"]["init_c2w"].clone()
    tpx.seg_deep_initialize(tb, tc, 3, 2)  # once initialized: a no-op
    assert torch.equal(before, tb["static"]["init_c2w"])
    np.testing.assert_array_equal(tb["static"]["initialized"],
                                  np.asarray(jb["static"]["initialized"]))
    for cam in range(7):
        want = np.asarray(jpx.seg_deep_apply(jb, jc, 3, cam))
        np.testing.assert_allclose(tpx.seg_deep_apply(tb, tc, 3, cam).numpy(), want,
                                   atol=1e-5, err_msg=str(cam))
    tbb = convert.seg_deep_bank_to_torch(jax.tree_util.tree_map(np.asarray, jb))
    assert sorted(tbb["static"]) == sorted(tb["static"])
    np.testing.assert_array_equal(tbb["static"]["initialized"], tb["static"]["initialized"])


@pytest.mark.parametrize("kind", ["photo", "flow"])
def test_seg_pixel_step_matches_jax(world, jax_interpret, kind, monkeypatch):  # noqa: F811
    sc, params_j, _ = world
    deep_j = jpx.DeepPoseCfg(n_images=N_IMG, **SMALL)
    deep_t = tpx.DeepPoseCfg(n_images=N_IMG, **SMALL)
    bank_j = jpx.init_seg_deep_bank(5, deep_j, N_IMG, INTERVAL, sc.max_mask_pose)
    bank_j = jpx.seg_deep_initialize(bank_j, deep_j, INTERVAL, 1)
    kw = dict(STEP_KW, pose_mode="seg_pixel")
    images = np.round(sc.images_np * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    masks = np.round(sc.masks_np[..., 0] * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    intr_inv = sc.intrinsics_all_inv.astype(np.float32)
    jcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": jneus.make_render_cfg(RENDER)}
    tcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": tneus.make_render_cfg(RENDER)}
    cfg_j = jstep.make_step_config(jcfg, deep_pose_cfg=deep_j, **kw)
    cfg_t = tstep.make_step_config(tcfg, deep_pose_cfg=deep_t, **kw)
    bufs_j = (jnp.asarray(images.transpose(3, 0, 1, 2)), jnp.asarray(masks),
              jnp.asarray(intr_inv), jnp.asarray(sc.mask_bboxes))
    bufs_t = tuple(torch.from_numpy(np.asarray(a)) for a in
                   (images, masks, intr_inv, sc.mask_bboxes))
    key = jax.random.key(11)
    state_j = jstep.TrainState(
        params=params_j, opt=joptim.adam_init(params_j), pose_bank=bank_j,
        pose_opt=joptim.seg_adam_init(bank_j["train"], 2), pose_static={},
        key=key, iter_step=jnp.zeros((), jnp.int32))
    if kind == "photo":
        img_id, add_img_id, img_id_corr, pixels_pair = 2, 1, 0, None
    else:
        img_id, img_id_corr, add_img_id = 2, 1, 0
        xs1, ys1, xs2, ys2 = sc.loftr_flows["0001_0002"]
        sel = np.arange(B // 2) * 7
        pixels_pair = np.stack([xs1[sel], ys1[sel], xs2[sel], ys2[sel]],
                               -1).astype(np.float32)
    packed = tstep.pack_scalars_np(LR, 1.0, 1.0, 1.0, 1.0, 1.0, img_id, add_img_id,
                                   img_id_corr, np.ones(2), np.ones(2), SEG_LR)
    _, sub = jax.random.split(key)
    if kind == "photo":
        step_j = jstep.make_photo_step(cfg_j, *bufs_j)
        new_j, mj = jax.jit(lambda s, p: step_j(s, p))(state_j, packed)
        k1, k2, _ = jax.random.split(sub, 3)
        pixels = _replay_pixels(k1, sc.mask_bboxes, img_id, 1.0)
    else:
        step_j = jstep.make_flow_step(cfg_j, *bufs_j)
        new_j, mj = jax.jit(lambda s, p, x: step_j(s, p, x))(state_j, packed, pixels_pair)
        k2, _ = jax.random.split(sub)
    add_pixels = _replay_pixels(k2, sc.mask_bboxes, add_img_id, 1.0)

    tree_t = convert.to_torch(jax.tree_util.tree_map(np.asarray, params_j))
    layout = convert.ParamLayout(tree_t)
    flat = layout.ravel(tree_t).requires_grad_(True)
    bank_t = convert.seg_deep_bank_to_torch(jax.tree_util.tree_map(np.asarray, bank_j))
    bank_layout = convert.ParamLayout(bank_t["train"])
    bank_flat = bank_layout.ravel(bank_t["train"]).requires_grad_(True)
    state_t = tstep.TrainState(
        flat=flat, layout=layout, opt=toptim.adam_init(flat.detach()),
        pose_static={}, generator=torch.Generator().manual_seed(0),
        bank_flat=bank_flat, bank_layout=bank_layout, bank_static=bank_t["static"],
        pose_opt=toptim.seg_adam_init(bank_flat.detach(), bank_layout.shapes, 2))
    scalars = tstep.unpack_scalars_np(packed, 2)[0]
    calls = _count_calls(monkeypatch, fused_sdf, "sdf_apply_grad_fused")
    if kind == "photo":
        step_t = tstep.make_photo_step(cfg_t, *bufs_t)
        state_t, mt = step_t(state_t, scalars, img_id, add_img_id,
                             pixels=pixels, add_pixels=add_pixels)
    else:
        step_t = tstep.make_flow_step(cfg_t, *bufs_t)
        state_t, mt = step_t(state_t, scalars, img_id, img_id_corr, add_img_id,
                             pixels_pair, add_pixels=add_pixels)
    assert len(calls) == 1  # the flat K2/K3 path
    for k, v in mj.items():
        np.testing.assert_allclose(float(mt[k]), float(v), rtol=1e-3, atol=1e-7,
                                   err_msg=k)
    if kind == "flow":
        assert float(mt["flow_loss"]) > 0
    assert state_t.pose_opt.step.tolist() == np.asarray(new_j.pose_opt.step).tolist()

    _, unravel = ravel_pytree(params_j)
    _, unravel_b = ravel_pytree(bank_j["train"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ref = {f"f.{n}": torch.tensor(np.asarray(v)) / 0.1 for n, v in
           convert.flatten(np_tree(unravel(new_j.opt.mu)))}
    ref.update({f"b.{n}": torch.tensor(np.asarray(v)) / 0.1 for n, v in
                convert.flatten(np_tree(unravel_b(new_j.pose_opt.mu)))})
    got = {f"f.{n}": t / 0.1 for n, t in convert.flatten(layout.views(state_t.opt.mu))}
    got.update({f"b.{n}": t / 0.1 for n, t in
                convert.flatten(bank_layout.views(state_t.pose_opt.mu))})
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res
    assert float(ref["b.lin0.w"].abs().max()) > 0  # the deep bank is trained

    new_pj = dict(convert.flatten(np_tree(new_j.params)))
    old_pj = dict(convert.flatten(np_tree(params_j)))
    for n, t in convert.flatten(state_t.params):
        _settled_steps(n, old_pj[n], t.detach().numpy(), new_pj[n],
                       ref[f"f.{n}"].numpy(), res["gnorm"])
    new_bj = dict(convert.flatten(np_tree(new_j.pose_bank["train"])))
    old_bj = dict(convert.flatten(np_tree(bank_j["train"])))
    for n, t in convert.flatten(state_t.pose_bank["train"]):
        _settled_steps(n, old_bj[n], t.detach().numpy(), new_bj[n],
                       ref[f"b.{n}"].numpy(), res["gnorm"])


@pytest.fixture
def small_deep_nets(monkeypatch):
    """Runners of both packages build their deep pose nets at SMALL."""
    from fmov_pose_tpu.train import runner as jrunner
    from fmov_pose_torch.train import runner as trunner
    assert jrunner and trunner.px is tpx  # both read DeepPoseCfg off these modules
    for px in (jpx, tpx):
        cls = px.DeepPoseCfg
        monkeypatch.setattr(px, "DeepPoseCfg",
                            lambda n_images, cls=cls: cls(n_images=n_images, **SMALL))


RESET = ("reset_based_on_rot = False",
         "reset_based_on_rot = True\n    reset_rot_threshold = 60")


def _reset_runner(root, tmp, bank, name, end_iter=100, k=None):
    from fmov_pose_torch.train.runner import Runner
    extra = [RESET] + ([PIXEL] if bank == "seg_pixel" else [])
    if k:
        extra.append(("maintain_shape = True", f"maintain_shape = True\n    plan_chunk = {k}"))
    sub = tmp / name
    sub.mkdir()
    conf = _virtual_conf(root, sub, end_iter=end_iter, extra=extra)
    r = Runner(conf, mode="train", case="SYN_ori", has_global_conf=True, device="cpu")
    assert r.pose_mode == bank and r.reset_based_on_rot
    return r


def _seed_segment(runner, seg, pose):
    """Segment ``seg``'s init pose set to ``pose`` (in place, flagged)."""
    with torch.no_grad():
        runner.state.bank_static["init_c2w"][seg] = torch.from_numpy(pose)
    runner.state.bank_static["initialized"][seg] = True


@pytest.mark.parametrize("bank", ["seg", "seg_pixel"])
def test_reset_fires_and_keeps_the_bank(seq_root, tmp_path, bank, small_deep_nets):  # noqa: F811
    r = _reset_runner(seq_root, tmp_path, bank, "fire")
    ctl = _reset_runner(seq_root, tmp_path, bank, "control")
    for runner, deg in ((r, 90.0), (ctl, 20.0)):
        # the state just before the third admission, segment 1 (frame 1)
        # seeded past (or below) the threshold from the last reference
        runner.current_image, runner.current_pose_mlp_index = 2, 1
        runner.prev_pose = np.eye(3, dtype=np.float32)
        _seed_segment(runner, 1, _pose(deg, (0.0, 0.0, -2.0)))
        runner.iter_step = 50
        runner.pro_iteration = runner.max_pro_iteration - 1
    flat0, bank0 = r.state.flat.detach().clone(), r.state.bank_flat.detach().clone()
    static0 = r.state.bank_static["init_c2w"].clone()
    r._progressive_update()
    assert r.reset_count == 1 and r.iter_step == 0 and r.state.iter_step == 0
    assert r.state.opt.step == 0
    assert r.state.flat.shape == flat0.shape and not torch.equal(r.state.flat, flat0)
    assert torch.equal(r.state.bank_flat, bank0)  # the bank survives bitwise
    assert torch.equal(r.state.bank_static["init_c2w"][:2], static0[:2])
    rel = r.prev_pose @ np.linalg.inv(_pose(90.0)[:3, :3])
    assert np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))) < 25.0
    assert (r.current_image, r.current_pose_mlp_index) == (3, 2)
    assert r.state.bank_static["initialized"][2]
    ctl._progressive_update()
    assert ctl.reset_count == 0 and ctl.iter_step == 50


@pytest.mark.parametrize("bank,k", [pytest.param("seg", None, id="seg-per_step"),
                                    pytest.param("seg_pixel", 4, id="seg_pixel-planned")])
def test_training_recovers_after_reset(seq_root, tmp_path, bank, k, small_deep_nets):  # noqa: F811
    r = _reset_runner(seq_root, tmp_path, bank, "recover", end_iter=120, k=k)
    query = r.query_pose

    def fast_rotation(i):
        out = _pose(40.0 * i)
        out[:3, 3] = query(i)[:3, 3]
        return out

    r.query_pose = fast_rotation
    # a reset restarts iter_step at 0, where the JAX loops' mesh event
    # fires: a 64^3 mesh on the CPU each time, which this test does not read
    r.validate_mesh = lambda *a, **k: None
    planned, resets = [0], []
    plan_step, reset = r._plan_step, r.reset_neus

    def counted():
        planned[0] += 1
        return plan_step()

    def marked(seed=None):
        resets.append(planned[0])  # the steps planned (and run) so far
        return reset(seed)

    r._plan_step, r.reset_neus = counted, marked
    r.train()
    assert r.dispatch == ("per-step" if k is None else f"planned x{k}")
    losses = np.asarray(r.history["loss"])
    assert r.reset_count >= 1 and len(resets) == r.reset_count
    assert r.current_image == 5  # admissions go on past the resets
    assert np.isfinite(losses).all()
    post = losses[resets[-1]:]
    assert len(post) >= 10
    assert post[-5:].mean() < post[:3].mean(), "no recovery after the last reset"
    poses = np.stack([query(i) for i in range(5)])
    assert np.isfinite(poses).all()
    for p in poses:
        np.testing.assert_allclose(p[:3, :3].T @ p[:3, :3], np.eye(3), atol=1e-3)


def test_seg_pixel_checkpoint_in_the_jax_layout(seq_root, tmp_path, small_deep_nets):  # noqa: F811
    from fmov_pose_tpu.train import checkpoint as jckpt
    from fmov_pose_tpu.train.runner import Runner as JRunner
    from fmov_pose_torch.train.runner import Runner
    conf = _virtual_conf(seq_root, tmp_path, end_iter=12, extra=[PIXEL])
    jr = JRunner(conf, mode="train", case="SYN_ori", has_global_conf=True)
    assert jr.pose_mode == "seg_pixel"
    jr.save_checkpoint()
    tr = Runner(conf, mode="train", case="SYN_ori", has_global_conf=True,
                is_continue=True, device="cpu")
    assert tr.pose_mode == "seg_pixel"
    # the JAX Runner's leaves, by position, bitwise
    leaves_j, treedef = jax.tree_util.tree_flatten(jckpt._to_numpy_tree(jr.state))
    names = [n for n, _ in tr.state_leaves()]
    assert [n for n in names if n.startswith("pose_bank.static.")] == [
        "pose_bank.static.init_c2w", "pose_bank.static.initialized",
        "pose_bank.static.progress"]
    for (n, x), y in zip(tr.state_leaves(), leaves_j):
        if n != "key":  # the port keeps a generator, seeded from JAX's key
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=n)
    # the port trains and saves; its leaves fill the JAX Runner's state
    # tree, which the JAX package writes and the port reads back bitwise
    tr.train()
    leaves_t, meta, _ = tckpt.load_checkpoint(
        tckpt.latest_checkpoint(os.path.join(tr.base_exp_dir, "checkpoints")))
    tree = jax.tree_util.tree_unflatten(treedef, leaves_t)
    for x, y in zip(jax.tree_util.tree_leaves(tree), leaves_j):
        assert np.shape(x) == np.shape(y) and np.asarray(x).dtype == np.asarray(y).dtype
    path = os.path.join(tmp_path, "jax_layout", "ckpt_000001_000012.ckpt")
    os.makedirs(os.path.dirname(path))
    jckpt.save_checkpoint(path, tree, {k: v for k, v in meta.items()
                                       if not k.startswith("generator")})
    back = Runner(conf, mode="train", case="SYN_ori", has_global_conf=True, device="cpu")
    back.load_checkpoint(path)
    for (n, x), (_, y) in zip(tr.state_leaves(), back.state_leaves()):
        if n != "key":
            np.testing.assert_array_equal(x, y, err_msg=n)
    assert (back.iter_step, back.current_image) == (tr.iter_step, tr.current_image) == (12, 1)
