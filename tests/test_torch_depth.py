"""Depth supervision (``train.depth_weight``): the port's Dataset depth
maps, the depth column of the ray batch, the depth loss and its gradient
against the JAX package on the CPU; and depth-supervised CPU runs of the
port's Runner (``tests/test_depth.py``'s, on the per-step loop and on the
scan path), and a conf that asks for depth where the data has none.

Tolerances: the Dataset's maps and the ray batch's 11 columns exactly
(the same float32 arithmetic on the same pixels; the ray directions to
1e-6, as ``pixels_to_rays`` multiplies in another order); the loss and
every metric rtol 1e-4 and the gradient leaves by the ROADMAP rule
(relative error < 1%, or absolute < 1e-4 x the global norm), as
``tests/test_torch_step.py`` holds the f32 step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.data import hocon as jhocon
from fmov_pose_tpu.data import rays as jrays
from fmov_pose_tpu.data.dataset import Dataset as JDataset
from fmov_pose_tpu.data.synthetic import make_orbit_sequence
from fmov_pose_tpu.train import step as jstep
from fmov_pose_torch import convert
from fmov_pose_torch.data import hocon as thocon
from fmov_pose_torch.data import rays as trays
from fmov_pose_torch.data.dataset import Dataset as TDataset
from fmov_pose_torch.train import step as tstep
from tests.test_depth import CONF
from tests.test_torch_step import (B, H, LR, STEP_KW, W, _check_grads, _check_scalars,
                                   _model_cfgs, _np_tree, world)  # noqa: F401
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)

DEPTH_W = 0.5


def _sequence(root, n=4, hw=48, png=False):
    """A synthetic sequence with its depth maps under depth/ (npy, or
    16-bit png of the depth in 1/1000 units)."""
    gt = make_orbit_sequence(str(root), n_frames=n, H=hw, W=hw, span_deg=40,
                             with_matches=False, with_crop=False)
    os.makedirs(root / "depth", exist_ok=True)
    for i, (_rgb, _mask, depth) in enumerate(gt["frames"]):
        if png:
            import cv2
            cv2.imwrite(str(root / "depth" / f"{i:04d}.png"),
                        np.round(depth * 1000).astype(np.uint16))
        else:
            np.save(str(root / "depth" / f"{i:04d}.npy"), depth)
    return gt


@pytest.mark.parametrize("png", [False, True], ids=["npy", "png"])
def test_dataset_depths_match_jax(tmp_path, png):
    _sequence(tmp_path / "SYN", png=png)
    for load, start in ((True, 0), (True, 1), (False, 0)):
        text = f"""dataset {{
            data_dir = {tmp_path / 'SYN'}/
            render_cameras_name = cameras_sphere.npz
            load_depth = {load}
            start_idx = {start}
        }}"""
        dj = JDataset(jhocon.parse_string(text)["dataset"])
        dt = TDataset(thocon.parse_string(text)["dataset"])
        if not load:
            assert dt.depths_np is None and dj.depths_np is None
            continue
        assert dt.depths_np.dtype == np.float32 and len(dt.depths_np) == dt.n_images
        np.testing.assert_array_equal(dt.depths_np, dj.depths_np)
        assert dt.depths_np.max() > 0


def test_ray_batch_depth_column_matches_jax(world):  # noqa: F811
    sc = world[0]
    rng = np.random.default_rng(2)
    depths = (rng.uniform(0.5, 2.0, (len(sc.images_np), H, W))
              * (rng.random((len(sc.images_np), H, W)) > 0.3)).astype(np.float32)
    images = sc.images_np.astype(np.float32)
    masks = sc.masks_np[..., 0].astype(np.float32)
    intr_inv = sc.intrinsics_all_inv.astype(np.float32)
    pose = sc.pose_all[1][:3].astype(np.float32)
    key = jax.random.key(5)
    data_j = np.asarray(jrays.gen_random_rays(
        key, jnp.asarray(images.transpose(3, 0, 1, 2)), jnp.asarray(masks),
        jnp.asarray(intr_inv), jnp.asarray(pose), 1, B, jnp.asarray(sc.mask_bboxes), 3,
        False, H, W, depths=jnp.asarray(depths)))
    # the JAX draw without mask guiding (rays.py: the guide, x and y keys)
    _, k_x, k_y = jax.random.split(key, 3)
    px = torch.from_numpy(np.array(jax.random.randint(k_x, (B,), 0, W))).long()
    py = torch.from_numpy(np.array(jax.random.randint(k_y, (B,), 0, H))).long()
    data_t = trays.gen_random_rays(
        None, torch.from_numpy(images), torch.from_numpy(masks),
        torch.from_numpy(intr_inv), torch.from_numpy(pose), 1, B,
        torch.from_numpy(sc.mask_bboxes), 3, False, H, W, pixels=(px, py),
        depths=torch.from_numpy(depths)).numpy()
    assert data_t.shape == data_j.shape == (B, 11)
    np.testing.assert_array_equal(data_t[:, 6:10], data_j[:, 6:10])
    np.testing.assert_allclose(data_t[:, :6], data_j[:, :6], rtol=0, atol=1e-6)
    np.testing.assert_allclose(data_t[:, 10], data_j[:, 10], rtol=1e-6)
    assert (data_t[:, 10] > 0).any() and (data_t[:, 10] == 0).any()


def test_depth_loss_matches_jax(world):  # noqa: F811
    """``_render_and_losses`` on one [B, 11] batch (some rays outside the
    mask, some without a depth): the depth loss, the total and its
    gradient leaves."""
    sc, params_j, static_j = world
    jcfg, tcfg = _model_cfgs(False)
    rng = np.random.default_rng(3)
    px, py = (torch.from_numpy(rng.integers(0, n, B)) for n in (W, H))
    depth = (rng.uniform(0.5, 2.0, (len(sc.images_np), H, W))
             * (rng.random((len(sc.images_np), H, W)) > 0.2)).astype(np.float32)
    data = trays.gen_random_rays(
        None, torch.from_numpy(sc.images_np), torch.from_numpy(sc.masks_np[..., 0]),
        torch.from_numpy(sc.intrinsics_all_inv.astype(np.float32)),
        torch.from_numpy(sc.pose_all[0][:3]), 0, B, None, 0, False, H, W,
        pixels=(px, py), depths=torch.from_numpy(depth)).numpy()
    kw = dict(STEP_KW, depth_weight=DEPTH_W)
    cfg_j = jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1, **kw)
    cfg_t = tstep.make_step_config(tcfg, **kw)
    sc_j = jstep.StepScalars(
        lr=jnp.float32(LR), cos_anneal=jnp.float32(0.7), main_update=1.0,
        pose_update=1.0, mask_guided=1.0, seg_touch=jnp.ones(1),
        seg_freeze=jnp.ones(1), seg_lr=jnp.ones(1), trans_head_on=1.0)

    def loss_j(p):
        return jstep._render_and_losses(cfg_j, jax.random.key(9), p, {}, static_j,
                                        jnp.asarray(data), sc_j)

    (_, mj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_j)
    items = convert.flatten(convert.to_torch(_np_tree(params_j)))
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    params_t = convert.unflatten(zip([n for n, _ in items], leaves))
    lt, mt = tstep._render_and_losses(cfg_t, None, params_t,
                                      convert.to_torch(_np_tree(static_j)),
                                      torch.from_numpy(data),
                                      tstep.StepScalars(lr=LR, cos_anneal=0.7))
    assert float(mj["depth_loss"]) > 0
    _check_scalars(mj, mt, 1e-4)
    grads = torch.autograd.grad(lt, leaves, allow_unused=True)
    ref, _ = _check_grads(gj, [(n, (torch.zeros_like(l) if g is None else g).numpy())
                               for (n, l), g in zip(items, grads)])
    # the loss moves the SDF: its gradient differs from the one without it
    (_, _), g0 = jax.jit(jax.value_and_grad(
        lambda p: jstep._render_and_losses(
            jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1, **STEP_KW),
            jax.random.key(9), p, {}, static_j, jnp.asarray(data), sc_j),
        has_aux=True))(params_j)
    g0 = dict(convert.flatten(_np_tree(g0)))
    assert np.abs(ref["sdf.layers.lin0.v"] - g0["sdf.layers.lin0.v"]).max() > 0


def _conf(tmp_path, data_dir, scan):
    text = CONF.format(exp_dir=str(tmp_path / "exp"), data_dir=str(data_dir))
    if scan:  # the scan path: chunks of 20 (the report freq) to end_iter 60
        text = text.replace("scan_steps = False", "scan_chunk = 20")
    path = tmp_path / "gt.conf"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("scan", [False, True], ids=["per_step", "scan"])
def test_depth_supervised_training(tmp_path, scan):
    """The JAX package's depth run (tests/test_depth.py) through the port's
    Runner: the maps reach the device, the step's depth weight is set, and
    60 steps train with a finite depth loss that is active and does not
    diverge."""
    from fmov_pose_torch.train.runner import Runner
    _sequence(tmp_path / "SYN")
    runner = Runner(_conf(tmp_path, tmp_path / "SYN", scan), mode="train", case="SYN",
                    has_global_conf=True, device="cpu")
    assert runner.depths_dev is not None and runner.depths_dev.shape == (4, 48, 48)
    assert runner.step_cfg.depth_weight == DEPTH_W
    runner.train()
    assert runner.dispatch == ("scan x20" if scan else "per-step")
    depth = np.asarray(runner.history["depth_loss"])
    assert len(depth) == (3 if scan else 60)
    assert np.all(np.isfinite(depth)) and depth.max() > 0
    n = max(1, len(depth) // 4)  # a chunk mean on the scan path
    assert np.mean(depth[-n:]) < 2.0 * np.mean(depth[:n])


def test_no_depth_dir_is_fine(tmp_path):
    """Depth asked for, no depth/ directory: the loss is off, as in JAX."""
    from fmov_pose_torch.train.runner import Runner
    make_orbit_sequence(str(tmp_path / "SYN2"), n_frames=3, H=32, W=32, span_deg=30,
                        with_matches=False, with_crop=False)
    runner = Runner(_conf(tmp_path, tmp_path / "SYN2", False), mode="train", case="SYN2",
                    has_global_conf=True, device="cpu")
    assert runner.dataset.depths_np is None and runner.depths_dev is None
    assert runner.step_cfg.depth_weight == 0.0
