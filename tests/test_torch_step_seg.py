"""The slice-3 steps: the phase-1 photometric step (segment pose bank,
``maintain_shape`` rays) and the flow step, port against the JAX package,
with the fused flat SDF path (K2/K3) on both sides.

Small sizes: SDF 4x32 with skip 2 and multires 3, color 2x32, 8 rays (+ 8
maintain_shape rays; the flow step 4 + 4 match rays + 8) x 8 samples,
``perturb`` 0, no up-sampler (``n_importance`` 0, as in the phase-1
confs), a 4-frame orbit scene with its exact matches, two segments of two
frames with ``emphasize_rot``.  The same weights and bank (JAX init
converted); the JAX pixel draws are replayed and handed to the port.  The
JAX side runs its flat Pallas kernels in interpret mode (TILE 32), the
port its plain K2/K3 (``use_fused_train``; below the rays and color gates
on both sides, as at the conf's M = 32,768).  One step each, through the
jitted JAX step and the port's step function: the metrics, then the
gradients as Adam keeps them (the first moment is 0.1 x the gated
gradient) for every field leaf and every bank leaf, then the moved
parameters.

Tolerances:
* loss and every metric: rtol 1e-3 (two bf16-operand evaluations differ
  where an f32 sum lands next to a bf16 rounding boundary);
* every gradient leaf, the fields' and the bank's: ``fused_sdf.leaf_rule``
  (relative L2 error < 1%, or absolute < 1e-4 x the global norm);
* the moved parameters within 1e-3 x lr + 1e-6 where the gradient is
  above 1e-4 x the global norm (the first Adam step moves each by about
  lr x sign(g); below that floor the sign of a noise gradient may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_tpu.poses import picture_pose as jpp
from fmov_pose_tpu.render import neus as jneus
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_tpu.train import step as jstep
from fmov_pose_torch import convert
from fmov_pose_torch.data import scene as tscene
from fmov_pose_torch.ops import fused_sdf
from fmov_pose_torch.poses import picture_pose as tpp
from fmov_pose_torch.render import neus as tneus
from fmov_pose_torch.train import optim as toptim
from fmov_pose_torch.train import step as tstep
from tests.test_torch_step_fast import _count_calls

SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
       "multires": 3, "bias": 0.5, "scale": 1.0, "geometric_init": True,
       "weight_norm": True, "use_fused": True, "use_fused_train": True}
COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2,
         "squeeze_out": True}
NERF = {"D": 2, "d_in": 4, "d_in_view": 3, "W": 32, "multires": 2,
        "multires_view": 2, "output_ch": 4, "skips": (4,), "use_viewdirs": True}
RENDER = {"n_samples": 8, "n_importance": 0, "n_outside": 0,
          "up_sample_steps": 1, "perturb": 0.0}
B, H, W, N_IMG, INTERVAL = 8, 24, 32, 4, 2
LR = 5e-4
SEG_LR = np.asarray([1e-3, 2e-3], np.float32)
STEP_KW = dict(batch_size=B, H=H, W=W, pose_mode="seg", n_segments=2,
               segment_img_num=INTERVAL, igr_weight=0.1, mask_weight=0.1,
               flow_weight=0.1, unit_sphere_weight=0.01,
               mask_guided_sampling=True, mask_guided_patch_size=3,
               maintain_shape=True)


@pytest.fixture
def jax_interpret(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_sdf as jfs
    monkeypatch.setattr(jfs, "TILE", 32)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def world():
    sc = tscene.make_orbit_scene(n_frames=N_IMG, H=H, W=W, span_deg=40.0,
                                 noise_deg=3.0, seed=1)
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    params = {"sdf": jn.init_sdf(k1, SDF), "color": jn.init_color(k2, COLOR),
              "nerf": jn.init_nerf(k3, NERF),
              "variance": jn.init_variance({"init_val": 0.3})}
    cfg = jpp.PoseCfg(emphasize_rot=True)
    bank = jpp.init_seg_bank(5, cfg, N_IMG, INTERVAL, sc.max_mask_pose)
    bank = jpp.seg_initialize(bank, cfg, INTERVAL, 1)
    return sc, params, bank


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _replay_pixels(key, bbox, img_id, mask_guided):
    """The pixel ids of the JAX ``gen_random_rays(key, ...)``
    (rays.py:85-98)."""
    k_guide, k_x, k_y = jax.random.split(key, 3)
    use_bbox = (jax.random.uniform(k_guide) < 0.7) & (mask_guided > 0)
    y0, y1, x0, x1 = jnp.asarray(bbox)[img_id]
    p = STEP_KW["mask_guided_patch_size"]
    y_lo = jnp.where(use_bbox, jnp.maximum(y0 - p, 0), 0)
    y_hi = jnp.where(use_bbox, jnp.minimum(y1 + p, H), H)
    x_lo = jnp.where(use_bbox, jnp.maximum(x0 - p, 0), 0)
    x_hi = jnp.where(use_bbox, jnp.minimum(x1 + p, W), W)
    px = jax.random.randint(k_x, (B,), x_lo, x_hi)
    py = jax.random.randint(k_y, (B,), y_lo, y_hi)
    return torch.tensor(np.array(px)).long(), torch.tensor(np.array(py)).long()


def _settled_steps(name, old, new_t, new_j, grad, gnorm):
    step_t, step_j = new_t - old, new_j - old
    settled = np.abs(grad) > 1e-4 * gnorm
    np.testing.assert_allclose(step_t[settled], step_j[settled], rtol=0,
                               atol=1e-3 * LR + 1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["photo", "flow"])
def test_seg_step_matches_jax(world, jax_interpret, kind, monkeypatch):
    sc, params_j, bank_j = world
    images = np.round(sc.images_np * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    masks = np.round(sc.masks_np[..., 0] * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    intr_inv = sc.intrinsics_all_inv.astype(np.float32)
    pose_cfg_j, pose_cfg_t = jpp.PoseCfg(emphasize_rot=True), tpp.PoseCfg(emphasize_rot=True)
    jcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": jneus.make_render_cfg(RENDER)}
    tcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": tneus.make_render_cfg(RENDER)}
    cfg_j = jstep.make_step_config(jcfg, pose_cfg=pose_cfg_j, **STEP_KW)
    cfg_t = tstep.make_step_config(tcfg, pose_cfg=pose_cfg_t, **STEP_KW)
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
    np.testing.assert_array_equal(packed, jstep.pack_scalars_np(
        LR, 1.0, 1.0, 1.0, 1.0, 1.0, img_id, add_img_id, img_id_corr,
        np.ones(2), np.ones(2), SEG_LR))

    _, sub = jax.random.split(key)
    if kind == "photo":
        step_j = jstep.make_photo_step(cfg_j, *bufs_j)
        new_j, mj = jax.jit(lambda s, p: step_j(s, p))(state_j, packed)
        k1, k2, _ = jax.random.split(sub, 3)
        pixels = _replay_pixels(k1, sc.mask_bboxes, img_id, 1.0)
    else:
        step_j = jstep.make_flow_step(cfg_j, *bufs_j)
        new_j, mj = jax.jit(lambda s, p, x: step_j(s, p, x))(state_j, packed,
                                                              pixels_pair)
        k2, _ = jax.random.split(sub)
    add_pixels = _replay_pixels(k2, sc.mask_bboxes, add_img_id, 1.0)

    tree_t = convert.to_torch(_np(params_j))
    layout = convert.ParamLayout(tree_t)
    flat = layout.ravel(tree_t).requires_grad_(True)
    bank_t = convert.seg_bank_to_torch(_np(bank_j))
    bank_layout = convert.ParamLayout(bank_t["train"])
    bank_flat = bank_layout.ravel(bank_t["train"]).requires_grad_(True)
    state_t = tstep.TrainState(
        flat=flat, layout=layout, opt=toptim.adam_init(flat.detach()),
        pose_static={}, generator=torch.Generator().manual_seed(0),
        bank_flat=bank_flat, bank_layout=bank_layout, bank_static=bank_t["static"],
        pose_opt=toptim.seg_adam_init(bank_flat.detach(), bank_layout.shapes, 2))
    scalars, i0, i1, i2 = tstep.unpack_scalars_np(packed, 2)
    assert (i0, i1, i2) == (img_id, add_img_id, img_id_corr)
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
    assert state_t.iter_step == 1 and state_t.opt.step == 1
    assert state_t.pose_opt.step.tolist() == np.asarray(new_j.pose_opt.step).tolist()

    # gradients as the first moments keep them, fields and bank together
    _, unravel = ravel_pytree(params_j)
    _, unravel_b = ravel_pytree(bank_j["train"])
    ref = {f"f.{n}": torch.tensor(np.asarray(v)) / 0.1 for n, v in
           convert.flatten(_np(unravel(new_j.opt.mu)))}
    ref.update({f"b.{n}": torch.tensor(np.asarray(v)) / 0.1 for n, v in
                convert.flatten(_np(unravel_b(new_j.pose_opt.mu)))})
    got = {f"f.{n}": t / 0.1 for n, t in convert.flatten(layout.views(state_t.opt.mu))}
    got.update({f"b.{n}": t / 0.1 for n, t in
                convert.flatten(bank_layout.views(state_t.pose_opt.mu))})
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res
    assert float(ref["b.lin1.w"].abs().max()) > 0          # the bank is trained
    assert float(ref["b.lin3_trans.w"].abs().max()) == 0   # emphasize_rot gate

    new_pj = dict(convert.flatten(_np(new_j.params)))
    old_pj = dict(convert.flatten(_np(params_j)))
    for n, t in convert.flatten(state_t.params):
        _settled_steps(n, old_pj[n], t.detach().numpy(), new_pj[n],
                       ref[f"f.{n}"].numpy(), res["gnorm"])
    new_bj = dict(convert.flatten(_np(new_j.pose_bank["train"])))
    old_bj = dict(convert.flatten(_np(bank_j["train"])))
    for n, t in convert.flatten(state_t.pose_bank["train"]):
        _settled_steps(n, old_bj[n], t.detach().numpy(), new_bj[n],
                       ref[f"b.{n}"].numpy(), res["gnorm"])


def test_pinned_row_and_host_scalars():
    """The packed row's host fields are host floats and ints; the segment
    vectors reach the device as one float32 row (the CPU here)."""
    packed = tstep.pack_scalars_np(1e-3, 0.5, 0.0, 1.0, 1.0, 0.0, 3, 1, 2,
                                   [1, 0], [0, 1], [0.1, 0.2])
    scalars, img_id, add_img_id, img_id_corr = tstep.unpack_scalars_np(packed, 2)
    assert (img_id, add_img_id, img_id_corr) == (3, 1, 2)
    assert isinstance(scalars.lr, float) and scalars.main_update == 0.0
    cfg = tstep.StepConfig(batch_size=1, H=1, W=1, pose_mode="seg", n_segments=2)
    row = tstep._seg_row(cfg, scalars, torch.device("cpu"))
    assert row.dtype == torch.float32 and row.shape == (3, 2)
    np.testing.assert_allclose(row.numpy(), [[1, 0], [0, 1], [0.1, 0.2]])
    assert tstep._seg_row(tstep.StepConfig(batch_size=1, H=1, W=1, pose_mode="gf"),
                          scalars, torch.device("cpu")) is None
    K = tstep.intr_inv_all_K(torch.linalg.inv(torch.diag(torch.tensor(
        [100.0, 90.0, 1.0, 1.0])))[None], 0)
    np.testing.assert_allclose(K.numpy(), np.diag([100.0, 90.0, 1.0]), rtol=1e-6)
