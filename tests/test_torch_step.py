"""The slice: one photometric training step, port against the JAX package.

Small sizes (32 rays x (16 + 16) samples with 4 up-sampling steps, SDF
4x32, color 2x32), gf pose mode, ``perturb`` 0, the same weights (JAX init
converted), the same ray batch (``_render_and_losses`` takes ``data``) or
the same pixel ids (``run_one``: the JAX pixel draw is replayed and handed
to the port).  Parametrised over ``use_fused``: with it on, the JAX side
runs the Pallas K1 in interpret mode for the up-sampler and the port runs
its plain K1.  The ``use_fused-cuda`` cases (marked ``cuda``, skipped
without a GPU) run the port on the card with the CUDA K1 and hold it
against the same JAX computation on the CPU.

Tolerances:
* loss and every metric: rtol 1e-4; with use_fused, 1e-3, because K1's
  bf16 operands place the up-sampled z values where the two sides' bf16
  roundings may differ (see test_torch_fused_sdf.py), and the fine pass
  then evaluates the f32 network at slightly different depths.
* every gradient leaf (the ROADMAP rule): relative error < 1%, or
  absolute error < 1e-4 x the global gradient norm.
* after one Adam step: the moments by the gradient rule; the parameters
  within 1e-3 x lr (the first Adam step moves each parameter by about
  lr x sign(g)), except where |g| is below the rule's absolute floor,
  where the sign of a gradient that is noise may differ.
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
from fmov_pose_torch.data import rays as trays
from fmov_pose_torch.data import scene as tscene
from fmov_pose_torch.ops import fused_sdf
from fmov_pose_torch.render import neus as tneus
from fmov_pose_torch.train import optim as toptim
from fmov_pose_torch.train import step as tstep

SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
       "multires": 4, "bias": 0.5, "scale": 1.0, "geometric_init": True,
       "weight_norm": True}
COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2,
         "squeeze_out": True}
NERF = {"D": 2, "d_in": 4, "d_in_view": 3, "W": 32, "multires": 2,
        "multires_view": 2, "output_ch": 4, "skips": (4,), "use_viewdirs": True}
RENDER = {"n_samples": 16, "n_importance": 16, "n_outside": 0,
          "up_sample_steps": 4, "perturb": 0.0}
B, H, W, N_IMG = 32, 24, 32, 3
LR = 5e-4
STEP_KW = dict(batch_size=B, H=H, W=W, pose_mode="gf", igr_weight=0.1,
               mask_weight=0.1, unit_sphere_weight=0.01,
               mask_guided_sampling=True, mask_guided_patch_size=3)


def _model_cfgs(use_fused):
    jcfg = {"sdf": dict(SDF, use_fused=use_fused), "color": dict(COLOR),
            "nerf": dict(NERF), "renderer": jneus.make_render_cfg(RENDER)}
    tcfg = {"sdf": dict(SDF, use_fused=use_fused), "color": dict(COLOR),
            "nerf": dict(NERF), "renderer": tneus.make_render_cfg(RENDER)}
    return jcfg, tcfg


@pytest.fixture(scope="module")
def world():
    """A small orbit scene and the JAX-initialised parameters."""
    sc = tscene.make_orbit_scene(n_frames=N_IMG, H=H, W=W, span_deg=40.0,
                                 noise_deg=3.0, seed=1)
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    params = {"sdf": jn.init_sdf(k1, SDF), "color": jn.init_color(k2, COLOR),
              "nerf": jn.init_nerf(k3, NERF),
              "variance": jn.init_variance({"init_val": 0.3})}
    gf = jpp.init_gf(5, jpp.PoseCfg(), sc.crop_poses)
    params["pose"] = gf["train"]
    return sc, params, gf["static"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_scalars(mj, mt, rtol):
    for k, v in mj.items():
        np.testing.assert_allclose(float(mt[k].detach()), float(v), rtol=rtol, atol=1e-7,
                                   err_msg=k)


def _check_grads(gj_tree, gt_items):
    """ROADMAP rule per leaf: rel err < 1% or abs err < 1e-4 x global norm."""
    ref = dict(convert.flatten(_np_tree(gj_tree)))
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref.values()))
    assert gnorm > 0
    for name, g in gt_items:
        r = ref[name]
        err = np.abs(g.astype(np.float64) - r).max()
        rel = err / max(np.abs(r).max(), 1e-30)
        assert rel < 1e-2 or err < 1e-4 * gnorm, (name, rel, err, gnorm)
    return ref, gnorm


def _ray_batch(sc, rng):
    """[B, 10] rays of frame 0 through random pixels, with their colors."""
    px = torch.from_numpy(rng.integers(0, W, B))
    py = torch.from_numpy(rng.integers(0, H, B))
    return trays.gen_random_rays(
        None, torch.from_numpy(sc.images_np), torch.from_numpy(sc.masks_np[..., 0]),
        torch.from_numpy(sc.intrinsics_all_inv.astype(np.float32)),
        torch.from_numpy(sc.pose_all[0][:3]), 0, B, None, 0, False, H, W,
        pixels=(px, py)).numpy()


CASES = [pytest.param(("cpu", False), id="plain"),
         pytest.param(("cpu", True), id="use_fused"),
         pytest.param(("cuda", True), id="use_fused-cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def case(monkeypatch, request):
    """(port device, use_fused).  On the card the port runs the CUDA K1
    (TF32 off), held against the JAX package on the CPU."""
    device, use_fused = request.param
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    if use_fused:
        jax.clear_caches()
        monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    yield torch.device(device), use_fused
    if use_fused:
        jax.clear_caches()


def _cpu(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("case", CASES, indirect=True)
def test_render_and_losses(world, case):
    dev, use_fused = case
    sc, params_j, static_j = world
    jcfg, tcfg = _model_cfgs(use_fused)
    data = _ray_batch(sc, np.random.default_rng(3))
    cfg_j = jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1,
                                   **STEP_KW)
    cfg_t = tstep.make_step_config(tcfg, **STEP_KW)
    sc_j = jstep.StepScalars(
        lr=jnp.float32(LR), cos_anneal=jnp.float32(0.7), main_update=1.0,
        pose_update=1.0, mask_guided=1.0, seg_touch=jnp.ones(1),
        seg_freeze=jnp.ones(1), seg_lr=jnp.ones(1), trans_head_on=1.0)
    sc_t = tstep.StepScalars(lr=LR, cos_anneal=0.7)

    def loss_j(p):
        return jstep._render_and_losses(cfg_j, jax.random.key(9), p, {},
                                        static_j, jnp.asarray(data), sc_j)

    (lj, mj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_j)

    items = convert.flatten(convert.to_torch(_np_tree(params_j), dev))
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    params_t = convert.unflatten(zip([n for n, _ in items], leaves))
    static_t = convert.to_torch(_np_tree(static_j), dev)
    lt, mt = tstep._render_and_losses(cfg_t, None, params_t, static_t,
                                      torch.from_numpy(data).to(dev), sc_t)
    grads = torch.autograd.grad(lt, leaves, allow_unused=True)
    rtol = 1e-3 if use_fused else 1e-4
    _check_scalars(mj, mt, rtol)
    _check_grads(gj, [(n, _cpu(torch.zeros_like(l) if g is None else g))
                      for (n, l), g in zip(items, grads)])


@pytest.mark.parametrize("case", CASES[1:], indirect=True)
def test_render_packs_k1_once(world, case, monkeypatch):
    """One ``render`` with use_fused materialises the SDF's weights and
    builds K1's pack once for its four SDF queries (the coarse samples and
    three up-sampling steps), and places the samples as the JAX render
    does: the points at the rendered z-values and the depth, within K1's
    bf16 placement (rtol 1e-3, as the losses above, and atol 1e-4 of the
    unit sphere's coordinates; 1.6e-4 at most, rel 5.8e-4, on the CPU)."""
    from fmov_pose_torch.ops import packing
    dev, _ = case
    sc, params_j, _ = world
    jcfg, tcfg = _model_cfgs(True)
    data = _ray_batch(sc, np.random.default_rng(3))
    calls = {"materialize": 0, "pack_train": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(fused_sdf, "materialize",
                        counted("materialize", fused_sdf.materialize))
    monkeypatch.setattr(packing, "pack_train", counted("pack_train", packing.pack_train))
    rays_o, rays_d = torch.from_numpy(data[:, :3]), torch.from_numpy(data[:, 3:6])
    near, far = trays.near_far_from_sphere(rays_o, rays_d)
    out_j = jneus.render(jax.random.key(9), params_j, jcfg, *(
        jnp.asarray(t.numpy()) for t in (rays_o, rays_d, near, far)))
    launches = fused_sdf.LAUNCHES
    with torch.no_grad():
        out_t = tneus.render(None, convert.to_torch(_np_tree(params_j), dev), tcfg,
                             *(t.to(dev) for t in (rays_o, rays_d, near, far)))
    assert calls == {"materialize": 1, "pack_train": 1 if dev.type == "cuda" else 0}
    assert fused_sdf.LAUNCHES - launches == (4 if dev.type == "cuda" else 0)
    for key in ("pts", "depth_fine"):
        np.testing.assert_allclose(_cpu(out_t[key]), np.asarray(out_j[key]),
                                   rtol=1e-3, atol=1e-4, err_msg=key)


def _jax_pixels(key, bbox, img_id):
    """Replay the pixel draw of the JAX run_one (step.py:445 then :416-422
    then rays.py:85-98)."""
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


@pytest.mark.parametrize("case", CASES, indirect=True)
def test_photo_step_run_one(world, case):
    """make_photo_step's run_one: rays from the gf pose of frame 1 (so
    the pose net gets gradients), loss, gradients, one Adam step."""
    dev, use_fused = case
    sc, params_j, static_j = world
    jcfg, tcfg = _model_cfgs(use_fused)
    img_id = 1
    images_u8 = np.round(sc.images_np * 256.0).astype(np.uint8)
    masks_u8 = np.round(sc.masks_np[..., 0] * 256.0).astype(np.uint8)
    images = images_u8.astype(np.float32) / 256.0
    masks = masks_u8.astype(np.float32) / 256.0
    intr_inv = sc.intrinsics_all_inv.astype(np.float32)

    cfg_j = jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1,
                                   **STEP_KW)
    step_j = jstep.make_photo_step(
        cfg_j, jnp.asarray(images.transpose(3, 0, 1, 2)), jnp.asarray(masks),
        jnp.asarray(intr_inv), jnp.asarray(sc.mask_bboxes))
    key = jax.random.key(11)
    state_j = jstep.TrainState(
        params=params_j, opt=joptim.adam_init(params_j), pose_bank={},
        pose_opt=(), pose_static=static_j, key=key,
        iter_step=jnp.zeros((), jnp.int32))
    packed = jstep.pack_scalars_np(LR, 1.0, 1.0, 1.0, 1.0, 1.0, img_id, 0, 0,
                                   np.ones(1), np.ones(1), np.ones(1))
    new_j, mj = jax.jit(lambda s, p: step_j(s, p))(state_j, packed)

    cfg_t = tstep.make_step_config(tcfg, **STEP_KW)
    step_t = tstep.make_photo_step(
        cfg_t, *(torch.from_numpy(a).to(dev) for a in
                 (images, masks, intr_inv, sc.mask_bboxes)))
    tree_t = convert.to_torch(_np_tree(params_j))
    layout = convert.ParamLayout(tree_t)
    flat = layout.ravel(tree_t, dev).requires_grad_(True)
    state_t = tstep.TrainState(
        flat=flat, layout=layout, opt=toptim.adam_init(flat.detach()),
        pose_static=convert.to_torch(_np_tree(static_j), dev),
        generator=torch.Generator(device=dev).manual_seed(0))
    old = {n: np.array(v) for n, v in convert.flatten(_np_tree(params_j))}
    px, py = _jax_pixels(key, sc.mask_bboxes, img_id)
    launches = fused_sdf.LAUNCHES
    state_t, mt = step_t(state_t, tstep.StepScalars(lr=LR, cos_anneal=1.0),
                                 img_id, pixels=(px.to(dev), py.to(dev)))
    # K1 launches only on the card: once for the coarse samples, then
    # once per up-sampling step but the last
    assert fused_sdf.LAUNCHES - launches == (4 if dev.type == "cuda" else 0)

    _check_scalars(mj, mt, 1e-3 if use_fused else 1e-4)
    assert state_t.iter_step == 1 and state_t.opt.step == 1

    # Adam's first moment is 0.1 x the gated gradient: the gradient rule
    _, unravel = ravel_pytree(params_j)
    grads_j = jax.tree_util.tree_map(lambda m: m / 0.1, unravel(new_j.opt.mu))
    mu_t = layout.views(state_t.opt.mu / 0.1)
    ref, gnorm = _check_grads(
        grads_j, [(n, _cpu(t)) for n, t in convert.flatten(mu_t)])
    assert np.abs(ref["pose.lin1.w"]).max() > 0  # the pose net is trained
    nu_j = dict(convert.flatten(_np_tree(unravel(new_j.opt.nu))))
    for n, t in convert.flatten(layout.views(state_t.opt.nu)):
        np.testing.assert_allclose(_cpu(t), nu_j[n], rtol=2e-2,
                                   atol=1e-3 * (1e-4 * gnorm) ** 2, err_msg=n)

    new_params_j = dict(convert.flatten(_np_tree(new_j.params)))
    for n, t in convert.flatten(state_t.params):
        step_t_ = _cpu(t) - old[n]
        step_j_ = new_params_j[n] - old[n]
        settled = np.abs(ref[n]) > 1e-4 * gnorm
        np.testing.assert_allclose(step_t_[settled], step_j_[settled], rtol=0,
                                   atol=1e-3 * LR + 1e-6, err_msg=n)
        assert np.abs(step_t_).max() <= LR * 1.001
