"""The slice-2 step: the phase-2 photometric step of
``confs/ho3d_global_womask_tpu_fast.conf`` (the fused training kernels K4/K5
and K8/K9, and the occupancy grid), port against the JAX package.

Small sizes: SDF 4x32 with skip 2 and multires 3, color 2x32, 8 rays x
(8 + 8) samples, a 16^3 grid, ``perturb`` 0, gf pose mode, the same weights
(JAX init converted) and the same [B, 10] ray batch.  The rays and color
gates are patched to 0 on both sides so that both take the fused path: the
JAX side runs its Pallas rays kernels in interpret mode (TILE 32, bf16
products as they are), the port its plain K4/K5 and K8/K9 (on the CPU a
wrapper takes its kernel's plain version).  The grid is refreshed from the
initial SDF on each side (``update_occ_grid``) and must agree exactly.

Tolerances:
* loss and every metric: rtol 1e-3 (two bf16-operand evaluations differ
  where an f32 sum lands next to a bf16 rounding boundary; see
  test_torch_fused_rays.py);
* every gradient leaf: ``fused_sdf.leaf_rule`` (relative L2 error < 1%, or
  absolute error < 1e-4 x the global gradient norm);
* one Adam step from those gradients: the moved parameters within
  1e-3 x lr + 1e-6 (the first step moves each by about lr x sign(g)), where
  |g| is above 1e-4 x the global norm (below it, the sign of a gradient that
  is noise may differ).

The flat case (``test_fused_train_below_the_rays_gate_raises``) keeps the
rays gate and patches only the color gate to 0: both sides take the flat
K2/K3 for the SDF and the per-sample K6/K7 for the color, held to the same
tolerances.  ``fast_step_both`` and ``check_step_against_jax`` serve
``tests/test_torch_background.py`` too.

The Runner case trains a tiny fast conf on the CPU with the grid refreshed
every 10 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_tpu.poses import picture_pose as jpp
from fmov_pose_tpu.render import neus as jneus
from fmov_pose_tpu.render import occupancy as jocc
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_tpu.train import step as jstep
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_color, fused_sdf
from fmov_pose_torch.render import neus as tneus
from fmov_pose_torch.render import occupancy as tocc
from fmov_pose_torch.train import optim as toptim
from fmov_pose_torch.train import step as tstep
from tests.test_torch_runner import CONF, _write_sequence
from tests.test_torch_step import _ray_batch, world  # noqa: F401 (fixture)

SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
       "multires": 3, "bias": 0.5, "scale": 1.0, "geometric_init": True,
       "weight_norm": True, "use_fused": True, "use_fused_train": True}
COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2,
         "squeeze_out": True}
NERF = {"D": 2, "d_in": 4, "d_in_view": 3, "W": 32, "multires": 2,
        "multires_view": 2, "output_ch": 4, "skips": (4,), "use_viewdirs": True}
RENDER = {"n_samples": 8, "n_importance": 8, "n_outside": 0,
          "up_sample_steps": 4, "perturb": 0.0}
B, H, W, RES = 8, 24, 32, 16
LR = 5e-4
STEP_KW = dict(batch_size=B, H=H, W=W, pose_mode="gf", igr_weight=0.1,
               mask_weight=0.1, unit_sphere_weight=0.01,
               mask_guided_sampling=True, mask_guided_patch_size=3,
               occupancy_sampling=True)


@pytest.fixture
def gates(monkeypatch):
    """The rays and color gates at 0 on both sides; the JAX kernels in
    interpret mode with 32-sample tiles."""
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_color as jfc
    from fmov_pose_tpu.ops import fused_sdf as jfs
    for mod, names in ((jfs, ("MIN_SAMPLES_RAYS",)), (jfc, ("MIN_SAMPLES",))):
        monkeypatch.setattr(mod, "TILE", 32)
        for n in names:
            monkeypatch.setattr(mod, n, 0)
    monkeypatch.setattr(fused_sdf, "MIN_SAMPLES_RAYS", 0)
    monkeypatch.setattr(fused_color, "MIN_SAMPLES", 0)
    yield
    jax.clear_caches()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _count_calls(monkeypatch, mod, name):
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def fast_step_both(world, monkeypatch, render=RENDER, counted=()):
    """The fast step on both sides from the same JAX-initialised weights,
    grid (refreshed from the initial SDF on each side, which must agree
    exactly) and ray batch.  ``counted``: (module, name) pairs whose calls
    are counted while the step and its gradient run.  Returns (JAX loss,
    metrics and gradient tree, JAX params after one Adam step, port
    metrics, the port's (name, leaf) items and gradients, the counts)."""
    sc, _, static_j = world
    k1, k2, k3 = jax.random.split(jax.random.key(1), 3)
    params_j = {"sdf": jn.init_sdf(k1, SDF), "color": jn.init_color(k2, COLOR),
                "nerf": jn.init_nerf(k3, NERF),
                "variance": jn.init_variance({"init_val": 0.3}),
                "pose": jpp.init_gf(5, jpp.PoseCfg(), sc.crop_poses)["train"]}
    grid_pts = tocc.make_grid_points(RES)
    occ_j = jocc.update_occ_grid(
        jn.sdf_only(params_j["sdf"], SDF, jnp.asarray(grid_pts)), RES)
    static_j = dict(static_j, occ_grid=occ_j)
    jcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": jneus.make_render_cfg(render)}
    tcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": tneus.make_render_cfg(render)}
    data = _ray_batch(sc, np.random.default_rng(3))[:B]
    cfg_j = jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1, **STEP_KW)
    cfg_t = tstep.make_step_config(tcfg, **STEP_KW)
    sc_j = jstep.StepScalars(
        lr=jnp.float32(LR), cos_anneal=jnp.float32(0.7), main_update=1.0,
        pose_update=1.0, mask_guided=1.0, seg_touch=jnp.ones(1),
        seg_freeze=jnp.ones(1), seg_lr=jnp.ones(1), trans_head_on=1.0)
    counts = {name: _count_calls(monkeypatch, mod, name) for mod, name in counted}

    def loss_j(p):
        return jstep._render_and_losses(cfg_j, jax.random.key(9), p, {},
                                        static_j, jnp.asarray(data), sc_j)

    (_, mj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_j)
    new_j, _ = joptim.adam_update(gj, joptim.adam_init(params_j), params_j, LR)

    tree_t = convert.to_torch(_np_tree(params_j))
    items = convert.flatten(tree_t)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    params_t = convert.unflatten(zip([n for n, _ in items], leaves))
    with torch.no_grad():
        sdf_t = tn.sdf_only(params_t["sdf"], SDF, torch.from_numpy(grid_pts))
    static_t = convert.to_torch(_np_tree(static_j))
    static_t["occ_grid"] = tocc.update_occ_grid(sdf_t, RES)
    np.testing.assert_array_equal(static_t["occ_grid"].numpy(), np.asarray(occ_j))
    assert 0 < float(static_t["occ_grid"].mean()) < 1

    launches = _launches()
    lt, mt = tstep._render_and_losses(cfg_t, None, params_t, static_t,
                                      torch.from_numpy(data), tstep.StepScalars(
                                          lr=LR, cos_anneal=0.7))
    grads = torch.autograd.grad(lt, leaves, allow_unused=True)
    # the CPU takes the plain versions: no kernel launches
    assert _launches() == launches
    return mj, gj, new_j, mt, items, grads, {k: len(v) for k, v in counts.items()}


def _launches():
    return (fused_sdf.LAUNCHES, fused_sdf.LAUNCHES_K2, fused_sdf.LAUNCHES_K3,
            fused_sdf.LAUNCHES_K4, fused_sdf.LAUNCHES_K5, fused_color.LAUNCHES_K6,
            fused_color.LAUNCHES_K7, fused_color.LAUNCHES_K8, fused_color.LAUNCHES_K9)


def check_step_against_jax(mj, gj, new_j, mt, items, grads, nonzero=()):
    """The metrics by rtol 1e-3, every gradient leaf by the leaf rule (the
    leaves ``nonzero`` must have a gradient), and one Adam step from the
    port's gradients against JAX's step."""
    for k, v in mj.items():
        np.testing.assert_allclose(float(mt[k].detach()), float(v), rtol=1e-3,
                                   atol=1e-7, err_msg=k)

    ref = {n: torch.from_numpy(np.array(v)) for n, v in convert.flatten(_np_tree(gj))}
    got = {n: torch.zeros_like(l) if g is None else g
           for (n, l), g in zip(items, grads)}
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res
    for n in ("sdf.layers.lin0.v", "color.layers.lin0.v") + tuple(nonzero):
        assert float(ref[n].abs().max()) > 0, n

    # one Adam step from the port's gradients, as the port's step takes it
    tree_t = convert.unflatten(items)
    layout = convert.ParamLayout(tree_t)
    flat = layout.ravel(tree_t)
    toptim.adam_update_flat_(layout.ravel(got), toptim.adam_init(flat), flat, LR)
    new_t = dict(convert.flatten(layout.views(flat)))
    new_jd = dict(convert.flatten(_np_tree(new_j)))
    for n, old in items:
        step_t = (new_t[n] - old).numpy()
        step_j = new_jd[n] - old.numpy()
        settled = ref[n].abs().numpy() > 1e-4 * res["gnorm"]
        np.testing.assert_allclose(step_t[settled], step_j[settled], rtol=0,
                                   atol=1e-3 * LR + 1e-6, err_msg=n)
        assert np.abs(step_t).max() <= LR * 1.001


def test_fast_step_matches_jax(world, gates, monkeypatch):  # noqa: F811
    mj, gj, new_j, mt, items, grads, calls = fast_step_both(
        world, monkeypatch, counted=((fused_sdf, "sdf_apply_grad_fused_rays"),
                                     (fused_color, "color_fused_ray")))
    assert calls == {"sdf_apply_grad_fused_rays": 1, "color_fused_ray": 1}  # fused
    check_step_against_jax(mj, gj, new_j, mt, items, grads)


FAST = """
    use_fused_train_kernels = True
    occupancy_sampling = True
    occ_grid_res = 16
    occ_update_freq = 10
"""


def test_runner_trains_fast_conf_on_cpu(tmp_path, monkeypatch):
    """A tiny fast conf through the Runner on the CPU: the plain K4/K5 and
    K8/K9 (the gates patched to 0), the grid all ones until the first
    refresh and refreshed after steps 10 and 20."""
    from fmov_pose_torch.train.runner import Runner
    monkeypatch.setattr(fused_sdf, "MIN_SAMPLES_RAYS", 0)
    monkeypatch.setattr(fused_color, "MIN_SAMPLES", 0)
    data_dir, _ = _write_sequence(tmp_path, 3, 32, 40, seed=2)
    conf = tmp_path / "tiny_fast.conf"
    conf.write_text(CONF.format(exp_dir=tmp_path / "exp", data_dir=data_dir)
                    .replace("end_iter = 40", "end_iter = 20")
                    .replace("batch_size = 256", "batch_size = 64")
                    .replace("learning_rate = 2e-3", "learning_rate = 2e-3" + FAST))
    runner = Runner(str(conf), device="cpu")
    assert runner.model_cfg["sdf"]["use_fused_train"] and runner.occupancy_sampling
    assert (runner.occ_grid_res, runner.occ_update_freq) == (16, 10)
    assert bool((runner.state.pose_static["occ_grid"] == 1).all())
    calls = (_count_calls(monkeypatch, fused_sdf, "sdf_apply_grad_fused_rays"),
             _count_calls(monkeypatch, fused_color, "color_fused_ray"))
    runner.train()
    assert runner.iter_step == 20 and runner.occ_refreshes == 2
    assert [len(c) for c in calls] == [20, 20]  # every step took the fused path
    grid = runner.state.pose_static["occ_grid"]
    assert grid.shape == (16, 16, 16) and 0 < float(grid.mean()) < 1
    loss = np.asarray(runner.history["loss"])
    assert loss.shape == (20,) and np.all(np.isfinite(loss))


def test_fused_train_below_the_rays_gate_raises(world, monkeypatch):  # noqa: F811
    """Below the rays gate with the color gate met: the flat K2/K3 path
    for the SDF and the per-sample K6/K7 for the color, on both sides (the
    JAX kernels in interpret mode, the port's plain versions).  This route
    raised before the port had K6/K7; now the loss, every gradient leaf
    and one Adam step match JAX's."""
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_color as jfc
    from fmov_pose_tpu.ops import fused_sdf as jfs
    for mod in (jfs, jfc):
        monkeypatch.setattr(mod, "TILE", 32)
    monkeypatch.setattr(jfc, "MIN_SAMPLES", 0)
    monkeypatch.setattr(fused_color, "MIN_SAMPLES", 0)
    cfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
           "renderer": tneus.make_render_cfg(RENDER)}
    M = B * (RENDER["n_samples"] + RENDER["n_importance"])
    assert M < fused_sdf.MIN_SAMPLES_RAYS == jfs.MIN_SAMPLES_RAYS
    assert tneus._fused_train_paths(cfg, 16, M) == ("flat", "sample")
    mj, gj, new_j, mt, items, grads, calls = fast_step_both(
        world, monkeypatch, counted=(
            (jfs, "_sdf_forward_grad_impl"), (jfc, "_color_fwd_impl"),
            (jfc, "_color_bwd_impl"), (jfs, "_sdf_fwd_grad_rays_impl"),
            (jfc, "_ray_fwd_impl"), (fused_sdf, "sdf_apply_grad_fused"),
            (fused_color, "color_fwd"), (fused_color, "color_bwd"),
            (fused_color, "color_fused_ray")))
    jax.clear_caches()
    # JAX: K2 and K6/K7, no rays kernel; the port: the same entries
    assert calls["_sdf_forward_grad_impl"] >= 1 and calls["_color_fwd_impl"] >= 1
    assert calls["_color_bwd_impl"] >= 1
    assert calls["_sdf_fwd_grad_rays_impl"] == calls["_ray_fwd_impl"] == 0
    assert (calls["sdf_apply_grad_fused"], calls["color_fwd"], calls["color_bwd"],
            calls["color_fused_ray"]) == (1, 1, 1, 0)
    check_step_against_jax(mj, gj, new_j, mt, items, grads)
