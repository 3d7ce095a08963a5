"""The NeRF++ background (``n_outside > 0``): ``render_core_outside``, the
outside z-values and the mixing in ``render_core``
(``fmov_pose_torch/render/neus.py``), port against the JAX package.

* The background network at the full width of the confs (D 8, W 256, PE 10
  on the 4-d NeRF++ point, PE 4 on the view), forward and gradients.
* The f32 render: 32 rays x (16 + 16 + 8) samples, the SDF-guided
  up-sampler, ``perturb`` 0, the same weights (JAX init converted) and
  rays: ``color_fine``, ``depth_fine``, ``weights`` [B, 40], ``weight_sum``,
  ``s_val`` and ``gradient_error``, and the gradients of every leaf
  (``nerf.*`` included) of a loss over them.
* The fast step with the background (``fast_step_both`` of
  test_torch_step_fast.py with ``n_outside`` 8, the rays and color gates
  at 0 on both sides): JAX takes its rays SDF kernels and the per-sample
  K6/K7 in interpret mode (the background blocks the ray-composited K8),
  the port its plain K4/K5 and K6/K7; the calls are counted on both sides.
* The routes of ``_fused_train_paths``, a tiny fast conf with
  ``n_outside = 8`` through the Runner on the CPU, and the perturbed
  outside z-values against the JAX formula on the same draws.

Tolerances: f32 outputs rtol 1e-4 with an atol of 1e-5 x the largest
magnitude of the compared array (both sides run the same f32 arithmetic in
other orders); gradients by ``fused_sdf.leaf_rule`` (relative L2 error < 1%
per leaf, or < 1e-4 of the global norm); the fast step as in
test_torch_step_fast.py (metrics rtol 1e-3, leaves by the rule, one Adam
step within 1e-3 x lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.data import rays as jrays
from fmov_pose_tpu.fields import nets as jn
from fmov_pose_tpu.render import neus as jneus
from fmov_pose_torch import convert
from fmov_pose_torch.data import rays as trays
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_color, fused_sdf
from fmov_pose_torch.render import neus as tneus
from tests.test_torch_runner import CONF, _write_sequence
from tests.test_torch_step import COLOR, NERF, SDF, _ray_batch, world  # noqa: F401
from tests.test_torch_step_fast import (FAST, RENDER as FAST_RENDER,  # noqa: F401
                                        SDF as FAST_SDF, _count_calls,
                                        check_step_against_jax, fast_step_both,
                                        gates)

NERF_FULL = {"D": 8, "d_in": 4, "d_in_view": 3, "W": 256, "multires": 10,
             "multires_view": 4, "output_ch": 4, "skips": (4,), "use_viewdirs": True}
RENDER = {"n_samples": 16, "n_importance": 16, "n_outside": 8,
          "up_sample_steps": 2, "perturb": 0.0}
OUTPUTS = ("color_fine", "depth_fine", "weights", "weight_sum", "s_val",
           "gradient_error")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(ref, got):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(ref).max()), 1e-30))


def _leaves(tree):
    items = convert.flatten(tree)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    return [n for n, _ in items], leaves, convert.unflatten(
        zip([n for n, _ in items], leaves))


def _check_grads(gj, names, grads, nonzero_prefix):
    ref = {n: torch.from_numpy(np.array(v)) for n, v in convert.flatten(_np_tree(gj))}
    got = {n: torch.zeros_like(ref[n]) if g is None else g for n, g in zip(names, grads)}
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res
    assert any(float(v.abs().max()) > 0 for n, v in ref.items()
               if n.startswith(nonzero_prefix))


def test_nerf_full_width_matches_jax():
    pj = jn.init_nerf(jax.random.key(3), NERF_FULL)
    names, leaves, pt = _leaves(convert.to_torch(_np_tree(pj)))
    rng = np.random.default_rng(0)
    u = rng.normal(size=(64, 3))
    r = rng.uniform(1.0, 4.0, (64, 1))
    pts4 = np.concatenate([u / np.linalg.norm(u, axis=-1, keepdims=True), 1.0 / r],
                          -1).astype(np.float32)
    dirs = (u / np.linalg.norm(u, axis=-1, keepdims=True)).astype(np.float32)
    ca, cr = rng.normal(size=(64, 1)).astype(np.float32), rng.normal(size=(64, 3)).astype(
        np.float32)

    def loss_j(p, x, v):
        a, c = jn.nerf_apply(p, NERF_FULL, x, v)
        return jnp.sum(a * ca) + jnp.sum(c * cr), (a, c)

    (_, (aj, cj)), gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2),
                                                   has_aux=True))(
        pj, jnp.asarray(pts4), jnp.asarray(dirs))
    xt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (pts4, dirs))
    at, ct = tn.nerf_apply(pt, NERF_FULL, xt, vt)
    _close(aj, at)
    _close(cj, ct)
    grads = torch.autograd.grad((at * torch.from_numpy(ca)).sum()
                                + (ct * torch.from_numpy(cr)).sum(), leaves + [xt, vt])
    _check_grads({"params": gj[0], "x": gj[1], "v": gj[2]},
                 [f"params.{n}" for n in names] + ["x", "v"], grads, "params.pts")


def test_render_with_background_matches_jax(world):  # noqa: F811
    sc, params_j, _ = world
    params_j = {k: params_j[k] for k in ("sdf", "color", "nerf", "variance")}
    data = _ray_batch(sc, np.random.default_rng(4))
    rays_o, rays_d = data[:, :3], data[:, 3:6]
    near, far = (t.numpy() for t in trays.near_far_from_sphere(
        torch.from_numpy(rays_o), torch.from_numpy(rays_d)))
    jnear, jfar = jrays.near_far_from_sphere(jnp.asarray(rays_o), jnp.asarray(rays_d))
    np.testing.assert_allclose(near, np.asarray(jnear), rtol=1e-6, atol=1e-6)
    B = data.shape[0]
    n_all = RENDER["n_samples"] + RENDER["n_importance"] + RENDER["n_outside"]
    rng = np.random.default_rng(5)
    c_col, c_dep, c_ws = (rng.normal(size=s).astype(np.float32)
                          for s in ((B, 3), (B, 1), (B, 1)))

    def loss_of(out, to):
        return ((out["color_fine"] * to(c_col)).sum()
                + 0.1 * (out["depth_fine"] * to(c_dep)).sum()
                + (out["weight_sum"] * to(c_ws)).sum() + 0.1 * out["gradient_error"])

    jcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": jneus.make_render_cfg(RENDER)}

    def loss_j(p):
        out = jneus.render(jax.random.key(0), p, jcfg, jnp.asarray(rays_o),
                           jnp.asarray(rays_d), jnp.asarray(near), jnp.asarray(far),
                           cos_anneal_ratio=0.7)
        return loss_of(out, jnp.asarray), {k: out[k] for k in OUTPUTS}

    (_, out_j), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_j)

    tcfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
            "renderer": tneus.make_render_cfg(RENDER)}
    names, leaves, params_t = _leaves(convert.to_torch(_np_tree(params_j)))
    out_t = tneus.render(None, params_t, tcfg, torch.from_numpy(rays_o),
                         torch.from_numpy(rays_d), torch.from_numpy(near),
                         torch.from_numpy(far), cos_anneal_ratio=0.7)
    assert out_t["weights"].shape == (B, n_all)
    # some samples lie outside the unit sphere, where the background mixes in
    assert 0 < float(out_t["inside_sphere"].mean()) < 1
    for k in OUTPUTS:
        _close(out_j[k], out_t[k])
    grads = torch.autograd.grad(
        loss_of(out_t, torch.from_numpy), leaves, allow_unused=True)
    _check_grads(gj, names, grads, "nerf.")


def test_fast_step_with_background_matches_jax(world, gates, monkeypatch):  # noqa: F811
    from fmov_pose_tpu.ops import fused_color as jfc
    from fmov_pose_tpu.ops import fused_sdf as jfs
    mj, gj, new_j, mt, items, grads, calls = fast_step_both(
        world, monkeypatch, render=dict(FAST_RENDER, n_outside=8), counted=(
            (jfs, "_sdf_fwd_grad_rays_impl"), (jfc, "_color_fwd_impl"),
            (jfc, "_color_bwd_impl"), (jfc, "_ray_fwd_impl"),
            (fused_sdf, "sdf_apply_grad_fused_rays"), (fused_color, "color_fwd"),
            (fused_color, "color_bwd"), (fused_color, "color_fused_ray")))
    # JAX: the rays SDF kernels and K6/K7, not K8; the port: the same
    assert calls["_sdf_fwd_grad_rays_impl"] >= 1 and calls["_color_fwd_impl"] >= 1
    assert calls["_color_bwd_impl"] >= 1 and calls["_ray_fwd_impl"] == 0
    assert (calls["sdf_apply_grad_fused_rays"], calls["color_fwd"], calls["color_bwd"],
            calls["color_fused_ray"]) == (1, 1, 1, 0)
    assert mt["loss"].isfinite()
    check_step_against_jax(mj, gj, new_j, mt, items, grads,
                           nonzero=("nerf.pts.lin0.w", "nerf.rgb.w"))


@pytest.mark.parametrize("fused,m_total,n_samples,background,color_gate,expected", [
    (False, 131072, 128, False, None, (None, None)),
    (True, 65536, 128, False, None, ("rays", "ray")),
    (True, 65536, 128, True, None, ("rays", "sample")),
    (True, 32768, 32, False, None, ("flat", None)),
    (True, 32768, 32, False, 0, ("flat", "sample")),
    (True, 32768, 32, True, 0, ("flat", "sample")),
    (True, 65536, 128, False, 10 ** 9, ("rays", None)),
])
def test_fused_train_paths_routes(monkeypatch, fused, m_total, n_samples, background,
                                  color_gate, expected):
    """The SDF and color routes as the JAX render_core picks them: K8/K9 on
    the rays path without a background, K6/K7 wherever else the color gate
    is met."""
    if color_gate is not None:
        monkeypatch.setattr(fused_color, "MIN_SAMPLES", color_gate)
    cfg = {"sdf": dict(FAST_SDF, use_fused_train=fused), "color": dict(COLOR)}
    assert tneus._fused_train_paths(cfg, n_samples, m_total, background) == expected


def test_runner_trains_with_background(tmp_path, monkeypatch):
    """A tiny fast conf with ``n_outside = 8`` through the Runner on the
    CPU (the gates patched to 0): every step takes K4/K5 and K6/K7 (their
    plain versions), never K8, the losses stay finite and the background
    network's parameters move."""
    from fmov_pose_torch.train.runner import Runner
    monkeypatch.setattr(fused_sdf, "MIN_SAMPLES_RAYS", 0)
    monkeypatch.setattr(fused_color, "MIN_SAMPLES", 0)
    data_dir, _ = _write_sequence(tmp_path, 3, 32, 40, seed=2)
    conf = tmp_path / "tiny_fast_bg.conf"
    conf.write_text(CONF.format(exp_dir=tmp_path / "exp", data_dir=data_dir)
                    .replace("end_iter = 40", "end_iter = 10")
                    .replace("batch_size = 256", "batch_size = 64")
                    .replace("n_outside = 0", "n_outside = 8")
                    .replace("learning_rate = 2e-3", "learning_rate = 2e-3" + FAST))
    runner = Runner(str(conf), device="cpu")
    assert runner.model_cfg["renderer"].n_outside == 8
    nerf0 = {n: t.detach().clone() for n, t in
             convert.flatten(runner.state.params["nerf"])}
    calls = {name: _count_calls(monkeypatch, mod, name) for mod, name in (
        (fused_sdf, "sdf_apply_grad_fused_rays"), (fused_color, "color_fwd"),
        (fused_color, "color_bwd"), (fused_color, "color_fused_ray"))}
    runner.train()
    assert runner.iter_step == 10
    assert {k: len(v) for k, v in calls.items()} == {
        "sdf_apply_grad_fused_rays": 10, "color_fwd": 10, "color_bwd": 10,
        "color_fused_ray": 0}
    loss = np.asarray(runner.history["loss"])
    assert loss.shape == (10,) and np.all(np.isfinite(loss))
    nerf1 = dict(convert.flatten(runner.state.params["nerf"]))
    assert all(float((nerf1[n] - t).abs().max()) > 0 for n, t in nerf0.items())


def test_perturbed_outside_z_values_follow_jax(world, monkeypatch):  # noqa: F811
    """With ``perturb`` > 0 the outside z-values take the second draw of the
    render's generator ([B, n_outside], after the inside [B, 1]) through
    the JAX ``render``'s stratification (``render/neus.py:397-416``),
    transcribed here in numpy on the same draws; the feed is the sorted
    union of the inside and outside z-values."""
    sc, params_j, _ = world
    params_t = convert.to_torch(_np_tree(
        {k: params_j[k] for k in ("sdf", "color", "nerf", "variance")}))
    data = _ray_batch(sc, np.random.default_rng(6))
    rays_o, rays_d = (torch.from_numpy(data[:, i:i + 3]) for i in (0, 3))
    near, far = trays.near_far_from_sphere(rays_o, rays_d)
    render = dict(RENDER, perturb=1.0)
    cfg = {"sdf": dict(SDF), "color": dict(COLOR), "nerf": dict(NERF),
           "renderer": tneus.make_render_cfg(render)}
    feeds = []
    real = tneus.render_core_outside
    monkeypatch.setattr(tneus, "render_core_outside",
                        lambda p, m, o, d, z, sd: feeds.append(z) or real(p, m, o, d, z, sd))
    with torch.no_grad():
        tneus.render(torch.Generator().manual_seed(11), params_t, cfg, rays_o, rays_d,
                     near, far)
    B, n_out, n_s = data.shape[0], render["n_outside"], render["n_samples"]
    g = torch.Generator().manual_seed(11)
    torch.rand((B, 1), generator=g)  # the inside draw
    t2 = torch.rand((B, n_out), generator=g).numpy().astype(np.float64)
    z = np.linspace(1e-3, 1.0 - 1.0 / (n_out + 1.0), n_out)
    mids = 0.5 * (z[1:] + z[:-1])
    upper, lower = np.concatenate([mids, z[-1:]]), np.concatenate([z[:1], mids])
    z_out = far.numpy() / np.flip(lower + (upper - lower) * t2, -1) + 1.0 / n_s
    feed = feeds[0].numpy()
    assert feed.shape == (B, n_s + render["n_importance"] + n_out)
    assert np.all(np.diff(feed, axis=-1) >= 0)
    # the outside samples lie beyond far, so they are the feed's tail
    np.testing.assert_allclose(feed[:, -n_out:], z_out, rtol=1e-5, atol=1e-6)
