"""The occupancy grid (``fmov_pose_torch/render/occupancy.py``) against the
JAX package's ``render/occupancy.py``, mirroring ``tests/test_occupancy.py``.

Exact agreement is expected wherever the arithmetic is the same: the grid
points, the dilated grid from the same SDF values and the nearest-voxel
lookup.  The importance z-values for fixed inputs agree to 4 f32 ulps of
the depth range: the pdf, cdf and inverse-CDF formulas are the same, but
XLA and PyTorch sum the pdf's normaliser, run the cumsum and space the
``linspace`` in different orders (one ulp each on an x86 CPU), and the port
searches with ``searchsorted`` where JAX compares all.  The render with a
grid compares an f32 network on both sides: the loss and depths at rtol
1e-4, every gradient leaf by ``fused_sdf.leaf_rule``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.render import neus as jneus
from fmov_pose_tpu.render import occupancy as jocc
from fmov_pose_torch import convert
from fmov_pose_torch.ops import fused_sdf
from fmov_pose_torch.render import neus as tneus
from fmov_pose_torch.render import occupancy as tocc
from tests.test_render import build_params, model_cfg, near_far, rays_toward_origin


def _sphere_sdf(res, radius=0.5):
    pts = tocc.make_grid_points(res)
    return (np.linalg.norm(pts, axis=-1) - radius).astype(np.float32)


@pytest.mark.parametrize("res", [16, 64])
def test_grid_points_and_update_match_jax(res):
    np.testing.assert_array_equal(tocc.make_grid_points(res), jocc.make_grid_points(res))
    rng = np.random.default_rng(res)
    # a sphere plus noise: bands, isolated cells and the grid's edges
    sdf = _sphere_sdf(res) + rng.normal(size=res ** 3).astype(np.float32) * 0.05
    got = tocc.update_occ_grid(torch.from_numpy(sdf), res)
    want = np.asarray(jocc.update_occ_grid(jnp.asarray(sdf), res))
    assert got.shape == (res, res, res) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_grid_is_a_surface_band():
    occ = tocc.update_occ_grid(torch.from_numpy(_sphere_sdf(64)), 64).numpy()
    r = np.linalg.norm(tocc.make_grid_points(64).reshape(64, 64, 64, 3), axis=-1)
    assert occ[np.abs(r - 0.5) < 0.1].mean() > 0.95
    assert occ[np.abs(r - 0.5) > 0.35].mean() < 0.05
    assert 0.0 < occ.mean() < 0.5


def test_query_matches_jax():
    rng = np.random.default_rng(0)
    occ = (rng.uniform(size=(16, 16, 16)) > 0.5).astype(np.float32)
    # inside, on the voxel midpoints (round half to even on both sides)
    # and outside [-1, 1]
    pts = np.concatenate([rng.uniform(-1.2, 1.2, (500, 3)),
                          (np.arange(-16, 17)[:, None] / 15.0).repeat(3, 1)]
                         ).astype(np.float32)
    np.testing.assert_array_equal(
        tocc.query_occ(torch.from_numpy(occ), torch.from_numpy(pts)).numpy(),
        np.asarray(jocc.query_occ(jnp.asarray(occ), jnp.asarray(pts))))


@pytest.mark.parametrize("n_importance", [16, 32])
def test_occupancy_importance_matches_jax(n_importance):
    occ = tocc.update_occ_grid(torch.from_numpy(_sphere_sdf(32)), 32)
    rays_o, rays_d = (np.array(a) for a in rays_toward_origin(8))
    near, far = (np.array(a) for a in near_far(rays_o, rays_d))
    z = (near + (far - near) * np.linspace(0, 1, 32, dtype=np.float32)[None]
         ).astype(np.float32)
    z += np.random.default_rng(1).uniform(-0.02, 0.02, (8, 1)).astype(np.float32)
    got = tocc.occupancy_importance(occ, torch.from_numpy(rays_o),
                                    torch.from_numpy(rays_d), torch.from_numpy(z),
                                    n_importance)
    want = jocc.occupancy_importance(jax.random.key(0), jnp.asarray(occ.numpy()),
                                     jnp.asarray(rays_o), jnp.asarray(rays_d),
                                     jnp.asarray(z), n_importance)
    want = np.asarray(want)
    assert got.shape == (8, 32 + n_importance)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * np.finfo(np.float32).eps * np.abs(want).max())
    # the coarse samples pass through untouched, and the merge is sorted
    assert np.isin(z, got.numpy()).all()
    assert (np.diff(got.numpy(), axis=-1) >= 0).all()


def test_render_with_grid_matches_jax():
    """The whole render with a grid (f32 networks, no kernels): the same
    z-values, so the same outputs and gradients.  The rays pass through the
    origin, where the geometric init's hidden pre-activations are exactly
    0 and softplus's derivative must be sigmoid(0) = 1/2 on both sides."""
    params_j = build_params()
    cfg_j = model_cfg(n_samples=16, n_importance=16)
    cfg_t = dict(cfg_j, renderer=tneus.make_render_cfg(cfg_j["renderer"]._asdict()))
    rays_o, rays_d = rays_toward_origin(4)
    near, far = near_far(rays_o, rays_d)
    occ = jocc.update_occ_grid(jnp.asarray(_sphere_sdf(32)), 32)

    def loss_j(p):
        out = jneus.render(jax.random.key(0), p, cfg_j, rays_o, rays_d, near, far,
                           perturb_overwrite=0.0, occ_grid=occ)
        return out["color_fine"].sum() + out["gradient_error"], out["depth_fine"]

    (lj, dj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params_j)
    items = convert.flatten(convert.to_torch(jax.tree_util.tree_map(np.asarray, params_j)))
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    out = tneus.render(None, convert.unflatten(zip([n for n, _ in items], leaves)),
                       cfg_t, *(torch.from_numpy(np.array(a))
                                for a in (rays_o, rays_d, near, far)),
                       perturb_overwrite=0.0,
                       occ_grid=torch.from_numpy(np.array(occ)))
    lt = out["color_fine"].sum() + out["gradient_error"]
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    np.testing.assert_allclose(out["depth_fine"].detach().numpy(), np.asarray(dj),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out["depth_fine"].detach().numpy()[:, 0], 1.5, atol=0.1)
    grads = torch.autograd.grad(lt, leaves, allow_unused=True)
    ref = {n: torch.from_numpy(np.array(v))
           for n, v in convert.flatten(jax.tree_util.tree_map(np.asarray, gj))}
    got = {n: torch.zeros_like(l) if g is None else g
           for (n, l), g in zip(items, grads)}
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res
