"""The port's fields (``fmov_pose_torch/fields/nets.py``) against the JAX
package's, with parameters converted from the JAX init.

Tolerance: f32, rtol 1e-4 per element plus an atol of 1e-5 x the largest
magnitude of the compared array (entries near zero have no relative
scale).  Both sides run the same f32 arithmetic in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn

SDF_CFG = {"d_out": 65, "d_in": 3, "d_hidden": 64, "n_layers": 4,
           "skip_in": (2,), "multires": 4, "bias": 0.5, "scale": 1.0,
           "geometric_init": True, "weight_norm": True}
COLOR_CFG = {"d_feature": 64, "mode": "idr", "d_in": 9, "d_out": 3,
             "d_hidden": 64, "n_layers": 2, "weight_norm": True,
             "multires_view": 2, "squeeze_out": True}
NERF_CFG = {"D": 4, "d_in": 4, "d_in_view": 3, "W": 64, "multires": 4,
            "multires_view": 2, "output_ch": 4, "skips": (2,),
            "use_viewdirs": True}


def _close(ref, got, rtol=1e-4):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-5 * max(float(np.abs(ref).max()), 1e-30))


def _both(params_j):
    return params_j, convert.to_torch(jax.tree_util.tree_map(np.asarray, params_j))


def _jit(fn, cfg):
    """``fn(params, cfg, *arrays)`` jitted with ``cfg`` fixed: one compile
    instead of one per op in eager mode."""
    return jax.jit(lambda p, *a: fn(p, cfg, *a))


def _init(fn, seed, cfg):
    return fn(jax.random.key(seed), cfg)


@pytest.fixture
def pts(rng):
    return (rng.normal(size=(200, 3)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_sdf_forward(pts, scale):
    cfg = dict(SDF_CFG, scale=scale)
    pj, pt = _both(_init(jn.init_sdf, 1, cfg))
    _close(_jit(jn.sdf_apply, cfg)(pj, jnp.asarray(pts)),
           tn.sdf_apply(pt, cfg, torch.from_numpy(pts)))
    _close(_jit(jn.sdf_only, cfg)(pj, jnp.asarray(pts)),
           tn.sdf_only(pt, cfg, torch.from_numpy(pts)))


def test_sdf_gradient(pts):
    pj, pt = _both(_init(jn.init_sdf, 2, SDF_CFG))
    gj = _jit(jn.sdf_gradient, SDF_CFG)(pj, jnp.asarray(pts))
    _close(gj, tn.sdf_gradient(pt, SDF_CFG, torch.from_numpy(pts)))
    out, g = tn.sdf_apply_with_gradient(pt, SDF_CFG, torch.from_numpy(pts))
    _close(_jit(jn.sdf_apply, SDF_CFG)(pj, jnp.asarray(pts)), out)
    _close(gj, g)


def test_eikonal_second_order(pts):
    """d/dweights of the eikonal loss: reverse over reverse through the
    SDF's input gradient, the core of the training step's backward."""
    pj, pt = _both(_init(jn.init_sdf, 3, SDF_CFG))
    x = jnp.asarray(pts)

    def eik_j(p):
        g = jn.sdf_gradient(p, SDF_CFG, x)
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    gj = jax.jit(jax.grad(eik_j))(pj)
    items = convert.flatten(pt)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    params = convert.unflatten(zip([n for n, _ in items], leaves))
    g = tn.sdf_gradient(params, SDF_CFG, torch.from_numpy(pts))
    loss = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    _close(jax.jit(eik_j)(pj), loss)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    ref = dict(convert.flatten(jax.tree_util.tree_map(np.asarray, gj)))
    for (name, leaf), gt in zip(items, grads):
        # the feature columns of the last layer do not reach the sdf
        _close(ref[name], torch.zeros_like(leaf) if gt is None else gt)


def test_color_forward_and_grad(rng):
    pj, pt = _both(_init(jn.init_color, 4, COLOR_CFG))
    M = 100
    arrs = [rng.normal(size=(M, 3)).astype(np.float32) for _ in range(3)]
    feat = rng.normal(size=(M, 64)).astype(np.float32)
    _close(_jit(jn.color_apply, COLOR_CFG)(pj, *[jnp.asarray(a) for a in arrs],
                                            jnp.asarray(feat)),
           tn.color_apply(pt, COLOR_CFG, *[torch.from_numpy(a) for a in arrs],
                          torch.from_numpy(feat)))
    gj = jax.jit(jax.grad(lambda f: jn.color_apply(
        pj, COLOR_CFG, *[jnp.asarray(a) for a in arrs], f).sum()))(jnp.asarray(feat))
    ft = torch.from_numpy(feat).requires_grad_(True)
    tn.color_apply(pt, COLOR_CFG, *[torch.from_numpy(a) for a in arrs], ft).sum().backward()
    _close(gj, ft.grad)


def test_nerf_and_variance(rng):
    pj, pt = _both(_init(jn.init_nerf, 5, NERF_CFG))
    p4 = rng.normal(size=(50, 4)).astype(np.float32)
    v3 = rng.normal(size=(50, 3)).astype(np.float32)
    aj, cj = _jit(jn.nerf_apply, NERF_CFG)(pj, jnp.asarray(p4), jnp.asarray(v3))
    at, ct = tn.nerf_apply(pt, NERF_CFG, torch.from_numpy(p4), torch.from_numpy(v3))
    _close(aj, at)
    _close(cj, ct)
    vj, vt = _both(jn.init_variance({"init_val": 0.3}))
    _close(jn.variance_inv_s(vj), tn.variance_inv_s(vt))


@pytest.mark.parametrize("net", ["sdf", "color", "nerf"])
def test_port_init_shapes_match_jax(net):
    """The port's own numpy-seeded init builds the same tree as JAX's."""
    init_j = {"sdf": lambda: _init(jn.init_sdf, 0, SDF_CFG),
              "color": lambda: _init(jn.init_color, 0, COLOR_CFG),
              "nerf": lambda: _init(jn.init_nerf, 0, NERF_CFG)}[net]()
    rng = np.random.default_rng(0)
    init_t = {"sdf": lambda: tn.init_sdf(rng, SDF_CFG),
              "color": lambda: tn.init_color(rng, COLOR_CFG),
              "nerf": lambda: tn.init_nerf(rng, NERF_CFG)}[net]()
    fj = convert.flatten(jax.tree_util.tree_map(np.asarray, init_j))
    ft = convert.flatten(init_t)
    assert [n for n, _ in fj] == [n for n, _ in ft]
    assert [np.shape(a) for _, a in fj] == [tuple(t.shape) for _, t in ft]


def test_port_geometric_init_is_a_sphere(rng):
    """IDR init: sdf(x) ~ |x| - bias, on both packages' inits."""
    cfg = dict(SDF_CFG, d_hidden=256, d_out=257)
    x = (rng.normal(size=(300, 3)) * 0.4).astype(np.float32)
    target = np.linalg.norm(x, axis=-1) - 0.5
    st = tn.sdf_only(tn.init_sdf(np.random.default_rng(0), cfg), cfg,
                     torch.from_numpy(x))[:, 0].numpy()
    sj = np.asarray(_jit(jn.sdf_only, cfg)(_init(jn.init_sdf, 0, cfg),
                                           jnp.asarray(x)))[:, 0]
    assert np.abs(st - target).mean() < 2 * np.abs(sj - target).mean() + 0.01
    assert np.corrcoef(st, target)[0, 1] > 0.9
