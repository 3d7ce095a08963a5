"""Neural fields: SDF, color, background NeRF, variance (port of
``fmov_pose_tpu/fields/nets.py``).

Parameters are nested dicts of tensors with the JAX package's keys, and
every network is a plain ``apply(params, cfg, ...)`` function, so the
parameters of both packages convert one to one (``convert.py``).  Weight
norm is stored as (v, g) and materialized per call with the JAX package's
1e-12 (``torch.nn.utils.weight_norm`` has none).  The eikonal gradient is
``torch.autograd.grad(create_graph=True)``, so the training loss
differentiates through it to second order.

Initializers draw from a numpy ``Generator`` the caller passes: IDR
geometric init for the SDF, ``nn.Linear``'s default init for the others.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from fmov_pose_torch.core.embedder import embed_dim, positional_encode

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# linear layers (optionally weight-normalized)
# ---------------------------------------------------------------------------


def _linear_params(w: np.ndarray, b: np.ndarray, weight_norm: bool) -> Params:
    w = torch.from_numpy(np.asarray(w, np.float32))
    b = torch.from_numpy(np.asarray(b, np.float32))
    if weight_norm:
        return {"v": w, "g": torch.linalg.norm(w, dim=1), "b": b}
    return {"w": w, "b": b}


def materialize(p: Params) -> torch.Tensor:
    """Dense [out, in] weight of a (possibly weight-normed) linear."""
    if "v" in p:
        v = p["v"]
        return v * (p["g"] / (torch.linalg.norm(v, dim=1) + 1e-12))[:, None]
    return p["w"]


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ materialize(p).T + p["b"]


def _torch_default_linear(rng: np.random.Generator, d_in: int, d_out: int,
                          weight_norm: bool) -> Params:
    """nn.Linear default init: kaiming_uniform(a=sqrt(5)) + uniform bias."""
    bound = 1.0 / math.sqrt(d_in)
    w = rng.uniform(-bound, bound, (d_out, d_in))
    b = rng.uniform(-bound, bound, (d_out,))
    return _linear_params(w, b, weight_norm)


def softplus100(z: torch.Tensor) -> torch.Tensor:
    """softplus(100 z) / 100.  ``F.softplus`` turns linear above 100z > 20,
    where the dropped log1p(exp(-100z)) is below half an f32 ulp of z.  Its
    derivative at z = 0 is sigmoid(0) = 1/2, as ``jax.nn.softplus``'s
    (autograd of relu(z) + log1p(exp(-100|z|)) / 100 gives 0 there), and
    its double backward stays finite."""
    return F.softplus(z, beta=100.0)


def _check_f32(cfg):
    d = cfg.get("compute_dtype")
    if d not in (None, "float32", "f32"):
        raise NotImplementedError(
            f"compute_dtype={d!r}: the port runs its fields in float32 only "
            "(bf16 activations are ROADMAP queue 1, item 7)")


# ---------------------------------------------------------------------------
# SDF network
# ---------------------------------------------------------------------------


def sdf_dims(cfg) -> list:
    d_in = cfg["d_in"]
    in_dim = embed_dim(cfg["multires"], d_in) if cfg["multires"] > 0 else d_in
    return [in_dim] + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]


def init_sdf(rng: np.random.Generator, cfg) -> Params:
    """Geometric (sphere) init per IDR; the skip layer's producer is
    ``d_hidden - d_pe`` wide."""
    dims = sdf_dims(cfg)
    skip_in = tuple(cfg.get("skip_in", (4,)))
    multires = cfg["multires"]
    bias = cfg.get("bias", 0.5)
    geometric = cfg.get("geometric_init", True)
    weight_norm = cfg.get("weight_norm", True)
    inside_outside = cfg.get("inside_outside", False)
    n_lin = len(dims) - 1

    layers = {}
    for l in range(n_lin):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in skip_in else dims[l + 1]
        in_dim = dims[l]
        if not geometric:
            layers[f"lin{l}"] = _torch_default_linear(rng, in_dim, out_dim,
                                                      weight_norm)
            continue
        std = math.sqrt(2) / math.sqrt(out_dim)
        if l == n_lin - 1:
            mean = math.sqrt(math.pi) / math.sqrt(dims[l])
            if inside_outside:
                mean, b_val = -mean, bias
            else:
                b_val = -bias
            w = rng.normal(mean, 1e-4, (out_dim, in_dim))
            b = np.full((out_dim,), b_val)
        elif multires > 0 and l == 0:
            w = np.zeros((out_dim, in_dim))
            w[:, :3] = rng.normal(0.0, std, (out_dim, 3))
            b = np.zeros((out_dim,))
        elif multires > 0 and l in skip_in:
            w = rng.normal(0.0, std, (out_dim, in_dim))
            w[:, -(dims[0] - 3):] = 0.0
            b = np.zeros((out_dim,))
        else:
            w = rng.normal(0.0, std, (out_dim, in_dim))
            b = np.zeros((out_dim,))
        layers[f"lin{l}"] = _linear_params(w, b, weight_norm)
    return {"layers": layers}


def sdf_apply(params: Params, cfg, x: torch.Tensor, progress=None) -> torch.Tensor:
    """[N, 3] -> [N, d_out] = [sdf, feature...]; ``progress`` is accepted
    for the BARF API and ignored, as in the reference."""
    del progress
    _check_f32(cfg)
    scale = cfg.get("scale", 1.0)
    multires = cfg["multires"]
    skip_in = tuple(cfg.get("skip_in", (4,)))
    n_lin = len(sdf_dims(cfg)) - 1

    inputs = x * scale
    if multires > 0:
        inputs = positional_encode(inputs, multires)
    h = inputs
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l in range(n_lin):
        if l in skip_in:
            h = torch.cat([h, inputs], dim=-1) * inv_sqrt2
        h = linear_apply(params["layers"][f"lin{l}"], h)
        if l < n_lin - 1:
            h = softplus100(h)
    return torch.cat([h[..., :1] / scale, h[..., 1:]], dim=-1)


def sdf_only(params: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    return sdf_apply(params, cfg, x)[..., :1]


def _grad_input(x: torch.Tensor) -> torch.Tensor:
    return x if x.requires_grad else x.detach().requires_grad_(True)


def sdf_gradient(params: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """d sdf / d x, differentiable again when grad mode is on (each output
    row depends only on its own input row, so the summed-scalar gradient
    is the per-point gradient)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = _grad_input(x)
        (g,) = torch.autograd.grad(sdf_only(params, cfg, x).sum(), x,
                                   create_graph=create)
    return g


def sdf_apply_with_gradient(params: Params, cfg, x: torch.Tensor):
    """(sdf_apply(x), sdf_gradient(x)) from one forward pass."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = _grad_input(x)
        out = sdf_apply(params, cfg, x)
        (g,) = torch.autograd.grad(out[:, :1].sum(), x, create_graph=create)
    if not create:
        out = out.detach()
    return out, g


# ---------------------------------------------------------------------------
# rendering (color) network — IDR style
# ---------------------------------------------------------------------------


def color_dims(cfg) -> list:
    d_in = cfg["d_in"] + cfg["d_feature"]
    if cfg.get("multires_view", 0) > 0:
        d_in += embed_dim(cfg["multires_view"], 3) - 3
    return [d_in] + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]


def init_color(rng: np.random.Generator, cfg) -> Params:
    dims = color_dims(cfg)
    weight_norm = cfg.get("weight_norm", True)
    return {"layers": {
        f"lin{l}": _torch_default_linear(rng, dims[l], dims[l + 1], weight_norm)
        for l in range(len(dims) - 1)}}


def color_apply(params, cfg, points, normals, view_dirs, feature, progress=None):
    del progress
    _check_f32(cfg)
    mode = cfg.get("mode", "idr")
    if cfg.get("multires_view", 0) > 0:
        view_dirs = positional_encode(view_dirs, cfg["multires_view"])
    if mode == "idr":
        h = torch.cat([points, view_dirs, normals, feature], dim=-1)
    elif mode == "no_view_dir":
        h = torch.cat([points, normals, feature], dim=-1)
    elif mode == "no_normal":
        h = torch.cat([points, view_dirs, feature], dim=-1)
    else:
        raise ValueError(mode)
    n_lin = cfg["n_layers"] + 1
    for l in range(n_lin):
        h = linear_apply(params["layers"][f"lin{l}"], h)
        if l < n_lin - 1:
            h = torch.relu(h)
    if cfg.get("squeeze_out", True):
        h = torch.sigmoid(h)
    return h


# ---------------------------------------------------------------------------
# background NeRF (NeRF++ 4D inputs) — used when n_outside > 0
# ---------------------------------------------------------------------------


def init_nerf(rng: np.random.Generator, cfg) -> Params:
    D, W = cfg["D"], cfg["W"]
    d_in, d_in_view = cfg["d_in"], cfg["d_in_view"]
    multires, multires_view = cfg.get("multires", 0), cfg.get("multires_view", 0)
    in_ch = embed_dim(multires, d_in) if multires > 0 else 3
    in_ch_view = embed_dim(multires_view, d_in_view) if multires_view > 0 else 3
    skips = tuple(cfg.get("skips", (4,)))

    pts_linears = [_torch_default_linear(rng, in_ch, W, False)]
    for i in range(D - 1):
        din = W + in_ch if i in skips else W
        pts_linears.append(_torch_default_linear(rng, din, W, False))
    return {
        "pts": {f"lin{i}": p for i, p in enumerate(pts_linears)},
        "views0": _torch_default_linear(rng, in_ch_view + W, W // 2, False),
        "feature": _torch_default_linear(rng, W, W, False),
        "alpha": _torch_default_linear(rng, W, 1, False),
        "rgb": _torch_default_linear(rng, W // 2, 3, False),
    }


def nerf_apply(params, cfg, input_pts, input_views):
    """Returns (alpha/density, rgb) of the NeRF++ background net."""
    _check_f32(cfg)
    D = cfg["D"]
    skips = tuple(cfg.get("skips", (4,)))
    if cfg.get("multires", 0) > 0:
        input_pts = positional_encode(input_pts, cfg["multires"])
    if cfg.get("multires_view", 0) > 0:
        input_views = positional_encode(input_views, cfg["multires_view"])
    h = input_pts
    for i in range(D):
        h = torch.relu(linear_apply(params["pts"][f"lin{i}"], h))
        if i in skips:
            h = torch.cat([input_pts, h], dim=-1)
    alpha = linear_apply(params["alpha"], h)
    feature = linear_apply(params["feature"], h)
    h = torch.relu(linear_apply(params["views0"],
                                torch.cat([feature, input_views], dim=-1)))
    return alpha, linear_apply(params["rgb"], h)


# ---------------------------------------------------------------------------
# single-variance network
# ---------------------------------------------------------------------------


def init_variance(cfg) -> Params:
    return {"variance": torch.tensor(float(cfg["init_val"]), dtype=torch.float32)}


def variance_inv_s(params) -> torch.Tensor:
    """inv_s = exp(10 * v), clipped to [1e-6, 1e6]."""
    return torch.clamp(torch.exp(params["variance"] * 10.0), 1e-6, 1e6)
