"""The plain NeuS model of the benchmark's reference: fields, renderer,
pose nets and ray generation, in PyTorch and nothing else.

This is the reference that decides a cell's ``correct``.  It follows the
published NeuS (github.com/Totoro97/NeuS, ``models/fields.py`` and
``models/renderer.py``) and the fmov_pose reference's pose nets and ray
draws, written out plainly: no kernels, no packing, no captured graphs.
It imports nothing of the program under test.

Precision: every product is f32 (the caller turns TF32 off), except where
``Precision`` says otherwise:

* ``query``: the up-sampler's gradient-free SDF queries multiply
  bf16-rounded operands with f32 sums, as the configurations state for
  that search (their ``precision`` key);
* ``train``: the operands of every training product rounded to a lower
  format (``"bf16"`` or ``"fp8"``, e4m3 with one scale a tensor), the
  control's lower precision: the forward's operands and, in the
  backward, the cotangents that meet them.  The rounding is
  straight-through, so the second-order backward sees the rounded
  operands' products;
* ``color``: the same for the color network's products alone (where
  ``train`` leaves them f32).

Random draws come from one ``torch.Generator`` in the order the program
draws them (frame, pixels, mask-guide coin, the maintain_shape batch's
pixels and coin, the stratified offset, the background's stratified
z-values), so that handed the same generator state the reference draws
the same numbers.

With ``n_outside`` > 0 the render adds NeuS's NeRF++ background
(``models/renderer.py``'s ``render_core_outside``): the ``nerf`` network,
its products at ``train``'s format, on the inverted-sphere coordinates
[p / r, 1 / r] at the mid-points of the sorted union of the inside and
the outside z-values; its alpha and colors replace the inside ones
outside the unit sphere, and its tail is appended.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class Precision(NamedTuple):
    query: Optional[str] = "bf16"
    train: Optional[str] = None
    color: Optional[str] = None


FP8_MAX = 448.0


def _round_to(x: torch.Tensor, fmt: Optional[str]) -> torch.Tensor:
    """x's values in format ``fmt`` (returned in f32); None leaves x."""
    if fmt is None:
        return x
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if fmt == "fp8":
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"unknown format {fmt!r}")


def rounded(x: torch.Tensor, fmt: Optional[str]) -> torch.Tensor:
    """Straight-through rounding: the value of ``_round_to``, the identity's
    derivative to any order."""
    if fmt is None:
        return x
    return x + (_round_to(x.detach(), fmt) - x).detach()


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to ``fmt`` (so a
    product's backward products take rounded operands on both sides); the
    backward is itself differentiable, for the second order."""

    @staticmethod
    def forward(ctx, y, fmt):
        ctx.fmt = fmt
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, ctx.fmt), None


# ---------------------------------------------------------------------------
# encodings and layers
# ---------------------------------------------------------------------------


def positional_encode(x, multires):
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)]."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    sc = sc.reshape(x.shape[:-1] + (2 * multires * x.shape[-1],))
    return torch.cat([x, sc], dim=-1)


def pe_dim(multires, d=3):
    return d * (1 + 2 * multires)


def weight(p):
    """The dense weight of a (weight-normed) linear layer."""
    if "v" in p:
        v = p["v"]
        return v * (p["g"] / (torch.linalg.norm(v, dim=1) + 1e-12))[:, None]
    return p["w"]


def linear(p, x, fmt=None):
    """x W^T + b; with ``fmt`` every product's operands rounded to it, the
    forward's and the backward's (the cotangent too)."""
    w = weight(p)
    y = rounded(x, fmt) @ rounded(w, fmt).T + p["b"]
    return y if fmt is None else _RoundCotangent.apply(y, fmt)


def softplus100(z):
    return F.softplus(z, beta=100.0)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


def sdf_dims(cfg):
    return [pe_dim(cfg["multires"], cfg["d_in"])] + [cfg["d_hidden"]] * cfg["n_layers"] \
        + [cfg["d_out"]]


def sdf_apply(params, cfg, x, fmt=None):
    """[N, 3] -> [N, d_out] = [sdf, features]."""
    scale = cfg["scale"]
    skip_in = tuple(cfg["skip_in"])
    n_lin = cfg["n_layers"] + 1
    inputs = positional_encode(x * scale, cfg["multires"])
    h = inputs
    for l in range(n_lin):
        if l in skip_in:
            h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
        h = linear(params["layers"][f"lin{l}"], h, fmt)
        if l < n_lin - 1:
            h = softplus100(h)
    return torch.cat([h[..., :1] / scale, h[..., 1:]], dim=-1)


def sdf_with_gradient(params, cfg, x, fmt=None):
    """(sdf_apply(x), d sdf / d x), the gradient differentiable again; x
    keeps its own graph (the rays depend on the pose nets)."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    out = sdf_apply(params, cfg, x, fmt)
    (g,) = torch.autograd.grad(out[:, :1].sum(), x, create_graph=True)
    return out, g


def color_dims(cfg):
    return [cfg["d_in"] + cfg["d_feature"] + pe_dim(cfg["multires_view"]) - 3] \
        + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]


def color_apply(params, cfg, points, normals, view_dirs, feature, fmt=None):
    """The IDR color network: [points, PE(view), normals, features]."""
    view = positional_encode(view_dirs, cfg["multires_view"])
    h = torch.cat([points, view, normals, feature], dim=-1)
    n_lin = cfg["n_layers"] + 1
    for l in range(n_lin):
        h = linear(params["layers"][f"lin{l}"], h, fmt)
        if l < n_lin - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def nerf_apply(params, cfg, pts4, dirs, fmt=None):
    """The NeRF++ background network (NeuS ``models/fields.py`` ``NeRF``, with
    view directions): (density [N, 1], rgb logits [N, 3]) of the points
    [N, 4] and the directions [N, 3]."""
    x = positional_encode(pts4, cfg["multires"])
    view = positional_encode(dirs, cfg["multires_view"])
    skips = tuple(cfg["skips"])
    h = x
    for i in range(cfg["D"]):
        h = torch.relu(linear(params["pts"][f"lin{i}"], h, fmt))
        if i in skips:
            h = torch.cat([x, h], dim=-1)
    density = linear(params["alpha"], h, fmt)
    feature = linear(params["feature"], h, fmt)
    h = torch.relu(linear(params["views0"], torch.cat([feature, view], dim=-1), fmt))
    return density, linear(params["rgb"], h, fmt)


def inv_s(params):
    return torch.clamp(torch.exp(params["variance"] * 10.0), 1e-6, 1e6)


# ---------------------------------------------------------------------------
# renderer
# ---------------------------------------------------------------------------


def transmittance_weights(alpha):
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1), dim=-1)
    return alpha * trans[..., :-1]


def norm_sq_along(rays_o, rays_d, z):
    o2 = torch.sum(rays_o * rays_o, dim=-1, keepdim=True)
    od = torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    d2 = torch.sum(rays_d * rays_d, dim=-1, keepdim=True)
    return o2 + 2.0 * z * od + z * z * d2


def sample_pdf(bins, weights, n):
    """NeuS's deterministic inverse-CDF samples (mid-stratified u)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, dtype=cdf.dtype,
                       device=cdf.device).expand(cdf.shape[:-1] + (n,)).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def merge_sorted(z_a, z_b, v_a=None, v_b=None):
    z, order = torch.sort(torch.cat([z_a, z_b], dim=-1), dim=-1, stable=True)
    if v_a is None:
        return z
    return z, torch.gather(torch.cat([v_a, v_b], dim=-1), -1, order)


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance, inv_s_up):
    B, N = z_vals.shape
    radius_sq = norm_sq_along(rays_o, rays_d, z_vals)
    inside = (radius_sq[:, :-1] < 1.0) | (radius_sq[:, 1:] < 1.0)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.clamp(torch.minimum(prev_cos, cos_val), -1e3, 0.0) * inside
    dist = next_z - prev_z
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * dist * 0.5) * inv_s_up)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * dist * 0.5) * inv_s_up)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return sample_pdf(z_vals, transmittance_weights(alpha), n_importance)


def outside_z(gen, n_out, n_s, perturb, far):
    """The background's z-values [B, n_out]: NeuS's stratified draws in
    (0, 1) (one [B, n_out] draw), inverted beyond ``far`` (``far / z``,
    plus 1 / n_samples as NeuS adds)."""
    B, dev = far.shape[0], far.device
    z = torch.linspace(1e-3, 1.0 - 1.0 / (n_out + 1.0), n_out, device=dev)
    if perturb > 0:
        mids = 0.5 * (z[1:] + z[:-1])
        upper, lower = torch.cat([mids, z[-1:]]), torch.cat([z[:1], mids])
        z = lower + (upper - lower) * torch.rand((B, n_out), generator=gen, device=dev)
    return far / torch.flip(torch.atleast_2d(z), dims=[-1]) + 1.0 / n_s


def render_outside(params, cfg, rays_o, rays_d, z_vals, sample_dist, fmt=None):
    """The background's (alpha, sampled colors) [B, N] and [B, N, 3] at the
    mid-points of ``z_vals`` [B, N]."""
    B, N = z_vals.shape
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full((B, 1), sample_dist, device=z_vals.device)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    r = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / r, 1.0 / r], dim=-1).reshape(-1, 4)
    dirs = rays_d[:, None, :].expand(B, N, 3).reshape(-1, 3)
    density, rgb = nerf_apply(params, cfg, pts4, dirs, fmt)
    alpha = 1.0 - torch.exp(-F.softplus(density.reshape(B, N)) * dists)
    return alpha, torch.sigmoid(rgb).reshape(B, N, 3)


def render(gen, params, model, rays_o, rays_d, near, far, cos_anneal, prec: Precision):
    """NeuS's hierarchical render of a ray batch, training mode."""
    rcfg, sdf_cfg, col_cfg = model["renderer"], model["sdf"], model["color"]
    B = rays_o.shape[0]
    dev = rays_o.device
    n_s, n_i = rcfg["n_samples"], rcfg["n_importance"]
    sample_dist = 2.0 / n_s
    z_vals = near + (far - near) * torch.linspace(0.0, 1.0, n_s, device=dev)[None, :]
    if rcfg["perturb"] > 0:
        z_vals = z_vals + (torch.rand((B, 1), generator=gen, device=dev) - 0.5) * 2.0 / n_s
    n_out = rcfg.get("n_outside", 0)
    if n_out > 0:
        z_out = outside_z(gen, n_out, n_s, rcfg["perturb"], far)
    if n_i > 0:
        with torch.no_grad():
            ro, rd = rays_o.detach(), rays_d.detach()
            z_vals = z_vals.detach()

            def query(z):
                pts = ro[:, None, :] + rd[:, None, :] * z[..., :, None]
                return sdf_apply(params["sdf"], sdf_cfg, pts.reshape(-1, 3),
                                 prec.query)[:, :1].reshape(B, -1)

            sdf = query(z_vals)
            steps = rcfg["up_sample_steps"]
            for i in range(steps):
                new_z = up_sample(ro, rd, z_vals, sdf, n_i // steps, 64.0 * 2 ** i)
                if i + 1 == steps:
                    z_vals = merge_sorted(z_vals, new_z)
                else:
                    z_vals, sdf = merge_sorted(z_vals, new_z, sdf, query(new_z))
    n_total = z_vals.shape[1]
    if n_out > 0:
        z_feed = torch.sort(torch.cat([z_vals, z_out.expand(B, n_out)], dim=-1), dim=-1).values
        bg_alpha, bg_color = render_outside(params["nerf"], model["nerf"], rays_o, rays_d,
                                            z_feed, sample_dist, prec.train)

    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full((B, 1), sample_dist, device=dev)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(B, n_total, 3).reshape(-1, 3)
    sdf_nn, gradients = sdf_with_gradient(params["sdf"], sdf_cfg, pts, prec.train)
    sdf = sdf_nn[:, :1]
    sampled_color = color_apply(params["color"], col_cfg, pts, gradients, dirs,
                                sdf_nn[:, 1:], prec.color or prec.train).reshape(B, n_total, 3)
    s = inv_s(params["variance"])
    true_cos = (dirs * gradients).sum(-1).reshape(B, n_total)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal)
                 + torch.relu(-true_cos) * cos_anneal)
    sdf_bn = sdf.reshape(B, n_total)
    prev_cdf = torch.sigmoid((sdf_bn - iter_cos * dists * 0.5) * s)
    next_cdf = torch.sigmoid((sdf_bn + iter_cos * dists * 0.5) * s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    if n_out > 0:
        inside = (norm_sq_along(rays_o, rays_d, mid_z).detach() < 1.0).to(alpha.dtype)
        alpha = torch.cat([alpha * inside + bg_alpha[:, :n_total] * (1.0 - inside),
                           bg_alpha[:, n_total:]], dim=-1)
        sampled_color = torch.cat(
            [sampled_color * inside[..., None] + bg_color[:, :n_total] * (1.0 - inside)[..., None],
             bg_color[:, n_total:]], dim=1)
    weights = transmittance_weights(alpha)
    color = (sampled_color * weights[..., None]).sum(dim=1)
    relax = (norm_sq_along(rays_o, rays_d, mid_z).detach() < 1.44).to(alpha.dtype)
    grad_norm = torch.sqrt((gradients * gradients).sum(-1)).reshape(B, n_total)
    return {
        "color": color,
        "weight_sum": weights.sum(dim=-1, keepdim=True),
        "weights": weights,
        "pts": pts,
        "eik_num": (relax * (grad_norm - 1.0) ** 2).sum(),
        "eik_den": relax.sum(),
    }


# ---------------------------------------------------------------------------
# poses: the Gaussian-Fourier pose net, one a sequence (gf) or one a
# segment of frames (seg)
# ---------------------------------------------------------------------------


def skew(w):
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    return torch.stack([torch.stack([z, -w2, w1], -1), torch.stack([w2, z, -w0], -1),
                        torch.stack([-w1, w0, z], -1)], -2)


def _series(t2, series, exact):
    small = t2 < 1e-4
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return torch.where(small, series(t2), exact(theta))


def rodrigues(r):
    """Axis-angle [..., 3] -> rotation [..., 3, 3]."""
    wx = skew(r)
    t2 = torch.sum(r * r, dim=-1)[..., None, None]
    a = _series(t2, lambda v: 1.0 - v / 6.0 + v * v / 120.0, lambda th: torch.sin(th) / th)
    b = _series(t2, lambda v: 0.5 - v / 24.0 + v * v / 720.0,
                lambda th: (1.0 - torch.cos(th)) / (th * th))
    return torch.eye(3, dtype=r.dtype, device=r.device) + a * wx + b * (wx @ wx)


def pose_net(train, static, cam, emphasize_rot):
    """c2w [3, 4] of frame ``cam`` (an int) through one pose net."""
    b = static["b"]
    cam_f = torch.full((1, 1), float(cam), device=b.device)
    ang = (2.0 * math.pi * cam_f) @ b.T
    feat = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) / math.sqrt(b.shape[0])
    h = F.gelu(feat @ train["lin1"]["w"].T + train["lin1"]["b"])
    h = F.gelu(h @ train["lin2"]["w"].T + train["lin2"]["b"])
    if emphasize_rot:
        rot = (h @ train["lin3_rot"]["w"].T + train["lin3_rot"]["b"]) * math.pi
        trans = h @ train["lin3_trans"]["w"].T + train["lin3_trans"]["b"]
        scale = (h @ train["lin3_scale"]["w"].T + train["lin3_scale"]["b"])[0, 0]
    else:
        pred = h @ train["lin3"]["w"].T + train["lin3"]["b"]
        rot, trans, scale = pred[:, :3] * math.pi, pred[:, 3:], 1.0
    c2w = torch.cat([rodrigues(rot), trans[..., None]], dim=-1)[0]
    init = static["init_c2w"][min(int(cam), static["init_c2w"].shape[0] - 1)]
    t = init[:3, 3] * scale
    bottom = torch.eye(4, device=b.device)[3:]
    return c2w @ torch.cat([torch.cat([init[:3, :3], t[:, None]], dim=1), bottom], dim=0)


def invert(pose):
    R_inv = pose[..., :3].transpose(-2, -1)
    return torch.cat([R_inv, -(R_inv @ pose[..., 3:])], dim=-1)


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------


def pixels_to_rays(px, py, intr_inv, pose):
    p = torch.stack([px, py, torch.ones_like(px)], dim=-1) @ intr_inv[:3, :3].T
    rays_v = (p / torch.linalg.norm(p, dim=-1, keepdim=True)) @ pose[:3, :3].T
    return pose[:3, 3].expand(rays_v.shape), rays_v


def random_rays(gen, scene, pose, img, B, patch, guided):
    """B rays of frame ``img`` at uniform pixels; with mask guiding, a coin
    (p = 0.7) restricts the window to the dilated mask box.  [B, 10] =
    (origin, direction, color, mask)."""
    dev = scene["images"].device
    H, W = scene["images"].shape[1:3]
    u = torch.rand((3, B), generator=gen, device=dev)
    x_lo, x_hi, y_lo, y_hi = 0, W, 0, H
    if guided:
        if torch.rand((), generator=gen, device=dev).item() < 0.7:
            y0, y1, x0, x1 = (int(v) for v in scene["bbox"][img].tolist())
            y_lo, y_hi = max(y0 - patch, 0), min(y1 + patch, H)
            x_lo, x_hi = max(x0 - patch, 0), min(x1 + patch, W)
    px = torch.clamp(x_lo + torch.floor(u[0] * (x_hi - x_lo)).long(), max=x_hi - 1)
    py = torch.clamp(y_lo + torch.floor(u[1] * (y_hi - y_lo)).long(), max=y_hi - 1)
    color = scene["images"][img, py, px]
    mask = scene["masks"][img, py, px][:, None]
    ro, rd = pixels_to_rays(px.float(), py.float(), scene["intr_inv"][img], pose)
    return torch.cat([ro, rd, color, mask], dim=-1)


def near_far(rays_o, rays_d):
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0
