"""NeuS volume renderer (port of ``fmov_pose_tpu/render/neus.py``).

Same numerics as the JAX module: sigmoid-CDF alpha
``(prev_cdf - next_cdf + 1e-5)/(prev_cdf + 1e-5)`` clipped to [0, 1], cos
annealing, the 1e-7 cumprod epsilon and the ``inv_s = 64 * 2**i``
up-sampling schedule.  The SDF-guided up-sampler runs under
``torch.no_grad()`` and queries the SDF through the fused kernel K1
(``ops/fused_sdf.py``) when the config asks for it, exactly where the JAX
``_sdf_only_fn`` does; its weights are materialised and packed once per
``render`` (``fused_sdf.FwdPack``), and the coarse query and every
``cat_z_vals`` query launch on that pack.  With an occupancy grid
(``render/occupancy.py``) one grid gather replaces the up-sampler.  ``render_core`` is the row form only (``[M, 3]``
geometry); the JAX package's channel-plane layouts exist for the TPU's
lane padding and are not ported.

``use_fused_train`` takes the JAX module's gates: at or above
``fused_sdf.MIN_SAMPLES_RAYS`` samples the SDF runs through K4/K5
(``sdf_apply_grad_fused_rays``), below it through the flat K2/K3
(``sdf_apply_grad_fused``).  With ``fused_color.MIN_SAMPLES`` the color
MLP runs through K8/K9 (``color_fused_ray``, color and composite in one)
on the rays path without a background, and through the per-sample K6/K7
(``color_fused_featfirst``) wherever else the JAX module takes them: the
flat SDF path, or the NeRF++ background, which mixes per-sample colors.
Below the gate it runs on the f32 network.

``n_outside > 0`` adds the NeRF++ background (``render_core_outside``):
the background network (``nets.nerf_apply``, f32) on the sorted union of
the inside and the outside z-values, its alpha and colors mixed into the
inside ones outside the unit sphere and its tail appended, as in the JAX
``render_core``.

Memory: the JAX step wraps the unfused SDF and color blocks in
``jax.checkpoint``; here autograd keeps the activations (a few GB at 512
rays x 128 samples, well inside an 80 GB card), so nothing is recomputed.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fmov_pose_torch.core.sampling import merge_sorted, sample_pdf
from fmov_pose_torch.fields import nets

Params = Dict[str, Any]


class RenderCfg(NamedTuple):
    n_samples: int
    n_importance: int
    n_outside: int
    up_sample_steps: int
    perturb: float


def make_render_cfg(conf: Dict[str, Any]) -> RenderCfg:
    return RenderCfg(
        n_samples=int(conf["n_samples"]),
        n_importance=int(conf["n_importance"]),
        n_outside=int(conf["n_outside"]),
        up_sample_steps=int(conf["up_sample_steps"]),
        perturb=float(conf["perturb"]),
    )


def _sdf_only_fn(model_cfg, sdf_params):
    """x [M, 3] -> sdf [M, 1] for gradient-free evaluation on ``sdf_params``:
    K1 on one pack of the weights (built here, once) when the config
    enables it and the kernel supports it, else the f32 reference."""
    sdf_cfg = model_cfg["sdf"]
    if sdf_cfg.get("use_fused", False) or sdf_cfg.get("use_fused_train", False):
        from fmov_pose_torch.ops import fused_sdf
        if fused_sdf.supported(sdf_cfg):
            pk = fused_sdf.FwdPack(sdf_params, sdf_cfg, False)
            return lambda x: fused_sdf.sdf_forward(pk, x)
    return lambda x: nets.sdf_only(sdf_params, sdf_cfg, x)


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` over the last dim with PyTorch's own backward for
    an input without zeros, the reversed cumulative sum of output x grad
    over the input (bitwise the built-in's), but without the built-in's
    test for zeros: that test reads a value back to the host, which a
    captured step (``train/graph.py``) cannot do.  The transmittance's
    factors 1 - alpha + 1e-7 (alpha <= 1) are never 0."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def _transmittance_weights(alpha: torch.Tensor) -> torch.Tensor:
    """weights = alpha * cumprod([1, 1-alpha+1e-7])[:, :-1]."""
    ones = torch.ones_like(alpha[..., :1])
    trans = _Cumprod.apply(torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1))
    return alpha * trans[..., :-1]


def _norm_sq_along(rays_o, rays_d, z):
    """|o + z d|^2 for every sample z [B, N]."""
    o2 = torch.sum(rays_o * rays_o, dim=-1, keepdim=True)
    od = torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    d2 = torch.sum(rays_d * rays_d, dim=-1, keepdim=True)
    return o2 + 2.0 * z * od + z * z * d2


def up_sample(params, model_cfg, rays_o, rays_d, z_vals, sdf, n_importance, inv_s):
    """One SDF-guided importance-sampling pass."""
    batch_size, n_samples = z_vals.shape
    radius_sq = _norm_sq_along(rays_o, rays_d, z_vals)
    inside_sphere = (radius_sq[:, :-1] < 1.0) | (radius_sq[:, 1:] < 1.0)
    sdf = sdf.reshape(batch_size, n_samples)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    # min(cos, prev_cos): robust against double-crossing sections
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights = _transmittance_weights(alpha)
    return sample_pdf(z_vals, weights, n_importance)


def cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z_vals, sdf, last: bool):
    """Merge new samples into z_vals, querying the SDF at them with the
    caller's ``sdf_fn`` (``_sdf_only_fn``) unless last."""
    batch_size, n_samples = z_vals.shape
    _, n_importance = new_z_vals.shape
    if last:
        return merge_sorted(z_vals, new_z_vals), sdf
    pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., :, None]
    new_sdf = sdf_fn(pts.reshape(-1, 3))
    new_sdf = new_sdf.reshape(batch_size, n_importance)
    return merge_sorted(z_vals, new_z_vals, sdf, new_sdf)


def _fused_train_paths(model_cfg, n_samples: int, m_total: int,
                       background: bool = False):
    """(SDF path: None, "rays" or "flat"; color path: None for the f32
    network, "ray" for K8/K9 or "sample" for K6/K7) as the JAX render_core
    picks them; ``background``: the NeRF++ background is mixed in."""
    sdf_cfg, color_cfg = model_cfg["sdf"], model_cfg["color"]
    if not sdf_cfg.get("use_fused_train", False):
        return None, None
    from fmov_pose_torch.ops import fused_color, fused_sdf
    if not fused_sdf.supported_train(sdf_cfg):
        return None, None
    sdf_path = ("rays" if fused_sdf.supported_rays(sdf_cfg, n_samples, m_total)
                else "flat")
    if not (color_cfg.get("use_fused_train", True) and fused_color.supported(color_cfg)
            and m_total >= fused_color.MIN_SAMPLES):
        return sdf_path, None
    if (sdf_path == "rays" and not background
            and fused_color.supported_ray(color_cfg, n_samples)):
        return sdf_path, "ray"
    return sdf_path, "sample"


def render_core_outside(params, model_cfg, rays_o, rays_d, z_vals, sample_dist):
    """The NeRF++ background shell: the background network at the
    mid-points, in the inverted-sphere coordinates [p / r, 1 / r] with
    r = |p| clipped to [1, 1e10]."""
    batch_size, n_samples = z_vals.shape
    dists = torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1],
         torch.full((batch_size, 1), sample_dist, dtype=z_vals.dtype,
                    device=z_vals.device)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    dis_to_center = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True),
                                1.0, 1e10)
    pts4 = torch.cat([pts / dis_to_center, 1.0 / dis_to_center], dim=-1)
    dirs = rays_d[:, None, :].expand(pts.shape)

    density, sampled_color = nets.nerf_apply(
        params["nerf"], model_cfg["nerf"], pts4.reshape(-1, 4), dirs.reshape(-1, 3))
    sampled_color = torch.sigmoid(sampled_color).reshape(batch_size, n_samples, 3)
    alpha = 1.0 - torch.exp(-F.softplus(density.reshape(batch_size, n_samples)) * dists)
    weights = _transmittance_weights(alpha)
    color = (weights[:, :, None] * sampled_color).sum(dim=1)
    return {"color": color, "sampled_color": sampled_color, "alpha": alpha,
            "weights": weights}


def render_core(params, model_cfg, rays_o, rays_d, z_vals, sample_dist,
                background_alpha=None, background_sampled_color=None,
                background_rgb=None, cos_anneal_ratio=1.0, eval_mode=False,
                eikonal_parts=False):
    """SDF -> alpha -> composite; the NeRF++ background's alpha and colors
    [B, N + n_outside] (``render_core_outside`` on the sorted union of the
    z-values) are mixed in outside the unit sphere and appended.
    ``eikonal_parts``: ``gradient_error`` is the pair (numerator,
    denominator) instead of their ratio."""
    batch_size, n_samples = z_vals.shape
    dists = torch.cat(
        [z_vals[..., 1:] - z_vals[..., :-1],
         torch.full((batch_size, 1), sample_dist, dtype=z_vals.dtype,
                    device=z_vals.device)], dim=-1)
    mid_z_vals = z_vals + dists * 0.5

    sdf_cfg = model_cfg["sdf"]
    sdf_path, color_path = _fused_train_paths(
        model_cfg, n_samples, batch_size * n_samples, background_alpha is not None)
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., :, None]
           ).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(batch_size, n_samples, 3).reshape(-1, 3)
    if sdf_path == "rays":
        from fmov_pose_torch.ops import fused_sdf
        sdf_nn, sdf_bn, gradients = fused_sdf.sdf_apply_grad_fused_rays(
            params["sdf"], sdf_cfg, pts, n_samples)
    elif sdf_path == "flat":
        from fmov_pose_torch.ops import fused_sdf
        sdf_nn, gradients = fused_sdf.sdf_apply_grad_fused(params["sdf"], sdf_cfg, pts)
        sdf_bn = sdf_nn[:, 0].reshape(batch_size, n_samples)
    else:
        sdf_nn, gradients = nets.sdf_apply_with_gradient(params["sdf"], sdf_cfg, pts)
        sdf_bn = sdf_nn[:, 0].reshape(batch_size, n_samples)
    sdf = sdf_bn.reshape(-1, 1)
    feature = sdf_nn[:, 1:]
    if eval_mode:
        gradients = gradients.detach()

    sampled_color = None  # composited in the kernel on the color-ray path
    if color_path == "sample":
        from fmov_pose_torch.ops import fused_color
        sampled_color = fused_color.color_fused_featfirst(
            params["color"], model_cfg["color"], pts, dirs, gradients, feature
        ).reshape(batch_size, n_samples, 3)
    elif color_path is None:
        sampled_color = nets.color_apply(
            params["color"], model_cfg["color"], pts, gradients, dirs, feature
        ).reshape(batch_size, n_samples, 3)

    inv_s = nets.variance_inv_s(params["variance"])
    true_cos = (dirs * gradients).sum(-1).reshape(batch_size, n_samples)
    # anneal keeps cos "alive" early in training
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)

    est_next_sdf = sdf_bn + iter_cos * dists * 0.5
    est_prev_sdf = sdf_bn - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev_sdf * inv_s)
    next_cdf = torch.sigmoid(est_next_sdf * inv_s)
    p = prev_cdf - next_cdf
    c = prev_cdf
    alpha = torch.clamp((p + 1e-5) / (c + 1e-5), 0.0, 1.0)

    pts_norm_sq = _norm_sq_along(rays_o, rays_d, mid_z_vals).detach()
    inside_sphere = (pts_norm_sq < 1.0).to(alpha.dtype)
    relax_inside_sphere = (pts_norm_sq < 1.44).to(alpha.dtype)

    if background_alpha is not None:
        alpha = (alpha * inside_sphere
                 + background_alpha[:, :n_samples] * (1.0 - inside_sphere))
        alpha = torch.cat([alpha, background_alpha[:, n_samples:]], dim=-1)
        sampled_color = (
            sampled_color * inside_sphere[:, :, None]
            + background_sampled_color[:, :n_samples] * (1.0 - inside_sphere)[:, :, None])
        sampled_color = torch.cat(
            [sampled_color, background_sampled_color[:, n_samples:]], dim=1)

    weights = _transmittance_weights(alpha)
    weights_sum = weights.sum(dim=-1, keepdim=True)
    if color_path == "ray":
        from fmov_pose_torch.ops import fused_color
        color = fused_color.color_fused_ray(
            params["color"], model_cfg["color"], sdf_nn, pts, dirs, gradients,
            weights)
    else:
        color = (sampled_color * weights[..., None]).sum(dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)

    grad_norm = torch.sqrt((gradients * gradients).sum(-1)).reshape(
        batch_size, n_samples)
    gradient_error_raw = (grad_norm - 1.0) ** 2
    eik_num = (relax_inside_sphere * gradient_error_raw).sum()
    eik_den = relax_inside_sphere.sum()
    if eikonal_parts:
        # a data-parallel caller sums both over the ranks
        gradient_error = (eik_num, eik_den)
    else:
        gradient_error = eik_num / (eik_den + 1e-5)

    return {
        "color": color,
        "sdf": sdf,
        "dists": dists,
        "gradients": gradients.reshape(batch_size, n_samples, 3),
        "s_val": 1.0 / inv_s,
        "mid_z_vals": mid_z_vals,
        "weights": weights,
        "cdf": c,
        "gradient_error": gradient_error,
        "inside_sphere": inside_sphere,
        "pts": pts,
    }


def render(generator, params, model_cfg, rays_o, rays_d, near, far,
           perturb_overwrite: float = -1.0, background_rgb=None,
           cos_anneal_ratio: float = 1.0, eval_mode: bool = False,
           occ_grid=None, eikonal_parts: bool = False):
    """Full hierarchical render; returns the JAX module's output dict.

    ``generator``: the ``torch.Generator`` for the stratified perturbation
    (unused when the perturbation is 0): the inside draw [B, 1], then the
    outside one [B, n_outside].  ``occ_grid``: an occupancy grid
    [R, R, R] that places the importance samples instead of the SDF-guided
    up-sampler.  ``eikonal_parts``: ``gradient_error`` is (numerator,
    denominator), the JAX ``eikonal_parts``, for a data-parallel caller."""
    cfg: RenderCfg = model_cfg["renderer"]
    batch_size = rays_o.shape[0]
    dev = rays_o.device
    sample_dist = 2.0 / cfg.n_samples
    z_lin = torch.linspace(0.0, 1.0, cfg.n_samples, device=dev)
    z_vals = near + (far - near) * z_lin[None, :]

    z_vals_outside = None
    if cfg.n_outside > 0:
        z_vals_outside = torch.linspace(
            1e-3, 1.0 - 1.0 / (cfg.n_outside + 1.0), cfg.n_outside, device=dev)

    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    if perturb > 0:
        t_rand = torch.rand((batch_size, 1), generator=generator, device=dev) - 0.5
        z_vals = z_vals + t_rand * 2.0 / cfg.n_samples
        if cfg.n_outside > 0:
            mids = 0.5 * (z_vals_outside[1:] + z_vals_outside[:-1])
            upper = torch.cat([mids, z_vals_outside[-1:]])
            lower = torch.cat([z_vals_outside[:1], mids])
            t_rand2 = torch.rand((batch_size, cfg.n_outside), generator=generator,
                                 device=dev)
            z_vals_outside = lower[None, :] + (upper - lower)[None, :] * t_rand2

    if cfg.n_outside > 0:
        z_vals_outside = far / torch.flip(torch.atleast_2d(z_vals_outside),
                                          dims=[-1]) + 1.0 / cfg.n_samples

    background_alpha = None
    background_sampled_color = None

    n_samples_total = cfg.n_samples
    if cfg.n_importance > 0 and occ_grid is not None:
        # one grid gather instead of the up-sampler's SDF passes
        from fmov_pose_torch.render import occupancy
        z_vals = occupancy.occupancy_importance(
            occ_grid, rays_o.detach(), rays_d.detach(), z_vals.detach(),
            cfg.n_importance)
        n_samples_total = cfg.n_samples + cfg.n_importance
    elif cfg.n_importance > 0:
        # SDF-guided up-sampling is gradient-free
        with torch.no_grad():
            z_vals = z_vals.detach()
            ro, rd = rays_o.detach(), rays_d.detach()
            sdf_fn = _sdf_only_fn(model_cfg, params["sdf"])
            pts = ro[:, None, :] + rd[:, None, :] * z_vals[..., :, None]
            sdf = sdf_fn(pts.reshape(-1, 3))
            sdf = sdf.reshape(batch_size, cfg.n_samples)
            for i in range(cfg.up_sample_steps):
                new_z = up_sample(
                    params, model_cfg, ro, rd, z_vals, sdf,
                    cfg.n_importance // cfg.up_sample_steps, 64.0 * 2 ** i)
                z_vals, sdf = cat_z_vals(
                    sdf_fn, ro, rd, z_vals, new_z, sdf,
                    last=(i + 1 == cfg.up_sample_steps))
        n_samples_total = cfg.n_samples + cfg.n_importance

    if cfg.n_outside > 0:
        z_vals_feed = torch.sort(torch.cat(
            [z_vals, z_vals_outside.expand(batch_size, cfg.n_outside)], dim=-1),
            dim=-1).values
        ret_outside = render_core_outside(
            params, model_cfg, rays_o, rays_d, z_vals_feed, sample_dist)
        background_sampled_color = ret_outside["sampled_color"]
        background_alpha = ret_outside["alpha"]

    ret_fine = render_core(
        params, model_cfg, rays_o, rays_d, z_vals, sample_dist,
        background_alpha=background_alpha,
        background_sampled_color=background_sampled_color,
        background_rgb=background_rgb, cos_anneal_ratio=cos_anneal_ratio,
        eval_mode=eval_mode, eikonal_parts=eikonal_parts)

    weights = ret_fine["weights"]
    weights_sum = weights.sum(dim=-1, keepdim=True)
    s_val = ret_fine["s_val"].expand(batch_size, n_samples_total).mean(
        dim=-1, keepdim=True)
    depth_fine = (weights[:, :n_samples_total] * ret_fine["mid_z_vals"]).sum(
        dim=-1, keepdim=True)

    return {
        "color_fine": ret_fine["color"],
        "depth_fine": depth_fine,
        "s_val": s_val,
        "cdf_fine": ret_fine["cdf"],
        "weight_sum": weights_sum,
        "weight_max": torch.max(weights, dim=-1, keepdim=True).values,
        "gradients": ret_fine["gradients"],
        "weights": weights,
        "gradient_error": ret_fine["gradient_error"],
        "inside_sphere": ret_fine["inside_sphere"],
        "pts": ret_fine["pts"],
    }
