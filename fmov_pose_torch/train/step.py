"""Training step: ray gen -> render -> losses -> gated flat Adam (port of
``fmov_pose_tpu/train/step.py:40-463``, the photometric step).

The JAX module compiles a pure step over an immutable ``TrainState``.
Here the step runs eagerly and updates the state in place: the flat
parameter buffer and the Adam moments are rewritten, never copied.
Randomness comes from the ``torch.Generator`` the state carries.  Per-step
scalars are host floats, so gating costs no device sync.

The port covers the pose modes ``gf`` (one global Gaussian-Fourier pose
net), ``se3`` (BARF refinement) and ``fixed`` (GT poses), with the
SDF-guided up-sampler or the occupancy grid (``occ_grid`` in
``pose_static``, as in the JAX step).  The flow step,
the segment banks and the scanned and planned multi-step forms are later
slices (ROADMAP queue 1, items 8-9).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple

import torch

from fmov_pose_torch import convert
from fmov_pose_torch.core import lie
from fmov_pose_torch.core import pose as posealg
from fmov_pose_torch.data import rays as raygen
from fmov_pose_torch.poses import picture_pose as pp
from fmov_pose_torch.render import neus
from fmov_pose_torch.train import optim


@dataclass
class TrainState:
    """flat: every trainable leaf raveled in ``layout`` order (requires
    grad); ``params`` are views of it.  pose_static: buffers of the pose
    mode (gf bands and init poses, se3 noise poses, GT poses)."""
    flat: torch.Tensor
    layout: convert.ParamLayout
    opt: optim.AdamState
    pose_static: Dict[str, torch.Tensor]
    generator: torch.Generator
    iter_step: int = 0

    @property
    def params(self):
        return self.layout.views(self.flat)


@dataclass
class StepConfig:
    """Static configuration of a training step."""
    batch_size: int
    H: int
    W: int
    pose_mode: str                  # "gf" | "se3" | "fixed"
    pose_cfg: pp.PoseCfg = pp.PoseCfg()
    igr_weight: float = 0.1
    mask_weight: float = 0.0
    unit_sphere_weight: float = 0.0
    use_white_bkgd: bool = False
    mask_guided_sampling: bool = False
    mask_guided_patch_size: int = 30
    only_rotation: bool = False
    occupancy_sampling: bool = False  # importance samples from pose_static["occ_grid"]
    model_cfg: Dict[str, Any] = field(default=None)


def make_step_config(model_cfg, **kw) -> StepConfig:
    return StepConfig(model_cfg=model_cfg, **kw)


class StepScalars(NamedTuple):
    """Per-iteration inputs computed on the host."""
    lr: float                # main Adam LR this step
    cos_anneal: float
    main_update: float = 1.0     # 0/1: detach_mesh_at_warm_up gate
    pose_update: float = 1.0     # 0/1: pose nets frozen (mesh warm-up)
    mask_guided: float = 1.0     # 0/1: bbox-guided pixel sampling active
    trans_head_on: float = 1.0   # 0/1: scale-head gate (disable_trans)


def pose_of_frame(cfg: StepConfig, params, pose_static, cam_id):
    """c2w [3, 4] of a frame under the configured pose model."""
    if cfg.pose_mode == "gf":
        return pp.gf_apply({"train": params["pose"], "static": pose_static},
                           cfg.pose_cfg, cam_id)
    if cfg.pose_mode == "se3":
        refine = lie.se3_exp(params["se3_refine"][cam_id],
                             only_rot=cfg.only_rotation)
        return posealg.compose_pair(refine, pose_static["noise_poses"][cam_id, :3])
    if cfg.pose_mode == "fixed":
        return pose_static["pose_all"][cam_id, :3]
    raise NotImplementedError(
        f"pose_mode {cfg.pose_mode!r}: segment pose banks are ROADMAP "
        "queue 1, item 8")


def _render_and_losses(cfg: StepConfig, generator, params, pose_static, data,
                       scalars: StepScalars):
    """Render a ray batch and assemble the photometric objective."""
    rays_o, rays_d = data[:, :3], data[:, 3:6]
    true_rgb, mask = data[:, 6:9], data[:, 9:10]
    near, far = raygen.near_far_from_sphere(rays_o, rays_d)
    background_rgb = (torch.ones((1, 3), device=data.device)
                      if cfg.use_white_bkgd else None)

    if cfg.mask_weight > 0.0:
        mask = (mask > 0.5).to(torch.float32)
    else:
        mask = torch.ones_like(mask)
    mask_sum = mask.sum() + 1e-5
    n_rays = float(rays_o.shape[0])

    render_params = {k: v for k, v in params.items()
                     if k in ("sdf", "color", "nerf", "variance")}
    occ_grid = pose_static.get("occ_grid") if cfg.occupancy_sampling else None
    out = neus.render(generator, render_params, cfg.model_cfg, rays_o, rays_d,
                      near, far, background_rgb=background_rgb,
                      cos_anneal_ratio=scalars.cos_anneal, occ_grid=occ_grid)

    color_fine = out["color_fine"]
    color_error = (color_fine - true_rgb) * mask
    color_loss = torch.abs(color_error).sum() / mask_sum
    psnr = 20.0 * torch.log10(
        1.0 / torch.sqrt(((color_fine - true_rgb) ** 2 * mask).sum()
                         / (mask_sum * 3.0)))

    eikonal_loss = out["gradient_error"]

    w_sum = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(mask * torch.log(w_sum) + (1.0 - mask) * torch.log(1.0 - w_sum))
    mask_loss = bce.sum() / n_rays

    zero = torch.zeros((), device=data.device)
    unit_sphere_loss = zero
    if cfg.unit_sphere_weight > 0:
        pts = out["pts"]
        weights_flat = out["weights"][:, :pts.shape[0] // rays_o.shape[0]]
        outside = (torch.linalg.norm(pts, dim=-1) > 1.0).to(
            torch.float32).reshape(weights_flat.shape)
        unit_sphere_loss = ((torch.abs(weights_flat) * outside).sum()
                            / (outside.sum() + 1e-8) * cfg.unit_sphere_weight)

    total = (color_loss + eikonal_loss * cfg.igr_weight
             + mask_loss * cfg.mask_weight + unit_sphere_loss)

    metrics = {
        "loss": total, "color_loss": color_loss, "eikonal_loss": eikonal_loss,
        "mask_loss": mask_loss, "flow_loss": zero,
        "unit_sphere_loss": unit_sphere_loss, "depth_loss": zero,
        "psnr": psnr,
        "s_val": out["s_val"].mean(),
        "cdf": (out["cdf_fine"][:, :1] * mask).sum() / mask_sum,
        "weight_max": (out["weight_max"] * mask).sum() / mask_sum,
    }
    return total, metrics


def _flat_gate_masks(layout: convert.ParamLayout, device):
    """0/1 vectors over the flat order: (pose-or-se3 leaves, pose
    lin3_trans, pose lin3_scale)."""
    return (layout.mask(lambda n: n.split(".")[0] in ("pose", "se3_refine"), device),
            layout.mask(lambda n: n.startswith("pose.lin3_trans."), device),
            layout.mask(lambda n: n.startswith("pose.lin3_scale."), device))


def _apply_updates(cfg: StepConfig, state: TrainState, flat_g, scalars: StepScalars,
                   masks):
    """Gate the flat gradient and take one Adam step.  The gates are exact
    0/1 values: main_update zeroes the gradient but still steps (moment
    drift); pose leaves use the pose gate, which is also 0 whenever
    main_update is; with emphasize_rot the lin3_trans head never moves and
    lin3_scale follows trans_head_on."""
    if cfg.pose_mode in ("gf", "se3"):
        m_pose, m_trans, m_scale = masks
        pose_gate = scalars.pose_update if scalars.main_update > 0 else 0.0
        gate = scalars.main_update * (1.0 - m_pose) + pose_gate * m_pose
        if cfg.pose_mode == "gf" and cfg.pose_cfg.emphasize_rot:
            gate = (gate * (1.0 - m_trans - m_scale)
                    + pose_gate * scalars.trans_head_on * m_scale)
        flat_g = flat_g * gate
    else:
        flat_g = flat_g * scalars.main_update
    optim.adam_update_flat_(flat_g, state.opt, state.flat, scalars.lr)


def make_photo_loss(cfg: StepConfig, images, masks, intr_inv_all, bbox_table):
    """The photometric loss closure used by make_photo_step."""

    def loss_fn(params, state: TrainState, img_id, scalars, pixels=None):
        pose0 = pose_of_frame(cfg, params, state.pose_static, img_id)
        data = raygen.gen_random_rays(
            state.generator, images, masks, intr_inv_all, pose0, img_id,
            cfg.batch_size, bbox_table, cfg.mask_guided_patch_size,
            cfg.mask_guided_sampling, cfg.H, cfg.W,
            mask_guided_active=scalars.mask_guided, pixels=pixels)
        return _render_and_losses(cfg, state.generator, params,
                                  state.pose_static, data, scalars)

    return loss_fn


def make_photo_step(cfg: StepConfig, images, masks, intr_inv_all, bbox_table):
    """Photometric step ``step(state, scalars, img_id, add_img_id=0,
    pixels=None) -> (state, metrics)``; ``pixels`` replaces the random
    pixel draw with given (px, py) ids.  The state is updated in place."""
    loss_fn = make_photo_loss(cfg, images, masks, intr_inv_all, bbox_table)
    gate_masks = {}

    def run_one(state: TrainState, scalars: StepScalars, img_id, add_img_id=0,
                pixels=None):
        del add_img_id  # maintain_shape rays are slice 3
        if "m" not in gate_masks:
            gate_masks["m"] = _flat_gate_masks(state.layout, state.flat.device)
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, state, img_id, scalars, pixels)
            (flat_g,) = torch.autograd.grad(loss, state.flat)
        _apply_updates(cfg, state, flat_g, scalars, gate_masks["m"])
        state.iter_step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return run_one

