"""Training steps: ray gen -> render -> losses -> gated flat Adams (port of
``fmov_pose_tpu/train/step.py``: the photometric and the flow step).

The JAX module compiles pure steps over an immutable ``TrainState``.
Here a step runs eagerly and updates the state in place: the flat
parameter buffer, the flat segment bank and their Adam moments are
rewritten, never copied.  Randomness comes from the ``torch.Generator``
the state carries.

Per-step scalars: the host plans every step (``pack_scalars_np``, the JAX
row of 9 + 3S floats).  The scalars the host uses stay host floats and
ints (learning rate, gates, frame ids), so they cost no device sync; the
per-segment touch, freeze and learning-rate vectors go to the device as
one row, copied from pinned host memory without blocking
(``to_device_async``), and so does a flow step's batch of match pixels.
A pageable copy would stall the stream until the device caught up.

Pose modes: ``seg`` (the segment bank of phase 1), ``gf`` (one global
Gaussian-Fourier pose net), ``se3`` (BARF refinement) and ``fixed`` (GT
poses); the SDF-guided up-sampler or the occupancy grid (``occ_grid`` in
``pose_static``).  ``maintain_shape`` adds a second frame's ray batch to
every step.  The scanned and planned multi-step forms and ``seg_pixel``
are not ported (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
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
    """flat: every trainable field (and gf/se3 pose) leaf raveled in
    ``layout`` order (requires grad); ``params`` are views of it.
    pose_static: buffers of the pose mode (gf bands and init poses, se3
    noise poses, GT poses, the occupancy grid).  Seg mode: the bank's
    trainable leaves raveled in ``bank_flat`` (``bank_layout`` order,
    requires grad), its static buffers ``bank_static`` (bands, init
    poses, the host ``initialized`` flags) and the segment Adam
    ``pose_opt``."""
    flat: torch.Tensor
    layout: convert.ParamLayout
    opt: optim.AdamState
    pose_static: Dict[str, torch.Tensor]
    generator: torch.Generator
    iter_step: int = 0
    bank_flat: Optional[torch.Tensor] = None
    bank_layout: Optional[convert.ParamLayout] = None
    bank_static: Optional[Dict[str, Any]] = None
    pose_opt: Optional[optim.SegAdamState] = None

    @property
    def params(self):
        return self.layout.views(self.flat)

    @property
    def pose_bank(self):
        """The segment bank {"train": views of bank_flat, "static"}, or {}."""
        if self.bank_flat is None:
            return {}
        return {"train": self.bank_layout.views(self.bank_flat),
                "static": self.bank_static}


@dataclass
class StepConfig:
    """Static configuration of a training step."""
    batch_size: int
    H: int
    W: int
    pose_mode: str                  # "seg" | "gf" | "se3" | "fixed"
    n_segments: int = 1
    segment_img_num: int = 1
    pose_cfg: pp.PoseCfg = pp.PoseCfg()
    igr_weight: float = 0.1
    mask_weight: float = 0.0
    flow_weight: float = 0.0
    unit_sphere_weight: float = 0.0
    use_white_bkgd: bool = False
    mask_guided_sampling: bool = False
    mask_guided_patch_size: int = 30
    maintain_shape: bool = False
    detach_ref: bool = False
    detach_flow_on_sdf: bool = False
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
    seg_touch: Optional[np.ndarray] = None   # [S] segments whose Adams step
    seg_freeze: Optional[np.ndarray] = None  # [S] 1 = trainable, 0 = frozen
    seg_lr: Optional[np.ndarray] = None      # [S] per-segment LR


N_SCALAR_FIELDS = 9


def pack_scalars_np(lr, cos_anneal, main_update, pose_update, mask_guided,
                    trans_head_on, img_id, add_img_id, img_id_corr,
                    seg_touch, seg_freeze, seg_lr) -> np.ndarray:
    """One f32 row of a step's host decisions, the JAX module's layout:
    9 scalars (frame ids exact below 2^24), then touch, freeze and LR [S]."""
    head = np.array([lr, cos_anneal, main_update, pose_update, mask_guided,
                     trans_head_on, img_id, add_img_id, img_id_corr], np.float32)
    return np.concatenate([head, np.asarray(seg_touch, np.float32),
                           np.asarray(seg_freeze, np.float32),
                           np.asarray(seg_lr, np.float32)])


def unpack_scalars_np(packed: np.ndarray, n_segments: int):
    """-> (StepScalars, img_id, add_img_id, img_id_corr), on the host."""
    k, s = N_SCALAR_FIELDS, n_segments
    h = [float(v) for v in packed[:6]]
    scalars = StepScalars(
        lr=h[0], cos_anneal=h[1], main_update=h[2], pose_update=h[3],
        mask_guided=h[4], trans_head_on=h[5], seg_touch=packed[k:k + s],
        seg_freeze=packed[k + s:k + 2 * s], seg_lr=packed[k + 2 * s:k + 3 * s])
    img_id, add_img_id, img_id_corr = (int(v) for v in packed[6:9])
    return scalars, img_id, add_img_id, img_id_corr


def to_device_async(arr, device) -> torch.Tensor:
    """A host f32 array on ``device``: on CUDA staged in fresh pinned
    memory and copied without blocking the host (PyTorch's pinned
    allocator does not hand the block out again before the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    if torch.device(device).type != "cuda":
        return t.to(device)
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


def pose_of_frame(cfg: StepConfig, params, pose_bank, pose_static, cam_id: int):
    """c2w [3, 4] of frame ``cam_id`` (a host int) under the pose model."""
    if cfg.pose_mode == "seg":
        return pp.seg_apply(pose_bank, cfg.pose_cfg, cfg.segment_img_num, cam_id)
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
        f"pose_mode {cfg.pose_mode!r}: seg_pixel is ROADMAP queue 1, item 8")


def _render_and_losses(cfg: StepConfig, generator, params, pose_static, data,
                       scalars: StepScalars, flow_ctx=None, pose_bank=None):
    """Render a ray batch and assemble the objective: color, eikonal,
    mask, unit-sphere and, given ``flow_ctx``, the flow loss."""
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

    flow_loss = zero
    if flow_ctx is not None:
        flow_loss = _flow_loss(cfg, params, pose_bank, pose_static, out, flow_ctx)

    total = (color_loss + eikonal_loss * cfg.igr_weight
             + mask_loss * cfg.mask_weight + unit_sphere_loss + flow_loss)

    metrics = {
        "loss": total, "color_loss": color_loss, "eikonal_loss": eikonal_loss,
        "mask_loss": mask_loss, "flow_loss": flow_loss,
        "unit_sphere_loss": unit_sphere_loss, "depth_loss": zero,
        "psnr": psnr,
        "s_val": out["s_val"].mean(),
        "cdf": (out["cdf_fine"][:, :1] * mask).sum() / mask_sum,
        "weight_max": (out["weight_max"] * mask).sum() / mask_sum,
    }
    return total, metrics


def _project_to_pixels(pts, c2w, K):
    """World pts [N, 3] -> pixel coords [N, 2] through a 3x4 c2w."""
    w2c = posealg.invert(c2w)
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ K[:3, :3].T
    return pix[:, :2] / pix[:, 2:]


def _flow_loss(cfg: StepConfig, params, pose_bank, pose_static, render_out,
               flow_ctx):
    """Bidirectional expected-pixel reprojection loss: each half-batch's
    weighted samples projected into the other frame against its matches."""
    img_id, img_id_corr, pixels_xy, pixels_xy_corr, K0, K1 = flow_ctx
    n_rays = render_out["weights"].shape[0]
    pts = render_out["pts"].reshape(n_rays, -1, 3)
    n_samples = pts.shape[1]
    weights = render_out["weights"][:, :n_samples]
    if cfg.detach_flow_on_sdf:
        weights = weights.detach()

    B2 = pixels_xy.shape[0]
    pts0, pts1 = pts[:B2].reshape(-1, 3), pts[B2:2 * B2].reshape(-1, 3)
    w0, w1 = weights[:B2], weights[B2:2 * B2]

    c2w_1 = pose_of_frame(cfg, params, pose_bank, pose_static, img_id)
    c2w_0 = pose_of_frame(cfg, params, pose_bank, pose_static, img_id_corr)
    if cfg.detach_ref:
        c2w_1, c2w_0 = c2w_1.detach(), c2w_0.detach()

    # corr-frame surface points -> frame img_id's pixels vs match pixels
    pix0 = _project_to_pixels(pts0, c2w_1, K1).reshape(B2, n_samples, 2)
    err0 = ((pix0 - pixels_xy[:, None, :]) * w0[:, :, None]).sum(dim=1)
    # img_id-frame surface points -> corr frame's pixels vs match pixels
    pix1 = _project_to_pixels(pts1, c2w_0, K0).reshape(B2, n_samples, 2)
    err1 = ((pix1 - pixels_xy_corr[:, None, :]) * w1[:, :, None]).sum(dim=1)
    return (torch.abs(err0).mean() + torch.abs(err1).mean()) * cfg.flow_weight


def intr_inv_all_K(intr_inv_all, idx):
    """K [3, 3] of frame ``idx`` from the stored inverse intrinsics
    (``inv_ex``: no error check, so no device sync)."""
    return torch.linalg.inv_ex(intr_inv_all[idx][:3, :3]).inverse


def _flat_gate_masks(layout: convert.ParamLayout, device):
    """0/1 vectors over the flat order: (pose-or-se3 leaves, pose
    lin3_trans, pose lin3_scale)."""
    return (layout.mask(lambda n: n.split(".")[0] in ("pose", "se3_refine"), device),
            layout.mask(lambda n: n.startswith("pose.lin3_trans."), device),
            layout.mask(lambda n: n.startswith("pose.lin3_scale."), device))


def _flat_bank_masks(layout: convert.ParamLayout, device):
    """(lin3_trans, lin3_scale) 0/1 vectors over the flat bank order, and
    the segment index of every position (``optim.seg_index``)."""
    return (layout.mask(lambda n: n.startswith("lin3_trans."), device),
            layout.mask(lambda n: n.startswith("lin3_scale."), device),
            optim.seg_index(layout.shapes, device))


def _apply_updates(cfg: StepConfig, state: TrainState, flat_g, scalars: StepScalars,
                   masks, bank_g=None, bank_masks=None, seg_row=None):
    """Gate the flat gradient and take one Adam step; in seg mode also the
    segment Adams.  The gates are exact 0/1 values: main_update zeroes the
    gradient but still steps (moment drift); pose leaves use the pose
    gate, which is also 0 whenever main_update is; with emphasize_rot the
    lin3_trans head never moves and lin3_scale follows trans_head_on.
    Bank positions take their segment's freeze gate times pose_update;
    ``seg_row`` [3, S] on the device is (touch, freeze, lr)."""
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

    if cfg.pose_mode == "seg":
        m_trans, m_scale, idx = bank_masks
        touch, freeze, seg_lr = seg_row
        gate_b = ((freeze * scalars.pose_update)[idx] * (1.0 - m_trans)
                  * ((1.0 - m_scale) + scalars.trans_head_on * m_scale))
        optim.seg_adam_update_flat_(bank_g * gate_b, state.pose_opt, state.bank_flat,
                                    touch, seg_lr, idx)


def _seg_row(cfg: StepConfig, scalars: StepScalars, device):
    """The step's (touch, freeze, lr) [3, S] on the device (seg mode)."""
    if cfg.pose_mode != "seg":
        return None
    return to_device_async(np.stack([scalars.seg_touch, scalars.seg_freeze,
                                     scalars.seg_lr]), device)


def _step_and_update(cfg: StepConfig, state: TrainState, scalars: StepScalars,
                     loss_of, cache: dict):
    """Gradients of ``loss_of(params, pose_bank)`` in the flat buffers and
    the gated updates; returns the detached metrics."""
    dev = state.flat.device
    seg_row = _seg_row(cfg, scalars, dev)  # its copy overlaps the forward
    if "m" not in cache:
        cache["m"] = _flat_gate_masks(state.layout, dev)
        if cfg.pose_mode == "seg":
            cache["b"] = _flat_bank_masks(state.bank_layout, dev)
    with torch.enable_grad():
        loss, metrics = loss_of(state.params, state.pose_bank)
        if cfg.pose_mode == "seg":
            flat_g, bank_g = torch.autograd.grad(loss, [state.flat, state.bank_flat])
        else:
            (flat_g,), bank_g = torch.autograd.grad(loss, state.flat), None
    _apply_updates(cfg, state, flat_g, scalars, cache["m"], bank_g, cache.get("b"),
                   seg_row)
    state.iter_step += 1
    return {k: v.detach() for k, v in metrics.items()}


def _maintain_rays(cfg, state, images, masks, intr_inv_all, bbox_table, params,
                   pose_bank, add_img_id, scalars, add_pixels):
    """The maintain_shape batch: random rays of frame ``add_img_id``."""
    pose_a = pose_of_frame(cfg, params, pose_bank, state.pose_static, add_img_id)
    return raygen.gen_random_rays(
        state.generator, images, masks, intr_inv_all, pose_a, add_img_id,
        cfg.batch_size, bbox_table, cfg.mask_guided_patch_size,
        cfg.mask_guided_sampling, cfg.H, cfg.W,
        mask_guided_active=scalars.mask_guided, pixels=add_pixels)


def make_photo_loss(cfg: StepConfig, images, masks, intr_inv_all, bbox_table):
    """The photometric loss closure used by make_photo_step."""

    def loss_fn(params, state: TrainState, img_id, scalars, pixels=None,
                add_img_id=0, add_pixels=None, pose_bank=None):
        pose0 = pose_of_frame(cfg, params, pose_bank, state.pose_static, img_id)
        data = raygen.gen_random_rays(
            state.generator, images, masks, intr_inv_all, pose0, img_id,
            cfg.batch_size, bbox_table, cfg.mask_guided_patch_size,
            cfg.mask_guided_sampling, cfg.H, cfg.W,
            mask_guided_active=scalars.mask_guided, pixels=pixels)
        if cfg.maintain_shape:
            data = torch.cat([data, _maintain_rays(
                cfg, state, images, masks, intr_inv_all, bbox_table, params,
                pose_bank, add_img_id, scalars, add_pixels)], dim=0)
        return _render_and_losses(cfg, state.generator, params,
                                  state.pose_static, data, scalars,
                                  pose_bank=pose_bank)

    return loss_fn


def make_photo_step(cfg: StepConfig, images, masks, intr_inv_all, bbox_table):
    """Photometric step ``step(state, scalars, img_id, add_img_id=0,
    pixels=None, add_pixels=None) -> (state, metrics)``; ``pixels`` /
    ``add_pixels`` replace the random pixel draws of the frame's and the
    maintain_shape batch with given (px, py) ids.  Updates in place."""
    loss_fn = make_photo_loss(cfg, images, masks, intr_inv_all, bbox_table)
    cache = {}

    def run_one(state: TrainState, scalars: StepScalars, img_id, add_img_id=0,
                pixels=None, add_pixels=None):
        metrics = _step_and_update(
            cfg, state, scalars,
            lambda params, bank: loss_fn(params, state, img_id, scalars, pixels,
                                         add_img_id, add_pixels, bank),
            cache)
        return state, metrics

    return run_one


def make_flow_step(cfg: StepConfig, images, masks, intr_inv_all, bbox_table):
    """Flow-pair step ``step(state, scalars, img_id, img_id_corr,
    add_img_id, pixels_pair, add_pixels=None) -> (state, metrics)``: half
    a batch of rays through the matched pixels of each frame (pixels_pair
    [B/2, 4] = (x, y) in img_id_corr, (x, y) in img_id; host numpy or a
    tensor), plus the maintain_shape batch.  Updates in place."""
    K_all = torch.linalg.inv_ex(intr_inv_all[:, :3, :3]).inverse  # once
    cache = {}

    def loss_fn(params, pose_bank, state, img_id, img_id_corr, add_img_id,
                pixels_xy, pixels_xy_corr, scalars, add_pixels):
        pose_corr = pose_of_frame(cfg, params, pose_bank, state.pose_static,
                                  img_id_corr)
        pose1 = pose_of_frame(cfg, params, pose_bank, state.pose_static, img_id)
        ro_c, rv_c = raygen.gen_flow_rays(pixels_xy_corr, intr_inv_all[img_id_corr],
                                          pose_corr)
        ro_1, rv_1 = raygen.gen_flow_rays(pixels_xy, intr_inv_all[img_id], pose1)
        col_c = raygen.gather_rgb(images, img_id_corr, pixels_xy_corr[:, 1].long(),
                                  pixels_xy_corr[:, 0].long())
        col_1 = raygen.gather_rgb(images, img_id, pixels_xy[:, 1].long(),
                                  pixels_xy[:, 0].long())
        ones = torch.ones((pixels_xy.shape[0], 1), device=pixels_xy.device)
        data = torch.cat([torch.cat([ro_c, rv_c, col_c, ones], dim=-1),
                          torch.cat([ro_1, rv_1, col_1, ones], dim=-1)], dim=0)
        if cfg.maintain_shape:
            data = torch.cat([data, _maintain_rays(
                cfg, state, images, masks, intr_inv_all, bbox_table, params,
                pose_bank, add_img_id, scalars, add_pixels)], dim=0)
        flow_ctx = (img_id, img_id_corr, pixels_xy, pixels_xy_corr,
                    K_all[img_id_corr], K_all[img_id])
        return _render_and_losses(cfg, state.generator, params, state.pose_static,
                                  data, scalars, flow_ctx=flow_ctx,
                                  pose_bank=pose_bank)

    def run_one(state: TrainState, scalars: StepScalars, img_id, img_id_corr,
                add_img_id, pixels_pair, add_pixels=None):
        if not isinstance(pixels_pair, torch.Tensor):
            pixels_pair = to_device_async(pixels_pair, state.flat.device)
        pixels_xy_corr, pixels_xy = pixels_pair[:, 0:2], pixels_pair[:, 2:4]
        metrics = _step_and_update(
            cfg, state, scalars,
            lambda params, bank: loss_fn(params, bank, state, img_id, img_id_corr,
                                         add_img_id, pixels_xy, pixels_xy_corr,
                                         scalars, add_pixels),
            cache)
        return state, metrics

    return run_one
