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

Pose modes: ``seg`` (the segment bank of phase 1), ``seg_pixel`` (its
bank of deep pose nets, ``model.pixel_level``), ``gf`` (one global
Gaussian-Fourier pose net), ``se3`` (BARF refinement) and ``fixed`` (GT
poses); the SDF-guided up-sampler or the occupancy grid (``occ_grid`` in
``pose_static``).  ``maintain_shape`` adds a second frame's ray batch to
every step.

The scanned form (``ScanPhotoSteps``, the JAX ``make_scan_photo_steps``)
plans nothing on the host: the schedule comes from a device iteration
count (``make_device_scalars``), the frame from the state's generator,
the Adam bias corrections from a device step count, and on CUDA one step
is a captured graph replayed k times a chunk.  The planned form
(``PlannedSteps``, the JAX ``make_planned_steps``) keeps the host's plan:
a chunk's packed rows and match pixels go to the device in one copy, and
on CUDA the photo and the flow step are captured graphs that read their
row there (``unpack_scalars_dev``), replayed row by row as the plan says.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from fmov_pose_torch import convert
from fmov_pose_torch.core import lie
from fmov_pose_torch.core import pose as posealg
from fmov_pose_torch.data import rays as raygen
from fmov_pose_torch.poses import picture_pose as pp
from fmov_pose_torch.poses import pixel_pose as px
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
    ``pose_opt``.  ``ray_generator``: under data parallelism
    (``parallel/dp.py``) this rank's own generator for its rays and render
    perturbation, while ``generator`` stays the one every rank shares (the
    scanned steps' frame draws); None elsewhere, where ``generator``
    draws everything."""
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
    ray_generator: Optional[torch.Generator] = None

    @property
    def rays_generator(self) -> torch.Generator:
        """The generator of the ray draws and the render's perturbation."""
        return self.generator if self.ray_generator is None else self.ray_generator

    def generators(self):
        """Every generator a step draws from (a captured step registers
        each)."""
        return [self.generator] + ([] if self.ray_generator is None else [self.ray_generator])

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
    pose_mode: str                  # "seg" | "seg_pixel" | "gf" | "se3" | "fixed"
    n_segments: int = 1
    segment_img_num: int = 1
    pose_cfg: pp.PoseCfg = pp.PoseCfg()
    igr_weight: float = 0.1
    mask_weight: float = 0.0
    flow_weight: float = 0.0
    depth_weight: float = 0.0           # > 0 only with depth maps (the Runner's rule)
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
    deep_pose_cfg: Any = None       # pixel_pose.DeepPoseCfg of "seg_pixel"


# the pose modes of a segment bank (``TrainState.bank_flat``, segment Adam)
BANK_MODES = ("seg", "seg_pixel")


def make_step_config(model_cfg, **kw) -> StepConfig:
    return StepConfig(model_cfg=model_cfg, **kw)


class StepScalars(NamedTuple):
    """Per-iteration inputs: host floats planned by the per-step loop, or
    0-d device tensors on the scanned steps (``make_device_scalars``) and
    the planned steps (``unpack_scalars_dev``)."""
    lr: float                # main Adam LR this step
    cos_anneal: float
    main_update: float = 1.0     # 0/1: detach_mesh_at_warm_up gate
    pose_update: float = 1.0     # 0/1: pose nets frozen (mesh warm-up)
    mask_guided: float = 1.0     # 0/1: bbox-guided pixel sampling active
    trans_head_on: float = 1.0   # 0/1: scale-head gate (disable_trans)
    seg_touch: Any = None    # [S] segments whose Adams step
    seg_freeze: Any = None   # [S] 1 = trainable, 0 = frozen
    seg_lr: Any = None       # [S] per-segment LR


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


def unpack_scalars_dev(packed: torch.Tensor, n_segments: int):
    """``unpack_scalars_np`` of a row on the device, reading nothing back:
    0-d f32 scalars, the frame ids as int64 tensors of one element, the
    segment vectors as views of the row."""
    k, s = N_SCALAR_FIELDS, n_segments
    scalars = StepScalars(
        lr=packed[0], cos_anneal=packed[1], main_update=packed[2],
        pose_update=packed[3], mask_guided=packed[4], trans_head_on=packed[5],
        seg_touch=packed[k:k + s], seg_freeze=packed[k + s:k + 2 * s],
        seg_lr=packed[k + 2 * s:k + 3 * s])
    ids = packed[6:9].to(torch.int64)
    return scalars, ids[0:1], ids[1:2], ids[2:3]


def _pinned(arr) -> torch.Tensor:
    """A host f32 array in fresh pinned memory (PyTorch's pinned allocator
    does not hand the block out again before a copy from it is done)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return pinned.copy_(t)


def copy_to_device_async_(dst: torch.Tensor, arr) -> torch.Tensor:
    """``dst`` (f32, on its device) filled from the host array ``arr``: on
    CUDA through pinned memory without blocking the host."""
    if dst.device.type != "cuda":
        return dst.copy_(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)))
    return dst.copy_(_pinned(arr), non_blocking=True)


def to_device_async(arr, device) -> torch.Tensor:
    """A host f32 array on ``device``: on CUDA staged in fresh pinned
    memory and copied without blocking the host (PyTorch's pinned
    allocator does not hand the block out again before the copy is done)."""
    if torch.device(device).type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(device)
    return _pinned(arr).to(device, non_blocking=True)


def pose_of_frame(cfg: StepConfig, params, pose_bank, pose_static, cam_id):
    """c2w [3, 4] of frame ``cam_id`` under the pose model: a host int, or
    (the scanned and the planned steps) a device id tensor of one element,
    gathered with on the device."""
    if cfg.pose_mode == "seg":
        return pp.seg_apply(pose_bank, cfg.pose_cfg, cfg.segment_img_num, cam_id)
    if cfg.pose_mode == "seg_pixel":
        return px.seg_deep_apply(pose_bank, cfg.deep_pose_cfg, cfg.segment_img_num,
                                 cam_id)
    if cfg.pose_mode == "gf":
        return pp.gf_apply({"train": params["pose"], "static": pose_static},
                           cfg.pose_cfg, cam_id)
    if cfg.pose_mode == "se3":
        refine = lie.se3_exp(raygen.frame_row(params["se3_refine"], cam_id),
                             only_rot=cfg.only_rotation)
        return posealg.compose_pair(
            refine, raygen.frame_row(pose_static["noise_poses"], cam_id)[:3])
    if cfg.pose_mode == "fixed":
        return raygen.frame_row(pose_static["pose_all"], cam_id)[:3]
    raise ValueError(f"unknown pose_mode {cfg.pose_mode!r}")


# the metrics of every step, in the order of the Runner's history columns
METRIC_NAMES = ("loss", "color_loss", "eikonal_loss", "mask_loss", "flow_loss",
                "unit_sphere_loss", "depth_loss", "psnr", "s_val", "cdf", "weight_max")


def _render_and_losses(cfg: StepConfig, generator, params, pose_static, data,
                       scalars: StepScalars, flow_ctx=None, pose_bank=None, group=None):
    """Render a ray batch and assemble the objective: color, eikonal,
    mask, unit-sphere, given ``flow_ctx`` the flow loss, and given a depth
    column in ``data`` (its 11th) and ``depth_weight`` the depth loss.

    ``group``: a ``torch.distributed`` process group (the JAX
    ``axis_name``), ``data`` this rank's share of the batch.  Every ratio
    loss then takes its numerator from this rank's rays and its
    denominator summed over the ranks (every denominator is free of
    gradient: the mask, the eikonal sphere mask, the unit-sphere
    ``outside``, the depth ``valid``, the counts), so the ranks' gradients
    sum to the whole batch's; the metrics are the whole batch's, from one
    all-reduce of the denominators and the detached numerators."""
    rays_o, rays_d = data[:, :3], data[:, 3:6]
    true_rgb, mask = data[:, 6:9], data[:, 9:10]
    depth_gt = data[:, 10:11] if data.shape[1] > 10 else None
    near, far = raygen.near_far_from_sphere(rays_o, rays_d)
    background_rgb = (torch.ones((1, 3), device=data.device)
                      if cfg.use_white_bkgd else None)

    if cfg.mask_weight > 0.0:
        mask = (mask > 0.5).to(torch.float32)
    else:
        mask = torch.ones_like(mask)
    world = 1 if group is None else dist.get_world_size(group)
    n_rays = float(rays_o.shape[0] * world)

    render_params = {k: v for k, v in params.items()
                     if k in ("sdf", "color", "nerf", "variance")}
    occ_grid = pose_static.get("occ_grid") if cfg.occupancy_sampling else None
    out = neus.render(generator, render_params, cfg.model_cfg, rays_o, rays_d,
                      near, far, background_rgb=background_rgb,
                      cos_anneal_ratio=scalars.cos_anneal, occ_grid=occ_grid,
                      eikonal_parts=True)

    # the sums over this batch's rays (num) and the denominators (den)
    color_fine = out["color_fine"]
    w_sum = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(mask * torch.log(w_sum) + (1.0 - mask) * torch.log(1.0 - w_sum))
    eik_num, eik_den = out["gradient_error"]
    num = {"color": torch.abs((color_fine - true_rgb) * mask).sum(),
           "sq": ((color_fine - true_rgb) ** 2 * mask).sum(),
           "eik": eik_num, "bce": bce.sum(),
           "cdf": (out["cdf_fine"][:, :1] * mask).sum(),
           "weight_max": (out["weight_max"] * mask).sum()}
    den = {"mask": mask.sum(), "eik": eik_den}
    if cfg.unit_sphere_weight > 0:
        pts = out["pts"]
        weights_flat = out["weights"][:, :pts.shape[0] // rays_o.shape[0]]
        outside = (torch.linalg.norm(pts, dim=-1) > 1.0).to(
            torch.float32).reshape(weights_flat.shape)
        num["unit"] = (torch.abs(weights_flat) * outside).sum()
        den["outside"] = outside.sum()
    if cfg.depth_weight > 0.0 and depth_gt is not None:
        # masked L1 over the in-mask rays with a depth, a validity weight
        # keeping the batch's shape
        valid = ((mask > 0.5) & (depth_gt > 0)).to(torch.float32)
        num["depth"] = (torch.abs(out["depth_fine"] - depth_gt) * valid).sum()
        den["valid"] = valid.sum()
    flow_loss = None
    if flow_ctx is not None:
        flow = _flow_loss(cfg, params, pose_bank, pose_static, out, flow_ctx, group)
        if group is None:
            flow_loss = flow
        else:
            num["flow0"], num["flow1"], den["flow"] = flow

    if group is None:
        glob_num, glob_den = num, den
    else:
        sums = torch.stack([v.detach() for v in (*num.values(), *den.values())])
        dist.all_reduce(sums, group=group)
        glob_num = dict(zip(num, sums[:len(num)]))
        glob_den = dict(zip(den, sums[len(num):]))
    total, terms = _loss_terms(cfg, num, glob_den, n_rays, flow_loss, data.device)
    if group is not None:  # the whole batch's terms, for the metrics
        _, terms = _loss_terms(cfg, glob_num, glob_den, n_rays, None, data.device)

    mask_sum = glob_den["mask"] + 1e-5
    psnr = 20.0 * torch.log10(1.0 / torch.sqrt(glob_num["sq"] / (mask_sum * 3.0)))
    metrics = {
        **terms, "psnr": psnr,
        "s_val": out["s_val"].mean(),
        "cdf": glob_num["cdf"] / mask_sum,
        "weight_max": glob_num["weight_max"] / mask_sum,
    }
    return total, metrics


def _loss_terms(cfg: StepConfig, num, den, n_rays: float, flow_loss, device):
    """(total, {"loss", each loss term}) from the sums ``num`` and the
    denominators ``den`` of ``_render_and_losses``.  The flow loss: from
    its two sums and their count where ``num`` has them (a group), else
    ``flow_loss`` as given (one device), or 0."""
    mask_sum = den["mask"] + 1e-5
    zero = torch.zeros((), device=device)
    color_loss = num["color"] / mask_sum
    eikonal_loss = num["eik"] / (den["eik"] + 1e-5)
    mask_loss = num["bce"] / n_rays
    unit_sphere_loss = (num["unit"] / (den["outside"] + 1e-8) * cfg.unit_sphere_weight
                        if "unit" in num else zero)
    if "flow0" in num:
        flow_loss = (num["flow0"] / den["flow"] + num["flow1"] / den["flow"]) * cfg.flow_weight
    elif flow_loss is None:
        flow_loss = zero
    depth_loss = (num["depth"] / (den["valid"] + 1e-8) * cfg.depth_weight
                  if "depth" in num else zero)
    total = (color_loss + eikonal_loss * cfg.igr_weight
             + mask_loss * cfg.mask_weight + unit_sphere_loss + flow_loss
             + depth_loss)
    return total, {"loss": total, "color_loss": color_loss,
                   "eikonal_loss": eikonal_loss, "mask_loss": mask_loss,
                   "flow_loss": flow_loss, "unit_sphere_loss": unit_sphere_loss,
                   "depth_loss": depth_loss}


def _project_to_pixels(pts, c2w, K):
    """World pts [N, 3] -> pixel coords [N, 2] through a 3x4 c2w."""
    w2c = posealg.invert(c2w)
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    pix = cam @ K[:3, :3].T
    return pix[:, :2] / pix[:, 2:]


def _flow_loss(cfg: StepConfig, params, pose_bank, pose_static, render_out,
               flow_ctx, group=None):
    """Bidirectional expected-pixel reprojection loss: each half-batch's
    weighted samples projected into the other frame against its matches.
    With a ``group``: the two directions' sums of absolute errors and
    their count on this rank (a tensor), for ``_render_and_losses`` to
    reduce."""
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
    if group is not None:
        return (torch.abs(err0).sum(), torch.abs(err1).sum(),
                err0.new_tensor(float(err0.numel())))
    return (torch.abs(err0).mean() + torch.abs(err1).mean()) * cfg.flow_weight


def intr_inv_all_K(intr_inv_all, idx):
    """K [3, 3] of frame ``idx`` (a host int or a device id) from the
    stored inverse intrinsics (``inv_ex``: no error check, so no device
    sync)."""
    return torch.linalg.inv_ex(raygen.frame_row(intr_inv_all, idx)[:3, :3]).inverse


def _flat_gate_masks(layout: convert.ParamLayout, device):
    """0/1 vectors over the flat order: (pose-or-se3 leaves, pose
    lin3_trans, pose lin3_scale)."""
    return (layout.mask(lambda n: n.split(".")[0] in ("pose", "se3_refine"), device),
            layout.mask(lambda n: n.startswith("pose.lin3_trans."), device),
            layout.mask(lambda n: n.startswith("pose.lin3_scale."), device))


def _flat_bank_masks(layout: convert.ParamLayout, device):
    """(lin3_trans, lin3_scale) 0/1 vectors over the flat bank order (all
    zero for the deep nets of ``seg_pixel``, which have no such heads),
    and the segment index of every position (``optim.seg_index``)."""
    return (layout.mask(lambda n: n.startswith("lin3_trans."), device),
            layout.mask(lambda n: n.startswith("lin3_scale."), device),
            optim.seg_index(layout.shapes, device))


def _apply_updates(cfg: StepConfig, state: TrainState, flat_g, scalars: StepScalars,
                   masks, adam_step, bank_g=None, bank_masks=None, seg_row=None):
    """Gate the flat gradient and take one Adam step; in a bank mode also
    the segment Adams.  The gates are exact 0/1 values: main_update zeroes the
    gradient but still steps (moment drift); pose leaves use the pose
    gate, which is also 0 whenever main_update is; with emphasize_rot the
    lin3_trans head never moves and lin3_scale follows trans_head_on.
    Bank positions take their segment's freeze gate times pose_update;
    ``seg_row`` [3, S] on the device is (touch, freeze, lr).  The scalars
    are host floats or 0-d device tensors; ``adam_step`` is the flat
    Adam's step count on the device (``optim.adam_update_flat_dev_``),
    which every loop keeps there, so that all take the same arithmetic."""
    if cfg.pose_mode in ("gf", "se3"):
        m_pose, m_trans, m_scale = masks
        if isinstance(scalars.main_update, torch.Tensor):
            pose_gate = torch.where(scalars.main_update > 0, scalars.pose_update, 0.0)
        else:
            pose_gate = scalars.pose_update if scalars.main_update > 0 else 0.0
        gate = scalars.main_update * (1.0 - m_pose) + pose_gate * m_pose
        if cfg.pose_mode == "gf" and cfg.pose_cfg.emphasize_rot:
            gate = (gate * (1.0 - m_trans - m_scale)
                    + pose_gate * scalars.trans_head_on * m_scale)
        flat_g = flat_g * gate
    else:
        flat_g = flat_g * scalars.main_update
    optim.adam_update_flat_dev_(flat_g, state.opt, state.flat, scalars.lr, adam_step)

    if cfg.pose_mode in BANK_MODES:
        m_trans, m_scale, idx = bank_masks
        touch, freeze, seg_lr = seg_row
        gate_b = ((freeze * scalars.pose_update)[idx] * (1.0 - m_trans)
                  * ((1.0 - m_scale) + scalars.trans_head_on * m_scale))
        optim.seg_adam_update_flat_(bank_g * gate_b, state.pose_opt, state.bank_flat,
                                    touch, seg_lr, idx)


def _seg_row(cfg: StepConfig, scalars: StepScalars, device):
    """The step's (touch, freeze, lr) [3, S] on the device (bank modes)."""
    if cfg.pose_mode not in BANK_MODES:
        return None
    return to_device_async(np.stack([scalars.seg_touch, scalars.seg_freeze,
                                     scalars.seg_lr]), device)


def _gate_masks(cfg: StepConfig, state: TrainState, cache: dict) -> dict:
    """The flat (and a bank mode's bank) gate masks, built at the first
    call and kept in ``cache``."""
    if "m" not in cache:
        dev = state.flat.device
        cache["m"] = _flat_gate_masks(state.layout, dev)
        if cfg.pose_mode in BANK_MODES:
            cache["b"] = _flat_bank_masks(state.bank_layout, dev)
    return cache


def _grads_and_update(cfg: StepConfig, state: TrainState, scalars: StepScalars,
                      loss_of, cache: dict, seg_row=None, *, adam_step, group=None):
    """Gradients of ``loss_of(params, pose_bank)`` in the flat buffers and
    the gated updates; returns the detached metrics.  With a process
    ``group`` the gradients (the flat one and a bank mode's bank one, in
    one buffer) are summed over its ranks before the update, so every rank
    applies the same one."""
    _gate_masks(cfg, state, cache)
    with torch.enable_grad():
        loss, metrics = loss_of(state.params, state.pose_bank)
        if cfg.pose_mode in BANK_MODES:
            flat_g, bank_g = torch.autograd.grad(loss, [state.flat, state.bank_flat])
        else:
            (flat_g,), bank_g = torch.autograd.grad(loss, state.flat), None
    if group is not None:
        grads = flat_g if bank_g is None else torch.cat([flat_g, bank_g])
        dist.all_reduce(grads, group=group)
        if bank_g is not None:
            flat_g, bank_g = grads[:flat_g.numel()], grads[flat_g.numel():]
    _apply_updates(cfg, state, flat_g, scalars, cache["m"], adam_step, bank_g,
                   cache.get("b"), seg_row)
    return {k: v.detach() for k, v in metrics.items()}


def _adam_count(state: TrainState, cache: dict) -> torch.Tensor:
    """The flat Adam's step count on the device for the per-step loop: a
    0-d int32 kept in ``cache``, set from the host count (a fill, no copy)
    wherever the two parted (a new Adam, a loaded checkpoint, steps run by
    another step function), else advanced by the step itself."""
    count = cache.get("adam_step")
    if count is None:
        count = cache["adam_step"] = torch.zeros((), dtype=torch.int32,
                                                 device=state.flat.device)
    if cache.get("adam_host") != state.opt.step:
        count.fill_(state.opt.step)
    cache["adam_host"] = state.opt.step + 1
    return count


def _step_and_update(cfg: StepConfig, state: TrainState, scalars: StepScalars,
                     loss_of, cache: dict, group=None):
    """One planned step: ``_grads_and_update`` with the host's scalars and
    the device Adam count (``_adam_count``), then the host counts."""
    seg_row = _seg_row(cfg, scalars, state.flat.device)  # its copy overlaps the forward
    metrics = _grads_and_update(cfg, state, scalars, loss_of, cache, seg_row,
                                adam_step=_adam_count(state, cache), group=group)
    state.opt.step += 1
    state.iter_step += 1
    return metrics


def _maintain_rays(cfg, state, images, masks, intr_inv_all, bbox_table, params,
                   pose_bank, add_img_id, scalars, add_pixels, depths=None):
    """The maintain_shape batch: random rays of frame ``add_img_id``."""
    pose_a = pose_of_frame(cfg, params, pose_bank, state.pose_static, add_img_id)
    return raygen.gen_random_rays(
        state.rays_generator, images, masks, intr_inv_all, pose_a, add_img_id,
        cfg.batch_size, bbox_table, cfg.mask_guided_patch_size,
        cfg.mask_guided_sampling, cfg.H, cfg.W,
        mask_guided_active=scalars.mask_guided, pixels=add_pixels, depths=depths)


def make_photo_loss(cfg: StepConfig, images, masks, intr_inv_all, bbox_table,
                    depths=None, group=None):
    """The photometric loss closure used by make_photo_step; ``depths``
    (z-depth maps [N, H, W]) adds each ray's depth to its batch; ``group``
    as in ``_render_and_losses`` (``cfg.batch_size`` is then this rank's
    share)."""

    def loss_fn(params, state: TrainState, img_id, scalars, pixels=None,
                add_img_id=0, add_pixels=None, pose_bank=None):
        pose0 = pose_of_frame(cfg, params, pose_bank, state.pose_static, img_id)
        data = raygen.gen_random_rays(
            state.rays_generator, images, masks, intr_inv_all, pose0, img_id,
            cfg.batch_size, bbox_table, cfg.mask_guided_patch_size,
            cfg.mask_guided_sampling, cfg.H, cfg.W,
            mask_guided_active=scalars.mask_guided, pixels=pixels, depths=depths)
        if cfg.maintain_shape:
            data = torch.cat([data, _maintain_rays(
                cfg, state, images, masks, intr_inv_all, bbox_table, params,
                pose_bank, add_img_id, scalars, add_pixels, depths)], dim=0)
        return _render_and_losses(cfg, state.rays_generator, params,
                                  state.pose_static, data, scalars,
                                  pose_bank=pose_bank, group=group)

    return loss_fn


def make_photo_step(cfg: StepConfig, images, masks, intr_inv_all, bbox_table,
                    depths=None, group=None):
    """Photometric step ``step(state, scalars, img_id, add_img_id=0,
    pixels=None, add_pixels=None) -> (state, metrics)``; ``pixels`` /
    ``add_pixels`` replace the random pixel draws of the frame's and the
    maintain_shape batch with given (px, py) ids; ``depths`` and
    ``group`` as in ``make_photo_loss``.  Updates in place."""
    loss_fn = make_photo_loss(cfg, images, masks, intr_inv_all, bbox_table, depths,
                              group)
    cache = {}

    def run_one(state: TrainState, scalars: StepScalars, img_id, add_img_id=0,
                pixels=None, add_pixels=None):
        metrics = _step_and_update(
            cfg, state, scalars,
            lambda params, bank: loss_fn(params, state, img_id, scalars, pixels,
                                         add_img_id, add_pixels, bank),
            cache, group)
        return state, metrics

    return run_one


def make_flow_loss(cfg: StepConfig, images, masks, intr_inv_all, bbox_table,
                   group=None):
    """The flow-pair loss closure used by make_flow_step: half a batch of
    rays through the matched pixels of each frame (pixels_pair [B/2, 4] =
    (x, y) in img_id_corr, (x, y) in img_id, a device tensor), plus the
    maintain_shape batch.  Frame ids are host ints or device ids.
    ``group`` as in ``_render_and_losses``: ``pixels_pair`` holds this
    rank's rows of the pairs."""
    K_all = torch.linalg.inv_ex(intr_inv_all[:, :3, :3]).inverse  # once

    def loss_fn(params, state: TrainState, img_id, img_id_corr, add_img_id,
                pixels_pair, scalars, add_pixels=None, pose_bank=None):
        pixels_xy_corr, pixels_xy = pixels_pair[:, 0:2], pixels_pair[:, 2:4]
        pose_corr = pose_of_frame(cfg, params, pose_bank, state.pose_static,
                                  img_id_corr)
        pose1 = pose_of_frame(cfg, params, pose_bank, state.pose_static, img_id)
        ro_c, rv_c = raygen.gen_flow_rays(
            pixels_xy_corr, raygen.frame_row(intr_inv_all, img_id_corr), pose_corr)
        ro_1, rv_1 = raygen.gen_flow_rays(
            pixels_xy, raygen.frame_row(intr_inv_all, img_id), pose1)
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
                    raygen.frame_row(K_all, img_id_corr), raygen.frame_row(K_all, img_id))
        return _render_and_losses(cfg, state.rays_generator, params,
                                  state.pose_static, data, scalars, flow_ctx=flow_ctx,
                                  pose_bank=pose_bank, group=group)

    return loss_fn


def make_flow_step(cfg: StepConfig, images, masks, intr_inv_all, bbox_table,
                   group=None):
    """Flow-pair step ``step(state, scalars, img_id, img_id_corr,
    add_img_id, pixels_pair, add_pixels=None) -> (state, metrics)``
    (``make_flow_loss``; pixels_pair host numpy or a tensor).  Updates in
    place."""
    loss_fn = make_flow_loss(cfg, images, masks, intr_inv_all, bbox_table, group)
    cache = {}

    def run_one(state: TrainState, scalars: StepScalars, img_id, img_id_corr,
                add_img_id, pixels_pair, add_pixels=None):
        if not isinstance(pixels_pair, torch.Tensor):
            pixels_pair = to_device_async(pixels_pair, state.flat.device)
        metrics = _step_and_update(
            cfg, state, scalars,
            lambda params, bank: loss_fn(params, state, img_id, img_id_corr,
                                         add_img_id, pixels_pair, scalars,
                                         add_pixels, bank),
            cache, group)
        return state, metrics

    return run_one


def make_device_scalars(schedule: Dict[str, float], device):
    """``it_f`` (a 0-d f32 device tensor) -> StepScalars of 0-d f32 device
    tensors, the scanned steps' schedule (the JAX function's, in f32): the
    cosine learning rate after a linear warm-up, the cos-anneal ratio, and
    constant gates (main and pose update, the scale head on) and
    mask-guided flag.  The divisors are device tensors made here, once: a
    division by a host float runs as a multiply by its reciprocal on CUDA."""
    lr0 = schedule["learning_rate"]
    alpha = schedule["learning_rate_alpha"]
    warm_up = schedule["warm_up_end"]
    end_iter = schedule["end_iter"]
    anneal_end = schedule.get("anneal_end", 0.0)

    def const(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    warm_den = const(max(warm_up, 1.0))
    cos_den = const(max(end_iter - warm_up, 1.0))
    anneal_den = const(anneal_end) if anneal_end != 0.0 else None
    one = const(1.0)
    mask_guided = const(schedule.get("mask_guided", 1.0))

    def device_scalars(it_f):
        warm = it_f / warm_den
        progress = (it_f - warm_up) / cos_den
        cosf = (torch.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
        lr = lr0 * torch.where(it_f < warm_up, warm, cosf)
        cos_anneal = (one if anneal_den is None
                      else torch.clamp(it_f / anneal_den, max=1.0))
        return StepScalars(lr=lr, cos_anneal=cos_anneal, main_update=one,
                           pose_update=one, mask_guided=mask_guided,
                           trans_head_on=one)

    return device_scalars


def state_buffers(state: TrainState):
    """The tensors a step writes (the flat parameters and Adam moments, and
    in a bank mode the bank and its Adam) and those it only reads (the
    pose buffers, the bank's static buffers): a captured step keeps their
    addresses, so a state whose buffers moved needs a new capture."""
    written = [state.flat, state.opt.mu, state.opt.nu]
    read = list(state.pose_static.values())
    if state.bank_flat is not None:
        po = state.pose_opt
        written += [state.bank_flat, po.step, po.mu, po.nu]
        read += [v for v in state.bank_static.values() if isinstance(v, torch.Tensor)]
    return written, read


class ScanCarry(NamedTuple):
    """The scanned steps' device buffers: the state's iteration count and
    the flat Adam's step count (0-d int32), the chunk's metric sums
    [len(METRIC_NAMES)] f32, and the frame each step of the chunk drew
    [k] int64 (step i of the chunk at i = iter_step mod k)."""
    iter_step: torch.Tensor
    adam_step: torch.Tensor
    metric_sum: torch.Tensor
    frames: torch.Tensor


class ScanPhotoSteps:
    """``k_steps`` photometric steps a call, every per-step quantity a
    function of the device's own iteration count (the counterpart of the
    JAX ``make_scan_photo_steps``; the phases whose host decisions are pure
    functions of ``iter_step``: no flow, no curriculum, no segment bank).

    ``scan(state, n_images_cur)`` runs ``k_steps`` steps on ``state`` in
    place and returns the chunk's mean metrics, a [len(METRIC_NAMES)]
    device tensor.  Each step: the schedule from the device count
    (``make_device_scalars``), a frame drawn uniform in
    ``[0, n_images_cur)`` from the state's generator (the JAX module draws
    iid too, not the per-step loop's epoch permutation), then the photo
    step with the device Adam count (``optim.adam_update_flat_dev_``), its
    metrics summed on the device.  On CUDA one step is captured into a CUDA
    graph at the first call (``train/graph.py``) and replayed ``k_steps``
    times a call; ``capture=False`` runs the same step eagerly, as the CPU
    does.  The host counts (``state.iter_step``, ``state.opt.step``)
    advance by ``k_steps`` after the steps; the device counts are set from
    them before.  ``step`` is one step alone: the tests give it the
    frame and the pixels (``img_id``, ``pixels``) instead of the draws.
    ``group``: the data-parallel step (``parallel/dp.py``,
    ``make_dp_scan_photo_steps``), its all-reduces inside the captured
    step; the frame comes from the generator the ranks share."""

    def __init__(self, cfg: StepConfig, images, masks, intr_inv_all, bbox_table,
                 schedule: Dict[str, float], k_steps: int, capture=None, depths=None,
                 group=None):
        if cfg.pose_mode not in ("fixed", "gf", "se3") or cfg.flow_weight > 0 \
                or cfg.maintain_shape:
            raise ValueError(f"scanned steps take a fixed, gf or se3 pose without "
                             f"flow or maintain_shape, not {cfg.pose_mode!r}")
        self.cfg, self.k = cfg, int(k_steps)
        self.group = group
        self.device = images.device
        self.loss_fn = make_photo_loss(cfg, images, masks, intr_inv_all, bbox_table,
                                       depths, group)
        self.device_scalars = make_device_scalars(schedule, self.device)
        self.capture = self.device.type == "cuda" if capture is None else capture
        self.cache = {}
        self.carry = None
        self.graph = None
        self._graph_key = None

    def step(self, state: TrainState, carry: ScanCarry, n_images_cur: int,
             img_id=None, pixels=None):
        """One scanned step on ``state`` and ``carry``, in place."""
        scalars = self.device_scalars(carry.iter_step.to(torch.float32))
        if img_id is None:
            img_id = torch.randint(n_images_cur, (1,), generator=state.generator,
                                   device=self.device)
            slot = torch.remainder(carry.iter_step, self.k).reshape(1).to(torch.int64)
            carry.frames.index_copy_(0, slot, img_id)
        metrics = _grads_and_update(
            self.cfg, state, scalars,
            lambda params, bank: self.loss_fn(params, state, img_id, scalars, pixels),
            self.cache, adam_step=carry.adam_step, group=self.group)
        carry.metric_sum.add_(torch.stack([metrics[k] for k in METRIC_NAMES]))
        carry.iter_step.add_(1)

    def _step_graph(self, state: TrainState, n_images_cur: int):
        """The captured step of (state, n_images_cur), built at its first use."""
        from fmov_pose_torch.train import graph
        written, read = state_buffers(state)
        gens = state.generators()
        key = (n_images_cur, *map(id, gens), *(t.data_ptr() for t in written + read))
        if self.graph is None or self._graph_key != key:
            _gate_masks(self.cfg, state, self.cache)
            self.graph = graph.StepGraph(
                lambda: self.step(state, self.carry, n_images_cur), gens,
                written + list(self.carry))
            self._graph_key = key
        return self.graph

    def __call__(self, state: TrainState, n_images_cur: int, frames=None, pixels=None):
        """``k_steps`` steps; ``frames`` / ``pixels``: per-step frame ids
        and (px, py) pixel ids given instead of the draws (eager only)."""
        if self.carry is None:
            dev = self.device
            self.carry = ScanCarry(
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros(len(METRIC_NAMES), dtype=torch.float32, device=dev),
                torch.full((self.k,), -1, dtype=torch.int64, device=dev))
        carry = self.carry
        carry.iter_step.fill_(state.iter_step)
        carry.adam_step.fill_(state.opt.step)
        carry.metric_sum.zero_()
        if self.capture:
            if frames is not None or pixels is not None:
                raise ValueError("given frames and pixels run eagerly (capture=False)")
            step_graph = self._step_graph(state, n_images_cur)
            for _ in range(self.k):
                step_graph.replay()
        else:
            for i in range(self.k):
                self.step(state, carry, n_images_cur,
                          None if frames is None else frames[i],
                          None if pixels is None else pixels[i])
        state.iter_step += self.k
        state.opt.step += self.k
        return carry.metric_sum / self.k


class PlannedSteps:
    """Chunks of host-planned steps, photo and flow mixed (the counterpart
    of the JAX ``make_planned_steps``): the Runner plans every step of a
    chunk on the host (``Runner._plan_step``) and ``chunk(state, rows,
    use_flow)`` runs them.

    ``rows`` [k, R]: each step's packed row (``pack_scalars_np``, 9 + 3S)
    followed, with flow on, by its match pixels [B/2, 4] raveled (zeros on
    a photo row); ``use_flow`` [k]: which steps are flow steps.  The rows
    go to the device in one pinned copy a chunk (``copy_to_device_async_``)
    into a buffer of ``k_steps`` rows, and a device cursor says which row a
    step reads (``unpack_scalars_dev``: nothing is read back).  The flat
    Adam counts on the device (``optim.adam_update_flat_dev_``), set from
    the host count before the chunk; the host counts (``state.iter_step``,
    ``state.opt.step``) advance by k after it.  Each step's metrics go to
    its row of a device buffer: the call returns them, [k,
    len(METRIC_NAMES)].

    On CUDA the photo step and (with ``flow_weight > 0``) the flow step
    are captured into a CUDA graph each at the first call
    (``train/graph.py``), and the host replays the one each row's flag
    names; ``capture=False`` runs the same steps eagerly, as the CPU
    does.  The graphs are taken again when the state's buffers move
    (``state_buffers``: a field reset, a checkpoint loaded)."""

    def __init__(self, cfg: StepConfig, images, masks, intr_inv_all, bbox_table,
                 k_steps: int, capture=None, depths=None):
        if k_steps < 2:
            raise ValueError(f"planned chunks take at least 2 steps, not {k_steps}")
        self.cfg, self.k = cfg, int(k_steps)
        dev = self.device = images.device
        self.photo_loss = make_photo_loss(cfg, images, masks, intr_inv_all, bbox_table,
                                          depths)
        self.flow_loss = (make_flow_loss(cfg, images, masks, intr_inv_all, bbox_table)
                          if cfg.flow_weight > 0 else None)
        self.n_packed = N_SCALAR_FIELDS + 3 * cfg.n_segments
        width = self.n_packed + (4 * (cfg.batch_size // 2) if self.flow_loss else 0)
        self.rows = torch.zeros((self.k, width), dtype=torch.float32, device=dev)
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self.adam_step = torch.zeros((), dtype=torch.int32, device=dev)
        self.metrics = torch.zeros((self.k, len(METRIC_NAMES)), dtype=torch.float32,
                                   device=dev)
        self.capture = dev.type == "cuda" if capture is None else capture
        self.cache = {}
        self.graphs = {}
        self.captures = 0  # times the steps were captured
        self._graph_key = None

    def step(self, state: TrainState, use_flow: bool):
        """The step of row ``cursor``, on ``state`` in place; the cursor
        advances."""
        cfg = self.cfg
        row = self.rows.index_select(0, self.cursor.reshape(1))[0]
        scalars, img_id, add_img_id, img_id_corr = unpack_scalars_dev(
            row[:self.n_packed], cfg.n_segments)
        seg_row = (row[N_SCALAR_FIELDS:self.n_packed].view(3, cfg.n_segments)
                   if cfg.pose_mode in BANK_MODES else None)
        if use_flow:
            pixels = row[self.n_packed:].view(-1, 4)

            def loss_of(params, bank):
                return self.flow_loss(params, state, img_id, img_id_corr, add_img_id,
                                      pixels, scalars, pose_bank=bank)
        else:
            def loss_of(params, bank):
                return self.photo_loss(params, state, img_id, scalars,
                                       add_img_id=add_img_id, pose_bank=bank)
        metrics = _grads_and_update(cfg, state, scalars, loss_of, self.cache, seg_row,
                                    adam_step=self.adam_step)
        self.metrics.index_copy_(0, self.cursor.reshape(1), torch.stack(
            [metrics[k] for k in METRIC_NAMES])[None])
        self.cursor.add_(1)

    def _step_graphs(self, state: TrainState):
        """{use_flow: the captured step}, built at the first use and again
        when the state's buffers moved."""
        from fmov_pose_torch.train import graph
        written, read = state_buffers(state)
        gens = state.generators()
        key = (*map(id, gens), *(t.data_ptr() for t in written + read))
        if self._graph_key != key:
            self.graphs = {}  # the old captures' memory goes first
            _gate_masks(self.cfg, state, self.cache)
            mutable = written + [self.cursor, self.adam_step, self.metrics]
            for use_flow in ((False, True) if self.flow_loss else (False,)):
                self.graphs[use_flow] = graph.StepGraph(
                    lambda uf=use_flow: self.step(state, uf), gens, mutable)
            self.captures += 1
            self._graph_key = key
        return self.graphs

    def __call__(self, state: TrainState, rows, use_flow):
        """len(use_flow) <= k_steps planned steps on ``state`` in place;
        returns their metrics [k, len(METRIC_NAMES)] (a view of the
        buffer, valid until the next call)."""
        k = len(use_flow)
        if not 0 < k <= self.k or len(rows) != k:
            raise ValueError(f"a chunk of {len(rows)} rows and {k} flags, at most "
                             f"{self.k}")
        if any(use_flow) and self.flow_loss is None:
            raise ValueError("a flow step planned without flow_weight > 0")
        copy_to_device_async_(self.rows[:k], rows)
        self.cursor.zero_()
        self.adam_step.fill_(state.opt.step)
        if self.capture:
            graphs = self._step_graphs(state)
            for uf in use_flow:
                graphs[bool(uf)].replay()
        else:
            for uf in use_flow:
                self.step(state, bool(uf))
        state.iter_step += k
        state.opt.step += k
        return self.metrics[:k]
