"""Experiment runner (port of ``fmov_pose_tpu/train/runner.py``: the
training lifecycle of one conf, phase 1 or phase 2).

Reads the reference's .conf files with the port's HOCON reader
(``data/hocon.py``) and trains with a plain Python loop, one step per
iteration, on the device the caller names (``device``; by default the
CUDA device, which must exist).  The data is a dataset object the caller
passes (``data/scene.py``, or anything with the same fields) or the
port's host ``Dataset`` read from the conf's ``data_dir``.

The host plans every step as the JAX Runner does, consuming its numpy RNG
in the same order (``_plan_step``): the frame, the flow coin and the LoFTR
pair of a flow step, the warm-up gates, and per segment the touch, freeze
and learning rate.  The progressive phase 1 (``train.progressive``,
``pose_type = seg``) admits ``image_interval`` frames every
``max_pro_iteration`` steps past the mesh warm-up, trains the newest
segment's pose net alone until ``pro_warm_up_end``, lazily initialises
each new segment from the last pose of the one before, and with
``reset_based_on_rot`` restarts the NeuS fields when the admitted frames
have turned by more than ``reset_rot_threshold`` degrees.  Photo and flow
steps alternate on the flow coin; ``maintain_shape`` adds a batch of an
earlier frame to every step.

The fused training kernels (``train.use_fused_train_kernels``: K2/K3 or
K4/K5 for the SDF, K8/K9 or K6/K7 for the color), the NeRF++ background
(``n_outside > 0``, trained with the fields) and the occupancy grid
(``train.occupancy_sampling``, refreshed after every ``occ_update_freq``-th
step) are taken as in the JAX Runner.  What the port leaves out raises
``NotImplementedError`` naming its ROADMAP item: checkpoints, validation
renders, meshes and exports (the training loop logs where the JAX Runner
would run them, and draws the host RNG the JAX ``validate_image`` draws),
the planned and scanned multi-step dispatch (``train.plan_chunk``), the
pixel-level pose banks (``model.pixel_level``), depth supervision and data
parallelism.
"""

from __future__ import annotations

import logging
import os
import shutil
import time

import numpy as np
import torch

from fmov_pose_torch import convert
from fmov_pose_torch.data import hocon
from fmov_pose_torch.fields import nets
from fmov_pose_torch.poses import picture_pose as pp
from fmov_pose_torch.render import neus
from fmov_pose_torch.train import optim, step as step_mod

LOG = logging.getLogger(__name__)


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not in the PyTorch port yet (ROADMAP queue 1, {item})")


def rotation_error_deg(rel_R: np.ndarray) -> float:
    d = 0.5 * (rel_R[0, 0] + rel_R[1, 1] + rel_R[2, 2] - 1.0)
    return float(np.arccos(max(min(d, 1.0), -1.0)) * 180.0 / np.pi)


class Runner:
    def __init__(self, conf_path, mode="train", case="CASE_NAME",
                 dataset="DTU", is_continue=False, start_at=-1,
                 start_img_idx=0, gradient_analysis=False, exp_dir=None,
                 has_global_conf=False, flow_interval=-1,
                 reset_rot_degree=-1, image_interval=-1, seed=2024,
                 device=None, scene=None):
        """``device``: where the state and the step run; None is the CUDA
        device (raises without one), the CPU only when asked for by name.
        ``scene``: an in-memory dataset used instead of the conf's
        data_dir."""
        if not mode.startswith("train"):
            _unsupported(f"mode {mode!r}", "item 10 (eval and export)")
        if is_continue:
            _unsupported("--is_continue (checkpoints)", "item 1")
        if gradient_analysis:
            _unsupported("--gradient_analysis", "item 10")
        if device is None:
            from fmov_pose_torch.device import require_cuda
            device = require_cuda()
        self.case = case
        self.mode = mode
        self.conf_path = conf_path
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)

        conf = hocon.parse_file(conf_path, {"CASE_NAME": case,
                                            "DATA_SET": dataset})
        self.conf = conf
        self.base_exp_dir = exp_dir or conf["general.base_exp_dir"]
        if not has_global_conf and "global_reset_exp" not in self.base_exp_dir:
            self.base_exp_dir += "_wo_global_conf"
        if flow_interval > 0:
            self.base_exp_dir += f"_m{flow_interval}"
            conf.put("train.flow_interval", flow_interval)
        if reset_rot_degree > 0:
            self.base_exp_dir += f"_r{reset_rot_degree}"
            conf.put("train.reset_rot_threshold", reset_rot_degree)
        if image_interval > 0:
            self.base_exp_dir += f"_i{image_interval}"
            conf.put("train.image_interval", image_interval)
            conf.put("train.max_pro_iteration", 1000 * image_interval)
            conf.put("train.pro_warm_up_end", 500 * image_interval)
            conf.put("train.current_image", image_interval)
        if flow_interval > 0 or reset_rot_degree > 0 or image_interval > 0:
            conf.put("train.save_freq", 30000)
        if start_img_idx > 0:
            self.base_exp_dir += f"_start_at_{start_img_idx}"
        os.makedirs(self.base_exp_dir, exist_ok=True)
        conf.put("dataset.start_idx", start_img_idx)

        if conf.get_float("train.depth_weight", 0.0) > 0:
            _unsupported("train.depth_weight", "item 6 (depth loss)")
        if conf.get_bool("model.pixel_level", False):
            _unsupported("model.pixel_level (seg_pixel pose banks)", "item 8")
        if conf.get_int("train.plan_chunk", 1) > 1:
            _unsupported("train.plan_chunk (planned multi-step dispatch)", "item 8")

        if scene is None:
            from fmov_pose_torch.data.dataset import Dataset
            scene = Dataset(conf["dataset"], exp_dir)
        self.dataset = scene
        self.iter_step = 0

        t = conf["train"]
        self.end_iter = t.get_int("end_iter")
        self.save_freq = t.get_int("save_freq")
        self.report_freq = t.get_int("report_freq")
        self.val_freq = t.get_int("val_freq")
        self.val_mesh_freq = t.get_int("val_mesh_freq")
        self.pose_freq = conf.get_int("train.pose_freq", 1000)
        self.batch_size = t.get_int("batch_size")
        self.learning_rate = t.get_float("learning_rate")
        self.learning_rate_alpha = t.get_float("learning_rate_alpha")
        self.use_white_bkgd = t.get_bool("use_white_bkgd")
        self.warm_up_end = conf.get_float("train.warm_up_end", 0.0)
        self.anneal_end = conf.get_float("train.anneal_end", 0.0)
        self.mask_guided_sampling = conf.get_bool(
            "train.mask_guided_sampling", False)
        self.igr_weight = t.get_float("igr_weight")
        self.mask_weight = t.get_float("mask_weight")
        self.flow_weight = conf.get_float("train.flow_weight", 0.0)
        self.unit_sphere_weight = conf.get_float("train.unit_sphere_weight", 0.0)

        self.progressive = conf.get_bool("train.progressive", False)
        self.image_interval = conf.get_int("train.image_interval", 10)
        self.current_image = min(
            conf.get_int("train.current_image", self.dataset.n_images),
            self.dataset.n_images)
        self.max_pro_iteration = conf.get_int("train.max_pro_iteration", 0)
        self.pro_warm_up_end = conf.get_int("train.pro_warm_up_end", 0)
        self.mesh_warmup_step = conf.get_int("train.mesh_warmup_step", 0)
        self.pose_lr = conf.get_float("train.pose_lr", 5e-4)
        self.pose_alpha = conf.get_float("train.pose_alpha", 0.5)
        self.flow_interval = conf.get("train.flow_interval", 1)
        self.only_rotation = conf.get_bool("train.only_rotation", False)
        self.detach_ref = conf.get_bool("train.detach_ref", False)
        self.detach_flow_on_sdf = conf.get_bool("train.detach_flow_on_sdf", False)
        self.detach_mesh_at_warm_up = conf.get_bool(
            "train.detach_mesh_at_warm_up", False)
        self.disable_trans_during_warm_up = conf.get_bool(
            "train.disable_trans_during_warm_up", False)
        self.reset_based_on_rot = conf.get_bool("train.reset_based_on_rot", False)
        self.reset_rot_threshold = conf.get_float("train.reset_rot_threshold", 60)
        self.mask_guided_patch_size = conf.get_int(
            "train.mask_guided_patch_size", 30)
        self.maintain_shape = conf.get_bool("train.maintain_shape", False)
        self.remove_prev_matches = conf.get_bool("train.remove_prev_matches", True)
        self.mask_init = conf.get_bool("dataset.mask_init", False)
        self.prev_pose = None

        if "model.barf" not in conf:
            conf.put("model.barf", False)
        self.barf = conf.get_bool("model.barf")
        self.pose_type = conf.get("model.pose_type", "None")

        self.model_cfg = {
            "sdf": conf["model.sdf_network"].as_plain_dict(),
            "color": conf["model.rendering_network"].as_plain_dict(),
            "nerf": conf["model.nerf"].as_plain_dict(),
            "renderer": neus.make_render_cfg(
                conf["model.neus_renderer"].as_plain_dict()),
        }
        self.model_cfg["sdf"]["skip_in"] = tuple(
            self.model_cfg["sdf"].get("skip_in", [4]))
        self.model_cfg["nerf"]["skips"] = tuple(
            self.model_cfg["nerf"].get("skips", [4]))
        compute_dtype = conf.get("train.compute_dtype", "float32")
        for net in ("sdf", "color", "nerf"):
            self.model_cfg[net].setdefault("compute_dtype", compute_dtype)
        # the fused SDF forward of the gradient-free paths (ops/fused_sdf.py)
        self.model_cfg["sdf"]["use_fused"] = conf.get_bool(
            "train.use_fused_kernels", True)
        # the fused training kernels (K2-K5 SDF, K6-K9 color; render_core)
        self.model_cfg["sdf"]["use_fused_train"] = conf.get_bool(
            "train.use_fused_train_kernels", False)
        # occupancy-grid guided importance sampling instead of the
        # SDF-guided up-sampler (render/occupancy.py)
        self.occupancy_sampling = (
            conf.get_bool("train.occupancy_sampling", False)
            and self.model_cfg["renderer"].n_importance > 0)
        self.occ_grid_res = conf.get_int("train.occ_grid_res", 64)
        self.occ_update_freq = conf.get_int("train.occ_update_freq", 250)
        self.occ_refreshes = 0
        self.variance_cfg = conf["model.variance_network"].as_plain_dict()

        noise_poses = None
        if self.barf:
            if conf.get("dataset.use_crop_init", False):
                noise_poses = self.dataset.crop_poses
            elif self.mask_init:
                noise_poses = np.repeat(
                    self.dataset.max_mask_pose[None], self.dataset.n_images, 0)
            else:
                raise NotImplementedError("only mask_init / crop_init supported")
        if self.pose_type == "seg":
            self.pose_mode = "seg"
        elif self.pose_type == "gf":
            self.pose_mode = "gf"
        elif self.barf:
            self.pose_mode = "se3"
        else:
            self.pose_mode = "fixed"
        self.pose_cfg = pp.PoseCfg(
            emphasize_rot=bool(conf.get("train.emphasize_rot", False)),
            small_rot=bool(conf.get("train.small_rot", False)))
        self.n_segments = (pp.num_segments(self.dataset.n_images, self.image_interval)
                           if self.pose_mode == "seg" else 1)
        self.current_pose_mlp_index = 0
        self.pro_iteration = 0
        self.reset_count = 0  # rotation-triggered reset_neus firings
        self.seg_progress = np.zeros((self.n_segments,), np.float64)
        self.seg_frozen = np.ones((self.n_segments,), np.float32)  # 1 = trainable

        self._init_device_buffers()
        self._init_state(noise_poses, seed)
        self._build_steps()
        self.file_backup()

        n_override = conf.get_int("dataset.n_images", self.dataset.n_images)
        self.dataset.n_images = min(n_override, self.dataset.n_images)
        self.history = {}   # metric -> per-step floats, filled by train()
        self.step_ms = []   # per-step device-timeline ms (CUDA only)
        self.flow_steps = 0

    # ------------------------------------------------------------------
    def _init_device_buffers(self):
        """Images and masks go to the device as uint8 and expand there:
        pixel data is k/256, so round(x*256) recovers k exactly."""
        d, dev = self.dataset, self.device
        imgs_u8 = np.round(d.images_np * 256.0).astype(np.uint8)
        self.images_dev = torch.from_numpy(imgs_u8).to(dev).float() / 256.0
        masks_u8 = np.round(d.masks_np[..., 0] * 256.0).astype(np.uint8)
        self.masks_dev = torch.from_numpy(masks_u8).to(dev).float() / 256.0
        self.intr_inv_dev = torch.as_tensor(
            np.asarray(d.intrinsics_all_inv, np.float32), device=dev)
        self.bbox_dev = torch.as_tensor(
            np.asarray(d.mask_bboxes, np.int32), device=dev)

    def _field_params(self, seed):
        rng = np.random.default_rng(seed)
        return {
            "sdf": nets.init_sdf(rng, self.model_cfg["sdf"]),
            "color": nets.init_color(rng, self.model_cfg["color"]),
            "nerf": nets.init_nerf(rng, self.model_cfg["nerf"]),
            "variance": nets.init_variance(self.variance_cfg),
        }

    def _set_fields(self, params):
        """The flat parameter buffer and a fresh Adam for ``params``."""
        layout = convert.ParamLayout(params)
        flat = layout.ravel(params, self.device).requires_grad_(True)
        return flat, layout, optim.adam_init(flat.detach())

    def _init_state(self, noise_poses, seed):
        params = self._field_params(seed)
        dev = self.device
        bank = {}
        if self.pose_mode == "seg":
            bank = pp.init_seg_bank(seed, self.pose_cfg, self.dataset.n_images,
                                    self.image_interval, np.asarray(noise_poses)[0])
            pose_static = {}
        elif self.pose_mode == "gf":
            gf = pp.init_gf(seed, self.pose_cfg, np.asarray(noise_poses))
            params["pose"] = gf["train"]
            pose_static = {k: v.to(dev) for k, v in gf["static"].items()}
        elif self.pose_mode == "se3":
            params["se3_refine"] = torch.zeros((self.dataset.n_images, 6))
            pose_static = {"noise_poses": torch.as_tensor(
                np.asarray(noise_poses, np.float32), device=dev)}
        else:
            pose_static = {"pose_all": torch.as_tensor(
                np.asarray(self.dataset.pose_all, np.float32), device=dev)}

        if self.occupancy_sampling:
            # fully occupied (uniform importance) until the first refresh
            pose_static["occ_grid"] = torch.ones(
                (self.occ_grid_res,) * 3, dtype=torch.float32, device=dev)

        flat, layout, opt = self._set_fields(params)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed + 1)
        self.state = step_mod.TrainState(
            flat=flat, layout=layout, opt=opt, pose_static=pose_static,
            generator=generator)
        if bank:
            bank_layout = convert.ParamLayout(bank["train"])
            bank_flat = bank_layout.ravel(bank["train"], dev).requires_grad_(True)
            self.state.bank_flat = bank_flat
            self.state.bank_layout = bank_layout
            self.state.bank_static = {
                "b": bank["static"]["b"].to(dev),
                "init_c2w": bank["static"]["init_c2w"].to(dev),
                "initialized": bank["static"]["initialized"]}
            self.state.pose_opt = optim.seg_adam_init(
                bank_flat.detach(), bank_layout.shapes, self.n_segments)

    def _build_steps(self):
        self.step_cfg = step_mod.make_step_config(
            self.model_cfg,
            batch_size=self.batch_size,
            H=self.dataset.H, W=self.dataset.W,
            n_segments=self.n_segments,
            segment_img_num=self.image_interval,
            pose_mode=self.pose_mode,
            pose_cfg=self.pose_cfg,
            igr_weight=self.igr_weight,
            mask_weight=self.mask_weight,
            flow_weight=self.flow_weight,
            unit_sphere_weight=self.unit_sphere_weight,
            use_white_bkgd=self.use_white_bkgd,
            mask_guided_sampling=self.mask_guided_sampling,
            mask_guided_patch_size=self.mask_guided_patch_size,
            maintain_shape=self.maintain_shape,
            detach_ref=self.detach_ref,
            detach_flow_on_sdf=self.detach_flow_on_sdf,
            only_rotation=self.only_rotation,
            occupancy_sampling=self.occupancy_sampling,
        )
        bufs = (self.images_dev, self.masks_dev, self.intr_inv_dev, self.bbox_dev)
        self.photo_step = step_mod.make_photo_step(self.step_cfg, *bufs)
        self.flow_step = step_mod.make_flow_step(self.step_cfg, *bufs)

    # ------------------------------------------------------------------
    # pose queries (host)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def query_poses(self, ids) -> np.ndarray:
        """Learned/GT c2w of the frames ``ids`` (or of frames 0..ids-1 for
        an int) as numpy [n, 4, 4], read back from the device once."""
        ids = range(ids) if isinstance(ids, int) else ids
        out = np.tile(np.eye(4, dtype=np.float32), (len(ids), 1, 1))
        if len(ids):
            st = self.state
            out[:, :3] = torch.stack([step_mod.pose_of_frame(
                self.step_cfg, st.params, st.pose_bank, st.pose_static, i)
                for i in ids]).cpu().numpy()
        return out

    def query_pose(self, i: int) -> np.ndarray:
        """Learned/GT c2w of frame i as numpy [4, 4]."""
        return self.query_poses([i])[0]

    # ------------------------------------------------------------------
    # schedules (host)
    # ------------------------------------------------------------------
    def get_cos_anneal_ratio(self) -> float:
        if self.anneal_end == 0.0:
            return 1.0
        return min(1.0, self.iter_step / self.anneal_end)

    def main_lr(self) -> float:
        if self.iter_step < self.warm_up_end:
            factor = self.iter_step / self.warm_up_end
        else:
            alpha = self.learning_rate_alpha
            progress = ((self.iter_step - self.warm_up_end)
                        / (self.end_iter - self.warm_up_end))
            factor = (np.cos(np.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
        return float(self.learning_rate * factor)

    def seg_lrs(self, touched) -> np.ndarray:
        """Per-segment pose LR; touched segments advance their progress
        counter first."""
        for s in touched:
            self.seg_progress[s] += 1
        if "_wo_global_conf" not in self.base_exp_dir:
            progress = self.seg_progress / max(self.max_pro_iteration, 1)
            alpha = self.pose_alpha
        else:
            progress = self.seg_progress / self.end_iter
            alpha = self.learning_rate_alpha
        factor = (np.cos(np.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
        return (self.pose_lr * factor).astype(np.float32)

    # image replay permutations
    def get_image_perm(self):
        if self.progressive:
            if self.current_image > self.image_interval:
                prev_num = self.current_image - self.image_interval
                w = ([0.2 / prev_num] * prev_num
                     + [0.8 / self.image_interval] * self.image_interval)
                return self.rng.choice(self.current_image, self.current_image, p=w)
            return self.rng.permutation(self.current_image)
        return self.rng.permutation(self.dataset.n_images)

    def get_prev_image_perm(self):
        if self.current_image > self.flow_interval:
            return self.rng.permutation(self.current_image - self.flow_interval)
        return self.rng.permutation(self.current_image)

    def get_current_image_perm(self):
        if self.current_image > (self.image_interval - 1) + self.flow_interval:
            if self.flow_interval == 1:
                return (self.rng.permutation(self.image_interval)
                        + self.current_image - self.image_interval)
            prev_num = (self.current_image - (self.image_interval - 1)
                        - self.flow_interval)
            w = ([0.2 / (self.flow_interval - 1)] * (self.flow_interval - 1)
                 + [0.8 / self.image_interval] * self.image_interval)
            return self.rng.choice(len(w), len(w), p=w) + prev_num
        return self.rng.permutation(self.current_image)

    def _sample_flow_pair(self, img_id_corr: int):
        """A partner frame and a batch of its matches, or None."""
        d = self.dataset
        name_corr = d.index_to_frame[img_id_corr]
        if name_corr not in d.flow_pairs:
            return None
        pairs_idx = [d.frame_to_index[n] for n in d.flow_pairs[name_corr]]
        pairs_idx = [i for i in pairs_idx
                     if i < self.current_image
                     and abs(i - img_id_corr) <= self.flow_interval]
        if not pairs_idx:
            return None
        img_id = int(self.rng.choice(pairs_idx))
        xs1, ys1, xs2, ys2 = d.loftr_flows[
            f"{name_corr}_{d.index_to_frame[img_id]}"]
        if len(xs1) == 0:
            return None
        b2 = self.batch_size // 2
        sel = self.rng.choice(len(xs1), b2, replace=True)
        pixels_corr = np.stack([xs1[sel], ys1[sel]], -1).astype(np.float32)
        pixels = np.stack([xs2[sel], ys2[sel]], -1).astype(np.float32)
        return img_id, pixels, pixels_corr

    def _touched_segments(self, ids):
        return sorted({int(i) // self.image_interval for i in ids
                       if i is not None and i >= 0})

    @torch.no_grad()
    def update_occ_grid(self):
        """Refresh the occupancy grid from the current SDF, through the
        f32 network (``nets.sdf_only``) as the JAX Runner does."""
        from fmov_pose_torch.render import occupancy
        if not hasattr(self, "_occ_pts"):
            self._occ_pts = torch.as_tensor(
                occupancy.make_grid_points(self.occ_grid_res), device=self.device)
        sdf = nets.sdf_only(self.state.params["sdf"], self.model_cfg["sdf"],
                            self._occ_pts)
        self.state.pose_static["occ_grid"] = occupancy.update_occ_grid(
            sdf, self.occ_grid_res)
        self.occ_refreshes += 1

    def reset_neus(self, seed=None):
        """Fresh SDF/color/NeRF/variance and a fresh Adam; the pose nets
        stay."""
        self.reset_count += 1
        seed = int(self.rng.integers(1 << 30)) if seed is None else seed
        params = self._field_params(seed)
        old = self.state.params
        keep = {k: old[k] for k in ("pose", "se3_refine") if k in old}
        params.update(convert.unflatten(
            (n, t.detach().clone()) for n, t in convert.flatten(keep)))
        st = self.state
        st.flat, st.layout, st.opt = self._set_fields(params)
        st.iter_step = 0
        if self.occupancy_sampling:
            st.pose_static["occ_grid"] = torch.ones(
                (self.occ_grid_res,) * 3, dtype=torch.float32, device=self.device)
        self.iter_step = 0
        self.mesh_warmup_step = self.conf.get_int("train.mesh_warmup_step", 0)

    # ------------------------------------------------------------------
    # the training loop
    # ------------------------------------------------------------------
    def _init_perms(self):
        if self.maintain_shape:
            self._image_perm = self.get_current_image_perm()
            self._prev_image_perm = self.get_prev_image_perm()
        else:
            self._image_perm = self.get_image_perm()
            self._prev_image_perm = None

    def _maybe_regen_perms(self):
        if self.iter_step % len(self._image_perm) == 0:
            self._image_perm = (self.get_current_image_perm()
                                if self.maintain_shape else self.get_image_perm())
        if (self.maintain_shape
                and self.iter_step % len(self._prev_image_perm) == 0):
            self._prev_image_perm = self.get_prev_image_perm()

    def _plan_step(self):
        """Every host-side decision of one step, packed into one row
        (``step.pack_scalars_np``).  Consumes the host RNG; mutates only the
        one-shot ``mesh_warmup_step`` reset and the segments' progress.
        Returns (packed, use_flow, pixels_pair, img_id)."""
        in_warmup = self.iter_step < self.mesh_warmup_step
        use_flow = (self.flow_weight > 0.0 and self.rng.random() < 0.5
                    and not in_warmup)
        img_id = int(self._image_perm[self.iter_step % len(self._image_perm)])
        if self.remove_prev_matches:
            if (abs(img_id - self.current_image) >= self.flow_interval
                    or self.current_image == self.dataset.n_images):
                use_flow = False

        flow_data = None
        img_id_corr = None
        if use_flow:
            flow_data = self._sample_flow_pair(img_id)
            if flow_data is None:
                use_flow = False
            else:
                img_id_corr = img_id
                img_id = flow_data[0]

        pose_update = 1.0
        if in_warmup and self.pose_mode != "gf":
            pose_update = 0.0
            if self.reset_based_on_rot and self.prev_pose is not None:
                img_id = int(self.rng.integers(0, self.current_image))
            else:
                img_id = 0
        elif self.mesh_warmup_step > 0 and not in_warmup:
            self.mesh_warmup_step = 0  # warm-up over, re-enable pose nets

        add_img_id = 0
        if self.maintain_shape:
            add_img_id = int(self._prev_image_perm[
                self.iter_step % len(self._prev_image_perm)])
            if in_warmup and self.pose_mode != "gf":
                add_img_id = 0

        touched = self._touched_segments(
            [img_id, img_id_corr, add_img_id if self.maintain_shape else None])
        main_update = 1.0
        if (self.detach_mesh_at_warm_up
                and self.iter_step > self.mesh_warmup_step
                and self.pro_iteration < self.pro_warm_up_end
                and self.current_pose_mlp_index in touched):
            main_update = 0.0

        seg_touch = np.zeros((self.n_segments,), np.float32)
        for s in touched:
            if s < self.n_segments:
                seg_touch[s] = 1.0
        seg_lr = self.seg_lrs([s for s in touched if s < self.n_segments])

        trans_head_on = 1.0
        if (self.disable_trans_during_warm_up
                and self.pro_iteration < self.pro_warm_up_end):
            trans_head_on = 0.0

        packed = step_mod.pack_scalars_np(
            self.main_lr(), self.get_cos_anneal_ratio(), main_update,
            pose_update,
            1.0 if (self.mask_guided_sampling and not in_warmup) else 0.0,
            trans_head_on, img_id, add_img_id,
            img_id_corr if img_id_corr is not None else 0,
            seg_touch, self.seg_frozen, seg_lr)

        pixels_pair = None
        if use_flow:
            _, pixels, pixels_corr = flow_data
            pixels_pair = np.concatenate([pixels_corr, pixels], axis=-1)
        return packed, use_flow, pixels_pair, img_id

    def _dispatch(self, packed, use_flow, pixels_pair):
        """One planned step on the device: the photo or the flow step."""
        scalars, img_id, add_img_id, img_id_corr = step_mod.unpack_scalars_np(
            packed, self.n_segments)
        if use_flow:
            self.flow_steps += 1
            self.state, metrics = self.flow_step(
                self.state, scalars, img_id, img_id_corr, add_img_id, pixels_pair)
        else:
            self.state, metrics = self.photo_step(self.state, scalars, img_id,
                                                  add_img_id)
        return metrics

    def _progressive_update(self):
        """Frame admission, segment switch, warm-up end, rotation reset."""
        if self._pro_tick():
            self._pro_events()

    def _pro_tick(self):
        """Advance the progressive counter by one step; True when an event
        (admission or warm-up end) fires at the new count.  Host only."""
        if not (self.pose_mode == "seg" and self.pro_iteration >= 0
                and self.iter_step > self.mesh_warmup_step):
            return False
        self.pro_iteration += 1
        return (self.pro_iteration == self.max_pro_iteration
                or self.pro_iteration == self.pro_warm_up_end)

    def _pro_events(self):
        if self.pro_iteration == self.max_pro_iteration:
            self.pro_iteration = 0
            prev_image = self.current_image
            self.current_image = min(self.current_image + self.image_interval,
                                     self.dataset.n_images)
            if self.current_image > prev_image:
                if self.reset_based_on_rot:
                    if self.prev_pose is None:
                        self.prev_pose = self.query_pose(0)[:3, :3]
                    cur_pose = self.query_pose(prev_image - 1)[:3, :3]
                    rel = cur_pose @ np.linalg.inv(self.prev_pose)
                    if rotation_error_deg(rel) > self.reset_rot_threshold:
                        LOG.info("rotation reset at image %d", prev_image)
                        self.reset_neus()
                        self.prev_pose = cur_pose
                self.current_pose_mlp_index += 1
                # freeze all previous segments; the new segment trains alone
                self.seg_frozen[:] = 0.0
                if self.current_pose_mlp_index < self.n_segments:
                    self.seg_frozen[self.current_pose_mlp_index] = 1.0
                    # lazy init of the new segment from the previous one
                    pp.seg_initialize(self.state.pose_bank, self.pose_cfg,
                                      self.image_interval, self.current_pose_mlp_index)
            else:
                self.pro_iteration = -1  # all frames admitted
            LOG.info("admitted frames: %d (segment %d)", self.current_image,
                     self.current_pose_mlp_index)
        if self.pro_iteration == self.pro_warm_up_end:
            # unfreeze all previous segments after the new segment's warm-up
            self.seg_frozen[:self.current_pose_mlp_index + 1] = 1.0

    def train(self):
        """Train to ``end_iter``, or until phase 1 has admitted every frame
        (with a global conf).  Fills ``self.history`` (every metric of
        every step, read back once at the end) and, on CUDA,
        ``self.step_ms`` (per-step times from events between steps)."""
        res_step = self.end_iter - self.iter_step
        self._init_perms()
        on_cuda = self.device.type == "cuda"
        events = []
        log = []
        t_start = time.perf_counter()
        rays_per_step = self.batch_size * (2 if self.maintain_shape else 1)
        rays_done = 0
        if on_cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        for _ in range(res_step):
            packed, use_flow, pixels_pair, _ = self._plan_step()
            metrics = self._dispatch(packed, use_flow, pixels_pair)
            self.iter_step += 1
            rays_done += rays_per_step
            log.append(metrics)
            if (self.occupancy_sampling
                    and self.iter_step % self.occ_update_freq == 0):
                self.update_occ_grid()
            if on_cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()

            if self.iter_step % self.report_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_start
                LOG.info("iter %d loss=%.4f color=%.4f eik=%.4f psnr=%.2f "
                         "rays/s=%.0f dir=%s",
                         self.iter_step, m["loss"], m["color_loss"],
                         m["eikonal_loss"], m["psnr"],
                         rays_done / max(dt, 1e-9), self.base_exp_dir)
            if self.iter_step % self.val_freq == 0:
                # the JAX Runner's validate_image draws its frame here
                idx = int(self.rng.integers(self.current_image))
                LOG.info("validate_image(%d) skipped: not in the port yet "
                         "(ROADMAP queue 1, item 10)", idx)
            self._progressive_update()
            self._maybe_regen_perms()
            if ("_wo_global_conf" not in self.base_exp_dir
                    and self.pro_iteration == -1
                    and self.current_image == self.dataset.n_images):
                LOG.info("all %d frames admitted: phase 1 ends (its mesh and "
                         "checkpoint are ROADMAP queue 1, items 1 and 10)",
                         self.current_image)
                break

        if on_cuda:
            torch.cuda.synchronize(self.device)
            self.step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        self.train_seconds = time.perf_counter() - t_start
        if log:
            stacked = {k: torch.stack([m[k] for m in log]).cpu().tolist()
                       for k in log[0]}
            for k, v in stacked.items():
                self.history.setdefault(k, []).extend(v)
        LOG.info("trained %d steps (%d flow) in %.1f s (checkpoints and "
                 "validation are not in the port yet)", len(log), self.flow_steps,
                 self.train_seconds)

    # ------------------------------------------------------------------
    def file_backup(self):
        """Copy the port's sources and the conf into <exp>/recording."""
        rec_dir = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec_dir, exist_ok=True)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        pkg = os.path.join(repo_root, "fmov_pose_torch")
        for root, _dirs, files in os.walk(pkg):
            if "_build" in root or "__pycache__" in root:
                continue
            for fn in files:
                if fn.endswith((".py", ".cu", ".cuh")):
                    rel = os.path.relpath(os.path.join(root, fn), repo_root)
                    dst = os.path.join(rec_dir, rel)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copyfile(os.path.join(root, fn), dst)
        shutil.copyfile(self.conf_path, os.path.join(rec_dir, "config.conf"))
