"""Experiment runner, non-progressive subset (port of
``fmov_pose_tpu/train/runner.py:85-447, 506-520, 811-916``).

Reads the reference's .conf files with the port's HOCON reader
(``data/hocon.py``) and trains one
configuration with a plain Python loop: a report line every
``report_freq`` steps.  The data is either a dataset object the caller
passes (``data/scene.py``, or anything with the same fields) or the JAX
package's host ``Dataset`` read from the conf's ``data_dir``.

What this subset leaves out raises ``NotImplementedError`` naming its
ROADMAP item: the progressive curriculum, segment banks and flow steps
(slice 2), checkpoints, the eval and export modes, and data parallelism.
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


class Runner:
    def __init__(self, conf_path, mode="train", case="CASE_NAME",
                 dataset="DTU", is_continue=False, start_at=-1,
                 start_img_idx=0, gradient_analysis=False, exp_dir=None,
                 has_global_conf=False, flow_interval=-1,
                 reset_rot_degree=-1, image_interval=-1, seed=2024,
                 device="cpu", scene=None):
        """``device``: where the state and the step run.  ``scene``: an
        in-memory dataset used instead of the conf's data_dir."""
        if not mode.startswith("train"):
            _unsupported(f"mode {mode!r}", "item 10 (eval and export)")
        if is_continue:
            _unsupported("--is_continue (checkpoints)", "item 1")
        if gradient_analysis:
            _unsupported("--gradient_analysis", "item 10")
        if flow_interval > 0 or reset_rot_degree > 0 or image_interval > 0:
            _unsupported("progressive-phase flags", "item 9")
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
        if start_img_idx > 0:
            self.base_exp_dir += f"_start_at_{start_img_idx}"
        os.makedirs(self.base_exp_dir, exist_ok=True)
        conf.put("dataset.start_idx", start_img_idx)

        t = conf["train"]
        if conf.get_bool("train.progressive", False):
            _unsupported("the progressive curriculum", "items 8-9")
        for key, item in (("train.flow_weight", "item 8 (flow step)"),
                          ("train.depth_weight", "item 6 (depth loss)")):
            if conf.get_float(key, 0.0) > 0:
                _unsupported(key, item)
        for key, item in (("train.maintain_shape", "item 8"),
                          ("train.occupancy_sampling", "item 4 (occupancy grid)"),
                          ("model.pixel_level", "item 8"),
                          ("train.use_fused_train_kernels",
                           "queue 2 (fused training kernels)")):
            if conf.get_bool(key, False):
                _unsupported(key, item)

        if scene is None:
            from fmov_pose_tpu.data.dataset import Dataset  # imports cv2
            scene = Dataset(conf["dataset"], exp_dir)
        self.dataset = scene
        self.iter_step = 0

        self.end_iter = t.get_int("end_iter")
        self.report_freq = t.get_int("report_freq")
        self.batch_size = t.get_int("batch_size")
        self.learning_rate = t.get_float("learning_rate")
        self.learning_rate_alpha = t.get_float("learning_rate_alpha")
        self.use_white_bkgd = t.get_bool("use_white_bkgd")
        self.warm_up_end = conf.get_float("train.warm_up_end", 0.0)
        self.anneal_end = conf.get_float("train.anneal_end", 0.0)
        self.mask_guided_sampling = conf.get_bool(
            "train.mask_guided_sampling", False)
        self.mask_guided_patch_size = conf.get_int(
            "train.mask_guided_patch_size", 30)
        self.mesh_warmup_step = conf.get_int("train.mesh_warmup_step", 0)
        self.only_rotation = conf.get_bool("train.only_rotation", False)
        self.mask_init = conf.get_bool("dataset.mask_init", False)

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
        if self.model_cfg["renderer"].n_outside > 0:
            _unsupported("n_outside > 0 (NeRF++ background)", "item 4")
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
            _unsupported("pose_type = seg (segment pose banks)", "item 8")
        elif self.pose_type == "gf":
            self.pose_mode = "gf"
        elif self.barf:
            self.pose_mode = "se3"
        else:
            self.pose_mode = "fixed"
        self.pose_cfg = pp.PoseCfg(
            emphasize_rot=bool(conf.get("train.emphasize_rot", False)),
            small_rot=bool(conf.get("train.small_rot", False)))

        self._init_device_buffers()
        self._init_state(noise_poses, seed)
        self._build_steps()
        self.file_backup()

        n_override = conf.get_int("dataset.n_images", self.dataset.n_images)
        self.dataset.n_images = min(n_override, self.dataset.n_images)
        self.history = {}   # metric -> per-step floats, filled by train()
        self.step_ms = []   # per-step device-timeline ms (CUDA only)

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

    def _init_state(self, noise_poses, seed):
        params = self._field_params(seed)
        dev = self.device
        if self.pose_mode == "gf":
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

        layout = convert.ParamLayout(params)
        flat = layout.ravel(params, dev).requires_grad_(True)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed + 1)
        self.state = step_mod.TrainState(
            flat=flat, layout=layout, opt=optim.adam_init(flat.detach()),
            pose_static=pose_static, generator=generator)

    def _build_steps(self):
        self.step_cfg = step_mod.make_step_config(
            self.model_cfg,
            batch_size=self.batch_size,
            H=self.dataset.H, W=self.dataset.W,
            pose_mode=self.pose_mode,
            pose_cfg=self.pose_cfg,
            igr_weight=self.conf.get_float("train.igr_weight"),
            mask_weight=self.conf.get_float("train.mask_weight"),
            unit_sphere_weight=self.conf.get_float(
                "train.unit_sphere_weight", 0.0),
            use_white_bkgd=self.use_white_bkgd,
            mask_guided_sampling=self.mask_guided_sampling,
            mask_guided_patch_size=self.mask_guided_patch_size,
            only_rotation=self.only_rotation,
        )
        self.photo_step = step_mod.make_photo_step(
            self.step_cfg, self.images_dev, self.masks_dev,
            self.intr_inv_dev, self.bbox_dev)

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

    def get_image_perm(self):
        return self.rng.permutation(self.dataset.n_images)

    # ------------------------------------------------------------------
    def _plan_step(self, image_perm):
        """Host-side decisions of one step: (img_id, StepScalars)."""
        in_warmup = self.iter_step < self.mesh_warmup_step
        img_id = int(image_perm[self.iter_step % len(image_perm)])
        pose_update = 1.0
        if in_warmup and self.pose_mode != "gf":
            pose_update = 0.0
            img_id = 0
        elif self.mesh_warmup_step > 0 and not in_warmup:
            self.mesh_warmup_step = 0  # warm-up over, re-enable pose nets
        scalars = step_mod.StepScalars(
            lr=self.main_lr(), cos_anneal=self.get_cos_anneal_ratio(),
            main_update=1.0, pose_update=pose_update,
            mask_guided=(1.0 if (self.mask_guided_sampling and not in_warmup)
                         else 0.0),
            trans_head_on=1.0)
        return img_id, scalars

    def train(self):
        """Train to ``end_iter``.  Fills ``self.history`` (every metric of
        every step, read back once at the end) and, on CUDA,
        ``self.step_ms`` (per-step times from events between steps)."""
        res_step = self.end_iter - self.iter_step
        image_perm = self.get_image_perm()
        on_cuda = self.device.type == "cuda"
        events = []
        log = []
        t_start = time.perf_counter()
        rays_done = 0
        if on_cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        for _ in range(res_step):
            img_id, scalars = self._plan_step(image_perm)
            self.state, metrics = self.photo_step(self.state, scalars, img_id)
            self.iter_step += 1
            rays_done += self.batch_size
            log.append(metrics)
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
            if self.iter_step % len(image_perm) == 0:
                image_perm = self.get_image_perm()

        if on_cuda:
            torch.cuda.synchronize(self.device)
            self.step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        self.train_seconds = time.perf_counter() - t_start
        if log:
            stacked = {k: torch.stack([m[k] for m in log]).cpu().tolist()
                       for k in log[0]}
            for k, v in stacked.items():
                self.history.setdefault(k, []).extend(v)
        LOG.info("trained %d steps in %.1f s (checkpoints and validation are "
                 "not in the port yet)", res_step, self.train_seconds)

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
