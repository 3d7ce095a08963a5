"""Experiment runner (port of ``fmov_pose_tpu/train/runner.py``: the
training lifecycle of one conf, phase 1 or phase 2).

Reads the reference's .conf files with the port's HOCON reader
(``data/hocon.py``) and trains on the device the caller names (``device``;
by default the CUDA device, which must exist) with one of the JAX Runner's
three loops, chosen in its order: the scan path (``_train_scan``: k =
``train.scan_chunk`` steps a dispatch, on CUDA one captured step replayed
k times) wherever ``_scan_eligible`` admits the phase, as JAX does by
default (``train.scan_steps``); else the planned path (``_train_planned``,
``train.plan_chunk`` > 1: chunks of up to k steps planned on the host, on
CUDA the photo and the flow step captured and replayed row by row); else
a plain Python loop, one planned step per iteration.  The data is a
dataset object the caller
passes (``data/scene.py``, or anything with the same fields) or the
port's host ``Dataset`` read from the conf's ``data_dir``.

The host plans every step as the JAX Runner does, consuming its numpy RNG
in the same order (``_plan_step``): the frame, the flow coin and the LoFTR
pair of a flow step, the warm-up gates, and per segment the touch, freeze
and learning rate.  The progressive phase 1 (``train.progressive``,
``pose_type = seg``) admits ``image_interval`` frames every
``max_pro_iteration`` steps past the mesh warm-up, trains the newest
segment's pose net (``model.pixel_level``: a deep pose net,
``poses/pixel_pose.py``) alone until ``pro_warm_up_end``, lazily initialises
each new segment from the last pose of the one before, and with
``reset_based_on_rot`` restarts the NeuS fields when the admitted frames
have turned by more than ``reset_rot_threshold`` degrees.  Photo and flow
steps alternate on the flow coin; ``maintain_shape`` adds a batch of an
earlier frame to every step.

The fused training kernels (``train.use_fused_train_kernels``: K2/K3 or
K4/K5 for the SDF, K8/K9 or K6/K7 for the color), the NeRF++ background
(``n_outside > 0``, trained with the fields) and the occupancy grid
(``train.occupancy_sampling``, refreshed after every ``occ_update_freq``-th
step) are taken as in the JAX Runner.

Checkpoints (``save_checkpoint``, ``load_checkpoint``; ``is_continue``
resumes from the latest) are the JAX package's files: the port reads the
JAX Runner's and writes its own in the same leaf order
(``train/checkpoint.py``).  The loop saves and extracts meshes
(``validate_mesh``, on K1 when the conf enables it) where the JAX loop
does: a mesh every ``val_mesh_freq`` steps, a checkpoint every
``save_freq``, both at the end of phase 1, a checkpoint at the end.  It
keeps no per-step tensor: each step writes its metrics into its row of one
preallocated device buffer, read back once after the loop into
``history``.

Between the phases of a two-phase run, ``save_aligned_poses`` maps phase
1's virtual-camera poses to the real camera (phase 1's 64^3 mesh and
PnP, ``pipeline/align.py``) and writes the phase-2 dataset;
``save_poses_simple`` writes the learned poses at the end.

The eval and export methods are the JAX Runner's, under the same file
names: ``eval_render`` (the render in eval mode, under ``torch.no_grad``,
never on the occupancy grid, through the fused kernels wherever the conf's
gates put a training render) and ``render_rays_chunked`` on it,
``validate_image``, ``validate_poses``, ``save_poses``,
``render_novel_image`` / ``interpolate_view``, ``rays_from_mask`` /
``render_poses``, ``validate_all_images``, ``save_alignment_materials``
and ``gradient_analysis_report`` (``--gradient_analysis``).  The training
loop calls ``validate_image`` every ``val_freq`` steps, ``validate_poses``
every ``pose_freq`` and the gradient report where the JAX loop does, each
inside a ``try`` that logs a warning and trains on, as the JAX loop does.

Depth supervision (``train.depth_weight > 0``: the Dataset's optional
``depth/`` maps, a masked L1 on the rendered depth) and bf16 activations
(``train.compute_dtype``, per network; the fused kernels ignore it, as
the JAX ones do) are the JAX Runner's.  ``train.matmul_precision``
(``default``, ``high`` or ``highest``, else ``ValueError``) sets PyTorch's
f32 matmul precision (``MATMUL_PRECISION``: ``highest`` full f32,
``high`` TF32, ``default`` ``"medium"``) while ``train`` and
``eval_render`` run, and restores the caller's setting after them; the
CUDA kernels ignore it, as the Pallas kernels do; with the key absent the
setting is left alone (full f32 unless the caller changed it).

Data parallelism (``parallel/dp.py``) follows the JAX Runner: launched as
one of several ranks (``FMOV_DISTRIBUTED=1``, ``torchrun``), the Runner
joins the process group before any device use and runs on
``cuda:(rank mod device_count)``; ``train.data_parallel`` (on by default
with more than one rank) splits the ray batch over the ranks when the
batch and its half divide by their number (``use_dp``).  Under it the
per-step loop takes the data-parallel photo and flow steps, the scan path
the data-parallel scanned steps (captured with their all-reduces under
NCCL, eager under gloo), and the planned path is not taken, as in JAX.
Every rank runs every step and every host decision alike (the same seed,
the same host RNG), so the curriculum, the rotation reset, the occupancy
refresh and the field resets agree; the state is broadcast from rank 0 at
the start and after a checkpoint is loaded (``dp.replicate_tree``).  The
host's writes are rank 0's (``is_main``): checkpoints, meshes, validation
images, pose files, the phase-2 dataset and the source backup; the other
ranks wait for the phase-2 dataset at a barrier.

The host's work outside the steps is named by spans (``tracing.span``):
``fmov::runner_init`` (``__init__``, with ``fmov::file_backup``),
``fmov::chunk`` (a chunk's dispatch, or a step's on the per-step loop),
``fmov::plan_chunk``, ``fmov::pack_rows``, ``fmov::events_after``,
``fmov::pro_events``, ``fmov::grid_refresh``, ``fmov::validate_mesh`` and
``fmov::checkpoint``; ``_finish`` logs their table in one line.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from fmov_pose_torch import convert, tracing
from fmov_pose_torch.data import hocon
from fmov_pose_torch.data import rays as raygen
from fmov_pose_torch.fields import nets
from fmov_pose_torch.parallel import dp
from fmov_pose_torch.poses import picture_pose as pp
from fmov_pose_torch.poses import pixel_pose as px
from fmov_pose_torch.pipeline import meshio
from fmov_pose_torch.render import geometry, neus
from fmov_pose_torch.train import checkpoint as ckpt
from fmov_pose_torch.train import optim, step as step_mod

LOG = logging.getLogger(__name__)


# train.matmul_precision -> torch.set_float32_matmul_precision: the JAX
# values' meaning on this backend (full f32; TF32; bf16-pass products)
MATMUL_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


@contextlib.contextmanager
def matmul_precision(setting):
    """PyTorch's f32 matmul precision at ``setting`` inside the block (None:
    left alone), the caller's restored after it."""
    if setting is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(setting)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def rotation_error_deg(rel_R: np.ndarray) -> float:
    d = 0.5 * (rel_R[0, 0] + rel_R[1, 1] + rel_R[2, 2] - 1.0)
    return float(np.arccos(max(min(d, 1.0), -1.0)) * 180.0 / np.pi)


class StepTimer:
    """Per-step device-timeline ms from a fixed ring of CUDA events: the
    event ending step n takes the slot of the one that ended step n - RING,
    whose step time is read first.  The host runs at most a few steps ahead
    of the device (its launch queue is bounded), so that read waits for
    nothing."""
    RING = 64

    def __init__(self):
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(self.RING)]
        self.ms = []
        self.n = 0
        self.events[0].record()

    def _read(self, k):
        """Step k's time (1-based): from event k-1 to event k; read in
        order."""
        end = self.events[k % self.RING]
        end.synchronize()
        self.ms.append(self.events[(k - 1) % self.RING].elapsed_time(end))

    def tick(self):
        self.n += 1
        if self.n >= self.RING:
            self._read(self.n - self.RING + 1)
        self.events[self.n % self.RING].record()

    def finish(self):
        """The times of the steps recorded, as a list."""
        for k in range(max(1, self.n - self.RING + 2), self.n + 1):
            self._read(k)
        return list(self.ms)


class Runner:
    @tracing.span("fmov::runner_init")
    def __init__(self, conf_path, mode="train", case="CASE_NAME",
                 dataset="DTU", is_continue=False, start_at=-1,
                 start_img_idx=0, gradient_analysis=False, exp_dir=None,
                 has_global_conf=False, flow_interval=-1,
                 reset_rot_degree=-1, image_interval=-1, seed=2024,
                 device=None, scene=None):
        """``device``: where the state and the step run; None is the CUDA
        device (raises without one), the CPU only when asked for by name.
        ``scene``: an in-memory dataset used instead of the conf's
        data_dir.  ``is_continue``: resume from the latest checkpoint under
        <exp>/checkpoints, or start afresh with a warning when there is
        none, as the JAX Runner does."""
        # data parallelism: join the process group before any device use
        dp.maybe_initialize_distributed()
        self.is_main = dp.is_main()
        if device is None:
            device = dp.local_device()
        self.seed = seed
        self.case = case
        self.mode = mode
        self.conf_path = conf_path
        self.gradient_analysis = gradient_analysis
        self.device = torch.device(device)
        # the host RNG is not checkpointed: a resumed Runner restarts it from
        # the seed, as the JAX Runner does
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
            conf.put("dataset.load_depth", True)
        mm_prec = conf.get("train.matmul_precision", None)
        if mm_prec is not None and mm_prec not in MATMUL_PRECISION:
            raise ValueError(f"train.matmul_precision must be default/high/highest, "
                             f"got {mm_prec!r}")
        self.matmul_precision = MATMUL_PRECISION.get(mm_prec)

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
        world = dp.world_size()
        self.use_dp = (conf.get_bool("train.data_parallel", world > 1) and world > 1
                       and self.batch_size % world == 0
                       and (self.batch_size // 2) % world == 0)
        if self.use_dp:
            LOG.info("data-parallel over %d ranks (%s)", world, dist.get_backend())
        self.validate_resolution_level = t.get_int("validate_resolution_level")
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
        self.depth_weight = conf.get_float("train.depth_weight", 0.0)

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
            self.pose_mode = ("seg_pixel" if conf.get_bool("model.pixel_level", False)
                              else "seg")
        elif self.pose_type == "gf":
            self.pose_mode = "gf"
        elif self.barf:
            self.pose_mode = "se3"
        else:
            self.pose_mode = "fixed"
        self.pose_cfg = pp.PoseCfg(
            emphasize_rot=bool(conf.get("train.emphasize_rot", False)),
            small_rot=bool(conf.get("train.small_rot", False)))
        self.deep_pose_cfg = (px.DeepPoseCfg(n_images=self.dataset.n_images)
                              if self.pose_mode == "seg_pixel" else None)
        self.n_segments = (pp.num_segments(self.dataset.n_images, self.image_interval)
                           if self.pose_mode in step_mod.BANK_MODES else 1)
        self.current_pose_mlp_index = 0
        self.pro_iteration = 0
        self.reset_count = 0  # rotation-triggered reset_neus firings
        self.seg_progress = np.zeros((self.n_segments,), np.float64)
        self.seg_frozen = np.ones((self.n_segments,), np.float32)  # 1 = trainable

        self._init_device_buffers()
        self._init_state(noise_poses, seed)
        self._build_steps()

        if is_continue:
            ckpt_dir = os.path.join(self.base_exp_dir, "checkpoints")
            latest = ckpt.latest_checkpoint(ckpt_dir)
            if latest is not None:
                self.load_checkpoint(latest)
            else:
                LOG.warning("--is_continue: no checkpoint under %s, starting from "
                            "scratch (check --global_conf: it changes the exp dir)",
                            ckpt_dir)
        if mode.startswith("train") and self.is_main:
            self.file_backup()

        n_override = conf.get_int("dataset.n_images", self.dataset.n_images)
        self.dataset.n_images = min(n_override, self.dataset.n_images)
        self.history = {}   # metric -> per-step floats, filled by train()
        self.eval_chunks = 0  # chunks through render_rays_chunked
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
        # depth maps only where the loss is on and the data has them
        depths = getattr(d, "depths_np", None)
        self.depths_dev = (torch.as_tensor(np.asarray(depths, np.float32), device=dev)
                           if depths is not None and self.depth_weight > 0 else None)

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
        elif self.pose_mode == "seg_pixel":
            bank = px.init_seg_deep_bank(seed, self.deep_pose_cfg, self.dataset.n_images,
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
                k: v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in bank["static"].items()}
            self.state.pose_opt = optim.seg_adam_init(
                bank_flat.detach(), bank_layout.shapes, self.n_segments)
        if self.use_dp:
            dp.attach_rank_generator(self.state, seed)
            dp.replicate_tree(self._replicated())

    def _replicated(self):
        """The state every rank holds alike: its tensors and the shared
        generator (not a rank's own, ``TrainState.ray_generator``)."""
        written, read = step_mod.state_buffers(self.state)
        return [*written, *read, self.state.generator]

    def _build_steps(self):
        self.step_cfg = step_mod.make_step_config(
            self.model_cfg,
            batch_size=self.batch_size,
            H=self.dataset.H, W=self.dataset.W,
            n_segments=self.n_segments,
            segment_img_num=self.image_interval,
            pose_mode=self.pose_mode,
            pose_cfg=self.pose_cfg,
            deep_pose_cfg=self.deep_pose_cfg,
            igr_weight=self.igr_weight,
            mask_weight=self.mask_weight,
            flow_weight=self.flow_weight,
            depth_weight=self.depth_weight if self.depths_dev is not None else 0.0,
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
        if self.use_dp:
            self.photo_step = dp.make_dp_photo_step(self.step_cfg, *bufs,
                                                    depths=self.depths_dev)
            self.flow_step = dp.make_dp_flow_step(self.step_cfg, *bufs)
        else:
            self.photo_step = step_mod.make_photo_step(self.step_cfg, *bufs,
                                                       depths=self.depths_dev)
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
        """A partner frame and a batch of its matches, or None.  The
        partners are a set, iterated as the JAX Runner iterates it; under
        data parallelism in sorted order, the one order every rank shares
        (a set of strings iterates in the order of the process's salted
        string hash)."""
        d = self.dataset
        name_corr = d.index_to_frame[img_id_corr]
        if name_corr not in d.flow_pairs:
            return None
        names = d.flow_pairs[name_corr]
        pairs_idx = [d.frame_to_index[n] for n in (sorted(names) if self.use_dp else names)]
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
    @tracing.span("fmov::grid_refresh")
    def update_occ_grid(self):
        """Refresh the occupancy grid from the current SDF, through the
        f32 network (``nets.sdf_only``) as the JAX Runner does."""
        from fmov_pose_torch.render import occupancy
        if not hasattr(self, "_occ_pts"):
            self._occ_pts = torch.as_tensor(
                occupancy.make_grid_points(self.occ_grid_res), device=self.device)
        sdf = nets.sdf_only(self.state.params["sdf"], self.model_cfg["sdf"],
                            self._occ_pts)
        # in place: a captured step (train/graph.py) reads the grid's address
        self.state.pose_static["occ_grid"].copy_(
            occupancy.update_occ_grid(sdf, self.occ_grid_res))
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
            st.pose_static["occ_grid"].fill_(1.0)
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
        if not (self.pose_mode in step_mod.BANK_MODES and self.pro_iteration >= 0
                and self.iter_step > self.mesh_warmup_step):
            return False
        self.pro_iteration += 1
        return (self.pro_iteration == self.max_pro_iteration
                or self.pro_iteration == self.pro_warm_up_end)

    @tracing.span("fmov::pro_events")
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
                    if self.pose_mode == "seg_pixel":
                        px.seg_deep_initialize(self.state.pose_bank, self.deep_pose_cfg,
                                               self.image_interval,
                                               self.current_pose_mlp_index)
                    else:
                        pp.seg_initialize(self.state.pose_bank, self.pose_cfg,
                                          self.image_interval, self.current_pose_mlp_index)
            else:
                self.pro_iteration = -1  # all frames admitted
            LOG.info("admitted frames: %d (segment %d)", self.current_image,
                     self.current_pose_mlp_index)
        if self.pro_iteration == self.pro_warm_up_end:
            # unfreeze all previous segments after the new segment's warm-up
            self.seg_frozen[:self.current_pose_mlp_index + 1] = 1.0

    def _scan_eligible(self):
        """k > 0 when the phase can run k steps a dispatch (the JAX Runner's
        rule): ``train.scan_steps`` on (the default), a fixed or gf pose,
        no flow, curriculum, maintain_shape, gradient report, rotation
        reset or mesh warm-up, so that every per-step decision is a pure
        function of iter_step; k = ``train.scan_chunk`` (100) divides
        every event's frequency (the grid refresh's too) and iter_step."""
        if not self.conf.get_bool("train.scan_steps", True):
            return 0
        if (self.pose_mode not in ("fixed", "gf") or self.flow_weight > 0
                or self.progressive or self.maintain_shape
                or self.gradient_analysis or self.reset_based_on_rot
                or self.mesh_warmup_step > 0):
            return 0
        k = self.conf.get_int("train.scan_chunk", 100)
        freqs = [self.report_freq, self.val_freq, self.val_mesh_freq,
                 self.save_freq, self.pose_freq]
        if self.occupancy_sampling:
            freqs.append(self.occ_update_freq)
        if any(f % k for f in freqs) or self.iter_step % k:
            return 0
        return k

    def _plan_eligible(self):
        """k > 1 when the loop can run chunks of k host-planned steps (the
        JAX Runner's rule): ``train.plan_chunk`` > 1, no data parallelism
        and no gradient report."""
        k = self.conf.get_int("train.plan_chunk", 1)
        if k <= 1 or self.use_dp or self.gradient_analysis:
            return 0
        return k

    def train(self):
        """Train to ``end_iter``, or until phase 1 has admitted every frame
        (with a global conf: then its mesh and checkpoint), on the first of
        the JAX Runner's loops that admits the phase: the scan path
        (``_scan_eligible``), the planned path (``_plan_eligible``), the
        per-step loop; ``self.dispatch`` says which ran ("scan x{k}",
        "planned x{k}" or "per-step").  Fills ``self.history`` (every
        metric of every step, or of every chunk on the scan path, read back
        once at the end) and, on CUDA, ``self.step_ms`` (times from events
        between steps; between chunks, a chunk's time over its steps, on
        the scan and the planned path).  Runs at ``train.matmul_precision``.
        Under data parallelism ``dispatch`` also names the ranks and, on
        the scan path, whether the chunk's step was captured."""
        with matmul_precision(self.matmul_precision):
            k = self._scan_eligible()
            if k:
                LOG.info("scan training: %d steps per dispatch", k)
                return self._train_scan(k)
            k = self._plan_eligible()
            if k:
                LOG.info("planned training: up to %d steps per dispatch", k)
                return self._train_planned(k)
            return self._train_per_step()

    def _rate_start(self, done):
        """(host seconds, rows done) once the device has run the first
        ``done`` rows: where the report line's rays/s counts from."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter(), done

    def _events_after(self, done, rows, rate_from, rays_per_row, tag):
        """The JAX loops' events at iter_step after a step or a chunk: the
        report line (history row ``done - 1``: the last step's metrics, or
        the scanned chunk's means; rays/s over the rows since ``rate_from``,
        ``_rate_start``'s (seconds, rows) at the end of the first whole
        chunk, as ``step_ms`` counts, so not the capture, or the loop's
        start on the per-step path; none before it), validate_image and
        validate_poses (each caught)."""
        with tracing.span("fmov::events_after"):
            if self.iter_step % self.report_freq == 0:
                m = dict(zip(step_mod.METRIC_NAMES, rows[done - 1].tolist()))  # the one sync
                rate = ""
                if rate_from is not None and done > rate_from[1]:
                    dt = time.perf_counter() - rate_from[0]
                    rate = " rays/s=%.0f" % ((done - rate_from[1]) * rays_per_row
                                             / max(dt, 1e-9))
                LOG.info("iter %d loss=%.4f color=%.4f eik=%.4f psnr=%.2f%s %s",
                         self.iter_step, m["loss"], m["color_loss"], m["eikonal_loss"],
                         m["psnr"], rate, tag)
            if self.iter_step % self.val_freq == 0:
                try:
                    self.validate_image()
                except Exception as e:  # keep training through viz errors
                    LOG.warning("validate_image failed: %s", e, exc_info=True)
            if self.iter_step % self.pose_freq == 0:
                try:
                    self.validate_poses()
                except Exception as e:
                    LOG.warning("validate_poses failed: %s", e, exc_info=True)

    def _mesh_event(self):
        """validate_mesh every ``val_mesh_freq`` steps (caught)."""
        if self.iter_step % self.val_mesh_freq == 0:
            with tracing.span("fmov::validate_mesh"):
                try:
                    self.validate_mesh()
                except Exception as e:  # keep training, as the JAX loop does
                    LOG.warning("validate_mesh failed: %s", e, exc_info=True)

    def _phase1_over(self):
        """Phase 1 of a two-phase run ends once every frame is admitted."""
        return ("_wo_global_conf" not in self.base_exp_dir and self.pro_iteration == -1
                and self.current_image == self.dataset.n_images)

    def _finish(self, rows, done, t_start, phase1_done, steps_a_row=1):
        """The end of every loop: the history read back once (``done``
        rows of ``steps_a_row`` steps), phase 1's mesh where it ended, the
        last checkpoint, then the spans' table (``tracing.SPANS``) logged
        in one line."""
        self.train_seconds = time.perf_counter() - t_start
        if done:
            cols = rows[:done].cpu().numpy()
            for j, k in enumerate(step_mod.METRIC_NAMES):
                self.history.setdefault(k, []).extend(cols[:, j].tolist())
        LOG.info("trained %d steps (%d flow) in %.1f s", done * steps_a_row,
                 self.flow_steps, self.train_seconds)
        if phase1_done:
            LOG.info("all %d frames admitted: phase 1 ends", self.current_image)
            self.validate_mesh()
        self.save_checkpoint()
        LOG.info("spans: %s", tracing.summary())

    def _train_per_step(self):
        """The JAX Runner's per-step loop: plan a step, run it, then its
        events in the JAX loop's order."""
        self.dispatch = "per-step" + self._dp_tag()
        res_step = max(self.end_iter - self.iter_step, 0)
        self._init_perms()
        names = step_mod.METRIC_NAMES
        rows = torch.empty((res_step, len(names)), dtype=torch.float32,
                           device=self.device)
        timer = StepTimer() if self.device.type == "cuda" else None
        t_start = time.perf_counter()
        rays_per_step = self.batch_size * (2 if self.maintain_shape else 1)
        done = 0
        phase1_done = False
        for _ in range(res_step):
            packed, use_flow, pixels_pair, img_id = self._plan_step()
            with tracing.span("fmov::chunk"):
                metrics = self._dispatch(packed, use_flow, pixels_pair)
                torch.stack([metrics[k] for k in names], out=rows[done])
            done += 1
            self.iter_step += 1
            if (self.occupancy_sampling
                    and self.iter_step % self.occ_update_freq == 0):
                self.update_occ_grid()
            if timer is not None:
                timer.tick()
            if self.gradient_analysis and self.iter_step % self.report_freq == 1:
                try:
                    self.gradient_analysis_report(img_id)
                except Exception as e:  # keep training, as the JAX loop does
                    LOG.warning("gradient_analysis failed: %s", e, exc_info=True)
            self._events_after(done, rows, (t_start, 0), rays_per_step,
                               f"dir={self.base_exp_dir}")
            self._progressive_update()
            self._mesh_event()
            self._maybe_regen_perms()
            if self.iter_step % self.save_freq == 0 and self.iter_step > 0:
                self.save_checkpoint()
            if self._phase1_over():
                phase1_done = True
                break
        if timer is not None:
            self.step_ms = timer.finish()
        self._finish(rows, done, t_start, phase1_done)

    def planned_steps(self, k, capture=None):
        """The planned steps of this Runner's step config
        (``step.PlannedSteps``, chunks of up to k steps)."""
        return step_mod.PlannedSteps(
            self.step_cfg, self.images_dev, self.masks_dev, self.intr_inv_dev,
            self.bbox_dev, k, capture, depths=self.depths_dev)

    def _plan_chunk(self, K):
        """Up to K steps planned as the per-step loop plans them
        (``_plan_step``, ``_pro_tick``, ``_maybe_regen_perms`` in its order,
        consuming the host RNG alike): at most to the next boundary of
        every frequency and of ``end_iter``, and ending with the step at
        which a progressive event fires.  Returns ([(packed, use_flow,
        pixels_pair)], event)."""
        with tracing.span("fmov::plan_chunk"):
            freqs = [self.report_freq, self.val_freq, self.pose_freq,
                     self.val_mesh_freq, self.save_freq]
            if self.occupancy_sampling:
                freqs.append(self.occ_update_freq)
            gap = min(f - self.iter_step % f for f in freqs)
            plan, event = [], False
            for _ in range(min(K, self.end_iter - self.iter_step, gap)):
                packed, use_flow, pixels_pair, _ = self._plan_step()
                plan.append((packed, use_flow, pixels_pair))
                self.iter_step += 1
                event = self._pro_tick()
                if event:
                    break
                self._maybe_regen_perms()
            return plan, event

    def _train_planned(self, K):
        """The JAX Runner's planned path: chunks of K host-planned steps
        (``_plan_chunk``), each one dispatch (``step.PlannedSteps``: on
        CUDA the captured photo and flow steps replayed row by row, whose
        capture or replay raises if it fails); a chunk cut short by an
        event or ``end_iter`` runs per step, as in JAX.  After a chunk, in
        the JAX loop's order: the progressive event, the grid refresh, the
        report line (the chunk's last step), validate_image,
        validate_poses, validate_mesh (each caught), the checkpoint, and
        phase 1's end.  ``history`` gets every step's row; ``step_ms`` a
        chunk's time over its steps, from the end of the first whole chunk
        (its capture is not a step)."""
        self.dispatch = f"planned x{K}"
        self._init_perms()
        chunk = self.planned = self.planned_steps(K)
        zero_pix = np.zeros(chunk.rows.shape[1] - chunk.n_packed, np.float32)
        res_step = max(self.end_iter - self.iter_step, 0)
        names = step_mod.METRIC_NAMES
        rows = torch.empty((res_step, len(names)), dtype=torch.float32,
                           device=self.device)
        timer, sizes, rate_from = None, [], None
        t_start = time.perf_counter()
        rays_per_step = self.batch_size * (2 if self.maintain_shape else 1)
        done = 0
        phase1_done = False
        while self.iter_step < self.end_iter:
            plan, event = self._plan_chunk(K)
            k = len(plan)
            if done + k > rows.shape[0]:  # a field reset restarted iter_step
                rows = torch.cat([rows, rows.new_empty((max(k, done), len(names)))])
            with tracing.span("fmov::chunk"):
                if k == K:
                    uses = [uf for _, uf, _ in plan]
                    with tracing.span("fmov::pack_rows"):
                        packed_rows = np.stack([
                            np.concatenate([packed, pix.reshape(-1) if uf else zero_pix])
                            for packed, uf, pix in plan])
                    rows[done:done + k] = chunk(self.state, packed_rows, uses)
                    self.flow_steps += sum(uses)
                else:  # cut short by an event or end_iter: per step, as in JAX
                    for j, (packed, uf, pix) in enumerate(plan):
                        metrics = self._dispatch(packed, uf, pix)
                        torch.stack([metrics[n] for n in names], out=rows[done + j])
            done += k
            if timer is not None:
                timer.tick()
                sizes.append(k)
            elif k == K and self.device.type == "cuda":
                timer = StepTimer()
            if rate_from is None and k == K:
                rate_from = self._rate_start(done)
            if event:
                self._pro_events()
                self._maybe_regen_perms()
            if (self.occupancy_sampling
                    and self.iter_step % self.occ_update_freq == 0):
                self.update_occ_grid()
            self._events_after(done, rows, rate_from, rays_per_step, f"(plan x{K})")
            self._mesh_event()
            if self.iter_step % self.save_freq == 0 and self.iter_step > 0:
                self.save_checkpoint()
            if self._phase1_over():
                phase1_done = True
                break
        if timer is not None:
            self.step_ms = [ms / n for ms, n in zip(timer.finish(), sizes)]
        self._finish(rows, done, t_start, phase1_done)

    def _dp_tag(self, capture=None):
        """The data-parallel part of ``dispatch``: the ranks and, given
        ``capture``, whether the step is captured."""
        if not self.use_dp:
            return ""
        how = "" if capture is None else (", captured" if capture else ", eager")
        return f" ({dp.world_size()} ranks{how})"

    def scan_steps(self, k, capture=None):
        """The scanned steps of this Runner's step config and schedule
        (``step.ScanPhotoSteps``, k steps a call; under data parallelism
        ``dp.make_dp_scan_photo_steps``, captured where the backend allows
        unless ``capture`` says otherwise)."""
        schedule = {
            "learning_rate": self.learning_rate,
            "learning_rate_alpha": self.learning_rate_alpha,
            "warm_up_end": self.warm_up_end, "end_iter": self.end_iter,
            "anneal_end": self.anneal_end,
            "mask_guided": 1.0 if self.mask_guided_sampling else 0.0,
        }
        if self.use_dp:
            return dp.make_dp_scan_photo_steps(
                self.step_cfg, self.images_dev, self.masks_dev, self.intr_inv_dev,
                self.bbox_dev, schedule, k, depths=self.depths_dev, capture=capture)
        return step_mod.ScanPhotoSteps(
            self.step_cfg, self.images_dev, self.masks_dev, self.intr_inv_dev,
            self.bbox_dev, schedule, k, capture, depths=self.depths_dev)

    def _train_scan(self, k):
        """The JAX Runner's scan path: chunks of k steps, each one dispatch
        (``step.ScanPhotoSteps``: on CUDA a captured step replayed k times,
        whose capture or replay raises if it fails), while a whole chunk
        fits before ``end_iter``: the steps past the last whole chunk are
        not run, as in JAX.  At a chunk's end, as there: the report line
        with the chunk's mean metrics, validate_image, validate_poses,
        validate_mesh (each caught), the grid refresh, the checkpoint; a
        checkpoint at the end.  ``history`` gets one row a chunk, its mean;
        ``step_ms`` the chunks' times."""
        scan = self.scan = self.scan_steps(k)
        self.dispatch = f"scan x{k}" + self._dp_tag(scan.capture)
        n_chunks = max(self.end_iter - self.iter_step, 0) // k
        names = step_mod.METRIC_NAMES
        rows = torch.empty((n_chunks, len(names)), dtype=torch.float32,
                           device=self.device)
        timer, rate_from = None, None
        t_start = time.perf_counter()
        done = 0
        while self.iter_step + k <= self.end_iter:
            with tracing.span("fmov::chunk"):
                rows[done] = scan(self.state, self.current_image)
            if timer is None and self.device.type == "cuda":
                # from the end of the first chunk: the capture is not a step
                timer = StepTimer()
            elif timer is not None:
                timer.tick()
            done += 1
            if rate_from is None:
                rate_from = self._rate_start(done)
            self.iter_step += k
            self._events_after(done, rows, rate_from, k * self.batch_size, f"(scan x{k})")
            self._mesh_event()
            if (self.occupancy_sampling
                    and self.iter_step % self.occ_update_freq == 0):
                self.update_occ_grid()
            if self.iter_step % self.save_freq == 0 and self.iter_step > 0:
                self.save_checkpoint()
        self.step_ms = timer.finish() if timer is not None else []
        self._finish(rows, done, t_start, False, steps_a_row=k)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _host_meta(self):
        return {"iter_step": self.iter_step, "current_image": self.current_image,
                "current_pose_mlp_index": self.current_pose_mlp_index,
                "pro_iteration": self.pro_iteration, "prev_pose": self.prev_pose,
                "seg_progress": self.seg_progress, "seg_frozen": self.seg_frozen,
                "mesh_warmup_step": self.mesh_warmup_step}

    def state_leaves(self):
        """The training state as the JAX package's checkpoint leaves:
        [(name, numpy array)] in its ``TrainState`` flatten order (params
        by sorted key; the flat Adam's step, mu, nu; the segment bank,
        static before train, its static leaves by name, with the JAX bank's
        ``progress`` [S] that the port does not keep, written as zeros; the
        segment Adam; the pose
        buffers by key; the PRNG key as uint32[2]; the state's step)."""
        st = self.state

        def arr(t, dtype=np.float32):
            return np.array(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                            else t, dtype=dtype)

        out = [(f"params.{n}", arr(t)) for n, t in convert.flatten(st.params)]
        out += [("opt.step", arr(st.opt.step, np.int32)), ("opt.mu", arr(st.opt.mu)),
                ("opt.nu", arr(st.opt.nu))]
        if st.bank_flat is not None:
            bs = st.bank_static
            for k in sorted({*bs, "progress"}):
                leaf = (np.zeros(self.n_segments, np.float32) if k == "progress"
                        else arr(bs[k], bool) if k == "initialized" else arr(bs[k]))
                out.append((f"pose_bank.static.{k}", leaf))
            out += [(f"pose_bank.train.{n}", arr(t))
                    for n, t in convert.flatten(st.bank_layout.views(st.bank_flat))]
            po = st.pose_opt
            out += [("pose_opt.step", arr(po.step, np.int32)), ("pose_opt.mu", arr(po.mu)),
                    ("pose_opt.nu", arr(po.nu))]
        out += [(f"pose_static.{k}", arr(st.pose_static[k])) for k in sorted(st.pose_static)]
        seed = st.generator.initial_seed()
        out += [("key", np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)),
                ("iter_step", arr(st.iter_step, np.int32))]
        return out

    @tracing.span("fmov::checkpoint")
    def save_checkpoint(self):
        """<exp>/checkpoints/ckpt_{current_image:06d}_{iter_step:06d}.ckpt:
        the state's leaves, the JAX Runner's host meta, and the device
        generator's state (so a resumed port run continues its stream);
        under data parallelism also every rank's own generator's, gathered
        from the ranks, and written by rank 0 alone."""
        meta = self._host_meta()
        meta["generator_state"] = self.state.generator.get_state().numpy().copy()
        meta["generator_device"] = self.device.type
        if self.use_dp:
            meta["rank_generator_states"] = dp.gather_generator_states(
                self.state.ray_generator)
        path = os.path.join(self.base_exp_dir, "checkpoints",
                            f"ckpt_{self.current_image:06d}_{self.iter_step:06d}.ckpt")
        if not self.is_main:
            return path
        ckpt.save_checkpoint(path, [a for _, a in self.state_leaves()], meta)
        LOG.info("checkpoint saved: %s", path)
        return path

    def _read_leaves(self, leaves):
        """{name: array} of a checkpoint's leaves, held to this Runner's
        state by position, shape and dtype kind; raises on any mismatch.
        A pre-flat-Adam JAX file (``optim.ensure_flat_adam``: moments as
        params-shaped trees) has each moment as one leaf per parameter
        leaf; they are raveled as ``ravel_pytree`` does."""
        tree_shapes = {"opt.mu": self.state.layout.shapes,
                       "opt.nu": self.state.layout.shapes}
        if self.state.bank_layout is not None:
            tree_shapes.update({"pose_opt.mu": self.state.bank_layout.shapes,
                                "pose_opt.nu": self.state.bank_layout.shapes})
        out, i = {}, 0
        for name, ref in self.state_leaves():
            if i >= len(leaves):
                raise ValueError(f"checkpoint has {len(leaves)} leaves; this Runner's "
                                 f"state needs more (missing {name})")
            leaf = np.asarray(leaves[i])
            shapes = tree_shapes.get(name)
            if shapes and leaf.shape != ref.shape and leaf.shape == tuple(shapes[0]):
                parts = [np.asarray(p) for p in leaves[i:i + len(shapes)]]
                if [p.shape for p in parts] != [tuple(s) for s in shapes]:
                    raise ValueError(f"checkpoint leaf {name}: neither flat {ref.shape} "
                                     f"nor the pre-flat-Adam tree of {len(shapes)} leaves")
                leaf = np.concatenate([p.reshape(-1) for p in parts])
                i += len(shapes)
            else:
                i += 1
            if leaf.shape != ref.shape or leaf.dtype.kind != ref.dtype.kind:
                raise ValueError(f"checkpoint leaf {name}: {leaf.dtype}{list(leaf.shape)}, "
                                 f"this Runner's state has {ref.dtype}{list(ref.shape)}")
            out[name] = leaf
        if i != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, this Runner's state "
                             f"{i}: another conf or pose mode")
        return out

    def load_checkpoint(self, path):
        """Restore the state and the host counters from ``path``, a JAX
        package's checkpoint or the port's.  The leaves map onto the state
        by name and shape (``_read_leaves``).  The device generator: a port
        file restores its state; a JAX file's PRNG key (uint32[2]) cannot
        reproduce JAX's stream in PyTorch, so the generator is seeded from
        it deterministically, (key[0] << 32) | key[1].  Under data
        parallelism the state is then broadcast from rank 0
        (``dp.replicate_tree``), and each rank's own generator takes its
        state from the file, or without one for this number of ranks is
        seeded anew (``dp.attach_rank_generator``)."""
        leaves, meta, fmt = ckpt.load_checkpoint(path)
        v = self._read_leaves(leaves)
        st, dev = self.state, self.device

        def tensor(a, dtype=torch.float32):
            return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

        def joined(prefix):
            return np.concatenate([a.reshape(-1) for n, a in v.items()
                                   if n.startswith(prefix)])

        with torch.no_grad():
            st.flat.copy_(tensor(joined("params.")))
            st.opt = optim.AdamState(step=int(v["opt.step"]), mu=tensor(v["opt.mu"]),
                                     nu=tensor(v["opt.nu"]))
            if st.bank_flat is not None:
                st.bank_flat.copy_(tensor(joined("pose_bank.train.")))
                for k in st.bank_static:
                    a = v[f"pose_bank.static.{k}"]
                    st.bank_static[k] = (np.array(a, bool) if k == "initialized"
                                         else tensor(a))
                st.pose_opt = optim.SegAdamState(
                    step=tensor(v["pose_opt.step"], torch.int32),
                    mu=tensor(v["pose_opt.mu"]), nu=tensor(v["pose_opt.nu"]))
            for k in st.pose_static:
                st.pose_static[k] = tensor(v[f"pose_static.{k}"])
        st.iter_step = int(v["iter_step"])
        if fmt == ckpt.FORMAT:
            if meta["generator_device"] != dev.type:
                raise ValueError(f"{path} holds a {meta['generator_device']} generator's "
                                 f"state; this Runner runs on {dev.type}")
            st.generator.set_state(torch.from_numpy(np.array(meta["generator_state"])))
        else:
            key = v["key"].astype(np.uint64)
            st.generator.manual_seed(int((key[0] << np.uint64(32)) | key[1]))
        if self.use_dp:
            dp.replicate_tree(self._replicated())
            states = meta.get("rank_generator_states")
            dp.attach_rank_generator(st, self.seed)
            if states is not None and len(states) == dp.world_size():
                st.ray_generator.set_state(torch.from_numpy(np.array(states[dp.rank()])))
        self.iter_step = int(meta["iter_step"])
        self.current_image = int(meta["current_image"])
        self.current_pose_mlp_index = int(meta["current_pose_mlp_index"])
        self.pro_iteration = int(meta["pro_iteration"])
        self.prev_pose = meta["prev_pose"]
        self.seg_progress = np.asarray(meta["seg_progress"])
        self.seg_frozen = np.asarray(meta["seg_frozen"])
        self.mesh_warmup_step = int(meta.get("mesh_warmup_step", 0))
        LOG.info("restored %s (%s; iter %d, image %d)", path, fmt, self.iter_step,
                 self.current_image)

    # ------------------------------------------------------------------
    # meshes
    # ------------------------------------------------------------------
    def validate_mesh(self, world_space=False, resolution=64, threshold=0.0,
                      use_norml_color=False, mesh_scale=1.0):
        """The zero level set of the SDF inside the object's bounds, as
        <exp>/meshes/{current_image:08d}_{step:08d}_{res}_{mode}.ply; with
        ``use_norml_color`` colored by its normals.  Returns the path;
        ``self.mesh_seconds`` holds the time of each stage.  Under data
        parallelism rank 0 alone extracts and writes it (the others return
        its path)."""
        step_tag = self.iter_step - (self.iter_step % self.val_mesh_freq)
        name = f"{self.current_image:08d}_{step_tag:08d}_{resolution}_{self.mode}.ply"
        path = os.path.join(self.base_exp_dir, "meshes", name)
        if not self.is_main:
            return path
        seconds = {}
        bound_min = np.asarray(self.dataset.object_bbox_min) * mesh_scale
        bound_max = np.asarray(self.dataset.object_bbox_max) * mesh_scale
        params = self.state.params
        query = geometry.make_sdf_query(params, self.model_cfg)
        vertices, triangles = geometry.extract_geometry(
            bound_min, bound_max, resolution, threshold, query, self.device,
            seconds=seconds)
        os.makedirs(os.path.join(self.base_exp_dir, "meshes"), exist_ok=True)
        if world_space and len(self.dataset.scale_mats_np):
            sm = self.dataset.scale_mats_np[0]
            vertices = vertices * sm[0, 0] + sm[:3, 3][None]
        colors = None
        t0 = time.perf_counter()
        if use_norml_color and len(vertices):
            colors = geometry.normal_colors(params, self.model_cfg, vertices, self.device)
        seconds["normals"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        meshio.write_ply(path, vertices, triangles, vertex_colors=colors)
        seconds["write"] = time.perf_counter() - t0
        self.mesh_seconds = seconds
        LOG.info("mesh saved: %s (%d verts)", path, len(vertices))
        if len(vertices) == 0:
            LOG.warning("extracted mesh is EMPTY: the SDF has no zero crossing "
                        "inside the bound yet (undertrained or diverged field)")
        return path

    # ------------------------------------------------------------------
    # eval renders
    # ------------------------------------------------------------------
    def eval_params(self):
        """The render networks' parameters, detached from the trainable
        buffer (no autograd graph reaches the state)."""
        params = self.state.layout.views(self.state.flat.detach())
        return {k: v for k, v in params.items()
                if k in ("sdf", "color", "nerf", "variance")}

    @torch.no_grad()
    def eval_render(self, rays_o, rays_d, near, far, cos_anneal_ratio):
        """One chunk through ``neus.render(..., eval_mode=True)``, the JAX
        Runner's ``_eval_render``: never on the occupancy grid, a white
        background with ``use_white_bkgd``, the conf's perturbation drawn
        from a generator seeded 0 and made anew for each call, as JAX
        draws every chunk from ``key(0)``.  Inputs (numpy or tensors) go
        to the Runner's device; returns the render dict."""
        dev = self.device

        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        with matmul_precision(self.matmul_precision):
            return neus.render(
                generator, self.eval_params(), self.model_cfg, t(rays_o), t(rays_d),
                t(near), t(far), cos_anneal_ratio=cos_anneal_ratio,
                background_rgb=(torch.ones((1, 3), device=dev) if self.use_white_bkgd
                                else None),
                eval_mode=True)

    @torch.no_grad()
    def render_rays_chunked(self, rays_o, rays_d, chunk=None):
        """Rays [n, 3] (numpy or tensors) rendered in chunks of ``chunk``
        (the batch size), the last padded with zero origins and (1, 1, 1)
        directions as JAX pads, near/far from the unit sphere, at the
        Runner's cos-anneal ratio.  Returns numpy {color_fine [n, 3],
        normal [n, 3] (gradients x weights x inside_sphere, summed over
        the samples), depth_fine [n, 1], weight_sum [n, 1]}, copied back
        once.  ``self.eval_chunks`` counts the chunks rendered."""
        chunk = chunk or self.batch_size
        dev = self.device
        ro = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)
        rd = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)
        n = ro.shape[0]
        pad = (-n) % chunk
        ro = torch.cat([ro, torch.zeros((pad, 3), device=dev)])
        rd = torch.cat([rd, torch.ones((pad, 3), device=dev)])
        r = self.model_cfg["renderer"]
        n_total = r.n_samples + r.n_importance
        cos_anneal = self.get_cos_anneal_ratio()
        outs = {"color_fine": [], "normal": [], "depth_fine": [], "weight_sum": []}
        for i in range(0, n + pad, chunk):
            ro_b, rd_b = ro[i:i + chunk], rd[i:i + chunk]
            near, far = raygen.near_far_from_sphere(ro_b, rd_b)
            out = self.eval_render(ro_b, rd_b, near, far, cos_anneal)
            for k in ("color_fine", "depth_fine", "weight_sum"):
                outs[k].append(out[k])
            outs["normal"].append((out["gradients"] * out["weights"][:, :n_total, None]
                                   * out["inside_sphere"][..., None]).sum(1))
            self.eval_chunks += 1
        return {k: torch.cat(v)[:n].cpu().numpy() for k, v in outs.items()}

    def _pose_rays_grid(self, idx_intr, pose, resolution_level):
        """The full-frame ray grid of intrinsics ``idx_intr`` through the
        c2w ``pose`` [>=3, 4] at 1 / ``resolution_level``: rays [H*W, 3]
        on the device and (H, W)."""
        rays_o, rays_d = raygen.gen_rays_grid(
            self.intr_inv_dev[idx_intr],
            torch.as_tensor(np.asarray(pose[:3], np.float32), device=self.device),
            self.dataset.H, self.dataset.W, resolution_level)
        H, W = rays_o.shape[:2]
        return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), H, W

    def validate_image(self, idx=-1, resolution_level=-1, return_img=False):
        """Render frame ``idx`` (drawn from the host RNG when < 0, as the JAX
        Runner draws it) at 1 / ``resolution_level`` (the conf's by
        default): <exp>/validations_fine/ (the render above the ground
        truth) and <exp>/normals/ PNGs named
        {current_image:08d}_{iter_step:08d}_0_{idx}.png; returns the PSNR
        against the frame's file, or the stacked image with
        ``return_img``.  Under data parallelism the other ranks than 0 draw
        the frame (the host RNG stays the same on every rank) and return
        None."""
        import cv2 as cv
        if idx < 0:
            idx = int(self.rng.integers(self.current_image))
        if not self.is_main:
            return None
        if resolution_level < 0:
            resolution_level = self.validate_resolution_level
        pose = self.query_pose(idx)[:3]
        rays_o, rays_d, H, W = self._pose_rays_grid(idx, pose, resolution_level)
        out = self.render_rays_chunked(rays_o, rays_d)
        img_fine = (out["color_fine"].reshape(H, W, 3) * 256).clip(0, 255)
        rot = np.linalg.inv(pose[:3, :3])
        normal_img = ((rot @ out["normal"].T).T.reshape(H, W, 3)
                      * 128 + 128).clip(0, 255)
        gt = self.dataset.image_at(idx, resolution_level)
        stacked = np.concatenate([img_fine, gt])
        if return_img:
            return stacked
        for sub, img in (("validations_fine", stacked), ("normals", normal_img)):
            os.makedirs(os.path.join(self.base_exp_dir, sub), exist_ok=True)
            cv.imwrite(os.path.join(
                self.base_exp_dir, sub,
                f"{self.current_image:08d}_{self.iter_step:08d}_0_{idx}.png"),
                img.astype(np.uint8))
        return float(10 * np.log10(255.0**2 / max(((img_fine - gt) ** 2).mean(), 1e-9)))

    def validate_poses(self, save_pose=False):
        """ATE/RPE of the learned against the annotated poses of the
        admitted frames (``pipeline/evalpose.py``), the JAX Runner's:
        <exp>/poses/stats_{iter_step:06d}.{json,txt} (``pipeline/report.py``),
        the pose plot where matplotlib imports (a warning otherwise), and
        with ``save_pose`` <exp>/poses_arr/.  Returns (ate, rpe_trans,
        rpe_rot, gt, est), infinities without two annotated frames."""
        from fmov_pose_torch.pipeline import evalpose
        d = self.dataset
        pose_all = self.query_poses(self.current_image)
        gt_list, learned = [], []
        if len(d.gt_poses) > 0:
            for i, frame_idx in enumerate(d.avai_ann_frame):
                if frame_idx >= self.current_image:
                    break
                gt_list.append(d.gt_poses[i])
                learned.append(pose_all[frame_idx])
        if not gt_list:
            return float("inf"), float("inf"), float("inf"), None, pose_all
        if len(gt_list) < 2:
            LOG.warning("only %d annotated frame(s) below current_image=%d: "
                        "ATE needs >=2 pose pairs (Umeyama is degenerate)",
                        len(gt_list), self.current_image)
            return float("inf"), float("inf"), float("inf"), None, pose_all
        gt = np.stack(gt_list)
        est = np.stack(learned)
        try:
            est_aligned = evalpose.align_ate_c2b_use_a2b(est, gt)
            ate = evalpose.compute_ATE(gt, est_aligned)
            rpe_trans, rpe_rot = evalpose.compute_rpe(gt, est_aligned)
        except Exception as e:
            LOG.warning("pose alignment failed: %s", e)
            return float("inf"), float("inf"), float("inf"), gt, est
        LOG.info("ate=%.5f rpe_trans=%.5f rpe_rot=%.4f deg", ate, rpe_trans,
                 np.rad2deg(rpe_rot))
        if not self.is_main:  # rank 0 owns the pose files
            return ate, rpe_trans, rpe_rot, gt, est
        pose_dir = os.path.join(self.base_exp_dir, "poses")
        os.makedirs(pose_dir, exist_ok=True)
        try:
            from fmov_pose_torch.pipeline import vis
            vis.vis_poses(
                est_aligned, gt, self.dataset.H, self.dataset.W,
                float(d.intrinsics_all[0][0, 0]), float(d.intrinsics_all[0][1, 1]),
                os.path.join(pose_dir, f"aligned_pose_{self.current_image:06d}_"
                                       f"{self.iter_step:06d}_{ate:.5f}.png"))
        except Exception as e:  # no matplotlib on the machine: no plot
            LOG.warning("vis_poses failed: %s", e)
        if save_pose:
            arr_dir = os.path.join(self.base_exp_dir, "poses_arr")
            os.makedirs(arr_dir, exist_ok=True)
            np.save(os.path.join(arr_dir, f"pred_poses_{self.iter_step}.npy"), est)
            np.save(os.path.join(arr_dir, "gt_poses.npy"), gt)
        try:
            from fmov_pose_torch.pipeline import report
            trans_err = np.linalg.norm(
                gt[:, :3, 3] - est_aligned[:len(gt), :3, 3], axis=-1)
            report.write_metrics(
                os.path.join(pose_dir, f"stats_{self.iter_step:06d}"),
                {"ate_rmse": ate, "rpe_trans": rpe_trans,
                 "rpe_rot_deg": float(np.rad2deg(rpe_rot)),
                 "trans_error": report.compute_statistics(trans_err)})
        except Exception as e:
            LOG.warning("metric report failed: %s", e)
        return ate, rpe_trans, rpe_rot, gt, est

    def render_novel_image(self, idx_0, idx_1, ratio, resolution_level):
        """The view ``ratio`` of the way from frame ``idx_0``'s pose to
        ``idx_1``'s (scipy's Slerp on the rotation, linear on the
        translation), with frame 0's intrinsics: uint8 [H, W, 3]."""
        from scipy.spatial.transform import Rotation as Rot
        from scipy.spatial.transform import Slerp
        pose_0 = np.linalg.inv(self.query_pose(idx_0))
        pose_1 = np.linalg.inv(self.query_pose(idx_1))
        rots = Rot.from_matrix(np.stack([pose_0[:3, :3], pose_1[:3, :3]]))
        rot = Slerp([0, 1], rots)(ratio)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot.as_matrix()
        pose[:3, 3] = ((1.0 - ratio) * pose_0 + ratio * pose_1)[:3, 3]
        pose = np.linalg.inv(pose)
        rays_o, rays_d, H, W = self._pose_rays_grid(0, pose, resolution_level)
        out = self.render_rays_chunked(rays_o, rays_d)
        return (out["color_fine"].reshape(H, W, 3) * 256).clip(0, 255).astype(np.uint8)

    def interpolate_view(self, img_idx_0, img_idx_1, n_frames=60):
        """``n_frames`` novel views at 1/4 resolution from frame
        ``img_idx_0`` to ``img_idx_1`` and back, as
        <exp>/render/{iter_step:08d}_{i0}_{i1}.mp4 (mp4v, 30 fps); returns
        the path."""
        import cv2 as cv
        images = []
        for i in range(n_frames):
            ratio = np.sin(((i / n_frames) - 0.5) * np.pi) * 0.5 + 0.5
            images.append(self.render_novel_image(
                img_idx_0, img_idx_1, ratio, resolution_level=4))
        images += images[::-1]
        video_dir = os.path.join(self.base_exp_dir, "render")
        os.makedirs(video_dir, exist_ok=True)
        h, w, _ = images[0].shape
        path = os.path.join(video_dir, f"{self.iter_step:08d}_{img_idx_0}_{img_idx_1}.mp4")
        writer = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        for img in images:
            writer.write(img.astype(np.uint8))
        writer.release()
        return path

    def rays_from_mask(self, idx: int, pose, resolution_level=1):
        """Ray grid over the mask's bbox of frame ``idx`` (the uncropped
        frame's mask, shifted by the crop, on a crop dataset) through the
        c2w ``pose``.  Returns numpy (rays_o, rays_d, ys, xs, p_norm), or
        None for an empty mask."""
        d = self.dataset
        if not d.crop:
            mask = d.masks_np[idx][:, :, 0]
            shift = (0.0, 0.0)
        else:
            import cv2 as cv
            mask_dir = os.path.join(d.data_dir.replace("_ori", ""), "mask_obj")
            path = os.path.join(mask_dir, d.index_to_frame[idx] + ".png")
            if os.path.exists(path):
                mask = cv.imread(path, cv.IMREAD_UNCHANGED) / 255.0
                if mask.ndim == 3:
                    mask = mask[..., 0]
            else:
                mask = d.masks_np[idx][:, :, 0]
            M = d.crop_transforms[d.index_to_frame[idx]]
            shift = (M[0, 2], M[1, 2])
        ys, xs = np.where(mask > 0.5)
        if len(ys) == 0:
            return None
        y0, y1 = max(ys.min() - 5, 0), min(ys.max() + 5, d.H - 1)
        x0, x1 = max(xs.min() - 5, 0), min(xs.max() + 5, d.W - 1)
        x0, x1 = x0 + shift[0], x1 + shift[0]
        y0, y1 = y0 + shift[1], y1 + shift[1]
        l = resolution_level  # noqa: E741
        tx = np.linspace(x0, x1, max(int(x1 - x0) // l, 2)).astype(np.int64)
        ty = np.linspace(y0, y1, max(int(y1 - y0) // l, 2)).astype(np.int64)
        px, py = np.meshgrid(tx, ty, indexing="xy")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        rays_o, rays_v, p_norm = raygen.pixels_to_rays(
            t(px.reshape(-1)), t(py.reshape(-1)), self.intr_inv_dev[idx], t(pose[:3]))
        return (rays_o.cpu().numpy(), rays_v.cpu().numpy(), py.reshape(-1),
                px.reshape(-1), p_norm.cpu().numpy())

    def render_poses(self, resolution_level=1, reduce_res=2, wo_normal=False):
        """Every frame with the oriented bbox of the latest mesh (a new 64^3
        one without any) projected through its learned pose, as
        <exp>/pose_vis/<frame>.jpg; unless ``wo_normal``, the normal map of
        the rays inside the mask's bbox as <exp>/normal_vis/<frame>.jpg;
        the frames as <exp>/poses_<iter_step>.gif where imageio imports (a
        warning otherwise).  Returns the pose_vis dir."""
        import cv2 as cv
        mesh_dir = os.path.join(self.base_exp_dir, "meshes")
        plys = sorted(os.listdir(mesh_dir)) if os.path.isdir(mesh_dir) else []
        if not plys:
            self.validate_mesh()
            plys = sorted(os.listdir(mesh_dir))
        verts, _tris = meshio.read_ply(os.path.join(mesh_dir, plys[-1]))
        lo, hi = verts.min(0), verts.max(0)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        box_edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
                     (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
        pose_dir = os.path.join(self.base_exp_dir, "pose_vis")
        normal_dir = os.path.join(self.base_exp_dir, "normal_vis")
        os.makedirs(pose_dir, exist_ok=True)
        os.makedirs(normal_dir, exist_ok=True)
        frames = []
        for i in range(self.dataset.n_images):
            pose = self.query_pose(i)
            img = self.dataset.image_at(i, resolution_level)
            img = cv.cvtColor(img.astype(np.uint8), cv.COLOR_BGR2RGB)
            obj_pose = np.linalg.inv(pose)
            rvec = cv.Rodrigues(obj_pose[:3, :3].astype(np.float64))[0]
            tvec = obj_pose[:3, 3].astype(np.float64)
            K = self.dataset.intrinsics_all[i][:3, :3].astype(np.float64)
            pts2d, _ = cv.projectPoints(corners.astype(np.float64), rvec, tvec, K, None)
            pts2d = (pts2d[:, 0] / resolution_level).astype(int)
            for a, b in box_edges:
                cv.line(img, tuple(pts2d[a]), tuple(pts2d[b]), (0, 255, 0), 2)
            cv.imwrite(os.path.join(pose_dir, f"{self.dataset.index_to_frame[i]}.jpg"),
                       cv.cvtColor(img, cv.COLOR_RGB2BGR))
            if not wo_normal:
                rm = self.rays_from_mask(i, pose, resolution_level=1)
                if rm is not None:
                    ro, rv, ys, xs, _ = rm
                    out = self.render_rays_chunked(ro, rv)
                    rot = np.linalg.inv(pose[:3, :3])
                    normals = (rot @ out["normal"].T).T
                    vis_mask = out["weight_sum"][:, 0] > 0.5
                    nimg = np.ones((self.dataset.H, self.dataset.W, 3))
                    ysv = np.clip(ys[vis_mask], 0, self.dataset.H - 1)
                    xsv = np.clip(xs[vis_mask], 0, self.dataset.W - 1)
                    nimg[ysv, xsv] = normals[vis_mask]
                    nimg = ((nimg * 128 + 128).clip(0, 255)).astype(np.uint8)
                    cv.imwrite(os.path.join(
                        normal_dir, f"{self.dataset.index_to_frame[i]}.jpg"), nimg)
            frames.append(img)
        try:
            import imageio
            imageio.mimsave(os.path.join(self.base_exp_dir, f"poses_{self.iter_step}.gif"),
                            frames, fps=5)
        except Exception as e:  # no imageio on the machine: no gif
            LOG.warning("gif export failed: %s", e)
        return pose_dir

    def validate_all_images(self, resolution_level=4):
        """Up to 10 evenly spaced frames, each render above its ground
        truth, as <exp>/imgs.gif (imageio required, as in the JAX
        Runner)."""
        import cv2 as cv
        import imageio
        n = self.dataset.n_images
        idxs = np.arange(n) if n < 10 else np.linspace(0, n - 1, 10, dtype=int)
        imgs = []
        for i in idxs:
            img = self.validate_image(int(i), resolution_level=resolution_level,
                                      return_img=True)
            imgs.append(cv.cvtColor(img.astype(np.uint8), cv.COLOR_BGR2RGB))
        imageio.mimsave(os.path.join(self.base_exp_dir, "imgs.gif"), imgs, fps=2)

    def save_alignment_materials(self, step=4, align_dir=None):
        """The rendered depth through every ``len // step``-th annotated
        frame (every frame without annotations), back-projected to world
        points [n, 4], as <exp>/world_pts_3D.npy or
        <align_dir>/<case>_world_pts_3D.npy; returns the path."""
        d = self.dataset
        ids = d.avai_ann_frame if len(d.avai_ann_frame) else list(range(d.n_images))
        world_pts = []
        for i in ids[::max(len(ids) // step, 1)]:
            pose = self.query_pose(i)
            rm = self.rays_from_mask(i, pose)
            if rm is None:
                continue
            ro, rv, ys, xs, p_norm = rm
            out = self.render_rays_chunked(ro, rv)
            depths = out["depth_fine"][:, 0] / p_norm[:, 0]
            K = d.intrinsics_all[i][:3, :3]
            xy_hom = np.stack([xs, ys, np.ones_like(xs)], 0).astype(np.float64)
            cam = (np.linalg.inv(K) @ xy_hom).T * depths[:, None]
            cam_h = np.concatenate([cam, np.ones((len(cam), 1))], 1)
            world_pts.append((pose @ cam_h.T).T)
        world_pts = np.concatenate(world_pts, 0)
        path = (os.path.join(align_dir, f"{self.case}_world_pts_3D.npy") if align_dir
                else os.path.join(self.base_exp_dir, "world_pts_3D.npy"))
        np.save(path, world_pts)
        return path

    def gradient_analysis_report(self, img_id=0):
        """Per-loss gradient magnitudes (``--gradient_analysis``): for each
        of color_loss, eikonal_loss and mask_loss, one gradient through the
        training step's render and losses (JAX's scalar row: lr 0,
        cos_anneal 1, every gate open, mask guiding off) on one ray batch
        of frame ``img_id`` (uniform pixels from a generator seeded 0; JAX
        draws from ``key(0)``), and (min, max, mean) of |grad| over each
        network's leaves.  Returns {loss: {net: (min, max, mean)}}."""
        cfg, st = self.step_cfg, self.state
        S = self.n_segments
        scalars = step_mod.StepScalars(
            lr=0.0, cos_anneal=1.0, main_update=1.0, pose_update=1.0,
            mask_guided=0.0, seg_touch=np.zeros(S, np.float32),
            seg_freeze=np.ones(S, np.float32), seg_lr=np.zeros(S, np.float32),
            trans_head_on=1.0)
        report = {}
        for name in ("color_loss", "eikonal_loss", "mask_loss"):
            flat = st.flat.detach().clone().requires_grad_(True)
            with torch.enable_grad():
                params = st.layout.views(flat)
                pose0 = step_mod.pose_of_frame(cfg, params, st.pose_bank,
                                               st.pose_static, img_id)
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
                data = raygen.gen_random_rays(
                    generator, self.images_dev, self.masks_dev, self.intr_inv_dev,
                    pose0, img_id, self.batch_size, self.bbox_dev,
                    cfg.mask_guided_patch_size, False, cfg.H, cfg.W)
                generator.manual_seed(1)
                _, metrics = step_mod._render_and_losses(
                    cfg, generator, params, st.pose_static, data, scalars,
                    pose_bank=st.pose_bank)
                (g,) = torch.autograd.grad(metrics[name], flat)
            grads = st.layout.views(g)
            stats = {}
            for net in ("sdf", "color", "nerf", "variance"):
                if net in grads:
                    vals = torch.cat([t.abs().reshape(-1) for _, t in
                                      convert.flatten(grads[net])]).cpu().numpy()
                    stats[net] = (float(vals.min()), float(vals.max()),
                                  float(vals.mean()))
            report[name] = stats
        for name, stats in report.items():
            LOG.info("gradient_analysis %s: %s", name, stats)
        return report

    # ------------------------------------------------------------------
    # poses out, and the phase transition
    # ------------------------------------------------------------------
    def save_poses(self):
        """After ``validate_poses`` with ``current_image`` lowered by 10 (at
        least 1), as the JAX Runner does: <exp>/poses/
        pred_poses_<iter_step>.npy (the admitted frames' c2w), gt_poses.npy
        (with annotations), intrinsics.npy and, on a crop dataset,
        transform_matrixs.npy; returns the dir."""
        self.current_image = max(self.current_image - 10, 1)
        self.validate_poses()
        pose_dir = os.path.join(self.base_exp_dir, "poses")
        if not self.is_main:  # rank 0 owns the pose files
            return pose_dir
        os.makedirs(pose_dir, exist_ok=True)
        poses = self.query_poses(self.current_image)
        np.save(os.path.join(pose_dir, f"pred_poses_{self.iter_step}.npy"), poses)
        if len(self.dataset.gt_poses):
            np.save(os.path.join(pose_dir, "gt_poses.npy"), self.dataset.gt_poses)
        np.save(os.path.join(pose_dir, "intrinsics.npy"), self.dataset.intrinsics_all)
        if self.dataset.crop:
            tm = np.stack([self.dataset.crop_transforms[self.dataset.index_to_frame[i]]
                           for i in range(len(poses))])
            np.save(os.path.join(pose_dir, "transform_matrixs.npy"), tm)
        return pose_dir

    def save_poses_simple(self, align_dir=None):
        """{frame name: c2w [4, 4]} of the admitted frames as
        <exp>/poses_<iter_step>.npy, or <align_dir>/<case>_poses.npy
        (rank 0's file); returns the path."""
        poses = self.query_poses(self.current_image)
        out = {self.dataset.index_to_frame[i]: poses[i]
               for i in range(self.current_image)}
        save_path = (os.path.join(align_dir, f"{self.case}_poses.npy")
                     if align_dir else
                     os.path.join(self.base_exp_dir, f"poses_{self.iter_step}.npy"))
        if self.is_main:
            np.save(save_path, out)
        return save_path

    def save_aligned_poses(self, save_dataset=True, normalize_trans=True,
                           tgt_dir=None, save_meta=True, global_mask_dir=None):
        """Phase transition: map the virtual-camera poses to the real camera
        through phase 1's 64^3 mesh and PnP, and write the phase-2 dataset
        (``pipeline/align.py``), as the JAX Runner does
        (`exp_runner.py:1333-1412` of the reference).  Without every frame
        admitted it backs off 10 frames.  The mesh is the one phase 1
        wrote at its end, or a new 64^3 one.  The ground truth for the
        ATE is ./data/HO3Dv3/ann/<case>.npz unless the conf names ML
        intrinsics.  Returns the alignment's (ATE, RPE trans, RPE rot), or
        None without a ground truth.  Under data parallelism rank 0 aligns
        and writes, the other ranks return None, and every rank leaves
        after a barrier, once the dataset is written (the JAX Runner has
        every rank align and write it)."""
        if self.current_image != self.dataset.n_images:
            self.current_image = max(self.current_image - 10, 1)
        result = None
        if self.is_main:
            result = self._align(save_dataset, normalize_trans, tgt_dir, save_meta,
                                 global_mask_dir)
        dp.barrier()
        return result

    def _align(self, save_dataset, normalize_trans, tgt_dir, save_meta,
               global_mask_dir):
        """``save_aligned_poses``'s alignment and writes, on one rank."""
        from fmov_pose_torch.pipeline import align
        img_names = [self.dataset.index_to_frame[i] for i in range(self.current_image)]
        poses = self.query_poses(range(self.current_image))
        Ks = self.dataset.intrinsics_all
        transform_matrixs = (np.stack([self.dataset.crop_transforms[n] for n in img_names])
                             if self.dataset.crop else None)
        step_tag = self.iter_step - (self.iter_step % self.val_mesh_freq)
        mesh_path = os.path.join(self.base_exp_dir, "meshes",
                                 f"{self.current_image:08d}_{step_tag:08d}_64_train.ply")
        if not os.path.exists(mesh_path):
            mesh_path = self.validate_mesh()
        case = self.case.split("_")[0]
        ml_intr = self.conf.get("dataset.ml_camera_intrinsics", "")
        ori_cam_path = None if ml_intr else f"./data/HO3Dv3/ann/{case}.npz"
        fn = align.align_poses if self.dataset.crop else align.align_poses_wo_virtual
        return fn(ori_cam_path, mesh_path, poses, Ks, transform_matrixs,
                  self.base_exp_dir, img_names, self.iter_step, case,
                  H=self.dataset.H, W=self.dataset.W,
                  save_dataset=save_dataset, normalize_trans=normalize_trans,
                  tgt_dir=tgt_dir, save_meta=save_meta,
                  global_mask_dir=global_mask_dir,
                  data_root=os.path.dirname(
                      os.path.dirname(self.dataset.data_dir.rstrip("/"))))

    # ------------------------------------------------------------------
    @tracing.span("fmov::file_backup")
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
