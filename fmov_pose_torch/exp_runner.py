"""Experiment CLI of the PyTorch port, with the flags and modes of
``exp_runner.py``.

    python -m fmov_pose_torch.exp_runner --mode MODE --conf CONF --case CASE \
        [--global_conf GLOBAL_CONF] [--is_continue]

Every mode runs on the CUDA device ``--gpu`` (without CUDA it raises).
``--mode train`` with ``--global_conf`` is the two-phase run of the
reference: phase 1 on ``--conf`` (the progressive ``ho3d_virtual*.conf``;
an exception there is written to
``<exp>/error_during_progressive_learning.txt`` and the run goes on, as
the reference's does), then the pose alignment (``Runner.
save_aligned_poses``: phase 1's 64^3 mesh, PnP, the normalization)
writes the phase-2 dataset into ``<exp>/<global conf name>/``, then a
new Runner on the global conf trains phase 2 there (resuming from its
checkpoints when they exist), writes the final mesh at
``--final_mesh_resolution`` with normal colors and the learned poses
(``poses_<iter>.npy``).  When that directory exists already, phase 1 and
the alignment are skipped.  Without ``--global_conf`` it runs one phase
of a conf (phase 1 with its ``--flow_interval``, ``--reset_rot_degree``
and ``--image_interval`` flags, the phase-2 global conf, a GT-pose or
BARF conf), then the final mesh.  ``--is_continue`` resumes from the
latest checkpoint of the exp dir.

The eval and export modes act on the Runner of ``--conf`` (with
``--is_continue``: its latest checkpoint), as the JAX CLI's do:
``validate_mesh`` (the 512^3 mesh scaled by ``--mesh_scale``; with
``--global_conf``, the 256^3 mesh of the phase-2 Runner in
``<exp>/<global conf name>/``), ``validate_poses``, ``interpolate_<i>_<j>``
(60 novel views from frame i to j and back, an mp4), ``validate_all_images``,
``save_poses``, ``save_poses_simple`` (into ``--align_dir`` when given),
``save_aligned_poses``, ``render_poses`` (with ``--global_conf`` on the
phase-2 Runner), ``pure_render_poses`` (without the normal maps),
``save_alignment_materials`` (into ``--align_dir`` when given),
``validate_textured_mesh`` (the 64^3 mesh, baked by
``pipeline/textured.py``) and ``generate_textured_mesh`` (the same on the
phase-2 Runner).  Any other mode raises ``NotImplementedError``.
``--gradient_analysis`` logs the per-loss gradient report during
training.  ``--mcube_threshold`` and ``--ori_cam_path`` are parsed and
unused, as in the JAX CLI.

Data parallelism, as the JAX CLI runs it: with ``FMOV_DISTRIBUTED=1`` each
process is one rank (``FMOV_COORDINATOR``/``FMOV_NUM_PROCESSES``/
``FMOV_PROCESS_ID``, or the variables ``torchrun`` sets), on
``cuda:(rank mod device_count)`` unless ``device`` is given; the Runners
split the ray batch over the ranks (``parallel/dp.py``), and rank 0 writes
the files:

    FMOV_DISTRIBUTED=1 torchrun --nproc_per_node 2 -m fmov_pose_torch.exp_runner \\
        --mode train --conf CONF --case CASE --global_conf GLOBAL_CONF
"""

import argparse
import logging
import os
import traceback


def main(argv=None, device=None):
    """Parse ``argv`` and run the mode; returns the last Runner (phase 2's
    in a two-phase run).  ``device`` overrides ``--gpu`` (a CPU run is
    asked for by passing ``device="cpu"``)."""
    logging.basicConfig(
        level=logging.INFO,
        format="[%(filename)s:%(lineno)s - %(funcName)s] %(message)s")

    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, default="./confs/base.conf")
    parser.add_argument("--mode", type=str, default="train")
    parser.add_argument("--mcube_threshold", type=float, default=0.0)
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--gpu", type=int, default=0)
    parser.add_argument("--case", type=str, default="")
    parser.add_argument("--dataset", type=str, default="DTU")
    parser.add_argument("--start_at", type=int, default=-1)
    parser.add_argument("--start_img_idx", type=int, default=0)
    parser.add_argument("--ori_cam_path", type=str, default="None")
    parser.add_argument("--gradient_analysis", default=False,
                        action="store_true")
    parser.add_argument("--global_conf", type=str, default="None")
    parser.add_argument("--flow_interval", type=int, default=-1)
    parser.add_argument("--reset_rot_degree", type=int, default=-1)
    parser.add_argument("--image_interval", type=int, default=-1)
    parser.add_argument("--mesh_scale", type=float, default=1.0)
    parser.add_argument("--align_dir", type=str, default=None)
    parser.add_argument("--final_mesh_resolution", type=int, default=512)
    parser.add_argument("--seed", type=int, default=2024)
    args = parser.parse_args(argv)

    from fmov_pose_torch.device import require_cuda
    from fmov_pose_torch.parallel import dp
    from fmov_pose_torch.train.runner import Runner

    # data parallelism (FMOV_DISTRIBUTED=1, e.g. under torchrun): one rank a
    # process, each on its own card
    dp.maybe_initialize_distributed()
    if device is None:
        device = dp.local_device() if dp.world_size() > 1 else require_cuda(args.gpu)
    logging.getLogger(__name__).info("device: %s", device)

    def reboot_runner(case, new_exp_dir):
        return Runner(
            args.global_conf, mode="train", case=case, dataset=args.dataset,
            is_continue=os.path.exists(os.path.join(new_exp_dir, "checkpoints")),
            start_at=args.start_at, start_img_idx=args.start_img_idx,
            gradient_analysis=args.gradient_analysis, exp_dir=new_exp_dir,
            has_global_conf=os.path.exists(new_exp_dir), seed=args.seed,
            device=device)

    def global_mask_dir_for(case):
        if "ho3d" in args.global_conf:
            return f"./data/HO3Dv3/{case}/mask_obj"
        if "ml" in args.global_conf:
            return f"./data/ML/{case}/mask_obj"
        raise NotImplementedError(args.global_conf)

    # start_at goes to the Runner, which takes it and, like the reference's,
    # does not use it
    runner = Runner(
        args.conf, args.mode, args.case, args.dataset, args.is_continue,
        args.start_at, args.start_img_idx, args.gradient_analysis,
        has_global_conf=args.global_conf != "None" or "GT.conf" in args.conf,
        flow_interval=args.flow_interval,
        reset_rot_degree=args.reset_rot_degree,
        image_interval=args.image_interval, seed=args.seed, device=device)
    conf_name = os.path.basename(args.global_conf).split(".")[0]

    def phase2_runner():
        return reboot_runner(runner.case.split("_")[0],
                             os.path.join(runner.base_exp_dir, conf_name))

    if args.mode == "train" and args.global_conf != "None":
        case = runner.case.split("_")[0]
        gmask = global_mask_dir_for(case)
        original_exp_dir = runner.base_exp_dir
        new_exp_dir = os.path.join(original_exp_dir, conf_name)
        if not os.path.exists(new_exp_dir):
            try:
                runner.train()
            except Exception as e:  # the reference's behaviour: log and align
                with open(os.path.join(original_exp_dir,
                                       "error_during_progressive_learning.txt"),
                          "w") as f:
                    f.write(f"Exception occurred: {e}\n")
                    f.write(traceback.format_exc())
            runner.save_aligned_poses(
                save_dataset=True, normalize_trans=True, tgt_dir=new_exp_dir,
                save_meta=False, global_mask_dir=gmask)
        runner = reboot_runner(case, new_exp_dir)
        print("reboot the system for global training" + "-" * 40)
        runner.train()
        runner.validate_mesh(resolution=args.final_mesh_resolution,
                             use_norml_color=True)
        runner.save_poses_simple()
    elif args.mode == "train":
        runner.train()
        runner.validate_mesh(resolution=args.final_mesh_resolution,
                             use_norml_color=True)
    elif args.mode == "validate_mesh":
        if args.global_conf != "None":
            runner = phase2_runner()
            runner.validate_mesh(resolution=256, use_norml_color=True,
                                 mesh_scale=args.mesh_scale)
        else:
            runner.validate_mesh(resolution=512, use_norml_color=True,
                                 mesh_scale=args.mesh_scale)
    elif args.mode == "validate_poses":
        runner.validate_poses()
    elif args.mode.startswith("interpolate"):
        _, i0, i1 = args.mode.split("_")
        runner.interpolate_view(int(i0), int(i1))
    elif args.mode == "validate_all_images":
        runner.validate_all_images(resolution_level=4)
    elif args.mode == "save_poses":
        runner.save_poses()
    elif args.mode == "save_poses_simple":
        runner.save_poses_simple(align_dir=args.align_dir)
    elif args.mode == "save_aligned_poses":
        runner.save_aligned_poses()
    elif args.mode == "render_poses":
        if args.global_conf != "None":
            runner = phase2_runner()
        runner.render_poses()
    elif args.mode == "pure_render_poses":
        runner.render_poses(wo_normal=True)
    elif args.mode == "save_alignment_materials":
        runner.save_alignment_materials(align_dir=args.align_dir)
    elif args.mode in ("validate_textured_mesh", "generate_textured_mesh"):
        from fmov_pose_torch.pipeline import textured
        if args.mode == "generate_textured_mesh":
            runner = phase2_runner()
        textured.textured_mesh(runner.validate_mesh(resolution=64), runner)
    else:
        raise NotImplementedError(args.mode)
    return runner


if __name__ == "__main__":
    from fmov_pose_torch.parallel import dp as _dp
    try:
        main()
    finally:
        _dp.shutdown()
