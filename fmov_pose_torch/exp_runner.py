"""Experiment CLI of the PyTorch port, with the flags of ``exp_runner.py``.

    python -m fmov_pose_torch.exp_runner --mode train --conf CONF --case CASE

``--mode train`` runs one phase of a conf on the CUDA device ``--gpu``
(without CUDA it raises): the progressive phase 1 (``ho3d_virtual*.conf``,
with its ``--flow_interval``, ``--reset_rot_degree`` and
``--image_interval`` flags), the phase-2 global conf, or a GT-pose or BARF
conf, then the final mesh at ``--final_mesh_resolution`` with normal
colors.  ``--is_continue`` resumes from the latest checkpoint of the exp
dir.  ``--mode validate_mesh`` writes the 512^3 mesh of the Runner's
state (with ``--is_continue``: of the latest checkpoint), scaled by
``--mesh_scale``.  ``--mcube_threshold`` is parsed and unused, as in the
JAX CLI.  The two-phase ``--global_conf`` run, which aligns phase 1's
poses between the phases (``pipeline/align.py``), the other eval and
export modes and their flags raise ``NotImplementedError`` naming their
ROADMAP item.
"""

import argparse
import logging

# flags of the eval and export modes not ported yet: (name, default)
_EXPORT_FLAGS = (("ori_cam_path", "None"), ("align_dir", None))


def main(argv=None, device=None):
    """Parse ``argv`` and run the mode; returns the Runner.  ``device``
    overrides ``--gpu`` (a CPU run is asked for by passing
    ``device="cpu"``)."""
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
    from fmov_pose_torch.train.runner import Runner

    if args.mode not in ("train", "validate_mesh"):
        raise NotImplementedError(
            f"--mode {args.mode}: the eval and export modes are not in the "
            "PyTorch port yet (ROADMAP queue 1, item 10)")
    if args.global_conf != "None":
        raise NotImplementedError(
            "--global_conf: the two-phase run needs the pose alignment between "
            "the phases, pipeline/align.py (ROADMAP queue 1, item 9); run each "
            "phase's conf on its own")
    for name, default in _EXPORT_FLAGS:
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name}: the pose export and alignment modes are not in the "
                "PyTorch port yet (ROADMAP queue 1, item 10)")
    if device is None:
        device = require_cuda(args.gpu)
    logging.getLogger(__name__).info("device: %s", device)

    # start_at goes to the Runner, which takes it and, like the reference's,
    # does not use it
    runner = Runner(
        args.conf, args.mode, args.case, args.dataset, args.is_continue,
        args.start_at, args.start_img_idx, args.gradient_analysis,
        has_global_conf="GT.conf" in args.conf,
        flow_interval=args.flow_interval,
        reset_rot_degree=args.reset_rot_degree,
        image_interval=args.image_interval, seed=args.seed, device=device)
    if args.mode == "train":
        runner.train()
        runner.validate_mesh(resolution=args.final_mesh_resolution,
                             use_norml_color=True)
    else:
        runner.validate_mesh(resolution=512, use_norml_color=True,
                             mesh_scale=args.mesh_scale)
    return runner


if __name__ == "__main__":
    main()
