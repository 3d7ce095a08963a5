"""Multi-process smoke entry: one data-parallel training step over
``torch.distributed`` (port of ``fmov_pose_tpu/parallel/multihost_smoke.py``).

Launched as N processes, each one rank (gloo on the CPU), it runs
``dp_train_step_tiny`` and prints the step's loss from rank 0 and every
rank's state digest; launched with ``--num-processes 1 --batch-ranks N``
it runs the same step in one process on the whole batch of N ranks,
without a group.  The step is the
JAX module's tiny one (a 4-frame 16x16 scene, SDF 4x32, color 2x32, the
segment bank, ``maintain_shape``, mask-guided rays, 8 rays a rank) on given
pixels (drawn on the host from a seed, each rank taking its rows) with
the render's perturbation off, so the one-process loss is the same
computation: ``tests/test_torch_multihost.py`` holds the two.

    python -m fmov_pose_torch.parallel.multihost_smoke \\
        --coordinator localhost:PORT --num-processes 2 --process-id I \\
        [--device cpu] [--batch-ranks N]
"""

from __future__ import annotations

import argparse
import hashlib

import numpy as np
import torch

RAYS_PER_RANK = 8
N_IMAGES, H, W = 4, 16, 16
TINY_SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
            "multires": 4, "bias": 0.5, "scale": 1.0, "geometric_init": True,
            "weight_norm": True}
TINY_COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
              "n_layers": 2, "weight_norm": True, "multires_view": 2,
              "squeeze_out": True}
TINY_NERF = {"D": 2, "d_in": 4, "d_in_view": 3, "W": 32, "multires": 2,
             "multires_view": 2, "output_ch": 4, "skips": (1,), "use_viewdirs": True}


def state_digest(state) -> str:
    """sha256 of the flat parameters, the Adam moments and the segment
    bank with its Adam: equal digests are bitwise-equal states."""
    h = hashlib.sha256()
    po = state.pose_opt
    for t in (state.flat, state.opt.mu, state.opt.nu, state.bank_flat, po.step,
              po.mu, po.nu):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train_step_tiny(n_ranks: int, rank: int, device, batch_ranks=None) -> tuple:
    """One training step of the tiny model (the JAX
    ``__graft_entry__.dp_train_step_tiny``) on rank ``rank``'s share of the
    global batch (``batch_ranks`` x 8 rays and as many maintain_shape rays,
    ``batch_ranks`` by default ``n_ranks``); with one rank, the
    single-device step on the whole batch.  Returns (loss, state digest)."""
    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.parallel import dp
    from fmov_pose_torch.poses import picture_pose as pp
    from fmov_pose_torch.render import neus
    from fmov_pose_torch.train import optim, step as step_mod

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    params = {"sdf": nets.init_sdf(rng, TINY_SDF), "color": nets.init_color(rng, TINY_COLOR),
              "nerf": nets.init_nerf(rng, TINY_NERF),
              "variance": nets.init_variance({"init_val": 0.3})}
    model_cfg = {"sdf": TINY_SDF, "color": TINY_COLOR, "nerf": TINY_NERF,
                 "renderer": neus.RenderCfg(8, 8, 0, 2, 0.0)}
    images = torch.as_tensor(rng.random((N_IMAGES, H, W, 3)), dtype=torch.float32)
    masks = torch.as_tensor(rng.random((N_IMAGES, H, W)) > 0.3, dtype=torch.float32)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 20.0
    intr[0, 2] = intr[1, 2] = 8.0
    intr_inv = torch.as_tensor(np.linalg.inv(intr)[None].repeat(N_IMAGES, 0),
                               dtype=torch.float32)
    bbox = torch.as_tensor(np.tile([2, 14, 2, 14], (N_IMAGES, 1)), dtype=torch.int32)

    pose_cfg = pp.PoseCfg(emphasize_rot=True)
    init_pose = np.eye(4, dtype=np.float32)
    init_pose[2, 3] = -2.0
    bank = pp.init_seg_bank(0, pose_cfg, N_IMAGES, 1, init_pose)
    n_seg = pp.num_segments(N_IMAGES, 1)
    cfg = step_mod.make_step_config(
        model_cfg, batch_size=RAYS_PER_RANK * (batch_ranks or n_ranks), H=H, W=W,
        n_segments=n_seg, segment_img_num=1, pose_mode="seg", pose_cfg=pose_cfg, igr_weight=0.1,
        mask_weight=5.0, mask_guided_sampling=True, mask_guided_patch_size=2,
        maintain_shape=True)

    layout = convert.ParamLayout(params)
    flat = layout.ravel(params, dev).requires_grad_(True)
    bank_layout = convert.ParamLayout(bank["train"])
    bank_flat = bank_layout.ravel(bank["train"], dev).requires_grad_(True)
    state = step_mod.TrainState(
        flat=flat, layout=layout, opt=optim.adam_init(flat.detach()), pose_static={},
        generator=torch.Generator(device=dev).manual_seed(1), bank_flat=bank_flat,
        bank_layout=bank_layout,
        bank_static={k: v.to(dev) if isinstance(v, torch.Tensor) else v
                     for k, v in bank["static"].items()},
        pose_opt=optim.seg_adam_init(bank_flat.detach(), bank_layout.shapes, n_seg))

    # the global batch's pixels, the same on every rank; this rank's rows
    n = cfg.batch_size
    px, py, apx, apy = (torch.as_tensor(rng.integers(2, 14, n)) for _ in range(4))
    rows = slice(rank * RAYS_PER_RANK, (rank + 1) * RAYS_PER_RANK) if n_ranks > 1 \
        else slice(0, n)
    bufs = [t.to(dev) for t in (images, masks, intr_inv, bbox)]
    if n_ranks > 1:
        step = dp.make_dp_photo_step(cfg, *bufs)
        dp.attach_rank_generator(state, 0)
    else:
        step = step_mod.make_photo_step(cfg, *bufs)
    scalars = step_mod.StepScalars(
        lr=5e-4, cos_anneal=1.0, seg_touch=np.ones(n_seg, np.float32),
        seg_freeze=np.ones(n_seg, np.float32), seg_lr=np.full(n_seg, 5e-4, np.float32))
    state, metrics = step(state, scalars, 1, add_img_id=0,
                          pixels=(px[rows].to(dev), py[rows].to(dev)),
                          add_pixels=(apx[rows].to(dev), apy[rows].to(dev)))
    return float(metrics["loss"]), state_digest(state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default=None, help="default: this rank's card")
    ap.add_argument("--batch-ranks", type=int, default=None,
                    help="the ranks the global batch is sized for (default: "
                         "--num-processes)")
    args = ap.parse_args(argv)

    from fmov_pose_torch.parallel import dp
    if args.num_processes > 1:
        dp.initialize(args.coordinator, args.num_processes, args.process_id,
                      "gloo" if args.device == "cpu" else None)
    try:
        device = args.device or dp.local_device()
        loss, digest = dp_train_step_tiny(args.num_processes, args.process_id, device,
                                          args.batch_ranks)
        print(f"MULTIHOST_STATE rank={args.process_id} {digest}", flush=True)
        if dp.is_main():
            print(f"MULTIHOST_LOSS {loss:.10f} n_processes={args.num_processes}",
                  flush=True)
    finally:
        dp.shutdown()


if __name__ == "__main__":
    main()
