"""Runner-level multi-process smoke: ``Runner.train`` under
``torch.distributed`` (port of
``fmov_pose_tpu/parallel/multihost_runner_smoke.py``).

Launched as N processes with ``FMOV_DISTRIBUTED=1`` and
``FMOV_COORDINATOR`` / ``FMOV_NUM_PROCESSES`` / ``FMOV_PROCESS_ID`` (or
under ``torchrun``), each rank writes the same synthetic 4-frame 32x32
orbit into its own ``--workdir``, trains the JAX module's GT conf (fixed
poses, 40 steps of 16 rays, the per-step loop; ``--scan K`` instead sets
every frequency to a multiple of K and trains on the scan path, K steps a
dispatch) through ``Runner.train``, and prints ``MULTIHOST_RUNNER_LOSS``
(the mean of the last 5 step losses, or of the last chunk's mean) from
rank 0 and ``MULTIHOST_RUNNER_STATE`` (a digest of the flat parameters
and the Adam moments) from every rank.  ``<workdir>/draws.json`` holds,
for each ray batch the rank drew, its frame and a digest of its rays:
``tests/test_torch_multihost.py`` holds the ranks to the same frames and
different rays, to bitwise the same state, and rank 1 to no file written.

    FMOV_DISTRIBUTED=1 FMOV_COORDINATOR=localhost:PORT FMOV_NUM_PROCESSES=2 \\
        FMOV_PROCESS_ID=I python -m fmov_pose_torch.parallel.multihost_runner_smoke \\
        --workdir DIR [--device cpu] [--scan K]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

GT_CONF = """
general {{
    base_exp_dir = {exp_dir}
    recording = [ ./ ]
}}
dataset {{
    data_dir = {data_dir}/
    render_cameras_name = cameras_sphere.npz
    object_cameras_name = cameras_sphere.npz
}}
train {{
    learning_rate = 5e-4
    learning_rate_alpha = 0.05
    end_iter = {end_iter}
    batch_size = 16
    validate_resolution_level = 4
    warm_up_end = 10
    anneal_end = 0
    use_white_bkgd = False
    save_freq = {save_freq}
    val_freq = {val_freq}
    val_mesh_freq = {val_freq}
    report_freq = {report_freq}
    pose_freq = {val_freq}
    scan_chunk = {scan_chunk}
    igr_weight = 0.1
    mask_weight = 0.1
}}
model {{
    nerf {{ D = 2, d_in = 4, d_in_view = 3, W = 32, multires = 2,
           multires_view = 2, output_ch = 4, skips=[1], use_viewdirs=True }}
    sdf_network {{ d_out = 33, d_in = 3, d_hidden = 32, n_layers = 4,
                  skip_in = [2], multires = 4, bias = 0.5, scale = 1.0,
                  geometric_init = True, weight_norm = True }}
    variance_network {{ init_val = 0.3 }}
    rendering_network {{ d_feature = 32, mode = idr, d_in = 9, d_out = 3,
                        d_hidden = 32, n_layers = 2, weight_norm = True,
                        multires_view = 2, squeeze_out = True }}
    neus_renderer {{ n_samples = 8, n_importance = 0, n_outside = 0,
                    up_sample_steps = 1, perturb = 1.0 }}
}}
"""


def conf_text(exp_dir, data_dir, scan=0):
    """The GT conf: per-step (40 steps, a report every 10), or with
    ``scan`` = K > 0 three chunks of K steps on the scan path."""
    if scan:
        return GT_CONF.format(exp_dir=exp_dir, data_dir=data_dir, end_iter=3 * scan,
                              save_freq=100 * scan, val_freq=1000 * scan,
                              report_freq=scan, scan_chunk=scan)
    return GT_CONF.format(exp_dir=exp_dir, data_dir=data_dir, end_iter=40,
                          save_freq=100000, val_freq=1000000, report_freq=10,
                          scan_chunk=100)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True,
                    help="this rank's scratch dir (the data is written alike "
                         "on every rank, so the ranks need not share it)")
    ap.add_argument("--device", default=None, help="default: this rank's card")
    ap.add_argument("--scan", type=int, default=0,
                    help="K > 0: train 3 chunks of K steps on the scan path")
    args = ap.parse_args(argv)

    # join the process group before any device use
    from fmov_pose_torch.parallel import dp
    dp.maybe_initialize_distributed("gloo" if args.device == "cpu" else None)
    try:
        _run(args, dp)
    finally:
        dp.shutdown()


def _run(args, dp):
    import numpy as np

    from fmov_pose_torch.data import rays as raygen
    from fmov_pose_torch.data.synthetic import make_orbit_sequence
    from fmov_pose_torch.train.runner import Runner

    data_dir = os.path.join(args.workdir, "SYN_ori")
    exp_dir = os.path.join(args.workdir, "exp")
    make_orbit_sequence(data_dir, n_frames=4, H=32, W=32, span_deg=40)
    conf_path = os.path.join(args.workdir, "gt.conf")
    with open(conf_path, "w") as f:
        f.write(conf_text(exp_dir, data_dir, args.scan))

    # every ray batch this rank draws: its frame and a digest of its rays
    draws = []
    gen_random_rays = raygen.gen_random_rays

    def recorded(*a, **kw):
        data = gen_random_rays(*a, **kw)
        draws.append((int(a[5]), hashlib.sha256(
            data.detach().cpu().numpy().tobytes()).hexdigest()))
        return data

    raygen.gen_random_rays = recorded
    runner = Runner(conf_path, mode="train", case="SYN_ori", has_global_conf=True,
                    device=args.device)
    if not runner.use_dp:
        raise RuntimeError(f"expected data parallelism over {dp.world_size()} ranks")
    runner.train()
    raygen.gen_random_rays = gen_random_rays

    losses = runner.history["loss"]
    tail = float(np.mean(losses[-5:]))
    st = runner.state
    digest = hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes() for t in (st.flat, st.opt.mu, st.opt.nu)
    )).hexdigest()
    with open(os.path.join(args.workdir, "draws.json"), "w") as f:
        json.dump({"frames": [d[0] for d in draws], "rays": [d[1] for d in draws],
                   "losses": losses, "dispatch": runner.dispatch}, f)
    print(f"MULTIHOST_RUNNER_STATE rank={dp.rank()} {digest}", flush=True)
    if runner.is_main:
        print(f"MULTIHOST_RUNNER_LOSS {tail:.10f} n_processes={dp.world_size()} "
              f"dispatch={runner.dispatch!r}", flush=True)


if __name__ == "__main__":
    main()
