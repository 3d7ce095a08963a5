"""The JAX package's side of ``fmov_pose_torch/phase1_probe.py``: phase 1
of the quality harness, cut to size, through the JAX Runner on the CPU, on
the data and conf the port's probe writes (``phase1_probe.prepare``; both
packages' ``make_orbit_sequence`` write the same bytes).  A tool, not a
test: it prints one JSON line a seed, with the port probe's keys.

    JAX_PLATFORMS=cpu python -m tests.phase1_probe_jax [--frames 6] [--res 64]
        [--span 68] [--max_pro 60] [--mesh_warmup 120] [--d_hidden 256]
        [--seeds 2024 1] [--init port] [--out FILE]
    JAX_PLATFORMS=cpu python -m tests.phase1_probe_jax --save_init DIR [...]

One JAX CPU device (the tests' 8-device mesh is not set here), so the JAX
Runner takes its one-device step, as on one chip.  ``--init port`` starts
each seed's JAX run from the port Runner's initial fields and segment bank
of that seed (the flat orders are equal); ``--save_init DIR`` trains
nothing and writes each seed's JAX Runner state before its first step to
``DIR/init_<seed>.ckpt``, the files the port probe's ``--init`` reads.
"""

import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fmov_pose_torch import phase1_probe  # noqa: E402


def _port_start(runner, conf, seed):
    """The JAX Runner's state with the port Runner's initial fields and
    segment bank of ``seed`` (same conf, on the CPU)."""
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from fmov_pose_torch.train.runner import Runner as TRunner
    tr = TRunner(conf, mode="train", case="SYN_ori", has_global_conf=True, seed=seed,
                 device="cpu")
    st = runner.state
    params = ravel_pytree(st.params)[1](jnp.asarray(tr.state.flat.detach().numpy()))
    bank_train = ravel_pytree(st.pose_bank["train"])[1](
        jnp.asarray(tr.state.bank_flat.detach().numpy()))
    return st._replace(params=params, pose_bank=dict(st.pose_bank, train=bank_train))


def run_phase1(work, conf, seed, init=None, save_init=None):
    from fmov_pose_tpu.train.runner import Runner
    cwd = os.getcwd()
    os.chdir(work)
    try:
        runner = Runner(conf, mode="train", case="SYN_ori", has_global_conf=True,
                        seed=seed)
        if init == "port":
            runner.state = _port_start(runner, conf, seed)
        if save_init:
            path = runner.save_checkpoint() or _latest(runner.base_exp_dir)
            os.makedirs(save_init, exist_ok=True)
            shutil.copy(path, os.path.join(save_init, f"init_{seed}.ckpt"))
            return {"seed": seed, "saved": os.path.join(save_init, f"init_{seed}.ckpt")}
        t0 = time.perf_counter()
        runner.train()
        seconds = time.perf_counter() - t0
        return phase1_probe.summary(seed, runner.validate_poses(), runner.iter_step,
                                    seconds, [])
    finally:
        os.chdir(cwd)


def _latest(exp_dir):
    d = os.path.join(exp_dir, "checkpoints")
    return os.path.join(d, sorted(os.listdir(d))[-1])


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    save_init = None
    if "--save_init" in argv:
        i = argv.index("--save_init")
        save_init = os.path.abspath(argv[i + 1])
        del argv[i:i + 2]
    args = phase1_probe.parse_args(argv)
    rows = []
    for seed in args.seeds:
        work = tempfile.mkdtemp(prefix=f"fmov_p1jax_{seed}_", dir=args.work)
        _, conf = phase1_probe.prepare(work, args)
        row = run_phase1(work, conf, seed, args.init, save_init)
        row.update(init=args.init, d_hidden=args.d_hidden, frames=args.frames,
                   max_pro=args.max_pro,
                   compute_dtype=args.compute_dtype, device="cpu", package="jax")
        print("probe " + json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
