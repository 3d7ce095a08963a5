"""Two-process data parallelism on the CPU (gloo), the port's counterpart
of ``tests/test_multihost.py``: ``fmov_pose_torch.parallel.multihost_smoke``
(one data-parallel step of the tiny segment-bank model) on two ranks
against one process on the same global batch, and
``fmov_pose_torch.parallel.multihost_runner_smoke`` (``Runner.train`` on
the GT conf) on two ranks: bitwise the same state on both, the same frame
in every step and different rays, and rank 1 writing no file; and the
two-phase CLI on two ranks in one work dir (rank 0 writes the phase-2
dataset, both read it after a barrier).  Every process runs under a time
limit, so that a hung rank fails the test.

Tolerance: the two-rank loss within rtol 1e-5 of the one-process loss
(the same sums in another order, in f32).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_dp_worker import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 100


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **kw)
    for k in ("FMOV_DISTRIBUTED", "FMOV_COORDINATOR", "FMOV_NUM_PROCESSES",
              "FMOV_PROCESS_ID"):
        if k not in kw:
            env.pop(k, None)
    return env


def _run_ranks(cmds_envs, cwd=REPO):
    """Start every (cmd, env) together in ``cwd``; their outputs, each
    under the time limit; a failed or hung process fails the test with its
    output."""
    procs = [subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in cmds_envs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed (rc={p.returncode}):\n{out}"
    return outs


def _parse(stdout, marker):
    m = re.search(rf"{marker} (\S+)", stdout)
    assert m, f"no {marker} line in output:\n{stdout}"
    return m.group(1)


def test_two_process_loss_matches_single_process():
    smoke = [sys.executable, "-m", "fmov_pose_torch.parallel.multihost_smoke",
             "--device", "cpu"]
    port = free_port()
    outs = _run_ranks([(smoke + ["--coordinator", f"localhost:{port}", "--num-processes",
                                 "2", "--process-id", str(i)], _env()) for i in range(2)])
    (single,) = _run_ranks([(smoke + ["--coordinator", "localhost:0", "--num-processes",
                                      "1", "--process-id", "0", "--batch-ranks", "2"],
                             _env())])
    multi_loss = float(_parse(outs[0], "MULTIHOST_LOSS"))
    assert np.isfinite(multi_loss)
    np.testing.assert_allclose(multi_loss, float(_parse(single, "MULTIHOST_LOSS")),
                               rtol=1e-5)
    digests = [_parse(out, f"MULTIHOST_STATE rank={i}") for i, out in enumerate(outs)]
    assert digests[0] == digests[1]
    assert "MULTIHOST_LOSS" not in outs[1]  # rank 0 reports


@pytest.mark.parametrize("scan", [0, 5], ids=["per_step", "scan"])
def test_runner_train_two_process(tmp_path, scan):
    """``Runner.train`` on two ranks (the per-step loop, or 3 chunks of 5
    scanned steps): both ranks end with bitwise the same flat parameters
    and Adam moments, every ray batch is of the same frame on both ranks
    and of different rays, rank 0 wrote the checkpoint and the source
    backup and rank 1 no file."""
    port = free_port()
    cmd = [sys.executable, "-m", "fmov_pose_torch.parallel.multihost_runner_smoke",
           "--device", "cpu", "--scan", str(scan)]
    outs = _run_ranks([
        (cmd + ["--workdir", str(tmp_path / f"rank{i}")],
         _env(FMOV_DISTRIBUTED="1", FMOV_COORDINATOR=f"localhost:{port}",
              FMOV_NUM_PROCESSES="2", FMOV_PROCESS_ID=str(i))) for i in range(2)])
    loss = float(_parse(outs[0], "MULTIHOST_RUNNER_LOSS"))
    assert np.isfinite(loss)
    digests = [_parse(out, f"MULTIHOST_RUNNER_STATE rank={i}") for i, out in enumerate(outs)]
    assert digests[0] == digests[1]

    draws = [json.loads((tmp_path / f"rank{i}" / "draws.json").read_text())
             for i in range(2)]
    n_steps = 15 if scan else 40
    assert len(draws[0]["frames"]) == n_steps
    assert draws[0]["frames"] == draws[1]["frames"]
    assert all(a != b for a, b in zip(draws[0]["rays"], draws[1]["rays"]))
    assert draws[0]["dispatch"] == (f"scan x{scan} (2 ranks, eager)" if scan
                                    else "per-step (2 ranks)")
    assert len(draws[0]["losses"]) == (3 if scan else 40)
    assert all(np.isfinite(draws[0]["losses"]))

    r0, r1 = tmp_path / "rank0" / "exp", tmp_path / "rank1" / "exp"
    assert list((r0 / "checkpoints").glob("*.ckpt")), "rank 0 wrote no checkpoint"
    assert (r0 / "recording").is_dir(), "rank 0 wrote no recording"
    written = [os.path.join(d, f) for d, _, fs in os.walk(r1) for f in fs]
    assert not written, f"rank 1 wrote {written}"


CLI_RANK = """
import hashlib, sys
from fmov_pose_torch import exp_runner
from fmov_pose_torch.parallel import dp
runner = exp_runner.main(sys.argv[1:], device="cpu")
st = runner.state
digest = hashlib.sha256(b"".join(t.detach().numpy().tobytes()
                                 for t in (st.flat, st.opt.mu, st.opt.nu))).hexdigest()
print(f"CLI_STATE rank={dp.rank()} {runner.use_dp} {runner.iter_step} {digest}", flush=True)
dp.shutdown()
"""


def test_cli_two_phase_two_ranks(tmp_path):
    """The two-phase CLI on two ranks in one work dir (the tiny command of
    ``tests/test_torch_pipeline.py``): rank 0 aligns and writes the phase-2
    dataset, both ranks read it after the barrier and train phase 2 to
    bitwise the same state; only rank 0 saves checkpoints and meshes."""
    from fmov_pose_torch.data import synthetic as tsyn
    from tests.test_torch_pipeline import ARGV, P2_DIR, P2_STEPS, _write_work
    _write_work(tmp_path, tsyn.make_orbit_sequence)
    port = free_port()
    # each rank its own string-hash salt, as separate hosts have: a set of
    # frame names iterates in another order on each
    outs = _run_ranks([
        ([sys.executable, "-c", CLI_RANK, *ARGV],
         _env(FMOV_DISTRIBUTED="1", FMOV_COORDINATOR=f"localhost:{port}",
              FMOV_NUM_PROCESSES="2", FMOV_PROCESS_ID=str(i), PYTHONHASHSEED=str(i + 1)))
        for i in range(2)], cwd=str(tmp_path))
    states = [re.search(rf"CLI_STATE rank={i} (\S+) (\d+) (\S+)", out).groups()
              for i, out in enumerate(outs)]
    assert states[0] == states[1] == ("True", str(P2_STEPS), states[0][2])
    for name in ("cameras_sphere.npz", "noise_cameras_sphere.npz"):
        assert (tmp_path / P2_DIR / name).is_file()
    assert list((tmp_path / P2_DIR / "checkpoints").glob("*.ckpt"))
    assert "checkpoint saved" in outs[0] and "mesh saved" in outs[0]
    assert "checkpoint saved" not in outs[1] and "mesh saved" not in outs[1]
    assert all("reboot the system for global training" in out for out in outs)
