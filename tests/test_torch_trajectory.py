"""The port's progressive phase 1 against the JAX Runner over a whole tiny
run, step by step, with an equal start and equal random draws.

Both Runners train ``tests/test_train_e2e.py``'s ``VIRTUAL_CONF`` (5
frames at 48x48, mesh warm-up 10, 15 steps a frame: 85 steps, every
admission, flow steps, every unfreeze) through their own ``train()``:

* **The same start.**  The JAX Runner saves its checkpoint before its
  first step; the port's Runner loads it (``load_checkpoint``, bitwise,
  ``tests/test_torch_checkpoint.py``).  The host plans are equal
  (``test_runner_plans_like_jax``).
* **The same draws.**  Each package's ``gen_random_rays`` is replaced,
  in this test only, by a sampler whose pixels come from one numpy table
  ``[n_frames, B]`` indexed by the frame id (traced on the JAX side): it
  also stands in for the mask-guided bounding-box coin.  Each package
  then builds its rays with its own ``pixels_to_rays`` and gathers.  The
  renderer's perturbation is 0, so no other draw is left.  The flow
  pixels are planned on the host and are equal.
* **What is held equal:** every step's loss and metric row, the poses
  of the admitted frames after each admission and each unfreeze, and at
  the end every field leaf, every bank leaf, both Adams' moments and
  step counts.

The tolerance grows with the step count: ``BASE + PER_STEP * step``,
relative for the loss and metrics, absolute for poses and state leaves
(their values are of order 1).  Measured on this run, and asserted at
about twice that:

* ``f32`` (the conf as written; JAX's f32 path): the two packages sum
  in different orders, so each step's gradients differ by f32
  round-off, and Adam carries each difference on.  The metrics part by
  at most 1.6e-6 relative at step 0 and 4.6e-5 by step 62; poses and
  leaves by 2.7e-5 at most (after 47 steps; 2.8e-5 in the segment Adam's
  first moment at the end).  Asserted: metrics 1e-5 + 2e-6 a step,
  state 1e-5 + 1e-6 a step.
* ``fused_flat`` (``use_fused_train_kernels``): the port's K2/K3, whose
  plain versions run on the CPU, against the JAX package's K2/K3 in
  interpret mode.  Both round their operands to bf16 (the kernels'
  contract), so the two sides agree to f32 round-off only until a sum
  that differs in its last bit lands on a bf16 rounding boundary (step 6
  here, 1.4e-4); from then on each step adds bf16-sized noise (~1e-3)
  and the runs wander apart as two samples of it: metrics up to 4.4e-2
  relative, poses up to 0.145 by step 84.  Asserted: metrics 1e-2 +
  1.5e-3 a step, state 1e-2 + 3.5e-3 a step.  A fault in the loop (a
  gate, an admission, a segment's init) moves these by O(1) at once.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.data import rays as jrays
from fmov_pose_torch.data import rays as trays
from tests.phase1_probe_jax import _latest
from tests.test_torch_progressive import N, _virtual_conf, seq_root  # noqa: F401
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)

N_STEPS = 85  # mesh warm-up 10 + 5 frames x 15 steps, then the early return
BATCH = 64
# the tolerance at step s (0-based): BASE + PER_STEP * s, relative for the
# loss and metrics, absolute for poses and state leaves (of order 1);
# (metric base, metric per step, state base, state per step) by case
TOL = {False: (1e-5, 2e-6, 1e-5, 1e-6), True: (1e-2, 1.5e-3, 1e-2, 3.5e-3)}
NO_PERTURB = ("perturb = 1.0", "perturb = 0.0")
# the JAX Runner's one-device step (the tests' 8 CPU devices would shard
# the batch, each shard drawing its own pixels); the port ignores the key
ONE_DEVICE = ("maintain_shape = True", "maintain_shape = True\n    data_parallel = False")
FUSED = ("learning_rate = 5e-4", "learning_rate = 5e-4\n    use_fused_train_kernels = True")


def _pixel_table(H, W):
    """(px, py) int32 [N, BATCH]: the pixels every draw of a frame takes."""
    rng = np.random.default_rng(7)
    return (rng.integers(0, W, (N, BATCH)).astype(np.int32),
            rng.integers(0, H, (N, BATCH)).astype(np.int32))


def _jax_sampler(table):
    """``gen_random_rays`` of the JAX module with the pixels of ``table``."""
    tx, ty = jnp.asarray(table[0]), jnp.asarray(table[1])

    def gen(key, images, masks, intr_inv_all, pose, img_id, batch_size, *args,
            depths=None, **kw):
        assert batch_size == BATCH and depths is None
        px, py = tx[img_id], ty[img_id]
        color = jrays.gather_rgb(images, img_id, py, px)
        mask = jrays.gather_pixels(masks[img_id][None], py, px)
        rays_o, rays_v, _ = jrays.pixels_to_rays(
            px.astype(jnp.float32), py.astype(jnp.float32), intr_inv_all[img_id], pose)
        return jnp.concatenate([rays_o, rays_v, color, mask], axis=-1)

    return gen


def _torch_sampler(table, real):
    """The port's ``gen_random_rays`` with the pixels of ``table``."""
    tx, ty = torch.from_numpy(table[0]).long(), torch.from_numpy(table[1]).long()

    def gen(generator, images, masks, intr_inv_all, pose, img_id, batch_size, *args,
            pixels=None, **kw):
        assert batch_size == BATCH and pixels is None
        return real(generator, images, masks, intr_inv_all, pose, img_id, batch_size,
                    *args, pixels=(tx[img_id], ty[img_id]), **kw)

    return gen


def _record(runner, to_host):
    """Wrap the Runner's steps and progressive events: every step's metrics
    (``to_host``: metrics -> {name: float}) and, after each event, the
    poses of the admitted frames."""
    log = {"metrics": [], "events": []}
    photo, flow, events = runner.photo_step, runner.flow_step, runner._pro_events

    def wrap(step, kind):
        def run(*a, **k):
            state, metrics = step(*a, **k)
            log["metrics"].append((kind, to_host(metrics)))
            return state, metrics
        return run

    def pro_events():
        events()
        log["events"].append((runner.iter_step, runner.current_image,
                              runner.seg_frozen.copy(),
                              runner.query_poses(runner.current_image)))

    runner.photo_step, runner.flow_step = wrap(photo, "photo"), wrap(flow, "flow")
    runner._pro_events = pro_events
    return log


def _extra(fused):
    return (NO_PERTURB, ONE_DEVICE) + ((FUSED,) if fused else ())


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "fused_flat"])
def jax_run(request, seq_root, tmp_path_factory):  # noqa: F811
    """The JAX Runner's whole run: (the conf's fused flag, its checkpoint
    before the first step, its log, its final state as numpy)."""
    from fmov_pose_tpu.train.runner import Runner as JRunner
    fused = request.param
    tmp = tmp_path_factory.mktemp("traj_jax")
    conf = _virtual_conf(seq_root, tmp, extra=_extra(fused))
    mp = pytest.MonkeyPatch()
    if fused:  # the JAX flat kernels K2/K3, in interpret mode on the CPU
        jax.clear_caches()
        mp.setenv("FMOV_PALLAS_INTERPRET", "1")
    try:
        jr = JRunner(conf, mode="train", case="SYN_ori", has_global_conf=True)
        assert not jr.use_dp
        mp.setattr(jrays, "gen_random_rays",
                   _jax_sampler(_pixel_table(jr.dataset.H, jr.dataset.W)))
        start = str(tmp / "start.ckpt")
        shutil.copy(jr.save_checkpoint() or _latest(jr.base_exp_dir), start)
        log = _record(jr, lambda m: {k: float(v) for k, v in m.items()})
        jr.train()
    finally:
        mp.undo()
        if fused:
            jax.clear_caches()
    assert jr.iter_step == N_STEPS and jr.current_image == N
    state = jax.tree_util.tree_map(np.asarray, jr.state._replace(key=None))
    return fused, start, log, state


def _close(a, b, step, base, per_step, what, relative=False):
    tol = base + per_step * step
    np.testing.assert_allclose(a, b, rtol=tol if relative else 0.0, atol=tol,
                               err_msg=f"{what} at step {step}")


def test_phase1_trajectory_matches_jax(seq_root, tmp_path, jax_run,  # noqa: F811
                                       monkeypatch):
    from fmov_pose_torch.ops import fused_sdf
    from fmov_pose_torch.train.runner import Runner
    fused, start, jlog, js = jax_run
    metric_base, metric_per_step, state_base, state_per_step = TOL[fused]
    tr = Runner(_virtual_conf(seq_root, tmp_path, extra=_extra(fused)), case="SYN_ori",
                has_global_conf=True, device="cpu")
    tr.load_checkpoint(start)
    monkeypatch.setattr(trays, "gen_random_rays", _torch_sampler(
        _pixel_table(tr.dataset.H, tr.dataset.W), trays.gen_random_rays))
    calls = []
    real = fused_sdf.sdf_apply_grad_fused
    monkeypatch.setattr(fused_sdf, "sdf_apply_grad_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tlog = _record(tr, lambda m: {k: float(v) for k, v in m.items()})
    tr.train()
    assert len(calls) == (N_STEPS if fused else 0)

    # every step: the same kind (photo or flow), loss and metrics
    assert len(tlog["metrics"]) == len(jlog["metrics"]) == N_STEPS
    kinds = [k for k, _ in jlog["metrics"]]
    assert [k for k, _ in tlog["metrics"]] == kinds and "flow" in kinds
    for step, ((_, mj), (_, mt)) in enumerate(zip(jlog["metrics"], tlog["metrics"])):
        for name, v in mj.items():
            _close(mt[name], v, step, metric_base, metric_per_step, name, relative=True)

    # every admission and unfreeze: the same frames, gates and poses
    # per frame: the unfreeze at pro_warm_up_end, then the admission (the
    # last one finds every frame admitted)
    assert len(tlog["events"]) == len(jlog["events"]) == 2 * N
    for (it_j, cur_j, frz_j, pj), (it_t, cur_t, frz_t, pt) in zip(jlog["events"],
                                                                  tlog["events"]):
        assert (it_t, cur_t) == (it_j, cur_j)
        np.testing.assert_array_equal(frz_t, frz_j)
        _close(pt, pj, it_j - 1, state_base, state_per_step, f"poses at event {it_j}")

    # the final state, leaf by leaf
    st, last = tr.state, N_STEPS - 1

    def np_(t):
        return t.detach().cpu().numpy()

    assert st.opt.step == int(js.opt.step) == N_STEPS
    np.testing.assert_array_equal(np_(st.pose_opt.step), js.pose_opt.step)
    np.testing.assert_array_equal(st.bank_static["initialized"],
                                  js.pose_bank["static"]["initialized"])
    pairs = [("params", np_(st.flat), ravel_pytree(js.params)[0]),
             ("opt.mu", np_(st.opt.mu), js.opt.mu), ("opt.nu", np_(st.opt.nu), js.opt.nu),
             ("bank", np_(st.bank_flat), ravel_pytree(js.pose_bank["train"])[0]),
             ("bank init_c2w", np_(st.bank_static["init_c2w"]),
              js.pose_bank["static"]["init_c2w"]),
             ("pose_opt.mu", np_(st.pose_opt.mu), js.pose_opt.mu),
             ("pose_opt.nu", np_(st.pose_opt.nu), js.pose_opt.nu)]
    for what, a, b in pairs:
        _close(a, np.asarray(b), last, state_base, state_per_step, what)
    _close(tr.query_poses(N), np.asarray(js_poses(js, tr)), last, state_base,
           state_per_step, "final poses")


def js_poses(js, tr):
    """The JAX final state's poses of every frame, through the port's pose
    function on the JAX bank's leaves (the pose math itself is held to
    JAX in ``tests/test_torch_seg.py``)."""
    from fmov_pose_torch import convert
    from fmov_pose_torch.train import step as tstep
    bank = {"train": convert.to_torch(js.pose_bank["train"]),
            "static": {"b": torch.tensor(js.pose_bank["static"]["b"]),
                       "init_c2w": torch.tensor(js.pose_bank["static"]["init_c2w"])}}
    out = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    with torch.no_grad():
        for i in range(N):
            out[i, :3] = tstep.pose_of_frame(tr.step_cfg, {}, bank, {}, i).numpy()
    return out
