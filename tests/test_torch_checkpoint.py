"""Checkpoints: the port reads the JAX package's files without JAX and
resumes where the JAX Runner resumes; its own files round-trip.

A JAX Runner trains ``tests/test_train_e2e.py``'s progressive
``VIRTUAL_CONF`` (segment bank, flow, one admission) for 30 steps on the
sequence of ``tests/test_torch_progressive.py`` and saves.  The port's
Runner, built with ``is_continue=True`` on the CPU, loads that file:

* the flat parameters, the flat Adam, the segment bank and the segment
  Adam equal the JAX state bitwise, and the host counters equal JAX's;
* the next 60 planned steps equal the resumed JAX Runner's plan, by the
  comparison of ``test_runner_plans_like_jax``;
* one photo loss on a fixed ray batch (perturb 0) and its gradient leaves
  agree with the resumed JAX state's within ``tests/test_torch_step.py``'s
  tolerances: every metric rtol 1e-4, every gradient leaf relative error
  < 1% or absolute error < 1e-4 x the global norm.

A port checkpoint round-trips bitwise (the device generator's state
included); ``latest_checkpoint`` picks JAX's file; a file cut short while
written never becomes the latest; a pre-flat-Adam JAX file loads; a file
of another state shape raises.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.train import checkpoint as jckpt
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_tpu.train import step as jstep
from fmov_pose_torch import convert
from fmov_pose_torch.data import rays as trays
from fmov_pose_torch.train import checkpoint as tckpt
from fmov_pose_torch.train import step as tstep
from tests.test_torch_progressive import _plan, _virtual_conf, seq_root  # noqa: F401
from tests.test_torch_step import _check_grads, _check_scalars
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)

N_TRAIN = 30  # mesh warm-up 10, then an admission after 15 steps


@pytest.fixture(scope="module")
def jax_run(seq_root, tmp_path_factory):  # noqa: F811
    """(conf path, the JAX Runner after N_TRAIN steps and its save)."""
    from fmov_pose_tpu.train.runner import Runner as JRunner
    tmp = tmp_path_factory.mktemp("jckpt")
    conf = _virtual_conf(seq_root, tmp, end_iter=N_TRAIN)
    jr = JRunner(conf, mode="train", case="SYN_ori", has_global_conf=True)
    jr.train()
    assert jr.iter_step == N_TRAIN and jr.current_image == 2
    return conf, jr


def _resumed(conf):
    from fmov_pose_torch.train.runner import Runner
    return Runner(conf, mode="train", case="SYN_ori", has_global_conf=True,
                  is_continue=True, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def test_jax_checkpoint_loads_bitwise(jax_run):
    conf, jr = jax_run
    tr = _resumed(conf)
    key = np.asarray(jax.random.key_data(jr.state.key)).astype(np.uint64)
    js = jax.tree_util.tree_map(np.asarray, jr.state._replace(key=None))
    np.testing.assert_array_equal(_np(tr.state.flat), np.asarray(ravel_pytree(js.params)[0]))
    assert tr.state.opt.step == int(js.opt.step) == N_TRAIN
    np.testing.assert_array_equal(_np(tr.state.opt.mu), js.opt.mu)
    np.testing.assert_array_equal(_np(tr.state.opt.nu), js.opt.nu)
    np.testing.assert_array_equal(_np(tr.state.bank_flat),
                                  np.asarray(ravel_pytree(js.pose_bank["train"])[0]))
    for k in ("b", "init_c2w"):
        np.testing.assert_array_equal(_np(tr.state.bank_static[k]), js.pose_bank["static"][k])
    np.testing.assert_array_equal(tr.state.bank_static["initialized"],
                                  js.pose_bank["static"]["initialized"])
    for k in ("step", "mu", "nu"):
        np.testing.assert_array_equal(_np(getattr(tr.state.pose_opt, k)),
                                      getattr(js.pose_opt, k), err_msg=k)
    assert tr.state.iter_step == int(js.iter_step)
    # the generator is seeded from JAX's key, (key[0] << 32) | key[1]
    assert tr.state.generator.initial_seed() == int((key[0] << np.uint64(32)) | key[1])
    for k in ("iter_step", "current_image", "current_pose_mlp_index", "pro_iteration",
              "mesh_warmup_step", "prev_pose"):
        assert getattr(tr, k) == getattr(jr, k), k
    np.testing.assert_array_equal(tr.seg_progress, jr.seg_progress)
    np.testing.assert_array_equal(tr.seg_frozen, jr.seg_frozen)
    np.testing.assert_allclose(tr.query_poses(5), jr.query_poses(5), atol=1e-5)


def test_resumed_plan_matches_jax(jax_run):
    """The host RNG restarts from the seed on both sides (neither saves it),
    so the resumed plans agree step for step, admissions included."""
    from fmov_pose_tpu.train.runner import Runner as JRunner
    conf, _ = jax_run
    jr = JRunner(conf, mode="train", case="SYN_ori", has_global_conf=True,
                 is_continue=True)
    tr = _resumed(conf)
    pj, pt = _plan(jr, 60), _plan(tr, 60)
    events = 0
    for step, (a, b) in enumerate(zip(pj, pt)):
        if isinstance(a[0], str):
            assert a == b, step
            events += 1
            continue
        np.testing.assert_array_equal(a[0], b[0], err_msg=str(step))
        assert (a[1], a[3]) == (b[1], b[3]), step
        assert (a[2] is None) == (b[2] is None), step
        if a[1]:
            np.testing.assert_array_equal(a[2], b[2], err_msg=str(step))
    assert len(pj) == len(pt) and events >= 2
    assert (tr.current_image, tr.current_pose_mlp_index) == (jr.current_image,
                                                             jr.current_pose_mlp_index)
    np.testing.assert_array_equal(tr.seg_frozen, jr.seg_frozen)
    np.testing.assert_array_equal(tr.seg_progress, jr.seg_progress)


def test_resumed_loss_and_gradients_match_jax(jax_run):
    """One photo loss of the loaded states on the same rays (frame 1 through
    fixed pixels, the pose from the resumed segment bank), perturb 0."""
    conf, jr = jax_run
    tr = _resumed(conf)
    cfg_t = tr.step_cfg
    cfg_t = dataclasses.replace(cfg_t, model_cfg=dict(
        cfg_t.model_cfg, renderer=cfg_t.model_cfg["renderer"]._replace(perturb=0.0)))
    cfg_j = jr.step_cfg
    cfg_j = dataclasses.replace(cfg_j, model_cfg=dict(
        cfg_j.model_cfg, renderer=cfg_j.model_cfg["renderer"]._replace(perturb=0.0)))
    rng = np.random.default_rng(5)
    B, img = 64, 1
    with torch.no_grad():
        pose = tstep.pose_of_frame(cfg_t, tr.state.params, tr.state.pose_bank,
                                   tr.state.pose_static, img)
        data = trays.gen_random_rays(
            None, tr.images_dev, tr.masks_dev, tr.intr_inv_dev, pose, img, B, None, 0,
            False, tr.dataset.H, tr.dataset.W,
            pixels=(torch.from_numpy(rng.integers(0, tr.dataset.W, B)),
                    torch.from_numpy(rng.integers(0, tr.dataset.H, B)))).numpy()
    S = tr.n_segments
    sc_j = jstep.StepScalars(
        lr=jnp.float32(0.0), cos_anneal=jnp.float32(1.0), main_update=1.0,
        pose_update=1.0, mask_guided=1.0, seg_touch=jnp.ones(S), seg_freeze=jnp.ones(S),
        seg_lr=jnp.zeros(S), trans_head_on=1.0)
    js = jr.state

    def loss_j(p):
        return jstep._render_and_losses(cfg_j, jax.random.key(9), p, js.pose_bank,
                                        js.pose_static, jnp.asarray(data), sc_j)

    (_, mj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(js.params)
    flat = tr.state.flat.detach().clone().requires_grad_(True)
    lt, mt = tstep._render_and_losses(cfg_t, None, tr.state.layout.views(flat),
                                      tr.state.pose_static, torch.from_numpy(data),
                                      tstep.StepScalars(lr=0.0, cos_anneal=1.0))
    (g,) = torch.autograd.grad(lt, flat)
    _check_scalars(mj, mt, 1e-4)
    _check_grads(gj, [(n, _np(t)) for n, t in convert.flatten(tr.state.layout.views(g))])


def test_port_checkpoint_round_trips(seq_root, tmp_path):  # noqa: F811
    """A port Runner's save, loaded by a fresh Runner, gives every leaf, the
    host counters and the generator's state bitwise, and saves the same
    leaves again; the loaded generator draws what the saved one draws."""
    from fmov_pose_torch.train.runner import Runner
    conf = _virtual_conf(seq_root, tmp_path, end_iter=N_TRAIN)
    a = Runner(conf, mode="train", case="SYN_ori", has_global_conf=True, device="cpu")
    a.train()
    path = tckpt.latest_checkpoint(os.path.join(a.base_exp_dir, "checkpoints"))
    assert os.path.basename(path) == f"ckpt_{a.current_image:06d}_{N_TRAIN:06d}.ckpt"
    leaves, meta, fmt = tckpt.load_checkpoint(path)
    assert fmt == tckpt.FORMAT
    b = _resumed(conf)
    for (n, x), (m, y) in zip(a.state_leaves(), b.state_leaves()):
        assert n == m and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=n)
    for (n, x), y in zip(a.state_leaves(), leaves):
        np.testing.assert_array_equal(x, y, err_msg=n)
    for k, v in a._host_meta().items():
        np.testing.assert_array_equal(getattr(b, k), v, err_msg=k)
    assert (a.state.opt.step, a.state.iter_step) == (b.state.opt.step, b.state.iter_step)
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    assert torch.equal(torch.rand(5, generator=a.state.generator),
                       torch.rand(5, generator=b.state.generator))
    np.testing.assert_array_equal(b.state.bank_static["initialized"],
                                  a.state.bank_static["initialized"])


def test_latest_checkpoint_is_jax_rule(tmp_path):
    names = ["ckpt_000002_000030.ckpt", "ckpt_000010_000005.ckpt",
             "ckpt_000002_000100.ckpt", "notes.txt", "ckpt_000011_000001.ckpt.7.tmp"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    got = tckpt.latest_checkpoint(str(tmp_path))
    assert got == jckpt.latest_checkpoint(str(tmp_path))
    assert os.path.basename(got) == "ckpt_000010_000005.ckpt"
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_half_written_checkpoint_is_never_latest(tmp_path, monkeypatch):
    """A save that fails midway leaves the previous file the latest and no
    file behind."""
    ckdir = tmp_path / "checkpoints"
    first = str(ckdir / "ckpt_000001_000010.ckpt")
    tckpt.save_checkpoint(first, [np.arange(4.0)], {"iter_step": 10})

    def cut(obj, f, protocol=None):
        f.write(b"\x80\x05partial")
        raise OSError("disk full")

    monkeypatch.setattr(pickle, "dump", cut)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_checkpoint(str(ckdir / "ckpt_000001_000020.ckpt"), [np.arange(4.0)],
                              {"iter_step": 20})
    assert os.listdir(ckdir) == ["ckpt_000001_000010.ckpt"]
    assert tckpt.latest_checkpoint(str(ckdir)) == first
    leaves, meta, _ = tckpt.load_checkpoint(first)
    np.testing.assert_array_equal(leaves[0], np.arange(4.0))
    assert meta == {"iter_step": 10}


def test_pre_flat_adam_jax_checkpoint_loads(jax_run, tmp_path):
    """A JAX file whose Adam moments are params-shaped trees (before the
    flat Adam, ``optim.ensure_flat_adam``) loads into the flat buffers."""
    conf, jr = jax_run
    js = jr.state
    _, unravel = ravel_pytree(js.params)
    _, unravel_b = ravel_pytree(js.pose_bank["train"])
    old = js._replace(
        opt=joptim.AdamState(step=js.opt.step, mu=unravel(js.opt.mu),
                             nu=unravel(js.opt.nu)),
        pose_opt=joptim.SegAdamState(step=js.pose_opt.step, mu=unravel_b(js.pose_opt.mu),
                                     nu=unravel_b(js.pose_opt.nu)))
    path = str(tmp_path / "checkpoints" / "ckpt_000002_000030.ckpt")
    jckpt.save_checkpoint(path, old, {"iter_step": jr.iter_step,
                                      "current_image": jr.current_image,
                                      "current_pose_mlp_index": jr.current_pose_mlp_index,
                                      "pro_iteration": jr.pro_iteration,
                                      "prev_pose": jr.prev_pose,
                                      "seg_progress": jr.seg_progress,
                                      "seg_frozen": jr.seg_frozen})
    assert len(tckpt.load_checkpoint(path)[0]) > len(jax.tree_util.tree_leaves(js))
    tr = _resumed(conf)
    tr.load_checkpoint(path)
    np.testing.assert_array_equal(_np(tr.state.opt.mu), np.asarray(js.opt.mu))
    np.testing.assert_array_equal(_np(tr.state.opt.nu), np.asarray(js.opt.nu))
    np.testing.assert_array_equal(_np(tr.state.pose_opt.mu), np.asarray(js.pose_opt.mu))
    assert tr.mesh_warmup_step == 0


@pytest.mark.parametrize("edit", ["drop_last", "reshape_first"])
def test_checkpoint_of_another_state_raises(jax_run, tmp_path, edit):
    conf, jr = jax_run
    path = jckpt.latest_checkpoint(os.path.join(jr.base_exp_dir, "checkpoints"))
    with open(path, "rb") as f:
        payload = pickle.load(f)
    leaves = payload["leaves"]
    payload["leaves"] = (leaves[:-1] if edit == "drop_last"
                         else [leaves[0].reshape(1, -1)] + leaves[1:])
    bad = str(tmp_path / "bad.ckpt")
    with open(bad, "wb") as f:
        pickle.dump(payload, f)
    tr = _resumed(conf)
    with pytest.raises(ValueError, match="checkpoint"):
        tr.load_checkpoint(bad)
