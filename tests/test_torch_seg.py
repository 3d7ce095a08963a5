"""The segment pose bank and the segment Adam of the port
(``poses/picture_pose.py``, ``train/optim.py``) against the JAX package.

The bank's initializer is numpy on both sides: leaves, bands and init poses
must be bitwise equal.  Poses through the two gf MLPs: within 1e-6 (f32
products in another order).  The segment Adam's elementwise math is the
JAX module's: within 1e-6 after several steps of a touch schedule, and
against independent torch Adams per segment within 5e-4 (torch computes
its bias corrections in another order), as ``tests/test_optim.py`` holds
the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.core.pose import to_4x4
from fmov_pose_tpu.poses import picture_pose as jpp
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_torch import convert
from fmov_pose_torch.poses import picture_pose as tpp
from fmov_pose_torch.train import optim as toptim

INIT = np.eye(4, dtype=np.float32)
INIT[:3, 3] = (0.1, -0.2, -2.5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("emphasize_rot", [False, True])
def test_seg_bank_matches_jax(emphasize_rot):
    """Same leaves, bands and poses of every frame; the shapes of
    tests/test_poses.py::test_seg_bank_shapes."""
    cfg_j, cfg_t = (jpp.PoseCfg(emphasize_rot=emphasize_rot),
                    tpp.PoseCfg(emphasize_rot=emphasize_rot))
    bj = jpp.init_seg_bank(7, cfg_j, 10, 3, INIT)
    bt = tpp.init_seg_bank(7, cfg_t, 10, 3, INIT)
    assert tpp.num_segments(10, 3) == jpp.num_segments(10, 3) == 4
    assert bt["train"]["lin1"]["w"].shape == (4, 64, 256)
    for (n, a), (m, b) in zip(convert.flatten(_np(bj["train"])),
                              convert.flatten(bt["train"])):
        assert n == m
        np.testing.assert_array_equal(a, b.numpy(), err_msg=n)
    for key in ("b", "init_c2w", "initialized"):
        np.testing.assert_array_equal(np.asarray(bj["static"][key]),
                                      np.asarray(bt["static"][key]), err_msg=key)
    assert isinstance(bt["static"]["initialized"], np.ndarray)  # host flags
    for cam in range(10):
        np.testing.assert_allclose(tpp.seg_apply(bt, cfg_t, 3, cam).numpy(),
                                   np.asarray(jpp.seg_apply(bj, cfg_j, 3, cam)),
                                   rtol=0, atol=1e-6, err_msg=str(cam))
    single = tpp.seg_slice(bt, 2)
    assert single["train"]["lin1"]["w"].shape == (64, 256)
    assert single["static"]["init_c2w"].shape == (1, 4, 4)


def test_seg_segments_have_distinct_bands():
    bank = tpp.init_seg_bank(0, tpp.PoseCfg(), 6, 2, INIT)
    b = bank["static"]["b"].numpy()
    assert not np.allclose(b[0], b[1])


def test_seg_initialize_matches_jax():
    """Lazy init copies the previous segment's last pose (as JAX does), is
    idempotent, and reads nothing back to decide: the flags are host numpy."""
    cfg_j, cfg_t = jpp.PoseCfg(emphasize_rot=True), tpp.PoseCfg(emphasize_rot=True)
    bj = jpp.init_seg_bank(0, cfg_j, 6, 2, INIT)
    bt = tpp.init_seg_bank(0, cfg_t, 6, 2, INIT)
    assert not bt["static"]["initialized"][1]
    last = np.asarray(jpp.gf_apply(jpp.seg_slice(bj, 0), cfg_j, 1))
    bj = jpp.seg_initialize(bj, cfg_j, 2, 1)
    bt = tpp.seg_initialize(bt, cfg_t, 2, 1)
    assert bt["static"]["initialized"].tolist() == [True, True, False]
    np.testing.assert_allclose(bt["static"]["init_c2w"][1].numpy(),
                               np.asarray(to_4x4(jnp.asarray(last))), atol=1e-6)
    np.testing.assert_allclose(bt["static"]["init_c2w"].numpy(),
                               np.asarray(bj["static"]["init_c2w"]), atol=1e-6)
    before = bt["static"]["init_c2w"].clone()
    tpp.seg_initialize(bt, cfg_t, 2, 1)  # idempotent
    assert torch.equal(bt["static"]["init_c2w"], before)
    # continuity: the new segment starts near the previous one's last pose
    first_new = tpp.seg_apply(bt, cfg_t, 2, 2).numpy()
    np.testing.assert_allclose(first_new[:, :3], last[:, :3], atol=0.1)


def test_seg_set_pose():
    bank = tpp.init_seg_bank(0, tpp.PoseCfg(), 6, 2, INIT)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (1.0, 2.0, 3.0)
    tpp.seg_set_pose(bank, 0, pose)   # initialized: kept without force
    np.testing.assert_array_equal(bank["static"]["init_c2w"][0].numpy(), INIT)
    tpp.seg_set_pose(bank, 2, pose)
    np.testing.assert_array_equal(bank["static"]["init_c2w"][2].numpy(), pose)
    assert bank["static"]["initialized"][2]
    tpp.seg_set_pose(bank, 0, pose, force=True)
    np.testing.assert_array_equal(bank["static"]["init_c2w"][0].numpy(), pose)


def test_gf_apply_takes_host_ids():
    """gf_apply of a host int matches JAX's and differentiates."""
    cfg = tpp.PoseCfg(emphasize_rot=True)
    gj = jpp.init_gf(4, jpp.PoseCfg(emphasize_rot=True), INIT)
    gt = tpp.init_gf(4, cfg, INIT)
    train = {k: {n: t.requires_grad_(True) for n, t in v.items()}
             for k, v in gt["train"].items()}
    pose = tpp.gf_apply({"train": train, "static": gt["static"]}, cfg, 3)
    np.testing.assert_allclose(
        pose.detach().numpy(),
        np.asarray(jpp.gf_apply(gj, jpp.PoseCfg(emphasize_rot=True), 3)), atol=1e-6)
    pose.sum().backward()
    assert float(train["lin1"]["w"].grad.abs().max()) > 0


def _bank(rng, S=3):
    return {"lin0": {"w": rng.normal(size=(S, 4, 5)).astype(np.float32),
                     "b": rng.normal(size=(S, 5)).astype(np.float32)},
            "scalep": rng.normal(size=(S,)).astype(np.float32)}


def test_seg_adam_matches_jax_flat():
    """Several steps of a touch schedule on a multi-leaf bank: parameters,
    moments and step counts as the JAX ``seg_adam_update_flat``."""
    rng = np.random.default_rng(3)
    bank = _bank(rng)
    layout = convert.ParamLayout(bank)
    flat = layout.ravel(bank)
    st_t = toptim.seg_adam_init(flat, layout.shapes, 3)
    idx = toptim.seg_index(layout.shapes)
    st_j = joptim.seg_adam_init(bank, 3)
    np.testing.assert_array_equal(idx.numpy(), joptim.seg_index(bank))
    params = jax.tree_util.tree_map(jnp.asarray, bank)
    lr = np.asarray([0.05, 0.1, 0.2], np.float32)
    for i, touch in enumerate(([1., 0., 1.], [1., 1., 0.], [0., 1., 1.], [1., 1., 1.])):
        touch = np.asarray(touch, np.float32)
        g = rng.normal(size=flat.shape).astype(np.float32) * (i + 1)
        params, st_j = joptim.seg_adam_update_flat(
            jnp.asarray(g), st_j, params, jnp.asarray(touch), jnp.asarray(lr))
        toptim.seg_adam_update_flat_(torch.from_numpy(g), st_t, flat,
                                     torch.from_numpy(touch), torch.from_numpy(lr), idx)
    np.testing.assert_allclose(flat.numpy(), np.asarray(ravel_pytree(params)[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(st_t.mu.numpy(), np.asarray(st_j.mu), atol=1e-6)
    np.testing.assert_allclose(st_t.nu.numpy(), np.asarray(st_j.nu), atol=1e-6)
    assert st_t.step.tolist() == np.asarray(st_j.step).tolist() == [3, 3, 3]
    # the JAX state carried over into the port's layout
    conv = convert.seg_adam_to_torch(st_j)
    assert conv.step.dtype == torch.int32
    np.testing.assert_array_equal(conv.mu.numpy(), np.asarray(st_j.mu))


def test_seg_adam_touch_isolation():
    """Untouched segments: params, moments and steps stay; a touched
    segment with zero gradient still drifts by momentum."""
    flat = torch.ones(12)
    shapes = [(3, 4)]
    st = toptim.seg_adam_init(flat, shapes, 3)
    idx = toptim.seg_index(shapes)
    lr = torch.tensor([0.1, 0.1, 0.2])
    toptim.seg_adam_update_flat_(torch.ones(12), st, flat,
                                 torch.tensor([1.0, 0.0, 1.0]), lr, idx)
    w = flat.reshape(3, 4).numpy()
    np.testing.assert_array_equal(w[1], 1.0)
    assert (w[0] < 1.0).all() and (w[2] < 1.0).all()
    assert st.step.tolist() == [1, 0, 1]
    np.testing.assert_array_equal(st.mu.reshape(3, 4)[1].numpy(), 0.0)
    np.testing.assert_allclose(1.0 - w[2], 2 * (1.0 - w[0]), rtol=1e-4)
    w0 = w[0].copy()
    toptim.seg_adam_update_flat_(torch.zeros(12), st, flat,
                                 torch.tensor([1.0, 0.0, 0.0]), lr, idx)
    assert (flat.reshape(3, 4)[0].numpy() < w0).all()  # frozen-segment drift
    with pytest.raises(ValueError, match="segment axis"):
        toptim.seg_adam_init(flat, [(2, 6)], 3)


def test_seg_adam_equals_independent_adams():
    """A bank of segment Adams == independent torch Adams per segment."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(2, 5)).astype(np.float32)
    torch_params = [torch.tensor(w0[i].copy(), requires_grad=True) for i in range(2)]
    torch_opts = [torch.optim.Adam([p], lr=0.05) for p in torch_params]
    flat = torch.from_numpy(w0.copy()).reshape(-1)
    shapes = [(2, 5)]
    st = toptim.seg_adam_init(flat, shapes, 2)
    idx = toptim.seg_index(shapes)
    for t0, t1 in [(1, 0), (1, 1), (0, 1), (1, 0), (1, 1)]:
        grads = 2 * flat.clone()
        for i, t in enumerate((t0, t1)):
            if t:
                torch_opts[i].zero_grad()
                torch_params[i].grad = 2 * torch_params[i].detach().clone()
                torch_opts[i].step()
        toptim.seg_adam_update_flat_(grads, st, flat, torch.tensor([float(t0), float(t1)]),
                                     torch.tensor([0.05, 0.05]), idx)
    for i in range(2):
        np.testing.assert_allclose(flat.reshape(2, 5)[i].numpy(),
                                   torch_params[i].detach().numpy(), atol=5e-4)


def test_seg_bank_converts_from_jax():
    bj = jpp.init_seg_bank(1, jpp.PoseCfg(), 4, 2, INIT)
    bj = jpp.seg_initialize(bj, jpp.PoseCfg(), 2, 1)
    bt = convert.seg_bank_to_torch(_np(bj))
    assert bt["static"]["initialized"].tolist() == [True, True]
    assert set(bt["static"]) == {"b", "init_c2w", "initialized"}
    for cam in range(4):
        np.testing.assert_allclose(tpp.seg_apply(bt, tpp.PoseCfg(), 2, cam).numpy(),
                                   np.asarray(jpp.seg_apply(bj, jpp.PoseCfg(), 2, cam)),
                                   atol=1e-6)
    layout = convert.ParamLayout(bt["train"])
    np.testing.assert_array_equal(layout.ravel(bt["train"]).numpy(),
                                  np.asarray(ravel_pytree(bj["train"])[0]))
