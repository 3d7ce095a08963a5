"""Data parallelism (``fmov_pose_torch/parallel/dp.py``) on the CPU: two
ranks, one process each, over a gloo process group (``tests/torch_dp_worker.py``
spawns them on a free ``tcp://`` port, each under a time limit).

* ``_render_and_losses`` with a group, each rank holding its half of one
  batch, against the JAX ``_render_and_losses(..., axis_name="data")``
  under a ``shard_map`` over two CPU devices that this test builds: the
  loss, every metric (JAX's ``cdf`` and ``weight_max`` are each device's
  numerator over the global mask sum, so their sum over the devices is the
  port's), and the gradient summed over the ranks.  Photo (with the unit
  sphere), flow and depth batches, the sizes and weights of
  ``tests/test_torch_step.py`` (JAX init converted, perturb 0).
* One data-parallel photo step and one flow step (segment bank,
  maintain_shape, given pixels) against the port's one-process steps on
  the whole batch; the two ranks' states bitwise equal.
* k scanned data-parallel steps against k per-step data-parallel
  dispatches (the counterpart of ``test_dp_scan_matches_per_step``).
* The fused training path (the plain versions of K4/K5 and K8/K9, the
  gates patched to 0, their operands in f32 as the JAX test's HIGHEST
  dots) under data parallelism against the unfused one,
  with and without the occupancy grid, and the grid's refresh feeding the
  next step (``test_dp_fused_hierarchical_matches_unfused``,
  ``test_dp_update_occ_grid_feeds_dp_step``).
* One rank: without ``FMOV_DISTRIBUTED`` nothing initialises and the
  Runner takes no data parallelism; a group of one is the one-device
  photo, flow and scanned steps, bitwise.

Tolerances (``tests/test_torch_step.py``'s): the loss and every metric
rtol 1e-4; every gradient leaf relative error < 1% or absolute error
< 1e-4 x the global gradient norm; the Adam moments by the same leaf rule
and the parameters' moves within 1e-3 x lr + 1e-6 where the gradient is
above the rule's floor.  The fused-against-unfused step: the JAX test's
loss rtol 1e-3 and parameters within 2% of their norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from fmov_pose_tpu.train import step as jstep
from fmov_pose_torch import convert
from fmov_pose_torch.data import rays as trays
from fmov_pose_torch.ops import fused_sdf
from fmov_pose_torch.parallel import dp
from fmov_pose_torch.render import neus as tneus
from tests import torch_dp_worker as worker
from tests.test_torch_progressive import seq_root  # noqa: F401 (fixture)
from tests.test_torch_step import (B, H, RENDER, STEP_KW, W, _check_grads, _model_cfgs,
                                   _np_tree, _ray_batch, world)  # noqa: F401 (fixture)

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

WORLD = 2
NAMES = ("loss", "color_loss", "eikonal_loss", "mask_loss", "flow_loss",
         "unit_sphere_loss", "depth_loss", "psnr", "s_val", "cdf", "weight_max")
PER_DEVICE = ("cdf", "weight_max")  # JAX: a device's numerator over the global sum


def _shard_mapped(fn, in_specs, out_specs):
    try:  # jax >= 0.8
        return shard_map(fn, mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)),
                         in_specs=in_specs, out_specs=out_specs, check_vma=False)
    except TypeError:
        return shard_map(fn, mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)),
                         in_specs=in_specs, out_specs=out_specs, check_rep=False)


def _flow_batch(sc, rng):
    """Half a batch of match pairs between frames 1 (corr) and 2, as the
    flow step lays them out: the corr frame's rays and the frame's, each
    [B/2, 10], their pixels and intrinsics."""
    b2 = B // 2
    pix = np.stack([rng.integers(4, W - 4, b2), rng.integers(4, H - 4, b2)], -1)
    pixc = np.clip(pix + rng.integers(-2, 3, pix.shape), 0, [W - 1, H - 1])
    images = torch.from_numpy(sc.images_np)
    intr_inv = torch.from_numpy(sc.intrinsics_all_inv.astype(np.float32))
    out = {}
    for name, frame, p in (("corr", 1, pixc), ("img", 2, pix)):
        p = torch.from_numpy(p.astype(np.float32))
        ro, rv = trays.gen_flow_rays(p, intr_inv[frame],
                                     torch.from_numpy(sc.pose_all[frame][:3]))
        rgb = trays.gather_rgb(images, frame, p[:, 1].long(), p[:, 0].long())
        out[name] = torch.cat([ro, rv, rgb, torch.ones((b2, 1))], -1).numpy()
    K = np.linalg.inv(sc.intrinsics_all_inv.astype(np.float64))[:, :3, :3]
    out.update(pixels=pix.astype(np.float32), pixels_corr=pixc.astype(np.float32),
               img_id=2, img_id_corr=1, K0=K[1].astype(np.float32),
               K1=K[2].astype(np.float32))
    return out


@pytest.mark.parametrize("kind", ["photo", "flow", "depth"])
def test_render_and_losses_two_ranks_vs_jax_shard_map(world, kind, tmp_path):  # noqa: F811
    sc, params_j, static_j = world
    jcfg, tcfg = _model_cfgs(False)
    rng = np.random.default_rng(3)
    step_kw = dict(STEP_KW)
    data, flow = None, None
    if kind == "flow":
        step_kw["flow_weight"] = 0.1
        flow = _flow_batch(sc, rng)
    else:
        data = _ray_batch(sc, rng)
        if kind == "depth":
            step_kw["depth_weight"] = 0.5
            depth = np.where(np.arange(B) % 3 == 0, 0.0, 1.5 + rng.random(B))
            data = np.concatenate([data, depth[:, None].astype(np.float32)], 1)
    cfg_j = jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1, **step_kw)
    sc_j = jstep.StepScalars(
        lr=jnp.float32(5e-4), cos_anneal=jnp.float32(0.7), main_update=1.0,
        pose_update=1.0, mask_guided=1.0, seg_touch=jnp.ones(1), seg_freeze=jnp.ones(1),
        seg_lr=jnp.ones(1), trans_head_on=1.0)

    def local(p, a, b, pix, pixc):
        if flow is None:
            batch, ctx = a, None
        else:
            batch = jnp.concatenate([a, b], 0)
            ctx = (flow["img_id"], flow["img_id_corr"], pix, pixc,
                   jnp.asarray(flow["K0"]), jnp.asarray(flow["K1"]))
        total, m = jstep._render_and_losses(cfg_j, jax.random.key(9), p, {}, static_j,
                                            batch, sc_j, flow_ctx=ctx, axis_name="data")
        return total, jnp.stack([jnp.asarray(m[n], jnp.float32) for n in NAMES])[None]

    sharded = _shard_mapped(local, (P(),) + (P("data"),) * 4, (P(), P("data")))
    if flow is None:
        args = (jnp.asarray(data), jnp.zeros((B, 1)), jnp.zeros((B, 2)), jnp.zeros((B, 2)))
    else:
        args = tuple(jnp.asarray(flow[k]) for k in ("corr", "img", "pixels", "pixels_corr"))
    (lj, per_dev), gj = jax.jit(jax.value_and_grad(
        lambda p: sharded(p, *args), has_aux=True))(params_j)
    per_dev = np.asarray(per_dev)
    mj = {n: (per_dev[:, i].sum() if n in PER_DEVICE else per_dev[0, i])
          for i, n in enumerate(NAMES)}
    for i, n in enumerate(NAMES):  # the psum'd metrics are the same on both devices
        if n not in PER_DEVICE:
            assert per_dev[0, i] == per_dev[1, i], n

    inp = {"sdf": tcfg["sdf"], "color": tcfg["color"], "nerf": tcfg["nerf"],
           "render": RENDER, "step_kw": step_kw, "params": _np_tree(params_j),
           "static": _np_tree(static_j), "data": data, "flow": flow, "cos_anneal": 0.7}
    outs = worker.spawn("losses", inp, WORLD, str(tmp_path))
    for n in NAMES:
        assert outs[0]["metrics"][n] == outs[1]["metrics"][n], n  # the same on each rank
        np.testing.assert_allclose(outs[0]["metrics"][n], float(mj[n]), rtol=1e-4,
                                   atol=1e-7, err_msg=n)
    assert float(lj) == pytest.approx(outs[0]["metrics"]["loss"], rel=1e-4)
    if kind == "flow":
        assert mj["flow_loss"] > 0
    if kind == "depth":
        assert mj["depth_loss"] > 0
    for n, g in outs[0]["grads"].items():
        assert np.array_equal(g, outs[1]["grads"][n]), n
    _check_grads(gj, list(outs[0]["grads"].items()))


# ---------------------------------------------------------------------------
# the port's data-parallel steps against its one-process steps
# ---------------------------------------------------------------------------

STEPS_IN = {"tiny": dict(pose_mode="seg", maintain_shape=True, flow_weight=0.1, batch=16),
            "img_id": 1, "add_img_id": 0, "flow_img_id": 2, "flow_img_id_corr": 1}


def _steps_inputs():
    rng = np.random.default_rng(5)
    n, b2 = STEPS_IN["tiny"]["batch"], STEPS_IN["tiny"]["batch"] // 2
    inp = dict(STEPS_IN)
    inp.update({k: rng.integers(0, W, n) if k.endswith("x") else rng.integers(0, H, n)
                for k in ("px", "py", "apx", "apy", "fapx", "fapy")})
    inp["pixels_pair"] = np.stack([rng.integers(4, W - 4, b2), rng.integers(4, H - 4, b2),
                                   rng.integers(4, W - 4, b2), rng.integers(4, H - 4, b2)],
                                  -1).astype(np.float32)
    return inp


def _leaves(layout, flat):
    return {n: t for n, t in convert.flatten(layout.views(torch.from_numpy(flat)))}


def _check_state(ref, got, before, lr=worker.LR):
    """The moments by the leaf rule, the parameters' moves within 1e-3 x
    lr + 1e-6 where the first moment is above the rule's floor."""
    cfg, state, _, _ = worker.tiny(**STEPS_IN["tiny"])
    for flat, mu, nu, layout in (("flat", "mu", "nu", state.layout),
                                 ("bank", "bank_mu", "bank_nu", state.bank_layout)):
        rule = fused_sdf.leaf_rule(_leaves(layout, ref[mu]), _leaves(layout, got[mu]))
        assert rule["ok"], (mu, rule)
        # the moments of gradients g: mu about 0.1 g, nu about 1e-3 g^2
        np.testing.assert_allclose(got[nu], ref[nu], rtol=2e-2,
                                   atol=1e-3 * (1e-3 * rule["gnorm"]) ** 2, err_msg=nu)
        settled = np.abs(ref[mu]) > 1e-4 * rule["gnorm"]
        move_ref, move_got = ref[flat] - before[flat], got[flat] - before[flat]
        np.testing.assert_allclose(move_got[settled], move_ref[settled], rtol=0,
                                   atol=1e-3 * lr + 1e-6, err_msg=flat)
    np.testing.assert_array_equal(got["bank_step"], ref["bank_step"])


def test_dp_photo_and_flow_steps_vs_one_process(tmp_path):
    inp = _steps_inputs()
    outs = worker.spawn("steps", inp, WORLD, str(tmp_path))
    ref = worker.photo_then_flow(inp, None, 1, 0)
    before = worker.state_arrays(worker.tiny(**STEPS_IN["tiny"])[1])
    for i, (state_ref, m_ref) in enumerate(ref):
        (s0, m0), (s1, m1) = outs[0][i], outs[1][i]
        for k in s0:
            assert np.array_equal(s0[k], s1[k]), (i, k)  # the ranks agree bitwise
        assert m0 == m1
        for n in NAMES:
            np.testing.assert_allclose(m0[n], m_ref[n], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {n}")
        _check_state(state_ref, s0, before)
        before = state_ref
    assert ref[1][1]["flow_loss"] > 0


def test_dp_scan_matches_per_step(tmp_path):
    outs = worker.spawn("scan", {"k": 3, "batch": 16}, WORLD, str(tmp_path))
    for out in outs:
        assert not out["dispatch_capture"]  # gloo: eager
        assert out["frames"] == out["drawn"]
        for k, v in out["scan"].items():
            np.testing.assert_allclose(out["per_step"][k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(out["per_step_mean"], out["scan_mean"], rtol=1e-5)
        assert out["iter"] == 3
    assert outs[0]["frames"] == outs[1]["frames"]  # the shared generator
    for k in outs[0]["scan"]:
        assert np.array_equal(outs[0]["scan"][k], outs[1]["scan"][k]), k


@pytest.mark.parametrize("occupancy", [False, True], ids=["upsampler", "grid"])
def test_dp_fused_matches_unfused(occupancy, tmp_path):
    outs = worker.spawn("fused", {"occupancy": occupancy}, WORLD, str(tmp_path))
    for fused in (True, False):
        for k in outs[0][fused][0]:
            assert np.array_equal(outs[0][fused][0][k], outs[1][fused][0][k]), (fused, k)
    (s_f, m_f), (s_x, m_x) = outs[0][True], outs[0][False]
    assert np.isfinite(m_f["loss"])
    np.testing.assert_allclose(m_f["loss"], m_x["loss"], rtol=1e-3)
    cfg, state, _, _ = worker.tiny()
    for n, a in _leaves(state.layout, s_f["flat"]).items():
        b = _leaves(state.layout, s_x["flat"])[n].double()
        d = float(torch.linalg.vector_norm(a.double() - b))
        assert d <= 2e-2 * max(float(torch.linalg.vector_norm(b)), 1e-3), (n, d)


def test_dp_occ_grid_refresh_feeds_dp_step(tmp_path):
    outs = worker.spawn("occ", {}, WORLD, str(tmp_path))
    assert np.array_equal(outs[0]["grid"], outs[1]["grid"])
    assert not np.all(outs[0]["grid"] == 1.0)
    for k in outs[0]["state"]:
        assert np.array_equal(outs[0]["state"][k], outs[1]["state"][k]), k
    assert np.isfinite(outs[0]["m1"]["loss"]) and np.isfinite(outs[0]["m2"]["loss"])
    assert outs[0]["iter"] == 2


def test_dp_runner_resumes_bitwise(tmp_path):
    """A two-rank Runner on the scan path resumed from its checkpoint at a
    chunk edge (the state broadcast from rank 0, each rank's own generator
    from the file) ends bitwise where the run it was saved from ends."""
    outs = worker.spawn("resume", {"tmp": str(tmp_path)}, WORLD, str(tmp_path))
    for out in outs:
        (sa, ga, ra, ia, da), (sb, gb, rb, ib, db) = out["a"], out["b"]
        assert ia == ib == 15 and da == db == "scan x5 (2 ranks, eager)"
        assert np.array_equal(ga, gb) and np.array_equal(ra, rb)
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), k
    assert not np.array_equal(outs[0]["a"][2], outs[1]["a"][2])  # each rank its own
    for k in outs[0]["a"][0]:
        assert np.array_equal(outs[0]["a"][0][k], outs[1]["a"][0][k]), k


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

def test_no_group_without_fmov_distributed(monkeypatch, tmp_path):
    from fmov_pose_torch.data.scene import make_orbit_scene
    from fmov_pose_torch.parallel import multihost_runner_smoke as smoke
    from fmov_pose_torch.train.runner import Runner
    monkeypatch.delenv("FMOV_DISTRIBUTED", raising=False)
    assert dp.maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (dp.world_size(), dp.rank(), dp.is_main()) == (1, 0, True)
    conf = tmp_path / "gt.conf"
    conf.write_text(smoke.conf_text(str(tmp_path / "exp"), str(tmp_path)))
    runner = Runner(str(conf), case="x", has_global_conf=True, device="cpu",
                    scene=make_orbit_scene(n_frames=3, H=24, W=32, seed=1))
    assert not runner.use_dp and runner.is_main
    assert runner.state.ray_generator is None


def test_group_of_one_is_the_one_device_step(tmp_path):
    inp = _steps_inputs()
    (out,) = worker.spawn("world1", inp, 1, str(tmp_path))
    assert out["ray_generator_of_one_rank"] is None
    for (s_dp, m_dp), (s, m) in zip(out["dp"], out["plain"]):
        for k in s:
            assert np.array_equal(s_dp[k], s[k]), k
        assert m_dp == m
    (s_dp, mean_dp, f_dp), (s, mean, f) = out["scan_dp"], out["scan_plain"]
    assert f_dp == f
    assert np.array_equal(mean_dp, mean)
    for k in s:
        assert np.array_equal(s_dp[k], s[k]), k


def test_flow_partners_in_one_order_under_dp(seq_root, tmp_path):  # noqa: F811
    """Under data parallelism the flow step's partner draw takes the
    partners in sorted order, so ranks whose sets iterate in other orders
    (each process salts its string hash) draw the same partner from the
    same host RNG; on one device it takes the set's own order, as the JAX
    Runner does."""
    from fmov_pose_torch.train.runner import Runner
    from tests.test_torch_progressive import _virtual_conf
    runner = Runner(_virtual_conf(seq_root, tmp_path), case="SYN_ori", device="cpu")
    d = runner.dataset
    runner.current_image = d.n_images
    name = next(n for n, p in sorted(d.flow_pairs.items()) if len(p) > 1)
    partners = sorted(d.flow_pairs[name])
    picks = {}
    for use_dp in (True, False):
        runner.use_dp = use_dp
        for order in (partners, partners[::-1]):
            d.flow_pairs[name] = list(order)  # iterated in this order
            runner.rng = np.random.default_rng(0)
            picks[use_dp, order[0]] = runner._sample_flow_pair(d.frame_to_index[name])[0]
    assert picks[True, partners[0]] == picks[True, partners[-1]]
    assert picks[False, partners[0]] != picks[False, partners[-1]]


def test_render_eikonal_parts(world):  # noqa: F811
    """``render(..., eikonal_parts=True)`` returns the eikonal numerator
    and denominator whose ratio (with the 1e-5) is the default's term."""
    sc, params_j, _ = world
    _, tcfg = _model_cfgs(False)
    data = torch.from_numpy(_ray_batch(sc, np.random.default_rng(3)))
    ro, rd = data[:, :3], data[:, 3:6]
    near, far = trays.near_far_from_sphere(ro, rd)
    params = convert.to_torch(_np_tree(params_j))
    params = {k: v for k, v in params.items() if k != "pose"}
    with torch.no_grad():
        ratio = tneus.render(None, params, tcfg, ro, rd, near, far)["gradient_error"]
        num, den = tneus.render(None, params, tcfg, ro, rd, near, far,
                                eikonal_parts=True)["gradient_error"]
    assert float(den) > 0
    assert torch.equal(num / (den + 1e-5), ratio)
