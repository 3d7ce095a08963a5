"""bf16 activations (``train.compute_dtype = bfloat16``): the port's fields
and one photo step against the JAX package's on the CPU, with parameters
converted from the JAX init.

Both sides multiply bf16 operands with f32 accumulation, add the bias in
f32 and store each layer's output in bf16; softplus runs in f32 (the
contract of ``fmov_pose_tpu/fields/nets.py:linear_apply``).  They sum in
different orders, so where an f32 sum lands next to a bf16 rounding
boundary the two sides store neighbouring bf16 values (one bf16 ulp,
2^-8 relative), and the next layers carry that on.  Measured here, no
such boundary was met in the fields: their outputs and the SDF's and the
color network's input gradients agree within 1.1e-7 of their largest
magnitude, and the eikonal loss's parameter gradient by the ROADMAP rule
(relative error < 1%, or absolute < 1e-4 x the global norm).  They are
held to ``ROUND`` (1e-2 of the largest magnitude), which a few such
neighbouring values pass and a wrong cast does not: the bf16 fields
differ from the f32 ones by 5.4e-4 (color, through its sigmoid) or more
of it, held at 2e-4 (``BF16_APART``).  The
photo step: loss and metrics within 1.3e-5 relative (held at 1e-3); its
gradient leaves, where the eikonal term's second-order backward rounds
its cotangents to bf16 at places that differ between the two autograds,
within 1.3% relative (``sdf.layers.lin4.v``) or 4.4e-4 of the global
norm, held at 2.5% or 1e-3 (``GRAD_RULE``); the moved parameters as in
``tests/test_torch_step.py`` where the gradient is above that floor.

The bf16 run of the whole Runner on the CPU trains the tiny progressive
conf to its end with finite, falling losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_tpu.train import optim as joptim
from fmov_pose_tpu.train import step as jstep
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.train import optim as toptim
from fmov_pose_torch.train import step as tstep
from tests.test_torch_fields import COLOR_CFG, NERF_CFG, SDF_CFG, _both, _init, _jit
from tests.test_torch_progressive import N, _virtual_conf, seq_root  # noqa: F401
from tests.test_torch_step import (LR, STEP_KW, _check_grads, _check_scalars, _jax_pixels,
                                   _model_cfgs, _np_tree, world)  # noqa: F401
from tests.test_torch_scan import one_torch_thread  # noqa: F401 (autouse)

BF16 = {"compute_dtype": "bfloat16"}
ROUND = 1e-2  # of the compared array's largest magnitude
BF16_APART = 2e-4  # the least gap between the bf16 and the f32 fields
GRAD_RULE = (2.5e-2, 1e-3)  # relative error, or absolute error x the global norm


def _round_close(ref, got, what):
    ref = np.asarray(ref, np.float64)
    got = got.detach().numpy().astype(np.float64) if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < ROUND, (what, err)


def test_compute_dtype_names():
    assert tn.compute_dtype({}) is None
    assert tn.compute_dtype({"compute_dtype": "float32"}) is None
    assert tn.compute_dtype({"compute_dtype": "bf16"}) is torch.bfloat16
    assert tn.compute_dtype(BF16) is torch.bfloat16
    with pytest.raises(ValueError):
        tn.compute_dtype({"compute_dtype": "int8"})


def test_float32_path_keeps_the_inputs_dtype(rng):
    """Without a compute dtype the fields run in their inputs' dtype, f64
    included (``chip_smoke.py``'s bake check evaluates the SDF in f64)."""
    x = torch.from_numpy(rng.normal(size=(20, 3)))
    sdf = convert.to_torch(_np_tree(_init(jn.init_sdf, 1, SDF_CFG)), dtype=torch.float64)
    out, g = tn.sdf_apply_with_gradient(sdf, SDF_CFG, x)
    assert out.dtype == g.dtype == torch.float64
    color = convert.to_torch(_np_tree(_init(jn.init_color, 4, COLOR_CFG)),
                             dtype=torch.float64)
    assert tn.color_apply(color, COLOR_CFG, x, g, x, out[:, 1:]).dtype == torch.float64
    nerf = convert.to_torch(_np_tree(_init(jn.init_nerf, 5, NERF_CFG)), dtype=torch.float64)
    a, c = tn.nerf_apply(nerf, NERF_CFG, torch.from_numpy(rng.normal(size=(20, 4))), x)
    assert a.dtype == c.dtype == torch.float64


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_sdf_bf16(rng, scale):
    """sdf_apply's value, sdf_gradient and the eikonal loss's parameter
    gradient (second order through the bf16 layers)."""
    cfg = dict(SDF_CFG, scale=scale, **BF16)
    pj, pt = _both(_init(jn.init_sdf, 1, cfg))
    pts = (rng.normal(size=(200, 3)) * 0.5).astype(np.float32)
    x = torch.from_numpy(pts)
    out = tn.sdf_apply(pt, cfg, x)
    assert out.dtype == torch.float32
    f32 = tn.sdf_apply(pt, dict(cfg, compute_dtype="float32"), x)
    assert (out - f32).abs().max() > BF16_APART * f32.abs().max()
    _round_close(_jit(jn.sdf_apply, cfg)(pj, jnp.asarray(pts)), out, "sdf_apply")
    gj = _jit(jn.sdf_gradient, cfg)(pj, jnp.asarray(pts))
    _round_close(gj, tn.sdf_gradient(pt, cfg, x), "sdf_gradient")
    o2, g2 = tn.sdf_apply_with_gradient(pt, cfg, x)
    _round_close(gj, g2, "sdf_apply_with_gradient")

    def eik_j(p):
        g = jn.sdf_gradient(p, cfg, jnp.asarray(pts))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    grads_j = jax.jit(jax.grad(eik_j))(pj)
    items = convert.flatten(pt)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    g = tn.sdf_gradient(convert.unflatten(zip([n for n, _ in items], leaves)), cfg, x)
    loss = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _check_grads(grads_j, [(n, (torch.zeros_like(l) if gr is None else gr).numpy())
                           for (n, l), gr in zip(items, grads)])


def test_color_bf16(rng):
    cfg = dict(COLOR_CFG, **BF16)
    pj, pt = _both(_init(jn.init_color, 4, cfg))
    M = 100
    arrs = [rng.normal(size=(M, 3)).astype(np.float32) for _ in range(3)]
    feat = rng.normal(size=(M, 64)).astype(np.float32)
    ref = _jit(jn.color_apply, cfg)(pj, *[jnp.asarray(a) for a in arrs], jnp.asarray(feat))
    ft = torch.from_numpy(feat).requires_grad_(True)
    out = tn.color_apply(pt, cfg, *[torch.from_numpy(a) for a in arrs], ft)
    assert out.dtype == torch.float32
    f32 = tn.color_apply(pt, COLOR_CFG, *[torch.from_numpy(a) for a in arrs], ft)
    assert (out - f32).abs().max() > BF16_APART * f32.abs().max()
    _round_close(ref, out, "color_apply")
    gj = jax.jit(jax.grad(lambda f: jn.color_apply(
        pj, cfg, *[jnp.asarray(a) for a in arrs], f).sum()))(jnp.asarray(feat))
    out.sum().backward()
    _round_close(gj, ft.grad, "color_apply feature gradient")


def test_nerf_bf16(rng):
    cfg = dict(NERF_CFG, **BF16)
    pj, pt = _both(_init(jn.init_nerf, 5, cfg))
    p4 = rng.normal(size=(50, 4)).astype(np.float32)
    v3 = rng.normal(size=(50, 3)).astype(np.float32)
    aj, cj = _jit(jn.nerf_apply, cfg)(pj, jnp.asarray(p4), jnp.asarray(v3))
    at, ct = tn.nerf_apply(pt, cfg, torch.from_numpy(p4), torch.from_numpy(v3))
    assert at.dtype == ct.dtype == torch.float32
    a32, _ = tn.nerf_apply(pt, NERF_CFG, torch.from_numpy(p4), torch.from_numpy(v3))
    assert (at - a32).abs().max() > BF16_APART * a32.abs().max()
    _round_close(aj, at, "nerf alpha")
    _round_close(cj, ct, "nerf rgb")


def test_photo_step_bf16(world):  # noqa: F811
    """One photometric step (gf pose, the f32 renderer path) with bf16
    activations in the SDF, color and background networks: metrics,
    gradients (Adam's first moment) and the moved parameters."""
    sc, params_j, static_j = world
    jcfg, tcfg = _model_cfgs(False)
    for cfg in (jcfg, tcfg):
        for net in ("sdf", "color", "nerf"):
            cfg[net].update(BF16)
    img_id = 1
    images = np.round(sc.images_np * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    masks = np.round(sc.masks_np[..., 0] * 256.0).astype(np.uint8).astype(np.float32) / 256.0
    intr_inv = sc.intrinsics_all_inv.astype(np.float32)
    cfg_j = jstep.make_step_config(jcfg, n_segments=1, segment_img_num=1, **STEP_KW)
    step_j = jstep.make_photo_step(
        cfg_j, jnp.asarray(images.transpose(3, 0, 1, 2)), jnp.asarray(masks),
        jnp.asarray(intr_inv), jnp.asarray(sc.mask_bboxes))
    key = jax.random.key(11)
    state_j = jstep.TrainState(
        params=params_j, opt=joptim.adam_init(params_j), pose_bank={}, pose_opt=(),
        pose_static=static_j, key=key, iter_step=jnp.zeros((), jnp.int32))
    packed = jstep.pack_scalars_np(LR, 1.0, 1.0, 1.0, 1.0, 1.0, img_id, 0, 0,
                                   np.ones(1), np.ones(1), np.ones(1))
    new_j, mj = jax.jit(lambda s, p: step_j(s, p))(state_j, packed)

    cfg_t = tstep.make_step_config(tcfg, **STEP_KW)
    step_t = tstep.make_photo_step(cfg_t, *(torch.from_numpy(a) for a in
                                            (images, masks, intr_inv, sc.mask_bboxes)))
    tree_t = convert.to_torch(_np_tree(params_j))
    layout = convert.ParamLayout(tree_t)
    flat = layout.ravel(tree_t, "cpu").requires_grad_(True)
    state_t = tstep.TrainState(
        flat=flat, layout=layout, opt=toptim.adam_init(flat.detach()),
        pose_static=convert.to_torch(_np_tree(static_j)),
        generator=torch.Generator().manual_seed(0))
    state_t, mt = step_t(state_t, tstep.StepScalars(lr=LR, cos_anneal=1.0), img_id,
                         pixels=_jax_pixels(key, sc.mask_bboxes, img_id))
    assert state_t.flat.dtype == state_t.opt.mu.dtype == torch.float32
    _check_scalars(mj, mt, 1e-3)
    _, unravel = ravel_pytree(params_j)
    ref = dict(convert.flatten(_np_tree(unravel(new_j.opt.mu / 0.1))))
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref.values()))
    for n, t in convert.flatten(layout.views(state_t.opt.mu / 0.1)):
        err = np.abs(t.detach().numpy().astype(np.float64) - ref[n]).max()
        assert (err < GRAD_RULE[0] * np.abs(ref[n]).max()
                or err < GRAD_RULE[1] * gnorm), (n, err, gnorm)
    new_params_j = dict(convert.flatten(_np_tree(new_j.params)))
    old = dict(convert.flatten(_np_tree(params_j)))
    for n, t in convert.flatten(state_t.params):
        settled = np.abs(ref[n]) > GRAD_RULE[1] * gnorm
        np.testing.assert_allclose((t.detach().numpy() - old[n])[settled],
                                   (new_params_j[n] - old[n])[settled], rtol=0,
                                   atol=1e-3 * LR + 1e-6, err_msg=n)


def test_runner_trains_bf16(seq_root, tmp_path):  # noqa: F811
    """``train.compute_dtype = bfloat16`` through the port's Runner: the
    tiny progressive conf trains through every admission, on f32
    parameters, with finite losses that fall."""
    from fmov_pose_torch.train.runner import Runner
    conf = _virtual_conf(seq_root, tmp_path, extra=(
        ("maintain_shape = True", "maintain_shape = True\n    compute_dtype = bfloat16"),))
    runner = Runner(conf, case="SYN_ori", has_global_conf=True, device="cpu")
    assert all(runner.model_cfg[n]["compute_dtype"] == "bfloat16"
               for n in ("sdf", "color", "nerf"))
    runner.train()
    assert runner.current_image == N and runner.iter_step == 85
    loss = np.asarray(runner.history["color_loss"])
    assert np.all(np.isfinite(runner.history["loss"]))
    assert loss[-20:].mean() < loss[:10].mean()
    assert runner.state.flat.dtype == torch.float32
