"""K6 and K7, the per-sample color MLP and its backward
(``fmov_pose_torch/ops/fused_color.py``: ``color_fused``,
``color_fused_featfirst``).

On the CPU the port's entries take the plain versions, held here against:
* the JAX package's K6/K7 in interpret mode (``FMOV_PALLAS_INTERPRET=1``,
  TILE 32, the bf16 products left as they are on both sides), through
  ``color_fused`` (prebuilt input rows) and ``color_fused_featfirst``
  (pts, dirs, normals, feature): at a small width (color 2x32, d_feature
  32, multires_view 2) on 45 samples and at the full width of
  ``confs/ho3d_global_womask_tpu_fast.conf`` (4x256 on the 289-wide input)
  on 40, both ragged against the tile.  The JAX featfirst entry permutes
  the first layer to feature-first order (TPU layout); the port keeps idr
  order, which changes only the order of the f32 sums;
* at the full width without JAX: K7's hand derivation against
  torch.autograd of K6's plain version, and K6's rows against the f32
  ``nets.color_apply``.

Tolerances: the rgb rows within 1e-5 of max|rgb| in the median and 1e-2 at
the maximum (two bf16-operand evaluations, see test_torch_fused_sdf.py);
every gradient leaf (the weight-norm v and g, b, and xc or pts, dirs,
normals, feature) by ``fused_sdf.leaf_rule`` (relative L2 error < 1% per
leaf, or < 1e-4 of the global L2 norm); the rows against f32 within 1e-2
of max|rgb| (bf16 operands).  The gradients are not held against f32: the
weight gradients are sums over samples of terms of both signs, and the
bf16 operand contract moves them by a few percent (measured on a CPU at
200 samples, `layers.lin0.v` and `lin1.v`), as it moves the JAX kernel's,
which the JAX comparison above holds the port to.  The CUDA
kernels run only on the card: the ``cuda``-marked test holds them against
the plain versions at the slice-4 step's M = 65,536 and a ragged 1,000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_color, fused_sdf

SMALL = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2, "squeeze_out": True}
FULL = {"d_feature": 256, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 256,
        "n_layers": 4, "weight_norm": True, "multires_view": 4, "squeeze_out": True}
WIDTHS = [pytest.param(SMALL, 45, id="small"), pytest.param(FULL, 40, id="full")]
GEO = ("pts", "dirs", "normals", "feature")


@pytest.fixture()
def jfc(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_color as jc
    monkeypatch.setattr(jc, "TILE", 32)
    yield jc
    jax.clear_caches()


def _d_in(cfg):
    return tn.color_dims(cfg)[0]


def _geometry(cfg, M, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(M, 3))
    return {"pts": rng.uniform(-1, 1, (M, 3)).astype(np.float32),
            "dirs": (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32),
            "normals": rng.normal(size=(M, 3)).astype(np.float32),
            "feature": rng.normal(size=(M, cfg["d_feature"])).astype(np.float32)}


def _both_params(cfg, seed):
    pj = jn.init_color(jax.random.key(seed), cfg)
    return pj, convert.to_torch(jax.tree_util.tree_map(np.asarray, pj))


def _port_grads(pt, entry, inputs, ct):
    """(rgb, {name: gradient}) of sum(rgb * ct) through a port entry."""
    items = convert.flatten(pt)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inputs.items()}
    rgb = entry(convert.unflatten(zip([n for n, _ in items], leaves)), *ts.values())
    grads = torch.autograd.grad((rgb * torch.from_numpy(ct)).sum(),
                                list(ts.values()) + leaves)
    return rgb.detach(), dict(zip(list(ts) + [n for n, _ in items], grads))


def _check_rows(ref, got):
    ref = torch.as_tensor(np.array(ref), dtype=torch.float64)
    d = (got.double() - ref).abs()
    scale = float(ref.abs().max())
    assert got.shape == ref.shape
    assert float(d.median()) <= 1e-5 * scale and float(d.max()) <= 1e-2 * scale


def _check_leaves(ref_inputs, ref_params, got):
    ref = {k: torch.tensor(np.array(v)) for k, v in ref_inputs.items()}
    ref.update({k: torch.tensor(np.array(v)) for k, v in
                convert.flatten(jax.tree_util.tree_map(np.asarray, ref_params))})
    assert set(ref) == set(got)
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res


@pytest.mark.parametrize("cfg,M", WIDTHS)
def test_color_fused_matches_jax(jfc, cfg, M):
    pj, pt = _both_params(cfg, 0)
    rng = np.random.default_rng(1)
    xc = rng.normal(size=(M, _d_in(cfg))).astype(np.float32)
    ct = rng.normal(size=(M, 3)).astype(np.float32)

    def loss_j(p, x):
        rgb = jfc.color_fused(p, cfg, x)
        return jnp.sum(rgb * ct), rgb

    (_, rgb_j), (gp, gx) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(pj, jnp.asarray(xc))
    before = (fused_color.LAUNCHES_K6, fused_color.LAUNCHES_K7)
    rgb, got = _port_grads(pt, lambda p, x: fused_color.color_fused(p, cfg, x),
                           {"xc": xc}, ct)
    assert (fused_color.LAUNCHES_K6, fused_color.LAUNCHES_K7) == before
    _check_rows(rgb_j, rgb)
    _check_leaves({"xc": gx}, gp, got)


@pytest.mark.parametrize("cfg,M", WIDTHS)
def test_color_fused_featfirst_matches_jax(jfc, cfg, M):
    pj, pt = _both_params(cfg, 2)
    geo = _geometry(cfg, M, 3)
    ct = np.random.default_rng(4).normal(size=(M, 3)).astype(np.float32)

    def loss_j(p, *g):
        rgb = jfc.color_fused_featfirst(p, cfg, *g)
        return jnp.sum(rgb * ct), rgb

    (_, rgb_j), grads_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            pj, *(jnp.asarray(geo[k]) for k in GEO))
    rgb, got = _port_grads(
        pt, lambda p, *g: fused_color.color_fused_featfirst(p, cfg, *g), geo, ct)
    _check_rows(rgb_j, rgb)
    _check_leaves(dict(zip(GEO, grads_j[1:])), grads_j[0], got)


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_matches_autograd_full_width(seed):
    """The hand derivation at the full width, without JAX: K7's plain
    version against torch.autograd of K6's plain version (the same
    bf16-operand forward; autograd keeps the backward's cotangents in f32
    where K7 rounds them to bf16, as the JAX kernel does), under a random
    per-sample cotangent; and K6's plain rows against the f32
    ``nets.color_apply`` through ``color_fused_featfirst``."""
    M = 200
    pt = convert.to_torch(convert.to_numpy(tn.init_color(np.random.default_rng(seed),
                                                         FULL)))
    geo = _geometry(FULL, M, seed + 1)
    rng = np.random.default_rng(seed + 2)
    ws, bs = fused_color.materialize(pt, FULL)
    ws = [w.clone().requires_grad_(True) for w in ws]
    bs = [b.clone().requires_grad_(True) for b in bs]
    xc = torch.from_numpy(rng.normal(size=(M, 289)).astype(np.float32)).requires_grad_(True)
    ct = torch.from_numpy(rng.normal(size=(M, 3)).astype(np.float32))
    ref = torch.autograd.grad((fused_color.color_fwd_plain(ws, bs, xc) * ct).sum(),
                              [xc] + ws + bs)
    xcbar, dws, dbs = fused_color.color_bwd_plain(ws, bs, xc.detach(), ct)
    names = ["xc"] + [f"w{l}" for l in range(len(ws))] + [f"b{l}" for l in range(len(bs))]
    res = fused_sdf.leaf_rule(dict(zip(names, ref)), dict(zip(names, [xcbar] + dws + dbs)))
    assert res["ok"], res

    with torch.no_grad():
        ts = {k: torch.from_numpy(v) for k, v in geo.items()}
        rgb = fused_color.color_fused_featfirst(pt, FULL, *ts.values())
        ref_rgb = tn.color_apply(pt, FULL, ts["pts"], ts["normals"], ts["dirs"],
                                 ts["feature"])
    assert float((rgb - ref_rgb).abs().max()) < 1e-2 * float(ref_rgb.abs().max())


def test_launchers_take_cuda_tensors_only():
    """The launchers check their arguments and never take a CPU tensor;
    the wrappers take the plain versions for CPU tensors."""
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        tn.init_color(np.random.default_rng(0), FULL))), FULL)
    pk = fused_color.RayPack(ws, bs, FULL)
    assert pk.d_in == 289 and pk.table[:, 7].tolist()[0] == 304  # K8/K9's packing
    xc = torch.randn(70, 289)
    ct = torch.randn(70, 3)
    with pytest.raises(ValueError):
        fused_color.launch_fwd_sample(pk, xc)
    with pytest.raises(ValueError):
        fused_color.launch_bwd_sample(pk, xc, ct)
    before = (fused_color.LAUNCHES_K6, fused_color.LAUNCHES_K7)
    rgb = fused_color.color_fwd(ws, bs, xc, FULL)
    xcbar, dws, dbs = fused_color.color_bwd(ws, bs, xc, ct, FULL)
    assert (fused_color.LAUNCHES_K6, fused_color.LAUNCHES_K7) == before
    assert rgb.shape == (70, 3) and xcbar.shape == (70, 289)
    assert [tuple(w.shape) for w in dws] == [tuple(w.shape) for w in ws]
    assert [tuple(b.shape) for b in dbs] == [tuple(b.shape) for b in bs]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [65536, 1000])
def test_kernels_match_plain_on_cuda(M):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        tn.init_color(np.random.default_rng(0), FULL)), dev), FULL)
    g = torch.Generator(device=dev).manual_seed(7)
    xc = torch.randn((M, 289), generator=g, device=dev)
    ct = torch.randn((M, 3), generator=g, device=dev)
    before = (fused_color.LAUNCHES_K6, fused_color.LAUNCHES_K7)
    rgb = fused_color.color_fwd(ws, bs, xc, FULL)
    got = fused_color.color_bwd(ws, bs, xc, ct, FULL)
    torch.cuda.synchronize()
    assert (fused_color.LAUNCHES_K6, fused_color.LAUNCHES_K7) == (before[0] + 1,
                                                                  before[1] + 1)
    _check_rows(fused_color.color_fwd_plain(ws, bs, xc).cpu(), rgb.cpu())
    ref = fused_color.color_bwd_plain(ws, bs, xc, ct)

    def named(t):
        return {"xc": t[0], **{f"w{l}": w for l, w in enumerate(t[1])},
                **{f"b{l}": b for l, b in enumerate(t[2])}}
    res = fused_sdf.leaf_rule(named(ref), named(got))
    assert res["ok"], res
