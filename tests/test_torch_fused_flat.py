"""K2 and K3, the flat SDF forward + d_inputs and its second-order
backward (``fmov_pose_torch/ops/fused_sdf.py``: ``sdf_fwd_grad_flat_plain``,
``sdf_bwd_flat_plain`` and the entry ``sdf_apply_grad_fused``).

On the CPU the port's entry takes the plain versions, held here against
the JAX package's flat kernels in interpret mode (``FMOV_PALLAS_INTERPRET=1``,
TILE 32, the kernels' bf16 products as they are on both sides): the JAX
``_sdf_forward_grad_impl`` / ``_sdf_bwd_impl`` one to one (the same
encoding, ybar and gbar in), and the JAX entry ``sdf_apply_grad_fused``
(the custom_vjp with the encoding's derivatives around the kernels), at a
small width (SDF 4x32, skip 2, multires 3, scale 0.8, 45 points: one full
tile and a ragged one) and at the full width of
``confs/ho3d_virtual_tpu_fast.conf`` (8x256, skip 4, multires 6, 40
points).  The entry's full-width case has no weight norm: the two
packages' weight-norm materialisations differ by f32 round-off (~6e-8),
which moves single weights across bf16 rounding boundaries and every
row with them; the small case carries the weight-norm VJP.

Tolerances:
* rows (out, d_inputs, grad, xebar): ``fused_sdf.tolerance_check``'s rule
  (median |error| <= 1e-5 and maximum <= 1e-2, relative to max|ref| for
  all but the sdf column).  Two bf16-operand evaluations agree to f32
  round-off except where an f32 sum lands next to a bf16 rounding
  boundary (see test_torch_fused_sdf.py).
* every gradient leaf (the weight-norm (v, g) leaves, the biases and x):
  ``fused_sdf.leaf_rule`` (relative L2 error < 1%, or absolute < 1e-4 x
  the global gradient norm), the gate the JAX kernels met.

The CUDA kernels run only on the card: the ``cuda``-marked tests hold them
against the plain versions at the full width, and K2 and K3 also bitwise
over two launches and on narrower tables (K3: a skip layer, 128 wide; K2:
the full, small and narrow widths at M = 32,768, 300 and 1,000).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_sdf

SMALL = {"d_out": 17, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
         "multires": 3, "bias": 0.5, "scale": 0.8, "geometric_init": True,
         "weight_norm": True}
FULL = {"d_out": 257, "d_in": 3, "d_hidden": 256, "n_layers": 8, "skip_in": (4,),
        "multires": 6, "bias": 0.5, "scale": 1.0, "geometric_init": True,
        "weight_norm": True}
WIDTHS = [pytest.param((SMALL, 45), id="small"), pytest.param((FULL, 40), id="full")]
ENTRY_WIDTHS = [pytest.param((SMALL, 45), id="small"),
                pytest.param((dict(FULL, weight_norm=False), 40), id="full")]


@pytest.fixture()
def jfs(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_sdf as jf
    monkeypatch.setattr(jf, "TILE", 32)
    yield jf
    jax.clear_caches()


def _params(cfg, seed):
    """JAX-initialised weights, moved off the geometric init so that every
    layer carries signal; (JAX tree, port tree)."""
    pj = jn.init_sdf(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    pj = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), pj)
    return pj, convert.to_torch(jax.tree_util.tree_map(np.asarray, pj))


def _rows_ok(ref, got, what):
    """tolerance_check's rule on [M, k] rows, relative to max|ref|."""
    ref = torch.as_tensor(np.array(ref), dtype=torch.float64)
    d = (got.detach().double() - ref).abs()
    scale = float(ref.abs().max())
    assert float(d.median()) <= fused_sdf.SDF_MEDIAN_TOL * scale, what
    assert float(d.max()) <= fused_sdf.SDF_MAX_TOL * scale, what


def _inputs(M, cfg, seed):
    rng = np.random.default_rng(seed)
    pe = 3 * (1 + 2 * cfg["multires"])
    return ((rng.uniform(-1, 1, (M, 3)) * 0.7).astype(np.float32),
            rng.normal(size=(M, cfg["d_out"])).astype(np.float32),
            rng.normal(size=(M, pe)).astype(np.float32),
            rng.normal(size=(M, 3)).astype(np.float32))


@pytest.mark.parametrize("width", WIDTHS)
def test_plain_matches_jax_flat_kernels(jfs, width):
    """sdf_fwd_grad_flat_plain and sdf_bwd_flat_plain against the JAX
    kernels' dispatchers on the same encoding, ybar and gbar."""
    cfg, M = width
    pj, pt = _params(cfg, 0)
    x, ybar, gbar, _ = _inputs(M, cfg, 1)
    key = jfs._cfg_key(cfg)
    ws_j, bs_j = jfs._materialize(pj, cfg)
    out_j, grad_j, din_j = jfs._sdf_forward_grad_impl(ws_j, bs_j, jnp.asarray(x), key)
    dws_j, dbs_j, xebar_j = jfs._sdf_bwd_impl(ws_j, bs_j, jnp.asarray(x),
                                              jnp.asarray(ybar), jnp.asarray(gbar), key)

    ws, bs = fused_sdf.materialize(pt, cfg)
    xe, jac, _, _ = fused_sdf.pe_parts(torch.from_numpy(x) * cfg["scale"],
                                       cfg["multires"])
    out, d_inputs = fused_sdf.sdf_fwd_grad_flat_plain(ws, bs, xe, cfg)
    errs = fused_sdf.tolerance_check(torch.tensor(np.asarray(out_j)), out)
    assert errs["ok"], errs
    _rows_ok(din_j, d_inputs, "d_inputs")
    _rows_ok(grad_j, fused_sdf.dim_sum(d_inputs * jac), "grad")

    xebar, dws, dbs = fused_sdf.sdf_bwd_flat_plain(
        ws, bs, xe, torch.from_numpy(ybar), torch.from_numpy(gbar), cfg)
    ref = {"xebar": torch.tensor(np.asarray(xebar_j)),
           **{f"w{l}": torch.tensor(np.asarray(w)) for l, w in enumerate(dws_j)},
           **{f"b{l}": torch.tensor(np.asarray(b)) for l, b in enumerate(dbs_j)}}
    got = {"xebar": xebar, **{f"w{l}": w for l, w in enumerate(dws)},
           **{f"b{l}": b for l, b in enumerate(dbs)}}
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res


@pytest.mark.parametrize("width", ENTRY_WIDTHS)
def test_entry_matches_jax(jfs, width):
    """sdf_apply_grad_fused: (out, grad) and every VJP leaf, x included,
    against the JAX entry of the same name; no kernel launch on the CPU."""
    cfg, M = width
    pj, pt = _params(cfg, 2)
    x, w_out, _, w_grad = _inputs(M, cfg, 3)

    def loss_j(p, xx):
        out, grad = jfs.sdf_apply_grad_fused(p, cfg, xx)
        return jnp.sum(out * w_out) + jnp.sum(grad * w_grad), (out, grad)

    (_, (oj, gj)), (gpj, gxj) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(pj, jnp.asarray(x))

    items = convert.flatten(pt)
    names = [n for n, _ in items]
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    xt = torch.from_numpy(x).requires_grad_(True)
    launches = (fused_sdf.LAUNCHES_K2, fused_sdf.LAUNCHES_K3)
    out, grad = fused_sdf.sdf_apply_grad_fused(convert.unflatten(zip(names, leaves)),
                                               cfg, xt)
    loss = (out * torch.from_numpy(w_out)).sum() + (grad * torch.from_numpy(w_grad)).sum()
    grads = torch.autograd.grad(loss, [xt] + leaves)
    assert (fused_sdf.LAUNCHES_K2, fused_sdf.LAUNCHES_K3) == launches  # CPU: plain
    assert out.shape == (M, cfg["d_out"]) and grad.shape == (M, 3)
    errs = fused_sdf.tolerance_check(torch.tensor(np.asarray(oj)), out.detach())
    assert errs["ok"], errs
    _rows_ok(gj, grad, "grad")
    ref = {"x": torch.tensor(np.asarray(gxj))}
    ref.update({n: torch.tensor(np.asarray(v)) for n, v in
                convert.flatten(jax.tree_util.tree_map(np.asarray, gpj))})
    got = {"x": grads[0], **dict(zip(names, grads[1:]))}
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res


def test_entry_matches_double_backward():
    """The flat entry's hand derivation, without JAX, against
    torch.autograd's double backward of the f32 networks at the full
    width, 256 points (bf16 products: the primal within 2e-2 of max|ref|,
    every leaf by the leaf rule, with the coherent cotangents of the JAX
    gate, scripts/validate_rays_tpu.py:40-42).  At the small width the bf16
    contract alone moves x's gradient by ~1.7%."""
    cfg = FULL
    pt = convert.to_torch(convert.to_numpy(tn.init_sdf(np.random.default_rng(3), cfg)))
    x, _, _, w_grad = _inputs(256, cfg, 4)
    w_grad = np.abs(w_grad)

    def loss(out, grad):
        return (out[:, 1:].sum() * 1e-2 + out[:, 0].sum() + 0.5 * (grad * grad).sum()
                + (grad * torch.from_numpy(w_grad)).sum())

    res = []
    for fused in (False, True):
        items = convert.flatten(pt)
        leaves = [t.clone().requires_grad_(True) for _, t in items]
        params = convert.unflatten(zip([n for n, _ in items], leaves))
        xt = torch.from_numpy(x).requires_grad_(True)
        with torch.enable_grad():
            out, grad = (fused_sdf.sdf_apply_grad_fused(params, cfg, xt) if fused
                         else tn.sdf_apply_with_gradient(params, cfg, xt))
            gs = torch.autograd.grad(loss(out, grad), [xt] + leaves)
        res.append((out.detach(), grad.detach(),
                    dict(zip(["x"] + [n for n, _ in items], gs))))
    (o_r, g_r, ref), (o, g, got) = res
    assert float((o - o_r).abs().max()) < 2e-2 * float(o_r.abs().max())
    assert float((g - g_r).abs().max()) < 2e-2 * float(g_r.abs().max())
    r = fused_sdf.leaf_rule(ref, got)
    assert r["ok"], r


def test_flat_launchers_reject_cpu_tensors():
    """On a CPU tensor the wrapper takes the plain version; the launchers
    themselves take only CUDA tensors."""
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(0), FULL))), FULL)
    pk = fused_sdf.RaysPack(ws, bs, FULL)
    xe = torch.zeros(64, 39)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sdf.launch_fwd_grad_flat(pk, xe)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sdf.launch_bwd_flat(pk, xe, torch.zeros(64, 257), xe)
    out, d_inputs = fused_sdf.sdf_fwd_grad_flat(ws, bs, xe, FULL)
    assert out.shape == (64, 257) and d_inputs.shape == (64, 39)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [32768, 1000])
def test_kernels_match_plain_on_cuda(M):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(0), FULL)), dev), FULL)
    x, ybar, gbar, _ = (torch.from_numpy(a).to(dev) for a in _inputs(M, FULL, 5))
    xe, _, _, _ = fused_sdf.pe_parts(x, FULL["multires"])
    before = (fused_sdf.LAUNCHES_K2, fused_sdf.LAUNCHES_K3)
    out, d_inputs = fused_sdf.sdf_fwd_grad_flat(ws, bs, xe, FULL)
    xebar, dws, dbs = fused_sdf.sdf_bwd_flat(ws, bs, xe, ybar, gbar, FULL)
    torch.cuda.synchronize()
    assert (fused_sdf.LAUNCHES_K2, fused_sdf.LAUNCHES_K3) == (before[0] + 1,
                                                              before[1] + 1)
    ro, rd = fused_sdf.sdf_fwd_grad_flat_plain(ws, bs, xe, FULL)
    errs = fused_sdf.tolerance_check(ro.cpu(), out.cpu())
    assert errs["ok"], errs
    _rows_ok(rd.cpu().numpy(), d_inputs.cpu(), "d_inputs")
    rx, rdws, rdbs = fused_sdf.sdf_bwd_flat_plain(ws, bs, xe, ybar, gbar, FULL)
    res = fused_sdf.leaf_rule(
        {"xebar": rx, **{f"w{l}": w for l, w in enumerate(rdws)},
         **{f"b{l}": b for l, b in enumerate(rdbs)}},
        {"xebar": xebar, **{f"w{l}": w for l, w in enumerate(dws)},
         **{f"b{l}": b for l, b in enumerate(dbs)}})
    assert res["ok"], res


NARROW = dict(FULL, d_hidden=128, n_layers=5, skip_in=(3,), multires=4, d_out=65)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,M", [pytest.param(FULL, 32768, id="full-32768"),
                                   pytest.param(FULL, 1000, id="full-1000"),
                                   pytest.param(NARROW, 1050, id="narrow-1050")])
def test_k3_bitwise_twice_and_plain_on_cuda(cfg, M):
    """K3 (its per-point pass, csrc/sdf_bwd_pass.cuh, and the
    weight-gradient stage) gives the same bits on two launches at the
    phase-1 step's M = 32,768 and a ragged 1,000, and on a narrow table (a
    skip layer, 128 wide) as well; each against the plain version under
    the leaf rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(1), cfg)), dev), cfg)
    x, ybar, gbar, _ = (torch.from_numpy(a).to(dev) for a in _inputs(M, cfg, 6))
    xe, _, _, _ = fused_sdf.pe_parts(x, cfg["multires"])
    pk = fused_sdf.RaysPack(ws, bs, cfg)
    first = fused_sdf.launch_bwd_flat(pk, xe, ybar, gbar)
    second = fused_sdf.launch_bwd_flat(pk, xe, ybar, gbar)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    xebar, dws, dbs = fused_sdf.sdf_bwd_flat(ws, bs, xe, ybar, gbar, cfg, pk)
    rx, rdws, rdbs = fused_sdf.sdf_bwd_flat_plain(ws, bs, xe, ybar, gbar, cfg)
    res = fused_sdf.leaf_rule(
        {"xebar": rx, **{f"w{l}": w for l, w in enumerate(rdws)},
         **{f"b{l}": b for l, b in enumerate(rdbs)}},
        {"xebar": xebar, **{f"w{l}": w for l, w in enumerate(dws)},
         **{f"b{l}": b for l, b in enumerate(dbs)}})
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,M", [pytest.param(c, M, id=f"{name}-{M}")
                                   for name, c in (("full", FULL), ("small", SMALL),
                                                   ("narrow", NARROW))
                                   for M in (32768, 300, 1000)])
def test_k2_bitwise_twice_and_plain_on_cuda(cfg, M):
    """K2 (its per-point pass, csrc/sdf_fwd_grad_pass.cuh: two tiles a block,
    A in registers) gives the same bits on two launches at the phase-1
    step's M = 32,768 and the ragged 300 (one pair, its second tile empty)
    and 1,000, at the full, small and narrow widths; each against the plain
    version by the row rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(2), cfg)), dev), cfg)
    x = torch.from_numpy(_inputs(M, cfg, 7)[0]).to(dev)
    xe, _, _, _ = fused_sdf.pe_parts(x * cfg["scale"], cfg["multires"])
    pk = fused_sdf.RaysPack(ws, bs, cfg)
    first = fused_sdf.launch_fwd_grad_flat(pk, xe)
    second = fused_sdf.launch_fwd_grad_flat(pk, xe)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    ro, rd = fused_sdf.sdf_fwd_grad_flat_plain(ws, bs, xe, cfg)
    errs = fused_sdf.tolerance_check(ro.cpu(), first[0].cpu())
    assert errs["ok"], errs
    _rows_ok(rd.cpu().numpy(), first[1].cpu(), "d_inputs")
