"""K4 and K5, the SDF forward + d(sdf)/dx and its second-order backward
(``fmov_pose_torch/ops/fused_sdf.py``, ``sdf_apply_grad_fused_rays``).

On the CPU the port's entry takes the plain versions, held here against:
* the JAX package's rays kernels in interpret mode
  (``FMOV_PALLAS_INTERPRET=1``), with TILE 32 and the rays gate at 0 as
  ``tests/test_fused_rays_sdf.py`` patches them, but with the kernels' bf16
  products left as they are on both sides; 6 rays x 16 samples at a small
  width (SDF 4x32, skip 2, multires 3, scale 0.8);
* torch.autograd (double backward) of the f32 ``nets`` functions at the
  full width of ``confs/ho3d_global_womask_tpu_fast.conf`` (8x256, skip 4,
  multires 6) with 2 rays x 128 samples.

Tolerances:
* the primal ``out``: ``fused_sdf.tolerance_check`` (K1's rule: the sdf's
  median |error| <= 1e-5 and maximum <= 1e-2, the features the same
  relative to max|feature|); ``grad`` the same relative to max|grad|.
  Two bf16-operand evaluations agree to f32 round-off except where an f32
  sum lands next to a bf16 rounding boundary (see test_torch_fused_sdf.py).
* every gradient leaf of a loss that touches all three outputs, the
  weight-norm (v, g) leaves and x included: ``fused_sdf.leaf_rule``
  (relative error < 1%, or absolute error < 1e-4 x the global gradient
  norm, in L2 norms per leaf, as the JAX package's gate measures them;
  scripts/validate_rays_tpu.py:57-69).  Measured on a CPU: the
  bf16-vs-f32 full-width case's worst leaf is sdf.lin0.v at 0.6-0.8% over
  four seeds.

The CUDA kernels run only on the card: the ``cuda``-marked tests hold them
against the plain versions at the full width, and K5 also bitwise over two
launches and on a narrow table (a skip layer, 128 wide).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_sdf, packing

SMALL = {"d_out": 17, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
         "multires": 3, "bias": 0.5, "scale": 0.8, "geometric_init": True,
         "weight_norm": True}
FULL = {"d_out": 257, "d_in": 3, "d_hidden": 256, "n_layers": 8, "skip_in": (4,),
        "multires": 6, "bias": 0.5, "scale": 1.0, "geometric_init": True,
        "weight_norm": True}


@pytest.fixture()
def jfs(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_sdf as jf
    monkeypatch.setattr(jf, "TILE", 32)
    monkeypatch.setattr(jf, "MIN_SAMPLES_RAYS", 0)
    yield jf
    jax.clear_caches()


def _jax_params(cfg, seed):
    """JAX-initialised weights, moved off the geometric init so that the
    features and every layer carry signal."""
    pj = jn.init_sdf(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    pj = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), pj)
    return pj, convert.to_torch(jax.tree_util.tree_map(np.asarray, pj))


def _inputs(M, d_out, seed):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1, 1, (M, 3)) * 0.7).astype(np.float32)
    w_out = rng.normal(size=(M, d_out)).astype(np.float32)
    w_sdf = rng.normal(size=(M,)).astype(np.float32)
    w_grad = rng.normal(size=(M, 3)).astype(np.float32)
    return x, w_out, w_sdf, w_grad


def _leaves(pt):
    items = convert.flatten(pt)
    return [n for n, _ in items], [t.clone().requires_grad_(True) for _, t in items]


def _check_rows(ref, got):
    """tolerance_check's rule on [M, k] rows, relative to max|ref|."""
    ref = torch.tensor(np.asarray(ref), dtype=torch.float64)
    d = (got.detach().double() - ref).abs()
    scale = float(ref.abs().max())
    assert float(d.median()) <= fused_sdf.SDF_MEDIAN_TOL * scale
    assert float(d.max()) <= fused_sdf.SDF_MAX_TOL * scale


def test_plain_matches_jax_rays_kernels(jfs):
    """Primal triple and every cotangent against the JAX rays kernels."""
    B, N = 6, 16
    M = B * N
    pj, pt = _jax_params(SMALL, 0)
    x, w_out, w_sdf, w_grad = _inputs(M, SMALL["d_out"], 1)

    def loss_j(p, x_pl):
        out, sdf_bn, grad_pl = jfs.sdf_apply_grad_fused_rays(p, SMALL, x_pl, N)
        return (jnp.sum(out * w_out) + jnp.sum(sdf_bn * w_sdf.reshape(B, N))
                + jnp.sum(grad_pl.T * w_grad)), (out, sdf_bn, grad_pl)

    x_pl = jnp.asarray(x.T)
    assert jfs.supported_rays(SMALL, N, M)
    (_, (oj, sj, gj)), (gpj, gxj) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(pj, x_pl)

    names, leaves = _leaves(pt)
    xt = torch.from_numpy(x).requires_grad_(True)
    k4, k5 = fused_sdf.LAUNCHES_K4, fused_sdf.LAUNCHES_K5
    out, sdf_bn, grad = fused_sdf.sdf_apply_grad_fused_rays(
        convert.unflatten(zip(names, leaves)), SMALL, xt, N)
    assert out.shape == (M, SMALL["d_out"]) and sdf_bn.shape == (B, N)
    assert grad.shape == (M, 3)
    errs = fused_sdf.tolerance_check(torch.tensor(np.asarray(oj)), out.detach())
    assert errs["ok"], errs
    np.testing.assert_array_equal(sdf_bn.detach().numpy().reshape(-1),
                                  out[:, 0].detach().numpy())
    _check_rows(np.asarray(sj).reshape(-1, 1), sdf_bn.reshape(-1, 1))
    _check_rows(np.asarray(gj).T, grad)

    loss = ((out * torch.from_numpy(w_out)).sum()
            + (sdf_bn * torch.from_numpy(w_sdf).reshape(B, N)).sum()
            + (grad * torch.from_numpy(w_grad)).sum())
    grads = torch.autograd.grad(loss, [xt] + leaves)
    assert (fused_sdf.LAUNCHES_K4, fused_sdf.LAUNCHES_K5) == (k4, k5)  # CPU: plain
    ref = {"x": torch.tensor(np.asarray(gxj).T)}
    ref.update({n: torch.tensor(v) for n, v in
                convert.flatten(jax.tree_util.tree_map(np.asarray, gpj))})
    got = {"x": grads[0], **dict(zip(names, grads[1:]))}
    res = fused_sdf.leaf_rule(ref, got)
    assert res["ok"], res


def test_plain_matches_double_backward_full_width():
    """The hand derivation at the full width, without JAX: the plain K4 +
    K5 against torch.autograd's double backward of the f32 networks."""
    B, N = 2, 128
    M = B * N
    pt = convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(3), FULL)))
    x, w_out, w_sdf, w_grad = _inputs(M, FULL["d_out"], 4)
    names, leaves = _leaves(pt)
    w_grad = np.abs(w_grad)

    def loss(out, sdf_bn, grad):
        # coherent cotangents, as in the JAX package's own gate (color sum
        # + eikonal + weight sum, scripts/validate_rays_tpu.py:40-42): with
        # independent N(0, 1) cotangents every gradient is a cancelling
        # random sum, and bf16 products against f32 leave ~1.2% per leaf
        return (out[:, 1:].sum() * 1e-2 + sdf_bn.sum() + 0.5 * (grad * grad).sum()
                + (grad * torch.from_numpy(w_grad)).sum())

    xr = torch.from_numpy(x).requires_grad_(True)
    with torch.enable_grad():
        out_r, grad_r = tn.sdf_apply_with_gradient(
            convert.unflatten(zip(names, leaves)), FULL, xr)
        ref = torch.autograd.grad(loss(out_r, out_r[:, 0].reshape(B, N), grad_r),
                                  [xr] + leaves)
    names2, leaves2 = _leaves(pt)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, sdf_bn, grad = fused_sdf.sdf_apply_grad_fused_rays(
        convert.unflatten(zip(names2, leaves2)), FULL, xt, N)
    got = torch.autograd.grad(loss(out, sdf_bn, grad), [xt] + leaves2)
    # bf16 products against f32: the primal within bf16's relative precision
    out, grad, out_r, grad_r = (t.detach() for t in (out, grad, out_r, grad_r))
    assert float((out - out_r).abs().max()) < 2e-2 * float(out_r.abs().max())
    assert float((grad - grad_r).abs().max()) < 2e-2 * float(grad_r.abs().max())
    res = fused_sdf.leaf_rule(dict(zip(["x"] + names, ref)),
                              dict(zip(["x"] + names, got)))
    assert res["ok"], res


def test_rays_gates_and_layout():
    assert fused_sdf.MIN_SAMPLES_RAYS == 65536
    assert fused_sdf.supported_rays(FULL, 128, 65536)
    assert not fused_sdf.supported_rays(FULL, 128, 65535)
    assert fused_sdf.supported_rays(FULL, 128)
    assert not fused_sdf.supported_rays(dict(FULL, skip_in=(8,)), 128)
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(0), FULL))), FULL)
    pk = fused_sdf.RaysPack(ws, bs, FULL)
    t = pk.table
    # padded input widths: PE 39 -> 48, skip input [224 | 48], K to 32
    assert t[:, 7].tolist() == [48, 256, 256, 256, 272, 256, 256, 256, 256]
    assert t[:, 0].tolist() == [64, 256, 256, 256, 288, 256, 256, 256, 256]
    assert t[:, 1].tolist() == [256, 256, 256, 224, 256, 256, 256, 256, 272]
    # each reverse block is the forward block transposed, rows padded to 32
    for kp, np_, _, w_off, _, kr, r_off, _ in t.tolist():
        fwd = pk.w_buf[w_off:w_off + kp * np_].view(kp, np_)
        rev = pk.w_buf[r_off:r_off + kr * kp].view(kr, kp)
        assert torch.equal(rev[:np_], fwd.T) and not rev[np_:].any()
    # unpacking a gradient in the packed layout restores the dense shapes
    dw = torch.arange(packing.dw_elems(pk.meta), dtype=torch.float32)
    dws, dbs = packing.unpack_grads(dw, torch.zeros(int(t[:, 1].sum())), pk.meta,
                                    ws, pk.row_maps)
    assert [d.shape for d in dws] == [w.shape for w in ws]
    assert [d.shape for d in dbs] == [b.shape for b in bs]
    with pytest.raises(ValueError):
        fused_sdf.launch_fwd_grad(pk, torch.zeros(64, 3))  # a CPU tensor


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(512, 128), (3, 100)])
def test_kernels_match_plain_on_cuda(B, N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    M = B * N
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(0), FULL)), dev), FULL)
    x, w_out, w_sdf, w_grad = (torch.from_numpy(a).to(dev)
                               for a in _inputs(M, FULL["d_out"], 5))
    before = (fused_sdf.LAUNCHES_K4, fused_sdf.LAUNCHES_K5)
    out, sdf, grad = fused_sdf.sdf_fwd_grad(ws, bs, x, FULL)
    xb, dws, dbs = fused_sdf.sdf_bwd(ws, bs, x, w_out, w_sdf, w_grad, FULL)
    torch.cuda.synchronize()
    assert (fused_sdf.LAUNCHES_K4, fused_sdf.LAUNCHES_K5) == (before[0] + 1,
                                                              before[1] + 1)
    ro, rg = fused_sdf.sdf_fwd_grad_plain(ws, bs, x, FULL)
    errs = fused_sdf.tolerance_check(ro.cpu(), out.cpu())
    assert errs["ok"], errs
    _check_rows(rg.cpu().numpy(), grad.cpu())
    rx, rdws, rdbs = fused_sdf.sdf_bwd_plain(ws, bs, x, w_out, w_sdf, w_grad, FULL)
    res = fused_sdf.leaf_rule(
        {"x": rx, **{f"w{l}": w for l, w in enumerate(rdws)},
         **{f"b{l}": b for l, b in enumerate(rdbs)}},
        {"x": xb, **{f"w{l}": w for l, w in enumerate(dws)},
         **{f"b{l}": b for l, b in enumerate(dbs)}})
    assert res["ok"], res


NARROW = dict(FULL, d_hidden=128, n_layers=5, skip_in=(3,), multires=4, d_out=65)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,B,N", [pytest.param(FULL, 512, 128, id="full-65536"),
                                     pytest.param(FULL, 3, 100, id="full-300"),
                                     pytest.param(NARROW, 7, 150, id="narrow-1050")])
def test_k5_bitwise_twice_and_plain_on_cuda(cfg, B, N):
    """K5 (its per-point pass, csrc/sdf_bwd_pass.cuh, and the
    weight-gradient stage) gives the same bits on two launches at the fast
    conf's M = 65,536 and a ragged 300, and on a narrow table (a skip
    layer, 128 wide: another pass table and ring depth) as well; each
    against the plain version under the leaf rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    M = B * N
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(1), cfg)), dev), cfg)
    x, w_out, w_sdf, w_grad = (torch.from_numpy(a).to(dev)
                               for a in _inputs(M, cfg["d_out"], 6))
    pk = fused_sdf.RaysPack(ws, bs, cfg)
    first = fused_sdf.launch_bwd(pk, x, w_out, w_sdf, w_grad)
    second = fused_sdf.launch_bwd(pk, x, w_out, w_sdf, w_grad)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    xb, dws, dbs = fused_sdf.sdf_bwd(ws, bs, x, w_out, w_sdf, w_grad, cfg, pk)
    rx, rdws, rdbs = fused_sdf.sdf_bwd_plain(ws, bs, x, w_out, w_sdf, w_grad, cfg)
    res = fused_sdf.leaf_rule(
        {"x": rx, **{f"w{l}": w for l, w in enumerate(rdws)},
         **{f"b{l}": b for l, b in enumerate(rdbs)}},
        {"x": xb, **{f"w{l}": w for l, w in enumerate(dws)},
         **{f"b{l}": b for l, b in enumerate(dbs)}})
    assert res["ok"], res
