"""K8 and K9, the ray-composited color MLP and its backward
(``fmov_pose_torch/ops/fused_color.py``, ``color_fused_ray``).

On the CPU the port's entry takes the plain versions, held here against:
* the JAX package's ray kernels in interpret mode (``FMOV_PALLAS_INTERPRET
  =1``, TILE 32 as ``tests/test_fused_ray.py`` patches it, the bf16
  products left as they are on both sides): 6 rays x 16 samples, color 2x32
  with multires_view 2 on a 33-wide SDF output.  The JAX kernels take the
  geometry as [9, M] channel planes and the first layer in feature-first
  order; the port takes [M, 3] rows in idr order, which changes only the
  order of the f32 sums;
* torch.autograd of the f32 ``nets.color_apply`` and the composite at the
  full width of ``confs/ho3d_global_womask_tpu_fast.conf`` (4x256,
  multires_view 4, 257-wide SDF output), 2 rays x 128 samples.

Tolerances: the color [B, 3] within 1e-5 of max|color| in the median and
1e-2 at the maximum (two bf16-operand evaluations, see
test_torch_fused_sdf.py); the gradients to the parameters (weight norm
included), sdf_out, pts, dirs, normals and weights by
``fused_sdf.leaf_rule`` (relative L2 error < 1% per leaf, or < 1e-4 of the
global L2 norm).  Against f32 the per-sample cotangents (sdf_out, pts,
dirs, normals) are ~9% off in L2, because a ReLU unit whose |z| is below
bf16's precision is on in one evaluation and off in the other; they pass
by the absolute clause at ~2e-6 of the global norm (measured on a CPU,
six seeds), and the parameter leaves, where those errors average out, by
the relative one.  The CUDA kernels run only on the card: the
``cuda``-marked test holds them against the plain versions.
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
NAMES = ("sdf_out", "pts", "dirs", "normals", "weights")


@pytest.fixture()
def jfc(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_color as jc
    monkeypatch.setattr(jc, "TILE", 32)
    yield jc
    jax.clear_caches()


def _inputs(cfg, B, N, seed):
    rng = np.random.default_rng(seed)
    M = B * N
    dirs = rng.normal(size=(M, 3))
    return {
        "sdf_out": rng.normal(size=(M, 1 + cfg["d_feature"])).astype(np.float32),
        "pts": rng.uniform(-1, 1, (M, 3)).astype(np.float32),
        "dirs": (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32),
        "normals": rng.normal(size=(M, 3)).astype(np.float32),
        "weights": (rng.uniform(0, 1, (B, N)) / N).astype(np.float32),
    }, rng.normal(size=(B, 3)).astype(np.float32)


def _torch_grads(pt, cfg, inp, ct):
    """(color, {name: gradient}) of sum(color * ct) through the port."""
    items = convert.flatten(pt)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inp.items()}
    color = fused_color.color_fused_ray(convert.unflatten(
        zip([n for n, _ in items], leaves)), cfg, *(ts[k] for k in NAMES))
    grads = torch.autograd.grad((color * torch.from_numpy(ct)).sum(),
                                [ts[k] for k in NAMES] + leaves)
    return color.detach(), dict(zip(list(NAMES) + [n for n, _ in items], grads))


def _check_color(ref, got):
    ref = torch.as_tensor(np.array(ref), dtype=torch.float64)
    d = (got.double() - ref).abs()
    scale = float(ref.abs().max())
    assert float(d.median()) <= 1e-5 * scale and float(d.max()) <= 1e-2 * scale


def test_plain_matches_jax_ray_kernels(jfc):
    B, N = 6, 16
    pj = jn.init_color(jax.random.key(0), SMALL)
    pt = convert.to_torch(jax.tree_util.tree_map(np.asarray, pj))
    inp, ct = _inputs(SMALL, B, N, 1)
    u = jnp.asarray(np.concatenate([inp["pts"], inp["dirs"], inp["normals"]], -1).T)
    assert jfc.supported_ray(SMALL, N)

    def loss_j(p, sdf_out, u, weights):
        color = jfc.color_fused_ray(p, SMALL, sdf_out, u, weights)
        return jnp.sum(color * ct), color

    (_, cj), gj = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True)(
        pj, jnp.asarray(inp["sdf_out"]), u, jnp.asarray(inp["weights"]))
    k8, k9 = fused_color.LAUNCHES_K8, fused_color.LAUNCHES_K9
    color, got = _torch_grads(pt, SMALL, inp, ct)
    assert (fused_color.LAUNCHES_K8, fused_color.LAUNCHES_K9) == (k8, k9)
    assert color.shape == (B, 3)
    _check_color(cj, color)
    gu = np.asarray(gj[2]).T
    ref = {"sdf_out": np.asarray(gj[1]), "pts": gu[:, 0:3], "dirs": gu[:, 3:6],
           "normals": gu[:, 6:9], "weights": np.asarray(gj[3])}
    ref.update(convert.flatten(jax.tree_util.tree_map(np.asarray, gj[0])))
    assert not got["sdf_out"][:, 0].any()  # column 0 (the sdf) gets zero
    res = fused_sdf.leaf_rule({k: torch.tensor(np.array(v)) for k, v in ref.items()},
                              got)
    assert res["ok"], res


def test_plain_matches_autograd_full_width():
    """The hand derivation at the full width, without JAX: plain K8 + K9
    against torch.autograd of the f32 color network and composite."""
    B, N = 2, 128
    pt = convert.to_torch(convert.to_numpy(
        tn.init_color(np.random.default_rng(2), FULL)))
    inp, _ = _inputs(FULL, B, N, 3)
    # a coherent cotangent, the JAX package's gate's color.sum()
    # (scripts/validate_rays_tpu.py:40): with a random one per ray, the
    # per-sample cotangents are cancelling sums, and ReLU units with
    # |z| below bf16's precision switch between the two evaluations
    ct = np.ones((B, 3), np.float32)
    color, got = _torch_grads(pt, FULL, inp, ct)

    items = convert.flatten(pt)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inp.items()}
    c = tn.color_apply(convert.unflatten(zip([n for n, _ in items], leaves)), FULL,
                       ts["pts"], ts["normals"], ts["dirs"], ts["sdf_out"][:, 1:])
    ref_color = (c.reshape(B, N, 3) * ts["weights"][:, :, None]).sum(1)
    ref = torch.autograd.grad((ref_color * torch.from_numpy(ct)).sum(),
                              [ts[k] for k in NAMES] + leaves)
    ref_color = ref_color.detach()
    assert float((color - ref_color).abs().max()) < 1e-2 * float(ref_color.abs().max())
    res = fused_sdf.leaf_rule(dict(zip(list(NAMES) + [n for n, _ in items], ref)), got)
    assert res["ok"], res


def test_gates_and_checks():
    assert fused_color.MIN_SAMPLES == 65536
    assert fused_color.supported_ray(FULL, 128)
    assert not fused_color.supported(dict(FULL, mode="no_view_dir"))
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        tn.init_color(np.random.default_rng(0), FULL))), FULL)
    pk = fused_color.RayPack(ws, bs, FULL)
    # the 289-wide input pads to 304 (320 rows), the 3-wide output to 16
    assert pk.table[:, 7].tolist() == [304, 256, 256, 256, 256]
    assert pk.table[:, 1].tolist() == [256, 256, 256, 256, 16]
    inp, _ = _inputs(FULL, 1, 64, 0)
    with pytest.raises(ValueError):  # CPU tensors never reach the kernel
        fused_color.launch_fwd(pk, *(torch.from_numpy(inp[k]) for k in NAMES))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(512, 128), (3, 100)])
def test_kernels_match_plain_on_cuda(B, N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        tn.init_color(np.random.default_rng(0), FULL)), dev), FULL)
    inp, ct = _inputs(FULL, B, N, 4)
    args = [torch.from_numpy(inp[k]).to(dev) for k in NAMES]
    ct = torch.from_numpy(ct).to(dev)
    before = (fused_color.LAUNCHES_K8, fused_color.LAUNCHES_K9)
    color = fused_color.color_ray_fwd(ws, bs, *args, FULL)
    got = fused_color.color_ray_bwd(ws, bs, *args, ct, FULL)
    torch.cuda.synchronize()
    assert (fused_color.LAUNCHES_K8, fused_color.LAUNCHES_K9) == (before[0] + 1,
                                                                  before[1] + 1)
    _check_color(fused_color.color_ray_fwd_plain(ws, bs, *args, FULL).cpu(), color.cpu())
    ref = fused_color.color_ray_bwd_plain(ws, bs, *args, ct, FULL)

    def named(g):
        return {**dict(zip(NAMES, g[:5])), **{f"w{l}": w for l, w in enumerate(g[5])},
                **{f"b{l}": b for l, b in enumerate(g[6])}}
    res = fused_sdf.leaf_rule(named(ref), named(got))
    assert res["ok"], res
