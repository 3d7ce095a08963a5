"""K1, the fused gradient-free SDF forward (``fmov_pose_torch/ops/fused_sdf.py``).

On the CPU the port's entries take the plain version, which is held
against the JAX package's Pallas kernel run in interpret mode
(``FMOV_PALLAS_INTERPRET=1``), at a small width and at the full width of
``confs/ho3d_global_womask.conf`` (8x256, multires 6) with M = 300 so the
last tile is ragged.

Tolerance (``fused_sdf.tolerance_check``): the median |error| of the sdf
within 1e-5 and its maximum within 1e-2; the features the same relative to
max|feature| (median 1e-5, maximum 1e-2).  Both sides round every operand
to bf16 and sum in f32, in different orders: most points agree to the
last f32 bit, but where an f32 sum lands next to a bf16 rounding boundary
the two round one bf16 step apart, and that step propagates through the
later layers, so the maximum grows with M.  Measured on this CPU at
M = 300: sdf max 6.7e-5 (small width), 9.2e-4 (full); features max 3.9e-5
and 5.9e-4 x max|feature|; medians 1.2e-7.  At M = 1000 the sdf maximum
reaches 1.9e-3 (and 7e-3 between either side and an f64 network without
bf16), so a bound of 1e-3 on the maximum would fail on rounding flips
alone; the median bound is what catches a layout or rounding fault.

``pack`` lays the weights out for the CUDA kernel (zero padding, the skip
layer's re-mapped rows); ``_emulate_kernel`` runs that layout with the
kernel's algorithm in PyTorch, so the layout is checked here too.  The
kernel itself runs only on the card: its test is marked ``cuda``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_torch import convert
from fmov_pose_torch.core.embedder import positional_encode
from fmov_pose_torch.ops import fused_sdf

SMALL = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4,
         "skip_in": (2,), "multires": 4, "bias": 0.5, "scale": 1.0,
         "geometric_init": True, "weight_norm": True}
FULL = {"d_out": 257, "d_in": 3, "d_hidden": 256, "n_layers": 8,
        "skip_in": (4,), "multires": 6, "bias": 0.5, "scale": 1.0,
        "geometric_init": True, "weight_norm": True}
CFGS = {"small": SMALL, "full": FULL}


@pytest.fixture()
def interp(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    yield
    jax.clear_caches()


def _params(cfg, seed):
    pj = jn.init_sdf(jax.random.key(seed), cfg)
    return pj, convert.to_torch(jax.tree_util.tree_map(np.asarray, pj))


def _points(n, seed):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * 0.5).astype(np.float32)


def _check(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    errs = fused_sdf.tolerance_check(torch.tensor(ref), torch.tensor(got))
    assert errs["ok"], errs


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("want_feature", [False, True])
def test_plain_matches_jax_kernel(interp, width, want_feature):
    """Plain K1 against the JAX kernel in interpret mode."""
    from fmov_pose_tpu.ops import fused_sdf as jf
    cfg = CFGS[width]
    pj, pt = _params(cfg, 0)
    x = _points(300, 1)
    fj = jf.sdf_apply_fused if want_feature else jf.sdf_only_fused
    ft = fused_sdf.sdf_apply_fused if want_feature else fused_sdf.sdf_only_fused
    before = fused_sdf.LAUNCHES
    _check(fj(pj, cfg, jnp.asarray(x)), ft(pt, cfg, torch.from_numpy(x)))
    assert fused_sdf.LAUNCHES == before  # a CPU tensor never launches


def _emulate_kernel(w_buf, b_buf, meta, x, scale):
    """csrc/sdf_fwd.cu's algorithm on the packed buffers, in PyTorch."""
    n_lin, skip, multires = (int(v) for v in meta[:3])
    layers = meta[3:].reshape(n_lin, 5)
    pe_dim = 3 * (1 + 2 * multires)
    pe_pad = (pe_dim + 15) // 16 * 16
    lda = max(pe_pad, int(layers[:, :2].max())) + 8
    M = x.shape[0]
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    xe = torch.zeros(M, pe_pad)
    xe[:, :pe_dim] = positional_encode(x * scale, multires)
    act = [torch.zeros(M, lda), torch.zeros(M, lda)]
    act[0][:, :pe_pad] = bf(xe)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l, (kp, np_, n, w_off, b_off) in enumerate(layers.tolist()):
        inp = act[l & 1]
        if l == skip and l > 0:
            off = int(layers[l - 1, 1])
            inp[:, off:off + pe_pad] = bf(xe * inv_sqrt2)
        W = w_buf[w_off:w_off + kp * np_].view(kp, np_).float()
        z = inp[:, :kp] @ W + b_buf[b_off:b_off + np_]
        if l < n_lin - 1:
            h = fused_sdf.act_pair(z)[0]
            if l + 1 == skip:
                h = h * inv_sqrt2
            act[(l + 1) & 1][:, :np_] = bf(h)
        else:
            out = z[:, :n].clone()
            out[:, 0] = out[:, 0] / scale
            return out


@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("want_feature", [False, True])
def test_packed_layout_matches_plain(width, want_feature):
    cfg = dict(CFGS[width], scale=0.8)
    _, pt = _params(cfg, 2)
    x = torch.from_numpy(_points(130, 3))
    ws, bs = fused_sdf.materialize(pt, cfg)
    w_buf, b_buf, meta = fused_sdf.pack(ws, bs, cfg, want_feature)
    assert w_buf.dtype == torch.bfloat16 and meta.dtype == np.int32
    plain = fused_sdf.sdf_forward_plain(ws, bs, x, cfg, want_feature)
    emu = _emulate_kernel(w_buf, b_buf, meta, x, cfg["scale"])
    assert emu.shape == plain.shape
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), rtol=0, atol=1e-5)


def test_full_width_layout():
    """The paddings the kernel is built around: 39 -> 48 (64 rows with the
    K chunk), 217 -> 224, skip input 224 + 48 -> 288 rows, 257 -> 272."""
    _, pt = _params(FULL, 0)
    ws, bs = fused_sdf.materialize(pt, FULL)
    _, _, meta = fused_sdf.pack(ws, bs, FULL, True)
    layers = meta[3:].reshape(9, 5)
    assert layers[:, 0].tolist() == [64, 256, 256, 256, 288, 256, 256, 256, 256]
    assert layers[:, 1].tolist() == [256, 256, 256, 224, 256, 256, 256, 256, 272]
    assert layers[:, 2].tolist() == [256, 256, 256, 217, 256, 256, 256, 256, 257]


@pytest.mark.parametrize("want_feature", [False, True])
def test_backward_is_the_f32_reference(want_feature):
    """The JAX custom_vjp's backward (``_sdf_only_bwd`` / ``_sdf_apply_bwd``)
    is the vjp of the plain f32 ``nets.sdf_only`` / ``nets.sdf_apply``; the
    port's backward is held against that vjp, so the JAX kernel's forward
    in interpret mode is not needed here."""
    pj, pt = _params(SMALL, 4)
    x = _points(64, 5)
    fj = jn.sdf_apply if want_feature else jn.sdf_only
    ft = fused_sdf.sdf_apply_fused if want_feature else fused_sdf.sdf_only_fused
    w = np.random.default_rng(6).normal(size=(64, 33 if want_feature else 1))
    w = w.astype(np.float32)
    gpj, gxj = jax.jit(jax.grad(lambda p, xx: jnp.sum(fj(p, SMALL, xx) * w),
                                argnums=(0, 1)))(pj, jnp.asarray(x))
    items = convert.flatten(pt)
    leaves = [t.clone().requires_grad_(True) for _, t in items]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ft(convert.unflatten(zip([n for n, _ in items], leaves)), SMALL, xt)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + leaves,
                                allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gxj), rtol=1e-4, atol=1e-5)
    ref = dict(convert.flatten(jax.tree_util.tree_map(np.asarray, gpj)))
    for (name, leaf), g in zip(items, grads[1:]):
        g = torch.zeros_like(leaf) if g is None else g
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-4,
                                   atol=1e-5 * max(np.abs(ref[name]).max(), 1e-30))


def test_supported_and_device_checks():
    assert fused_sdf.supported(FULL)
    assert not fused_sdf.supported(dict(FULL, multires=0))
    assert not fused_sdf.supported(dict(FULL, skip_in=(2, 4)))
    _, pt = _params(SMALL, 0)
    ws, bs = fused_sdf.materialize(pt, SMALL)
    with pytest.raises(ValueError):
        fused_sdf.sdf_forward_cuda(ws, bs, torch.zeros(4, 3), SMALL, False)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [32768, 8192, 1000])
@pytest.mark.parametrize("want_feature", [False, True])
def test_kernel_matches_plain_on_cuda(M, want_feature):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _, pt = _params(FULL, 0)
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(pt), dev), FULL)
    x = torch.from_numpy(_points(M, 7)).to(dev)
    before = fused_sdf.LAUNCHES
    got = fused_sdf.sdf_forward_cuda(ws, bs, x, FULL, want_feature)
    torch.cuda.synchronize()
    assert fused_sdf.LAUNCHES == before + 1
    _check(fused_sdf.sdf_forward_plain(ws, bs, x, FULL, want_feature).cpu(), got.cpu())
