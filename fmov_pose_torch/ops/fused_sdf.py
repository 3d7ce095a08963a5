"""Fused SDF kernels: K1 (gradient-free forward), K4 and K2 (forward +
d(sdf)/dx, rays and flat) and K5 and K3 (their second-order backward), with
their plain versions and entries.

K2-K5 are described below ``sdf_apply_fused`` (the training step's SDF);
this header describes K1.

K1 replaces the Pallas kernel ``fmov_pose_tpu/ops/fused_sdf.py:_make_fwd_kernel``
(launched by ``_sdf_forward_impl``; entries ``sdf_only_fused`` and
``sdf_apply_fused``).  The kernel is ``csrc/sdf_fwd.cu``: per point, the
positional encoding, the 9-linear SDF MLP with softplus(beta=100) and the
skip concat /sqrt(2), and sdf/scale (plus the 256 features when asked).
Its arithmetic is the TPU kernel's: f32 inputs, biases and outputs, and
every product of bf16-rounded operands accumulated in f32.

What bounds it on an H100: about 0.92 MFLOP of products per point for the
sdf alone against 12 bytes in and 4 out.  The training step's up-sampler
queries 57,344 points (32,768 + 3 x 8,192) per step, ~53 GFLOP, so the
products bound it, never the bytes.  It runs on the per-point pipeline of
K6-K9 (``csrc/sdf_pipe.cuh`` on ``csrc/pipe.cuh``): one block per SM loops
over 64-point tiles, the weights (1 MB in bf16, too big for shared memory) stream
through a cp.async ring across layers and tiles, the products run on
mma.sync with their epilogues in registers, and a tile's activations stay
in shared memory.  See the source's header.

Beside it:

* ``FwdPack`` — K1's weights for one set of parameters, built once: the
  dense f32 weights (the weight norm materialised; the plain version's)
  and, on CUDA, ``pack_forward``'s blocks and layer table (those of
  ``packing.pack_train`` without the reverse blocks), the last layer cut
  to its column 0 for the sdf alone.  The up-sampler builds one per
  render and queries it four times.
* ``launch`` — one kernel launch on a pack; the only place that counts
  ``LAUNCHES`` (kernel launches so far) and K1's entries of
  ``LAUNCH_SIZES`` (launches by kernel and M, which every kernel's launch
  function counts), inside the profiler range ``PROFILE_K1``.
* ``sdf_forward`` — K1 on a pack: a CUDA tensor launches the kernel (or
  raises); a CPU tensor takes the plain version on the pack's weights, the
  port's counterpart of the JAX package's interpret mode.
* ``sdf_forward_plain`` — the same arithmetic in PyTorch (operands rounded
  with ``.bfloat16().float()`` and multiplied in f32: a bf16 ``matmul``
  would also round its output).  The CPU tests hold it against the JAX
  kernel in interpret mode; ``chip_smoke.py`` holds the kernel against it.
* ``sdf_only_fused`` / ``sdf_apply_fused`` — the JAX entries' counterparts:
  a pack of the given parameters, then ``sdf_forward``.  Their backward
  differentiates the plain f32 ``nets`` functions, as the JAX custom_vjp
  does; the TPU kernel has no backward kernel, so neither has this one.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from fmov_pose_torch import convert
from fmov_pose_torch.core.embedder import positional_encode
from fmov_pose_torch.fields import nets
from fmov_pose_torch.ops import packing, wgrad
from fmov_pose_torch.ops.packing import round_up

LAUNCHES = 0
# launches by (kernel, rows M), counted beside each LAUNCHES* counter
LAUNCH_SIZES = collections.Counter()
# the profiler range around K1's launches (``profile_step.py`` reads it)
PROFILE_K1 = "fmov::K1_sdf_fwd"

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _skip(cfg) -> int:
    return tuple(cfg.get("skip_in", (4,)))[0]


def supported(cfg) -> bool:
    """The configurations the kernel takes (``ops/fused_sdf.py:supported``
    of the JAX package without its backend test: here the tensor's device
    picks kernel or plain version).  The skip layer must have a layer
    before it (its input is laid out as [h | xe]); it may be the last."""
    skips = tuple(cfg.get("skip_in", (4,)))
    return (cfg.get("d_in", 3) == 3 and cfg.get("multires", 0) > 0
            and len(skips) == 1 and 0 < skips[0] <= cfg["n_layers"])


def materialize(params, cfg):
    """Weight-norm -> dense W^T [in, out] and biases [out], all f32."""
    n_lin = cfg["n_layers"] + 1
    ws = [nets.materialize(params["layers"][f"lin{l}"]).T for l in range(n_lin)]
    bs = [params["layers"][f"lin{l}"]["b"] for l in range(n_lin)]
    return ws, bs


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def sdf_forward_plain(ws, bs, x, cfg, want_feature: bool) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: [M, 3] -> [M, d_out] or [M, 1]."""
    scale = cfg.get("scale", 1.0)
    skip = _skip(cfg)
    n_lin = len(ws)
    xe = positional_encode(x * scale, cfg["multires"])
    h = xe
    for l in range(n_lin):
        if l == skip:
            h = torch.cat([h, xe], dim=-1) * _INV_SQRT2
        z = _bf16(h) @ _bf16(ws[l]) + bs[l]
        h = act_pair(z)[0] if l < n_lin - 1 else z
    out = torch.cat([h[:, :1] / scale, h[:, 1:]], dim=-1)
    return out if want_feature else out[:, :1]


# Agreement of two bf16-operand evaluations (kernel, plain version, JAX
# kernel): most points agree to the last f32 bit, but an f32 sum that lands
# next to a bf16 rounding boundary rounds one bf16 step apart on the two
# sides, and the step propagates through the later layers.  The maximum
# grows with M: kernel against plain version at the full width on an H100,
# sdf 2.3e-3 at M = 1,000 and 4.1e-3 at M = 32,768, medians 6e-7.  So the
# median is held tight (a layout or rounding fault moves it by orders of
# magnitude) and the maximum only bounds gross faults such as a bad edge.
SDF_MEDIAN_TOL, SDF_MAX_TOL = 1e-5, 1e-2
FEAT_MEDIAN_TOL, FEAT_MAX_TOL = 1e-5, 1e-2   # relative to max|feature|


def tolerance_check(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """Errors of ``got`` against ``ref`` ([M, 1] or [M, d_out]) and whether
    they are within the tolerances above."""
    d = (got.double() - ref.double()).abs()
    res = {"sdf_max": float(d[:, 0].max()), "sdf_median": float(d[:, 0].median())}
    ok = (res["sdf_max"] <= SDF_MAX_TOL and res["sdf_median"] <= SDF_MEDIAN_TOL
          and bool(torch.isfinite(got).all()))
    if ref.shape[1] > 1:
        scale = float(ref[:, 1:].abs().max())
        res["feat_max_rel"] = float(d[:, 1:].max()) / scale
        res["feat_median_rel"] = float(d[:, 1:].median()) / scale
        ok = (ok and res["feat_max_rel"] <= FEAT_MAX_TOL
              and res["feat_median_rel"] <= FEAT_MEDIAN_TOL)
    res["ok"] = ok
    return res


LEAF_REL_TOL, LEAF_ABS_TOL = 1e-2, 1e-4


def leaf_rule(ref: dict, got: dict) -> dict:
    """Gradient agreement per leaf, the gate the JAX kernels met
    (``scripts/validate_rays_tpu.py:57-69``): a leaf
    passes if |got - ref| / |ref| < 1%, or |got - ref| < 1e-4 x the global
    norm of ``ref``, all L2 norms.  Returns the worst leaf's errors and
    ``ok``."""
    gnorm = math.sqrt(sum(float((r.double() ** 2).sum()) for r in ref.values()))
    res = {"ok": True, "gnorm": gnorm, "worst": None, "worst_rel": 0.0,
           "worst_abs_over_gnorm": 0.0, "failed": []}
    for name, r in ref.items():
        err = float(torch.linalg.vector_norm(got[name].double() - r.double()))
        rel = err / max(float(torch.linalg.vector_norm(r.double())), 1e-30)
        if not (math.isfinite(err) and (rel < LEAF_REL_TOL or err < LEAF_ABS_TOL * gnorm)):
            res["ok"] = False
            res["failed"].append(name)
        if rel > res["worst_rel"]:
            res.update(worst=name, worst_rel=rel,
                       worst_abs_over_gnorm=err / max(gnorm, 1e-30))
    return res


class FwdPack:
    """K1's weights for one set of SDF parameters, built once and launched
    on many times: the dense f32 weights and biases (``ws``, ``bs``; the
    plain version's) and, on CUDA, the forward-only packed blocks, biases
    and layer table (``w_buf``, ``b_buf``, ``meta``).  ``want_feature``
    False packs only column 0 of the last layer (N = 1, padded to 16)."""

    def __init__(self, params, cfg, want_feature: bool):
        if not supported(cfg):
            raise ValueError(f"SDF config not supported by the kernel: {cfg}")
        self.cfg, self.want_feature = cfg, want_feature
        self.ws, self.bs = materialize(params, cfg)
        self.device = self.ws[0].device
        self.n_lin = len(self.ws)
        self.skip = _skip(cfg)
        self.multires = cfg["multires"]
        self.scale = float(cfg.get("scale", 1.0))
        if self.device.type == "cuda":
            self.w_buf, self.b_buf, self.meta = pack_forward(
                self.ws, self.bs, cfg, want_feature)
            self.n_out = int(packing.layer_table(self.meta)[-1, 2])


def pack_forward(ws, bs, cfg, want_feature: bool):
    """K1's packed weights of dense ``ws``/``bs``: the forward-only blocks,
    biases and layer table of ``packing.pack_train`` (``reverse=False``);
    without the feature, only column 0 of the last layer."""
    ws, bs = list(ws), list(bs)
    if not want_feature:
        ws[-1], bs[-1] = ws[-1][:, :1], bs[-1][:1]
    in_ws, row_maps = _input_layout(ws, cfg)
    return packing.pack_train(ws, bs, in_ws, row_maps, reverse=False)


def launch(pk: FwdPack, x: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA pack and a CUDA float32 [M, 3] ``x`` -> [M, 1] or
    [M, d_out]; the only place that counts LAUNCHES."""
    global LAUNCHES
    M = x.shape[0]
    _check_cuda_rows("x", x, 3, M, x.device)
    if pk.device != x.device:
        raise ValueError(f"K1's pack is on {pk.device}, the points on {x.device}")
    M_pad = round_up(max(M, 1), packing.TILE_M)
    out = torch.empty((M, pk.n_out), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device), torch.profiler.record_function(PROFILE_K1):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fmov_sdf_fwd(
            x.data_ptr(), M, M_pad, pk.scale, pk.w_buf.data_ptr(), pk.b_buf.data_ptr(),
            pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin, pk.skip, pk.multires,
            _grid(x.device, M_pad // packing.TILE_M), out.data_ptr(), pk.n_out, stream)
    _raise_on(lib, err, "sdf_fwd", M)
    LAUNCHES += 1
    LAUNCH_SIZES["K1", M] += 1
    return out


def sdf_forward(pk: FwdPack, x: torch.Tensor) -> torch.Tensor:
    """K1 on the pack for a CUDA tensor, the plain version on the pack's
    weights for a CPU tensor."""
    if x.is_cuda:
        return launch(pk, x.contiguous())
    return sdf_forward_plain(pk.ws, pk.bs, x, pk.cfg, pk.want_feature)


def _cfg_key(cfg):
    keys = ("d_out", "d_in", "d_hidden", "n_layers", "multires", "scale")
    items = [(k, cfg[k]) for k in keys if k in cfg]
    items.append(("skip_in", tuple(cfg.get("skip_in", (4,)))))
    return tuple(items)


class _SdfForward(torch.autograd.Function):
    """Kernel (or plain) primal; backward = autograd of the f32 nets
    function, like the JAX custom_vjp (``_sdf_only_bwd``/``_sdf_apply_bwd``)."""

    @staticmethod
    def forward(ctx, cfg_key, want_feature, names, x, *leaves):
        cfg = dict(cfg_key)
        ctx.cfg, ctx.names, ctx.want_feature = cfg, names, want_feature
        ctx.save_for_backward(x, *leaves)
        return sdf_forward(FwdPack(convert.unflatten(zip(names, leaves)), cfg,
                                   want_feature), x)

    @staticmethod
    def backward(ctx, ct):
        x, *leaves = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            leaves_ = [t.detach().requires_grad_(True) for t in leaves]
            out = nets.sdf_apply(convert.unflatten(zip(ctx.names, leaves_)),
                                 ctx.cfg, x_)
            if not ctx.want_feature:
                out = out[:, :1]
            grads = torch.autograd.grad(out, [x_] + leaves_, ct,
                                        allow_unused=True)
        return (None, None, None, *grads)


def _apply(params, cfg, x, want_feature):
    items = convert.flatten(params)
    names = tuple(n for n, _ in items)
    return _SdfForward.apply(_cfg_key(cfg), want_feature, names, x,
                             *[t for _, t in items])


def sdf_only_fused(params, cfg, x):
    """[M, 3] -> sdf [M, 1]."""
    return _apply(params, cfg, x, False)


def sdf_apply_fused(params, cfg, x):
    """[M, 3] -> [sdf, feature] [M, d_out]."""
    return _apply(params, cfg, x, True)


# ---------------------------------------------------------------------------
# K4 and K5: the rays path of the training step; K2 and K3: its flat path
# ---------------------------------------------------------------------------
#
# K4 (``csrc/sdf_fwd_grad.cu``) replaces ``_make_fwd_grad_rays_kernel``
# (launched by ``_sdf_fwd_grad_rays_impl``): per point the PE, the SDF
# forward, and the reverse chain of d(sdf)/dx through the MLP and the PE
# Jacobian.  K5 (``csrc/sdf_bwd.cu``) replaces ``_make_bwd_rays_kernel``
# (``_sdf_bwd_rays_impl``): the VJP of (out, sdf_bn, grad), recomputing the
# forward and the gradient chain, then Phase A (reverse of the gradient
# chain, with the Hessian term s'' = 100 s'(1 - s')) and Phase B (reverse
# of the forward), and the PE second-derivative term.  The derivation is
# the JAX package's (``ops/fused_sdf.py:407-434``).  Both take the JAX
# entry's outputs in row layout: x [M, 3], grad [M, 3]; the [3, M] channel
# planes are TPU layout.  sdf_bn [B, N] is column 0 of ``out`` reshaped.
#
# Arithmetic: every product rounds both operands to bf16 and accumulates
# in f32, including K5's weight-gradient products (the JAX kernel's bf16
# dot_generals); the PE, the activations and every elementwise step are
# f32, and so are the bias and column-0 sums.
#
# On an H100 K4 is ~2.2 MFLOP per point and K5 ~6.6 (33 products of
# ~256x256 per point, plus the weight gradients).  Each runs a per-point
# pass of its own on a TMA weight ring and wgmma.  K4's
# (``csrc/sdf_fwd_grad_pass.cuh``) keeps two 64-point tiles in flight a
# block, one a warpgroup, with the A operands in registers, and the two
# warpgroups take turns at the tensor cores, so one tile's epilogue runs
# under the other's products.  K5's (``csrc/sdf_bwd_pass.cuh``) splits
# each product's output columns between two warpgroups, A operands in
# shared memory.  The per-point intermediates that do not fit beside
# them go to a workspace in device memory: K4 only its sigmoids
# (``fwd_workspace_specs``), K5 also the gradient chain, the cotangents
# and the weight-gradient operands (``bwd_workspace_specs``; ~40 KB per
# point), which bound K5's pass by their bytes; K5 recomputes the forward
# instead of keeping K4's.  K5's weight gradients are one product per
# layer over all points (``[fbar; inp]^T @ [e; zbar]``, the Phase A and B
# terms stacked): the weight-gradient stage (``wgrad.py``,
# ``csrc/wgrad.cu``) after the per-point pass, split over the rows and
# reduced in a fixed order: run to run the result is the same.
#
# K2 and K3 (``csrc/sdf_flat.cu``) replace ``_make_fwd_grad_kernel`` and
# ``_make_bwd_kernel_biased`` (``_sdf_forward_grad_impl`` /
# ``_sdf_bwd_impl``), which the JAX ``render_core`` takes below the rays
# gate through ``sdf_apply_grad_fused``.  The same math as K4/K5, and the
# same per-point tiles with other input and output stages: they take the
# encoding xe [M, pe_dim] as given, and K2 returns d_inputs [M, pe_dim],
# K3 takes its cotangent gbar and returns xebar [M, pe_dim].  The entry
# computes the PE, its Jacobian-vector products and the second-derivative
# term around them, exactly where the JAX entry does (its
# ``_sdf_forward_grad_impl`` and ``_sdf_apply_grad_bwd``), so both kernels
# compare with the JAX kernels one to one.  The extra [M, 39] arrays cost
# ~5 MB a pass at the phase-1 step's M = 32,768: nothing on this card
# (the rays kernels pull the PE in because of the TPU's lane padding).

LAUNCHES_K2 = 0
LAUNCHES_K3 = 0
LAUNCHES_K4 = 0
LAUNCHES_K5 = 0
# profiler ranges around the launches (``profile_step.py`` reads them)
PROFILE_K2, PROFILE_K3 = "fmov::K2_sdf_fwd_grad_flat", "fmov::K3_sdf_bwd_flat"
PROFILE_K4, PROFILE_K5 = "fmov::K4_sdf_fwd_grad", "fmov::K5_sdf_bwd"

# the JAX gate (``ops/fused_sdf.py:1185``); an H100 measurement may move it
MIN_SAMPLES_RAYS = 65536


# The widest hidden layer K2-K5 take: their per-point passes write a
# hidden layer's output in one pass of 256 columns (``BWD_NW`` in
# ``csrc/sdf_bwd_pass.cuh``, ``FG_NW`` in ``csrc/sdf_fwd_grad_pass.cuh``:
# there the next product's A operand, in registers).  K1 takes up to 384.
MAX_HIDDEN_TRAIN = 256


def supported_train(cfg) -> bool:
    """The configurations the training kernels K2-K5 take: ``supported``,
    with hidden layers at most ``MAX_HIDDEN_TRAIN`` wide."""
    return supported(cfg) and cfg["d_hidden"] <= MAX_HIDDEN_TRAIN


def supported_rays(cfg, n_samples: int, n_pts: int = None) -> bool:
    """The rays path takes the config and, given n_pts, is worth it
    (``MIN_SAMPLES_RAYS``).  Row layout needs no tile-aligned rays.  The
    skip layer must be a hidden one: the gradient chain starts from the
    last layer's column 0 against the hidden width (as in the JAX kernel)."""
    ok = supported_train(cfg) and n_samples > 0 and _skip(cfg) < cfg["n_layers"]
    if n_pts is not None:
        ok = ok and n_pts >= MIN_SAMPLES_RAYS
    return ok


_PE_TABLES = {}


def _pe_tables(multires: int, device):
    """Per encoded column: the input dim, the frequency and the kind
    (0 identity, 1 sin, 2 cos), in ``positional_encode``'s order; made
    once a device (a copy from the host cannot run in a captured step)."""
    key = (multires, torch.device(device))
    if key not in _PE_TABLES:
        dims, freqs, kinds = [0, 1, 2], [1.0] * 3, [0] * 3
        for k in range(multires):
            for kind in (1, 2):
                dims += [0, 1, 2]
                freqs += [2.0 ** k] * 3
                kinds += [kind] * 3
        _PE_TABLES[key] = (torch.tensor(dims, device=device),
                           torch.tensor(freqs, dtype=torch.float32, device=device),
                           torch.tensor(kinds, device=device))
    return _PE_TABLES[key]


def pe_parts(xs: torch.Tensor, multires: int):
    """(xe, jac, d2, dims) of the PE of xs [M, 3]: the encoding, its
    derivative and second derivative per column, and each column's dim."""
    dims, f, kind = _pe_tables(multires, xs.device)
    R = xs[:, dims]
    Rf = R * f
    s, c = torch.sin(Rf), torch.cos(Rf)
    xe = torch.where(kind == 0, R, torch.where(kind == 1, s, c))
    jac = torch.where(kind == 0, torch.ones_like(R),
                      torch.where(kind == 1, f * c, -f * s))
    d2 = torch.where(kind == 0, torch.zeros_like(R),
                     torch.where(kind == 1, -(f * f) * s, -(f * f) * c))
    return xe, jac, d2, dims


def dim_sum(t: torch.Tensor) -> torch.Tensor:
    """[M, 3(1 + 2L)] per-column values -> [M, 3] sums per input dim."""
    return t.reshape(t.shape[0], -1, 3).sum(1)


def act_pair(z: torch.Tensor):
    """softplus(100 z)/100 and sigmoid(100 z) from one exp (``_act_pair``)."""
    E = torch.exp(-100.0 * torch.abs(z))
    sp = torch.relu(z) + torch.log1p(E) * 0.01
    sig = torch.where(z >= 0, 1.0 / (1.0 + E), E / (1.0 + E))
    return sp, sig


def _bdot(a, b):
    return _bf16(a) @ _bf16(b)


def _forward_chain(ws, bs, xe, skip):
    """Layer inputs, activations and sigmoids of the hidden layers."""
    inps, sigs = [], []
    h = xe
    for l in range(len(ws) - 1):
        inp = torch.cat([h, xe], -1) * _INV_SQRT2 if l == skip else h
        inps.append(inp)
        h, sig = act_pair(_bdot(inp, ws[l]) + bs[l])
        sigs.append(sig)
    last = len(ws) - 1
    inps.append(torch.cat([h, xe], -1) * _INV_SQRT2 if last == skip else h)
    return inps, sigs


def _grad_chain(ws, xe, sigs, skip):
    """ds[l] (cotangent of layer l's hidden input, l >= 1) and d_inputs."""
    n_lin = len(ws)
    ds = [None] * n_lin
    ds[n_lin - 1] = ws[-1][:, 0][None, :].expand(xe.shape[0], -1)
    d_inputs = torch.zeros_like(xe)
    for l in range(n_lin - 2, -1, -1):
        fm = _bdot(ds[l + 1] * sigs[l], ws[l].T)
        if l == skip:
            h_dim = ws[l].shape[0] - xe.shape[1]
            d_inputs = d_inputs + fm[:, h_dim:] * _INV_SQRT2
            ds[l] = fm[:, :h_dim] * _INV_SQRT2
        else:
            ds[l] = fm
    return ds, d_inputs + ds[0]


def sdf_fwd_grad_flat_plain(ws, bs, xe, cfg):
    """K2's arithmetic: the encoding xe [M, pe_dim] -> (out [M, d_out],
    d_inputs [M, pe_dim]), d_inputs the cotangent of xe of the raw sdf
    (before the /scale)."""
    scale = cfg.get("scale", 1.0)
    skip = _skip(cfg)
    inps, sigs = _forward_chain(ws, bs, xe, skip)
    z = _bdot(inps[-1], ws[-1]) + bs[-1]
    out = torch.cat([z[:, :1] / scale, z[:, 1:]], -1)
    _, d_inputs = _grad_chain(ws, xe, sigs, skip)
    return out, d_inputs


def sdf_fwd_grad_plain(ws, bs, x, cfg):
    """K4's arithmetic: x [M, 3] -> (out [M, d_out], grad [M, 3])."""
    xe, jac, _, _ = pe_parts(x * cfg.get("scale", 1.0), cfg["multires"])
    out, d_inputs = sdf_fwd_grad_flat_plain(ws, bs, xe, cfg)
    # scale * (1/scale) on the sdf column cancels: grad is wrt raw x
    return out, dim_sum(d_inputs * jac)


def _bwd_core(ws, bs, xe, ybar, gbar, skip, operands=None):
    """The hand derivation transcribed (``ops/fused_sdf.py:407-434`` of
    the JAX package): the VJP of (z_{L-1}, d_inputs) given their
    cotangents ybar [M, d_out] and gbar [M, pe_dim] -> (xebar, dws, dbs,
    d_inputs).  ``operands``, a dict, receives the weight products'
    operands: at l, [(fbar_l, d_l) of Phase A (l < L-1), (inp_l, zbar_l)
    of Phase B], and at "col" the rows whose column sums are the last
    layer's column-0 term."""
    n_lin = len(ws)
    inps, sigs = _forward_chain(ws, bs, xe, skip)
    ds, d_inputs = _grad_chain(ws, xe, sigs, skip)
    dws = [None] * n_lin
    dbs = [None] * n_lin

    # Phase A: reverse the gradient chain (ascending l)
    zbar_chain = [None] * n_lin
    dbar = gbar
    for l in range(n_lin - 1):
        fbar = (torch.cat([dbar * _INV_SQRT2, gbar * _INV_SQRT2], -1)
                if l == skip else dbar)
        sp = sigs[l]
        if operands is not None:
            operands[l] = [(fbar, ds[l + 1] * sp)]
        dws[l] = _bdot(fbar.T, ds[l + 1] * sp)
        ebar = _bdot(fbar, ws[l])
        dbar = ebar * sp
        zbar_chain[l] = ebar * ds[l + 1] * (100.0 * sp * (1.0 - sp))
    col_bar = dbar.sum(0)
    if operands is not None:
        operands["col"] = dbar
    dws[n_lin - 1] = torch.zeros_like(ws[-1])
    dws[n_lin - 1][:, 0] = col_bar

    # Phase B: reverse the forward chain (descending l)
    xebar = torch.zeros_like(xe)
    zbar = ybar
    for l in range(n_lin - 1, -1, -1):
        if operands is not None:
            operands.setdefault(l, []).append((inps[l], zbar))
        dws[l] = dws[l] + _bdot(inps[l].T, zbar)
        dbs[l] = zbar.sum(0)
        inpbar = _bdot(zbar, ws[l].T)
        if l == skip:
            h_dim = ws[l].shape[0] - xe.shape[1]
            xebar = xebar + inpbar[:, h_dim:] * _INV_SQRT2
            ibar = inpbar[:, :h_dim] * _INV_SQRT2
        else:
            ibar = inpbar
        if l == 0:
            xebar = xebar + ibar
        else:
            zbar = ibar * sigs[l - 1] + zbar_chain[l - 1]
    return xebar, dws, dbs, d_inputs


def sdf_bwd_flat_plain(ws, bs, xe, ybar, gbar, cfg, operands=None):
    """K3's arithmetic: xe, ybar [M, d_out] (the cotangent of the raw last
    layer, its sdf column already divided by scale) and gbar [M, pe_dim]
    (the cotangent of d_inputs) -> (xebar [M, pe_dim], dws, dbs);
    ``operands`` as in ``_bwd_core``."""
    xebar, dws, dbs, _ = _bwd_core(ws, bs, xe, ybar, gbar, _skip(cfg), operands)
    return xebar, dws, dbs


def sdf_bwd_plain(ws, bs, x, ct_out, ct_sdf, ct_grad, cfg, operands=None):
    """K5's arithmetic: the cotangents ct_out [M, d_out], ct_sdf [M]
    (sdf_bn's, flattened) and ct_grad [M, 3] -> (xbar [M, 3], dws, dbs):
    K3's core with the encoding's derivatives around it; ``operands`` as
    in ``_bwd_core``."""
    scale = cfg.get("scale", 1.0)
    xe, jac, d2, dims = pe_parts(x * scale, cfg["multires"])
    ybar = torch.cat([(ct_out[:, :1] + ct_sdf[:, None]) / scale, ct_out[:, 1:]], -1)
    ct_grad_G = ct_grad[:, dims]
    xebar, dws, dbs, d_inputs = _bwd_core(ws, bs, xe, ybar, ct_grad_G * jac,
                                          _skip(cfg), operands)
    xsbar = dim_sum(xebar * jac + ct_grad_G * d_inputs * d2)
    return xsbar * scale, dws, dbs


def _input_layout(ws, cfg):
    """Padded input widths and row maps of the SDF layers (the skip
    layer reads [h (np of the layer before) | pe (pe_pad)])."""
    skip = _skip(cfg)
    pe_pad = round_up(ws[0].shape[0], 16)
    in_ws, row_maps = [], []
    for l in range(len(ws)):
        if l == 0:
            in_ws.append(pe_pad)
            row_maps.append(None)
        else:
            np_prev = round_up(ws[l - 1].shape[1], 16)
            if l == skip:
                n_h = ws[l - 1].shape[1]
                in_ws.append(np_prev + pe_pad)
                row_maps.append([(0, 0, n_h), (n_h, np_prev, ws[l].shape[0] - n_h)])
            else:
                in_ws.append(np_prev)
                row_maps.append(None)
    return in_ws, row_maps


class RaysPack:
    """K2-K5's packed weights (``packing.pack_train``) for one set of
    dense weights, plus the f32 column 0 of the last layer's W^T."""

    def __init__(self, ws, bs, cfg):
        if not supported_rays(cfg, 1):
            raise ValueError(f"SDF config not supported by the kernels: {cfg}")
        self.in_ws, self.row_maps = _input_layout(ws, cfg)
        self.w_buf, self.b_buf, self.meta = packing.pack_train(
            ws, bs, self.in_ws, self.row_maps)
        self.table = packing.layer_table(self.meta)
        np_last_in = int(self.table[-2, 1])
        self.wlast = torch.zeros(np_last_in, dtype=torch.float32,
                                 device=ws[0].device)
        self.wlast[:ws[-1].shape[0]] = ws[-1][:, 0]
        self.n_lin = len(ws)
        self.skip = _skip(cfg)
        self.multires = cfg["multires"]
        self.scale = float(cfg.get("scale", 1.0))
        self.n_out = ws[-1].shape[1]
        self.shapes = [tuple(w.shape) for w in ws]


def _typed(lib, signatures):
    """Set the ctypes signatures {fn: argtypes} (and the error string's)
    once per library."""
    if not getattr(lib, "_fmov_typed", False):
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.fmov_train_error_string.argtypes = [ctypes.c_int]
        lib.fmov_train_error_string.restype = ctypes.c_char_p
        lib._fmov_typed = True
    return lib


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (x, M, M_pad, scale, w, b, wlast, meta, n_lin, skip, multires, ptrs, G,
#  out, n_out, sdf, grad, stream); K2 takes xe for x and d_inputs for
#  (sdf, grad); G blocks, each looping over pairs of 64-point tiles
_FWD_GRAD_ARGS = [_VP, _CI, _CI, _CF, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP, _CI,
                  _VP, _CI, _VP, _VP, _VP]
_FWD_GRAD_FLAT_ARGS = _FWD_GRAD_ARGS[:15] + [_VP, _VP]
# (x, ct_out, ct_sdf, ct_grad, M, M_pad, n_out, scale, w, b, wlast, meta,
#  n_lin, skip, multires, ptrs, G, xbar, stream); K3 takes (xe, ybar,
#  gbar) for the first four and xebar for xbar
_BWD_ARGS = [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _CF, _VP, _VP, _VP, _VP, _CI, _CI,
             _CI, _VP, _CI, _VP, _VP]
_BWD_FLAT_ARGS = _BWD_ARGS[1:]
# (meta, n_lin, skip, multires, out[4]); K4/K2's takes out[4 + 4 x 64]
_BWD_PLAN_ARGS = [_VP, _CI, _CI, _CI, _VP]
_FWD_GRAD_PLAN_INTS = 4 + 4 * 64  # csrc/sdf_fwd_grad_pass.cuh FG_MAX_SUB


# (x, M, M_pad, scale, w, b, meta, n_lin, skip, multires, G, out, n_out,
#  stream)
_FWD_ARGS = [_VP, _CI, _CI, _CF, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP, _CI, _VP]


def _lib():
    from fmov_pose_torch.ops import build
    return _typed(build.library("sdf_fwd"), {"fmov_sdf_fwd": _FWD_ARGS})


def _rays_lib():
    from fmov_pose_torch.ops import build
    return (_typed(build.library("sdf_fwd_grad"),
                   {"fmov_sdf_fwd_grad": _FWD_GRAD_ARGS,
                    "fmov_sdf_fwd_grad_plan": _BWD_PLAN_ARGS}),
            _typed(build.library("sdf_bwd"), {"fmov_sdf_bwd": _BWD_ARGS,
                                              "fmov_sdf_bwd_plan": _BWD_PLAN_ARGS}))


def _flat_lib():
    from fmov_pose_torch.ops import build
    return _typed(build.library("sdf_flat"),
                  {"fmov_sdf_fwd_grad_flat": _FWD_GRAD_FLAT_ARGS,
                   "fmov_sdf_bwd_flat": _BWD_FLAT_ARGS})


def _check_cuda_rows(name, t, width, M, device):
    if not (t.is_cuda and t.device == device and t.dtype == torch.float32
            and t.dim() == 2 and t.shape == (M, width) and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous CUDA float32 [{M}, {width}] "
                         f"tensor on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _grid(device, n_tiles: int) -> int:
    """Blocks of a per-point pass: at most one per SM, each looping over
    tiles (the per-block partial sums stay few and are reduced in order)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_tiles, sms))


def _fwd_grid(device, n_tiles: int) -> int:
    """Blocks of K4/K2's pass: each block's two warpgroups take a pair of
    tiles at a time (``sdf_fwd_grad_block``), so at most one block per SM
    and per pair."""
    return _grid(device, (n_tiles + 1) // 2)


def _raise_on(lib, err, what, M):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.fmov_train_error_string(err).decode()} "
                           f"(cudaError {err}, M={M})")


def fwd_workspace_specs(table, M_pad: int):
    """K4/K2's per-point arrays, in the order of ``sdf_fwd_grad_launch``'s
    pointer table (csrc/sdf_fwd_grad_pass.cuh): SIG_0..SIG_{L-2}, the sigmoids the
    reverse chain reads back, in the per-point pass's fragment order (each
    64-row tile of a [M_pad, np(l)] array one row of 64 np(l) values,
    ``frag4``), each tile's written and read back by the warpgroup that owns
    it; the layer inputs and D_l stay on chip.  Returns
    [(name, rows, width, dtype)]."""
    t = np.asarray(table).tolist()
    tiles = M_pad // packing.TILE_M
    return [(f"SIG{l}", tiles, packing.TILE_M * t[l][1], torch.float32)
            for l in range(len(t) - 1)]


def _fwd_workspace(pk: RaysPack, M_pad: int, dev) -> packing.Workspace:
    """K4/K2's workspace (``fwd_workspace_specs``), allocated."""
    ws_ = packing.Workspace()
    for spec in fwd_workspace_specs(pk.table, M_pad):
        ws_.add(*spec)
    ws_.allocate(dev)
    return ws_


def bwd_workspace_specs(table, M_pad: int, G: int, KS: int, dw_elems: int):
    """K5/K3's per-point arrays and partial sums, in the order of
    ``sdf_bwd_launch``'s pointer table (csrc/sdf_bwd_pass.cuh): the bf16
    operands of the weight-gradient product row-major, the f32 arrays
    SIG, DS and ZC in the per-point pass's fragment order (each 64-row
    tile of a [M_pad, W] array one row of 64 W values, ``frag4``).
    Returns ([(name, rows, width, dtype)], n_bias)."""
    t = np.asarray(table).tolist()
    n_lin = len(t)
    tiles = M_pad // packing.TILE_M
    specs = [(f"AB{l}", 2 * M_pad, t[l][0], torch.bfloat16) for l in range(n_lin)]
    specs += [(f"BB{l}", 2 * M_pad, t[l][1], torch.bfloat16) for l in range(n_lin)]
    specs += [(f"SIG{l}", tiles, packing.TILE_M * t[l][1], torch.float32)
              for l in range(n_lin - 1)]
    specs += [(f"DS{l}", tiles, packing.TILE_M * t[l - 1][1], torch.float32)
              for l in range(1, n_lin - 1)]
    specs += [(f"ZC{l}", tiles, packing.TILE_M * t[l][1], torch.float32)
              for l in range(n_lin - 1)]
    n_bias = sum(row[1] for row in t)
    specs += [("DBPART", G, n_bias, torch.float32), ("CBPART", G, t[-2][1], torch.float32),
              ("DWPART", KS, dw_elems, torch.float32)]
    return specs, n_bias


def bwd_launch_plan(pk: RaysPack) -> dict:
    """The launch plan of K5/K3's per-point pass for ``pk``'s layer table,
    from the library that launches it (``fmov_sdf_bwd_plan``,
    ``csrc/sdf_bwd_pass.cuh`` ``bwd_plan``): dynamic shared memory in
    bytes, ring stages, passes a tile and threads a block."""
    _, lib = _rays_lib()
    out = (ctypes.c_int * 4)()
    err = lib.fmov_sdf_bwd_plan(pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin,
                                pk.skip, pk.multires, out)
    if err:
        raise ValueError("K5/K3's per-point pass does not take this layer table: "
                         f"{lib.fmov_train_error_string(err).decode()}")
    return dict(zip(("smem", "stages", "passes", "threads"), out))


def fwd_grad_launch_plan(pk: RaysPack) -> dict:
    """The launch plan of K4/K2's per-point pass for ``pk``'s layer table,
    from the library that launches it (``fmov_sdf_fwd_grad_plan``,
    ``csrc/sdf_fwd_grad_pass.cuh`` ``fg_plan``): dynamic shared memory in
    bytes, ring stages, passes a tile, threads a block, and each pass as
    (map, n0, nw, k): tensor map 2 l (F_l) or 2 l + 1 (R_l), output columns
    [n0, n0 + nw), reduction columns [0, k)."""
    lib, _ = _rays_lib()
    out = (ctypes.c_int * _FWD_GRAD_PLAN_INTS)()
    err = lib.fmov_sdf_fwd_grad_plan(pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin,
                                     pk.skip, pk.multires, out)
    if err:
        raise ValueError("K4/K2's per-point pass does not take this layer table: "
                         f"{lib.fmov_train_error_string(err).decode()}")
    passes = [tuple(out[4 + 4 * p:8 + 4 * p]) for p in range(out[2])]
    return {"smem": out[0], "stages": out[1], "passes": out[2], "threads": out[3],
            "table": passes}


def _bwd_workspace(pk: RaysPack, M_pad: int, G: int, KS: int, dev):
    """K5/K3's workspace (``bwd_workspace_specs``), allocated; returns
    (workspace, n_bias)."""
    specs, n_bias = bwd_workspace_specs(pk.table, M_pad, G, KS,
                                        packing.dw_elems(pk.meta))
    ws_ = packing.Workspace()
    for spec in specs:
        ws_.add(*spec)
    ws_.allocate(dev)
    return ws_, n_bias


def launch_fwd_grad(pk: RaysPack, x: torch.Tensor):
    """K4 on pre-packed weights: x CUDA float32 [M, 3] -> (out, sdf [M],
    grad); the only place that counts LAUNCHES_K4."""
    global LAUNCHES_K4
    M = x.shape[0]
    _check_cuda_rows("x", x, 3, M, x.device)
    if pk.w_buf.device != x.device:
        raise ValueError("packed weights and points on different devices")
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    ws_ = _fwd_workspace(pk, M_pad, x.device)
    out = torch.empty((M, pk.n_out), dtype=torch.float32, device=x.device)
    sdf = torch.empty(M, dtype=torch.float32, device=x.device)
    grad = torch.empty((M, 3), dtype=torch.float32, device=x.device)
    lib, _ = _rays_lib()
    with torch.cuda.device(x.device), torch.profiler.record_function(PROFILE_K4):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fmov_sdf_fwd_grad(
            x.data_ptr(), M, M_pad, pk.scale, pk.w_buf.data_ptr(),
            pk.b_buf.data_ptr(), pk.wlast.data_ptr(),
            pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin, pk.skip,
            pk.multires, ws_.table.ctypes.data_as(ctypes.c_void_p),
            _fwd_grid(x.device, M_pad // packing.TILE_M), out.data_ptr(), pk.n_out,
            sdf.data_ptr(), grad.data_ptr(), stream)
    _raise_on(lib, err, "sdf_fwd_grad", M)
    LAUNCHES_K4 += 1
    LAUNCH_SIZES["K4", M] += 1
    return out, sdf, grad


def _split_k(device, table, M_pad: int, sdf: bool) -> int:
    """Row splits of the weight-gradient stage on this device's SMs
    (``wgrad.split_k``) for K5/K3's (``sdf``) or K9/K7's layer table."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return wgrad.split_k(sms, wgrad.table_dims(table, M_pad, sdf))


def bwd_pass(pk: RaysPack, x, ct_out, ct_sdf, ct_grad):
    """K5's per-point pass alone, on pre-packed weights: (xbar [M, 3], the
    weight-gradient stage on the workspace it filled)."""
    M = x.shape[0]
    dev = x.device
    _check_cuda_rows("x", x, 3, M, dev)
    _check_cuda_rows("ct_out", ct_out, pk.n_out, M, dev)
    _check_cuda_rows("ct_sdf", ct_sdf.reshape(M, 1), 1, M, dev)
    _check_cuda_rows("ct_grad", ct_grad, 3, M, dev)
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    G = _grid(dev, M_pad // packing.TILE_M)
    KS = _split_k(dev, pk.table, M_pad, True)
    ws_, _ = _bwd_workspace(pk, M_pad, G, KS, dev)
    xbar = torch.empty((M, 3), dtype=torch.float32, device=dev)
    _, lib = _rays_lib()
    with torch.cuda.device(dev):
        err = lib.fmov_sdf_bwd(
            x.data_ptr(), ct_out.data_ptr(), ct_sdf.data_ptr(), ct_grad.data_ptr(),
            M, M_pad, pk.n_out, pk.scale, pk.w_buf.data_ptr(), pk.b_buf.data_ptr(),
            pk.wlast.data_ptr(), pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin,
            pk.skip, pk.multires, ws_.table.ctypes.data_as(ctypes.c_void_p), G,
            xbar.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "sdf_bwd", M)
    return xbar, wgrad.sdf_stage(ws_, pk.table, M_pad, KS)


def launch_bwd(pk: RaysPack, x, ct_out, ct_sdf, ct_grad):
    """K5 on pre-packed weights: the cotangents of (out, sdf [M], grad)
    -> (xbar [M, 3], dw_pad, db_pad) in the packed layout: the per-point
    pass, then the weight-gradient stage; the only place that counts
    LAUNCHES_K5."""
    global LAUNCHES_K5
    with torch.profiler.record_function(PROFILE_K5):
        xbar, stage = bwd_pass(pk, x, ct_out, ct_sdf, ct_grad)
        dw_pad, db_pad = wgrad.launch(stage)
    LAUNCHES_K5 += 1
    LAUNCH_SIZES["K5", x.shape[0]] += 1
    return xbar, dw_pad, db_pad


def _pe_width(pk: RaysPack) -> int:
    return 3 * (1 + 2 * pk.multires)


def launch_fwd_grad_flat(pk: RaysPack, xe: torch.Tensor):
    """K2 on pre-packed weights: the encoding xe CUDA float32 [M, pe_dim]
    -> (out [M, d_out], d_inputs [M, pe_dim]); the only place that counts
    LAUNCHES_K2."""
    global LAUNCHES_K2
    M = xe.shape[0]
    dev = xe.device
    _check_cuda_rows("xe", xe, _pe_width(pk), M, dev)
    if pk.w_buf.device != dev:
        raise ValueError("packed weights and points on different devices")
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    ws_ = _fwd_workspace(pk, M_pad, dev)
    out = torch.empty((M, pk.n_out), dtype=torch.float32, device=dev)
    d_inputs = torch.empty((M, _pe_width(pk)), dtype=torch.float32, device=dev)
    lib = _flat_lib()
    with torch.cuda.device(dev), torch.profiler.record_function(PROFILE_K2):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fmov_sdf_fwd_grad_flat(
            xe.data_ptr(), M, M_pad, pk.scale, pk.w_buf.data_ptr(),
            pk.b_buf.data_ptr(), pk.wlast.data_ptr(),
            pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin, pk.skip,
            pk.multires, ws_.table.ctypes.data_as(ctypes.c_void_p),
            _fwd_grid(dev, M_pad // packing.TILE_M), out.data_ptr(), pk.n_out,
            d_inputs.data_ptr(), stream)
    _raise_on(lib, err, "sdf_fwd_grad_flat", M)
    LAUNCHES_K2 += 1
    LAUNCH_SIZES["K2", M] += 1
    return out, d_inputs


def bwd_flat_pass(pk: RaysPack, xe, ybar, gbar):
    """K3's per-point pass alone, on pre-packed weights: (xebar [M, pe_dim],
    the weight-gradient stage on the workspace it filled)."""
    M = xe.shape[0]
    dev = xe.device
    pe_dim = _pe_width(pk)
    _check_cuda_rows("xe", xe, pe_dim, M, dev)
    _check_cuda_rows("ybar", ybar, pk.n_out, M, dev)
    _check_cuda_rows("gbar", gbar, pe_dim, M, dev)
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    G = _grid(dev, M_pad // packing.TILE_M)
    KS = _split_k(dev, pk.table, M_pad, True)
    ws_, _ = _bwd_workspace(pk, M_pad, G, KS, dev)
    xebar = torch.empty((M, pe_dim), dtype=torch.float32, device=dev)
    lib = _flat_lib()
    with torch.cuda.device(dev):
        err = lib.fmov_sdf_bwd_flat(
            xe.data_ptr(), ybar.data_ptr(), gbar.data_ptr(), M, M_pad, pk.n_out,
            pk.scale, pk.w_buf.data_ptr(), pk.b_buf.data_ptr(), pk.wlast.data_ptr(),
            pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin, pk.skip, pk.multires,
            ws_.table.ctypes.data_as(ctypes.c_void_p), G, xebar.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "sdf_bwd_flat", M)
    return xebar, wgrad.sdf_stage(ws_, pk.table, M_pad, KS)


def launch_bwd_flat(pk: RaysPack, xe, ybar, gbar):
    """K3 on pre-packed weights: xe, ybar [M, d_out] and gbar [M, pe_dim]
    -> (xebar [M, pe_dim], dw_pad, db_pad) in the packed layout: the
    per-point pass, then the weight-gradient stage; the only place that
    counts LAUNCHES_K3."""
    global LAUNCHES_K3
    with torch.profiler.record_function(PROFILE_K3):
        xebar, stage = bwd_flat_pass(pk, xe, ybar, gbar)
        dw_pad, db_pad = wgrad.launch(stage)
    LAUNCHES_K3 += 1
    LAUNCH_SIZES["K3", xe.shape[0]] += 1
    return xebar, dw_pad, db_pad


def sdf_fwd_grad(ws, bs, x, cfg, pk: RaysPack = None):
    """K4 for a CUDA tensor (packing ``ws`` unless ``pk`` is given), the
    plain version for a CPU tensor: (out, sdf [M], grad)."""
    if x.is_cuda:
        return launch_fwd_grad(pk or RaysPack(ws, bs, cfg), x.contiguous())
    out, grad = sdf_fwd_grad_plain(ws, bs, x, cfg)
    return out, out[:, 0].clone(), grad


def sdf_bwd(ws, bs, x, ct_out, ct_sdf, ct_grad, cfg, pk: RaysPack = None):
    """K5 for a CUDA tensor, the plain version for a CPU tensor:
    (xbar [M, 3], dws, dbs) in the layout of ``ws``/``bs``."""
    if x.is_cuda:
        pk = pk or RaysPack(ws, bs, cfg)
        xbar, dw_pad, db_pad = launch_bwd(
            pk, x.contiguous(), ct_out.contiguous(), ct_sdf.contiguous(),
            ct_grad.contiguous())
        dws, dbs = packing.unpack_grads(dw_pad, db_pad, pk.meta, ws, pk.row_maps)
        return xbar, dws, dbs
    return sdf_bwd_plain(ws, bs, x, ct_out, ct_sdf, ct_grad, cfg)


def sdf_fwd_grad_flat(ws, bs, xe, cfg, pk: RaysPack = None):
    """K2 for a CUDA tensor (packing ``ws`` unless ``pk`` is given), the
    plain version for a CPU tensor: (out, d_inputs)."""
    if xe.is_cuda:
        return launch_fwd_grad_flat(pk or RaysPack(ws, bs, cfg), xe.contiguous())
    return sdf_fwd_grad_flat_plain(ws, bs, xe, cfg)


def sdf_bwd_flat(ws, bs, xe, ybar, gbar, cfg, pk: RaysPack = None):
    """K3 for a CUDA tensor, the plain version for a CPU tensor:
    (xebar [M, pe_dim], dws, dbs) in the layout of ``ws``/``bs``."""
    if xe.is_cuda:
        pk = pk or RaysPack(ws, bs, cfg)
        xebar, dw_pad, db_pad = launch_bwd_flat(
            pk, xe.contiguous(), ybar.contiguous(), gbar.contiguous())
        dws, dbs = packing.unpack_grads(dw_pad, db_pad, pk.meta, ws, pk.row_maps)
        return xebar, dws, dbs
    return sdf_bwd_flat_plain(ws, bs, xe, ybar, gbar, cfg)


def _zeros_for(ct, shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device) if ct is None else ct


class _SdfRays(torch.autograd.Function):
    """K4 forward, K5 backward, on the dense weights and biases, so that
    autograd carries the weight-norm (v, g) VJP (``mat_vjp`` in JAX)."""

    @staticmethod
    def forward(ctx, cfg_key, n_samples, x, *wb):
        cfg = dict(cfg_key)
        n_lin = len(wb) // 2
        ws, bs = list(wb[:n_lin]), list(wb[n_lin:])
        pk = RaysPack(ws, bs, cfg) if x.is_cuda else None
        out, sdf, grad = sdf_fwd_grad(ws, bs, x, cfg, pk)
        ctx.cfg, ctx.pk, ctx.n_lin = cfg, pk, n_lin
        ctx.save_for_backward(x, *wb)
        return out, sdf.reshape(-1, n_samples), grad

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_out, ct_sdf, ct_grad):
        x, *wb = ctx.saved_tensors
        ws, bs = wb[:ctx.n_lin], wb[ctx.n_lin:]
        M = x.shape[0]
        ct_out = _zeros_for(ct_out, (M, ws[-1].shape[1]), x)
        ct_sdf = _zeros_for(ct_sdf, (M,), x).reshape(M)
        ct_grad = _zeros_for(ct_grad, (M, 3), x)
        xbar, dws, dbs = sdf_bwd(ws, bs, x, ct_out, ct_sdf, ct_grad, ctx.cfg,
                                 ctx.pk)
        return (None, None, xbar, *dws, *dbs)


def sdf_apply_grad_fused_rays(params, cfg, pts, n_samples: int):
    """(out [M, d_out], sdf_bn [M // n_samples, n_samples], grad [M, 3])
    for points [M, 3] laid out ray by ray; K4 forward, K5 backward (the
    plain versions for CPU tensors).  Differentiable in the parameters
    (weight norm included) and in pts."""
    if pts.shape[0] % n_samples:
        raise ValueError(f"{pts.shape[0]} points are not whole rays of {n_samples}")
    ws, bs = materialize(params, cfg)
    return _SdfRays.apply(_cfg_key(cfg), n_samples, pts, *ws, *bs)


class _SdfFlat(torch.autograd.Function):
    """K2 forward, K3 backward, with the encoding and its derivatives in
    PyTorch around them: the JAX custom_vjp ``_sdf_apply_grad_op``
    (``_sdf_apply_grad_fwd`` / ``_sdf_apply_grad_bwd``).  On the dense
    weights and biases, so that autograd carries the weight-norm VJP."""

    @staticmethod
    def forward(ctx, cfg_key, x, *wb):
        cfg = dict(cfg_key)
        n_lin = len(wb) // 2
        ws, bs = list(wb[:n_lin]), list(wb[n_lin:])
        xe, jac, _, _ = pe_parts(x * cfg.get("scale", 1.0), cfg["multires"])
        pk = RaysPack(ws, bs, cfg) if x.is_cuda else None
        out, d_inputs = sdf_fwd_grad_flat(ws, bs, xe, cfg, pk)
        # grad = pe_vjp(xs, d_inputs): the scale and the sdf's /scale cancel
        grad = dim_sum(d_inputs * jac)
        ctx.cfg, ctx.pk, ctx.n_lin = cfg, pk, n_lin
        ctx.save_for_backward(x, d_inputs, *wb)
        return out, grad

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_out, ct_grad):
        x, d_inputs, *wb = ctx.saved_tensors
        cfg = ctx.cfg
        ws, bs = wb[:ctx.n_lin], wb[ctx.n_lin:]
        M = x.shape[0]
        scale = cfg.get("scale", 1.0)
        ct_out = _zeros_for(ct_out, (M, ws[-1].shape[1]), x)
        ct_grad = _zeros_for(ct_grad, (M, 3), x)
        xe, jac, d2, dims = pe_parts(x * scale, cfg["multires"])
        # out = [z0 / scale, z1..]: the cotangent of the raw z
        ybar = torch.cat([ct_out[:, :1] / scale, ct_out[:, 1:]], -1)
        # grad = pe_vjp(xs, d_inputs): the cotangent of d_inputs
        ct_grad_G = ct_grad[:, dims]
        xebar, dws, dbs = sdf_bwd_flat(ws, bs, xe, ybar, ct_grad_G * jac, cfg,
                                       ctx.pk)
        # through the encoding, plus the xs-dependence of pe_vjp itself
        xsbar = dim_sum(xebar * jac + ct_grad_G * d_inputs * d2)
        return (None, xsbar * scale, *dws, *dbs)


def sdf_apply_grad_fused(params, cfg, x):
    """(out [M, d_out], grad [M, 3]) for points x [M, 3]; K2 forward, K3
    backward (the plain versions for CPU tensors).  Differentiable in the
    parameters (weight norm included) and in x.  The JAX entry of the
    same name is its contract."""
    ws, bs = materialize(params, cfg)
    return _SdfFlat.apply(_cfg_key(cfg), x, *ws, *bs)
