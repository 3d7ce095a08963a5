"""The IDR color MLP's kernels: K8/K9 (ray-composited) and K6/K7
(per sample), their plain versions and the entries ``color_fused_ray``,
``color_fused`` and ``color_fused_featfirst``.

K8 (``csrc/color_ray.cu``, ``fmov_color_ray_fwd``) replaces the Pallas kernel
``fmov_pose_tpu/ops/fused_color.py:_make_ray_fwd_kernel`` (launched by
``_ray_fwd_impl``): per sample it builds the IDR color input
[pts, view-direction PE, normals, feature] from the raw SDF output, runs the
ReLU MLP to a sigmoid rgb, and composites each ray with the render weights.
K9 (``fmov_color_ray_bwd``) replaces ``_make_ray_bwd_kernel``
(``_ray_bwd_impl``): it recomputes the forward and returns the cotangents
of the feature columns of the SDF output (column 0 gets zero), of pts, dirs
and normals, of the weights, and the weight and bias gradients.

K6 (``csrc/color_sample.cu``, ``fmov_color_sample_fwd``) replaces
``_make_fwd_kernel`` (launched by ``_color_fwd_impl``): the same MLP on
prebuilt input rows xc [M, d_in], per-sample rgb [M, 3], no composite.  K7
(``fmov_color_sample_bwd``) replaces ``_make_bwd_kernel``
(``_color_bwd_impl``): from a per-sample cotangent ct [M, 3] it recomputes
the forward and returns xcbar [M, d_in] and the weight and bias gradients.
The render takes them where K8 cannot run: the NeRF++ background mixes
per-sample colors, or the SDF takes the flat path.  The four kernels share
one tile code (``csrc/color_train.cuh``) with other input and output
stages, and K6/K7 take K8/K9's packed weights (``RayPack``).

The input keeps ``nets.color_apply``'s idr order; the JAX kernels'
feature-first permutation of the first layer is TPU layout, and changes
only the order of the f32 sums.  Geometry is row layout ([M, 3] each), not
[9, M] channel planes.  Products round both operands to bf16 and sum in
f32 (``_dot``/``_dot_acc`` of the JAX module); everything else is f32.

On an H100 the MLP is ~0.54 MFLOP per sample forward and ~1.6 backward,
so all four kernels are bound by their products.  All four run their
per-point pass on the pipeline of the SDF training kernels
(``csrc/pipe.cuh``): the weights of the tile's products stream through a
cp.async ring ahead of the tensor cores, the products run on mma.sync with
the epilogues in registers, and each product's A operand stays in shared
memory.  The forward kernels K8/K6 walk the L products of the forward and
write nothing but their output (K8: the per-sample rgb C, for the
composite); the backward kernels K9/K7 recompute the forward through the
same tile code, keep the ReLU masks as bits in shared memory, and write
each layer's input X_l and output cotangent ZB_l to the workspace
(``_workspace``) for the weight gradients, which are one product per layer
over all samples, split over K and reduced in a fixed order.  K8's per-ray
composite is a second, small launch (a ray's samples may span two tiles).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from fmov_pose_torch.core.embedder import positional_encode
from fmov_pose_torch.ops import fused_sdf, packing

LAUNCHES_K6 = 0
LAUNCHES_K7 = 0
LAUNCHES_K8 = 0
LAUNCHES_K9 = 0
# profiler ranges around the launches (``profile_step.py`` reads them)
PROFILE_K6, PROFILE_K7 = "fmov::K6_color_fwd", "fmov::K7_color_bwd"
PROFILE_K8, PROFILE_K9 = "fmov::K8_color_ray_fwd", "fmov::K9_color_ray_bwd"

# the JAX gate (``ops/fused_color.py:45``); an H100 measurement may move it
MIN_SAMPLES = 65536


def supported(cfg) -> bool:
    return cfg.get("mode", "idr") == "idr" and cfg.get("squeeze_out", True)


def supported_ray(cfg, n_samples: int) -> bool:
    """Row layout needs no tile-aligned rays (the JAX ``TILE % n_samples``)."""
    return supported(cfg) and n_samples > 0


# weight norm -> dense W^T [in, out] and biases [out], as for the SDF
materialize = fused_sdf.materialize


def _bdot(a, b):
    return fused_sdf._bf16(a) @ fused_sdf._bf16(b)


def _inputs(sdf_out, pts, dirs, normals, cfg):
    """The idr input [pts, PE(dirs), normals, feature] and d PE / d dirs."""
    vpe, vjac, _, _ = fused_sdf.pe_parts(dirs, cfg["multires_view"])
    return torch.cat([pts, vpe, normals, sdf_out[:, 1:]], -1), vjac


def _mlp(ws, bs, xc):
    acts = [xc]
    h = xc
    for l in range(len(ws)):
        h = _bdot(h, ws[l]) + bs[l]
        if l < len(ws) - 1:
            h = torch.relu(h)
            acts.append(h)
    return acts, torch.sigmoid(h)


def _descend(ws, acts, zbar):
    """From the cotangent zbar of the last pre-activation: (the input
    cotangent, dws, dbs), the backward kernels' descent."""
    n_lin = len(ws)
    dws, dbs = [None] * n_lin, [None] * n_lin
    for l in range(n_lin - 1, -1, -1):
        dws[l] = _bdot(acts[l].T, zbar)
        dbs[l] = zbar.sum(0)
        ibar = _bdot(zbar, ws[l].T)
        if l > 0:
            zbar = ibar * (acts[l] > 0.0).to(ibar.dtype)
    return ibar, dws, dbs


def color_fwd_plain(ws, bs, xc):
    """K6's arithmetic, the JAX ``apply_from_concat`` with bf16 operands:
    xc [M, d_in] -> rgb [M, 3]."""
    return _mlp(ws, bs, xc)[1]


def color_bwd_plain(ws, bs, xc, ct):
    """K7's arithmetic, the hand derivation of the JAX ``_make_bwd_kernel``:
    ct [M, 3] -> (xcbar [M, d_in], dws, dbs)."""
    acts, c = _mlp(ws, bs, xc)
    return _descend(ws, acts, ct * c * (1.0 - c))


def color_ray_fwd_plain(ws, bs, sdf_out, pts, dirs, normals, weights, cfg):
    """K8's arithmetic -> color [B, 3]."""
    xc, _ = _inputs(sdf_out, pts, dirs, normals, cfg)
    _, c = _mlp(ws, bs, xc)
    B, N = weights.shape
    return (c.reshape(B, N, 3) * weights[:, :, None]).sum(1)


def color_ray_bwd_plain(ws, bs, sdf_out, pts, dirs, normals, weights, ct, cfg):
    """K9's arithmetic, the hand derivation: ct [B, 3] -> (featbar
    [M, d_sdf] with column 0 zero, pts_bar, dirs_bar, normals_bar,
    d_weights [B, N], dws, dbs)."""
    xc, vjac = _inputs(sdf_out, pts, dirs, normals, cfg)
    acts, c = _mlp(ws, bs, xc)
    B, N = weights.shape
    d_weights = (c.reshape(B, N, 3) * ct[:, None, :]).sum(2)
    cbar = (ct[:, None, :] * weights[:, :, None]).reshape(-1, 3)
    ibar, dws, dbs = _descend(ws, acts, cbar * c * (1.0 - c))
    n_pe = vjac.shape[1]
    featbar = torch.cat([torch.zeros_like(ibar[:, :1]), ibar[:, 6 + n_pe:]], -1)
    dirs_bar = fused_sdf.dim_sum(ibar[:, 3:3 + n_pe] * vjac)
    return (featbar, ibar[:, :3], dirs_bar, ibar[:, 3 + n_pe:6 + n_pe],
            d_weights, dws, dbs)


class RayPack:
    """K8/K9's packed weights for one set of dense weights."""

    def __init__(self, ws, bs, cfg):
        if not supported(cfg):
            raise ValueError(f"color config not supported by the kernels: {cfg}")
        d_in = ws[0].shape[0]
        self.in_ws = [packing.round_up(d_in, 16)] + [
            packing.round_up(w.shape[1], 16) for w in ws[:-1]]
        self.row_maps = [None] * len(ws)
        self.w_buf, self.b_buf, self.meta = packing.pack_train(
            ws, bs, self.in_ws, self.row_maps)
        self.table = packing.layer_table(self.meta)
        self.n_lin = len(ws)
        self.multires_view = cfg["multires_view"]
        self.d_in = d_in


def _lib():
    from fmov_pose_torch.ops import build
    lib = build.library("color_ray")
    if not getattr(lib, "_fmov_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fmov_color_ray_fwd.argtypes = [
            vp, ci, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, vp, ci, vp, vp]
        lib.fmov_color_ray_fwd.restype = ci
        lib.fmov_color_ray_bwd.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, vp, ci, ci,
            vp, vp, vp, vp, vp, vp]
        lib.fmov_color_ray_bwd.restype = ci
        lib.fmov_train_error_string.argtypes = [ci]
        lib.fmov_train_error_string.restype = ctypes.c_char_p
        lib._fmov_typed = True
    return lib


def _check(pk, sdf_out, pts, dirs, normals, weights):
    M = pts.shape[0]
    dev = pts.device
    for name, t, w in (("sdf_out", sdf_out, sdf_out.shape[1]), ("pts", pts, 3),
                       ("dirs", dirs, 3), ("normals", normals, 3)):
        fused_sdf._check_cuda_rows(name, t, w, M, dev)
    B, N = weights.shape
    fused_sdf._check_cuda_rows("weights", weights.reshape(M, 1), 1, B * N, dev)
    if 3 + 3 * (1 + 2 * pk.multires_view) + 3 + sdf_out.shape[1] - 1 != pk.d_in:
        raise ValueError(f"sdf_out is {sdf_out.shape[1]} wide; the color input "
                         f"is {pk.d_in}")
    if pk.w_buf.device != dev:
        raise ValueError("packed weights and samples on different devices")
    return M, B, N, dev


def _workspace(pk, M_pad, dev, backward, G=0, KS=0, composite=False):
    """The table ``color_core_setup`` and its callers read.  Backward:
    X_0..X_{L-1}, ZB_0..ZB_{L-1}, DBPART, DWPART; K8's forward
    (``composite``): only the per-sample rgb C; K6's forward: nothing."""
    ws_ = packing.Workspace()
    t = pk.table
    if backward:
        for l in range(pk.n_lin):
            ws_.add(f"X{l}", M_pad, t[l, 0], torch.bfloat16)
        for l in range(pk.n_lin):
            ws_.add(f"ZB{l}", M_pad, t[l, 1], torch.bfloat16)
        ws_.add("DBPART", G, int(t[:, 1].sum()), torch.float32)
        ws_.add("DWPART", KS, packing.dw_elems(pk.meta), torch.float32)
    elif composite:
        ws_.add("C", M_pad, 4, torch.float32)
    return ws_.allocate(dev)


def launch_fwd(pk: RayPack, sdf_out, pts, dirs, normals, weights):
    """K8 on pre-packed weights -> color [B, 3]; the only place that
    counts LAUNCHES_K8."""
    global LAUNCHES_K8
    M, B, N, dev = _check(pk, sdf_out, pts, dirs, normals, weights)
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    ws_ = _workspace(pk, M_pad, dev, False, composite=True)
    color = torch.empty((B, 3), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev), torch.profiler.record_function(PROFILE_K8):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fmov_color_ray_fwd(
            sdf_out.data_ptr(), sdf_out.shape[1], pts.data_ptr(), dirs.data_ptr(),
            normals.data_ptr(), weights.data_ptr(), M, M_pad, N,
            pk.w_buf.data_ptr(), pk.b_buf.data_ptr(),
            pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin, pk.multires_view,
            ws_.table.ctypes.data_as(ctypes.c_void_p),
            fused_sdf._grid(dev, M_pad // packing.TILE_M), color.data_ptr(), stream)
    fused_sdf._raise_on(lib, err, "color_ray_fwd", M)
    LAUNCHES_K8 += 1
    fused_sdf.LAUNCH_SIZES["K8", M] += 1
    return color


def launch_bwd(pk: RayPack, sdf_out, pts, dirs, normals, weights, ct):
    """K9 on pre-packed weights: ct [B, 3] -> (featbar [M, d_sdf], ubar
    [M, 9] = [pts | dirs | normals] cotangents, d_weights [B, N], dw_pad,
    db_pad); the only place that counts LAUNCHES_K9."""
    global LAUNCHES_K9
    M, B, N, dev = _check(pk, sdf_out, pts, dirs, normals, weights)
    fused_sdf._check_cuda_rows("ct", ct, 3, B, dev)
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    G = fused_sdf._grid(dev, M_pad // packing.TILE_M)
    KS = fused_sdf._split_k(dev, pk.meta, M_pad)
    ws_ = _workspace(pk, M_pad, dev, True, G, KS)
    featbar = torch.empty_like(sdf_out)
    ubar = torch.empty((M, 9), dtype=torch.float32, device=dev)
    d_weights = torch.empty((B, N), dtype=torch.float32, device=dev)
    dw_pad = torch.empty(packing.dw_elems(pk.meta), dtype=torch.float32, device=dev)
    db_pad = torch.empty(int(pk.table[:, 1].sum()), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev), torch.profiler.record_function(PROFILE_K9):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fmov_color_ray_bwd(
            sdf_out.data_ptr(), sdf_out.shape[1], pts.data_ptr(), dirs.data_ptr(),
            normals.data_ptr(), weights.data_ptr(), ct.data_ptr(), M, M_pad, N,
            pk.w_buf.data_ptr(), pk.b_buf.data_ptr(),
            pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin, pk.multires_view,
            ws_.table.ctypes.data_as(ctypes.c_void_p), G, KS,
            featbar.data_ptr(), ubar.data_ptr(), d_weights.data_ptr(),
            dw_pad.data_ptr(), db_pad.data_ptr(), stream)
    fused_sdf._raise_on(lib, err, "color_ray_bwd", M)
    LAUNCHES_K9 += 1
    fused_sdf.LAUNCH_SIZES["K9", M] += 1
    return featbar, ubar, d_weights, dw_pad, db_pad


def color_ray_fwd(ws, bs, sdf_out, pts, dirs, normals, weights, cfg, pk=None):
    """K8 for CUDA tensors, the plain version for CPU tensors."""
    if pts.is_cuda:
        return launch_fwd(pk or RayPack(ws, bs, cfg), *(
            t.contiguous() for t in (sdf_out, pts, dirs, normals, weights)))
    return color_ray_fwd_plain(ws, bs, sdf_out, pts, dirs, normals, weights, cfg)


def color_ray_bwd(ws, bs, sdf_out, pts, dirs, normals, weights, ct, cfg, pk=None):
    """K9 for CUDA tensors, the plain version for CPU tensors; returns
    color_ray_bwd_plain's tuple."""
    if pts.is_cuda:
        pk = pk or RayPack(ws, bs, cfg)
        featbar, ubar, d_weights, dw_pad, db_pad = launch_bwd(pk, *(
            t.contiguous() for t in (sdf_out, pts, dirs, normals, weights, ct)))
        dws, dbs = packing.unpack_grads(dw_pad, db_pad, pk.meta, ws, pk.row_maps)
        return (featbar, ubar[:, 0:3], ubar[:, 3:6], ubar[:, 6:9], d_weights,
                dws, dbs)
    return color_ray_bwd_plain(ws, bs, sdf_out, pts, dirs, normals, weights, ct, cfg)


def _sample_lib():
    from fmov_pose_torch.ops import build
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return fused_sdf._typed(build.library("color_sample"), {
        # (xc, d_in, M, M_pad, w, b, meta, n_lin, ptrs, G, rgb, stream)
        "fmov_color_sample_fwd": [vp, ci, ci, ci, vp, vp, vp, ci, vp, ci, vp, vp],
        # (xc, ct, d_in, M, M_pad, w, b, meta, n_lin, ptrs, G, KS, xcbar,
        #  dw, db, stream)
        "fmov_color_sample_bwd": [vp, vp, ci, ci, ci, vp, vp, vp, ci, vp, ci, ci,
                                  vp, vp, vp, vp]})


def _check_sample(pk, xc, ct=None):
    M, dev = xc.shape[0], xc.device
    fused_sdf._check_cuda_rows("xc", xc, pk.d_in, M, dev)
    if ct is not None:
        fused_sdf._check_cuda_rows("ct", ct, 3, M, dev)
    if pk.w_buf.device != dev:
        raise ValueError("packed weights and samples on different devices")
    return M, dev


def launch_fwd_sample(pk: RayPack, xc):
    """K6 on pre-packed weights: xc [M, d_in] -> rgb [M, 3]; the only
    place that counts LAUNCHES_K6."""
    global LAUNCHES_K6
    M, dev = _check_sample(pk, xc)
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    ws_ = _workspace(pk, M_pad, dev, False)
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    lib = _sample_lib()
    with torch.cuda.device(dev), torch.profiler.record_function(PROFILE_K6):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fmov_color_sample_fwd(
            xc.data_ptr(), pk.d_in, M, M_pad, pk.w_buf.data_ptr(), pk.b_buf.data_ptr(),
            pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin,
            ws_.table.ctypes.data_as(ctypes.c_void_p),
            fused_sdf._grid(dev, M_pad // packing.TILE_M), rgb.data_ptr(), stream)
    fused_sdf._raise_on(lib, err, "color_sample_fwd", M)
    LAUNCHES_K6 += 1
    fused_sdf.LAUNCH_SIZES["K6", M] += 1
    return rgb


def launch_bwd_sample(pk: RayPack, xc, ct):
    """K7 on pre-packed weights: ct [M, 3] -> (xcbar [M, d_in], dw_pad,
    db_pad) in the packed layout; the only place that counts LAUNCHES_K7."""
    global LAUNCHES_K7
    M, dev = _check_sample(pk, xc, ct)
    M_pad = packing.round_up(max(M, 1), packing.TILE_M)
    G = fused_sdf._grid(dev, M_pad // packing.TILE_M)
    KS = fused_sdf._split_k(dev, pk.meta, M_pad)
    ws_ = _workspace(pk, M_pad, dev, True, G, KS)
    xcbar = torch.empty((M, pk.d_in), dtype=torch.float32, device=dev)
    dw_pad = torch.empty(packing.dw_elems(pk.meta), dtype=torch.float32, device=dev)
    db_pad = torch.empty(int(pk.table[:, 1].sum()), dtype=torch.float32, device=dev)
    lib = _sample_lib()
    with torch.cuda.device(dev), torch.profiler.record_function(PROFILE_K7):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fmov_color_sample_bwd(
            xc.data_ptr(), ct.data_ptr(), pk.d_in, M, M_pad, pk.w_buf.data_ptr(),
            pk.b_buf.data_ptr(), pk.meta.ctypes.data_as(ctypes.c_void_p), pk.n_lin,
            ws_.table.ctypes.data_as(ctypes.c_void_p), G, KS, xcbar.data_ptr(),
            dw_pad.data_ptr(), db_pad.data_ptr(), stream)
    fused_sdf._raise_on(lib, err, "color_sample_bwd", M)
    LAUNCHES_K7 += 1
    fused_sdf.LAUNCH_SIZES["K7", M] += 1
    return xcbar, dw_pad, db_pad


def color_fwd(ws, bs, xc, cfg, pk=None):
    """K6 for a CUDA tensor (packing ``ws`` unless ``pk`` is given), the
    plain version for a CPU tensor: rgb [M, 3]."""
    if xc.is_cuda:
        return launch_fwd_sample(pk or RayPack(ws, bs, cfg), xc.contiguous())
    return color_fwd_plain(ws, bs, xc)


def color_bwd(ws, bs, xc, ct, cfg, pk=None):
    """K7 for a CUDA tensor, the plain version for a CPU tensor: (xcbar
    [M, d_in], dws, dbs) in the layout of ``ws``/``bs``."""
    if xc.is_cuda:
        pk = pk or RayPack(ws, bs, cfg)
        xcbar, dw_pad, db_pad = launch_bwd_sample(pk, xc.contiguous(), ct.contiguous())
        dws, dbs = packing.unpack_grads(dw_pad, db_pad, pk.meta, ws, pk.row_maps)
        return xcbar, dws, dbs
    return color_bwd_plain(ws, bs, xc, ct)


class _ColorSample(torch.autograd.Function):
    """K6 forward, K7 backward, on the dense weights and biases, so that
    autograd carries the weight-norm (v, g) VJP: the JAX custom_vjp
    ``_color_op``."""

    @staticmethod
    def forward(ctx, cfg_key, xc, *wb):
        cfg = dict(cfg_key)
        n_lin = len(wb) // 2
        ws, bs = list(wb[:n_lin]), list(wb[n_lin:])
        pk = RayPack(ws, bs, cfg) if xc.is_cuda else None
        ctx.cfg, ctx.pk, ctx.n_lin = cfg, pk, n_lin
        ctx.save_for_backward(xc, *wb)
        return color_fwd(ws, bs, xc, cfg, pk)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        xc, *wb = ctx.saved_tensors
        ws, bs = wb[:ctx.n_lin], wb[ctx.n_lin:]
        xcbar, dws, dbs = color_bwd(ws, bs, xc, ct, ctx.cfg, ctx.pk)
        return (None, xcbar, *dws, *dbs)


class _ColorRay(torch.autograd.Function):
    """K8 forward, K9 backward, on the dense weights and biases."""

    @staticmethod
    def forward(ctx, cfg_key, sdf_out, pts, dirs, normals, weights, *wb):
        cfg = dict(cfg_key)
        n_lin = len(wb) // 2
        ws, bs = list(wb[:n_lin]), list(wb[n_lin:])
        pk = RayPack(ws, bs, cfg) if pts.is_cuda else None
        ctx.cfg, ctx.pk, ctx.n_lin = cfg, pk, n_lin
        ctx.save_for_backward(sdf_out, pts, dirs, normals, weights, *wb)
        return color_ray_fwd(ws, bs, sdf_out, pts, dirs, normals, weights, cfg, pk)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        sdf_out, pts, dirs, normals, weights, *wb = ctx.saved_tensors
        ws, bs = wb[:ctx.n_lin], wb[ctx.n_lin:]
        featbar, pbar, dbar, nbar, wbar, dws, dbs = color_ray_bwd(
            ws, bs, sdf_out, pts, dirs, normals, weights, ct, ctx.cfg, ctx.pk)
        return (None, featbar, pbar, dbar, nbar, wbar, *dws, *dbs)


def _cfg_key(cfg):
    return (("n_layers", cfg["n_layers"]), ("multires_view", cfg["multires_view"]),
            ("mode", cfg.get("mode", "idr")),
            ("squeeze_out", cfg.get("squeeze_out", True)))


def color_fused_ray(params, cfg, sdf_out, pts, dirs, normals, weights):
    """Composited color [B, 3] of the samples of B rays of N samples each:
    sdf_out [M, 1 + d_feature] (the raw SDF output; column 0 is not read),
    pts, dirs, normals [M, 3], weights [B, N], M = B N.  Gradients flow to
    the parameters (weight norm included), sdf_out's feature columns,
    pts, dirs, normals and weights."""
    ws, bs = materialize(params, cfg)
    return _ColorRay.apply(_cfg_key(cfg), sdf_out, pts, dirs, normals, weights,
                           *ws, *bs)


def color_fused(params, cfg, xc):
    """Per-sample rgb [M, 3] of the color network on prebuilt input rows
    xc [M, d_in] (``nets.color_apply`` with mode idr and squeeze_out): K6
    forward, K7 backward (the plain versions for CPU tensors).  Gradients
    flow to the parameters (weight norm included) and to xc."""
    ws, bs = materialize(params, cfg)
    return _ColorSample.apply(_cfg_key(cfg), xc, *ws, *bs)


def color_fused_featfirst(params, cfg, pts, dirs, normals, feature):
    """The counterpart of the JAX entry of this name: ``color_fused`` on
    the input rows [pts, PE(dirs), normals, feature] built here, pts, dirs
    and normals [M, 3], feature [M, d_feature].  The order is idr, the
    order of ``nets.color_apply`` and of the weights: the JAX entry's
    feature-first column permutation is TPU lane layout and is not
    ported."""
    xc = torch.cat([pts, positional_encode(dirs, cfg["multires_view"]), normals,
                    feature], -1)
    return color_fused(params, cfg, xc)
