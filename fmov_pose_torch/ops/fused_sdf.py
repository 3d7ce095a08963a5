"""Fused gradient-free SDF forward: CUDA kernel, plain version, entry points.

Replaces the Pallas kernel ``fmov_pose_tpu/ops/fused_sdf.py:_make_fwd_kernel``
(launched by ``_sdf_forward_impl``; entries ``sdf_only_fused`` and
``sdf_apply_fused``).  The kernel is ``csrc/sdf_fwd.cu``: per point, the
positional encoding, the 9-linear SDF MLP with softplus(beta=100) and the
skip concat /sqrt(2), and sdf/scale (plus the 256 features when asked).
Its arithmetic is the TPU kernel's: f32 inputs, biases and outputs, and
every product of bf16-rounded operands accumulated in f32.

What bounds it on an H100: about 1.05 MFLOP per point against 12 bytes in
and 4 (or 1,028) bytes out.  The training step's up-sampler queries
57,344 points (32,768 + 3 x 8,192) per step, ~60 GFLOP, so the kernel is
compute- and shared-memory-bound, never bandwidth-bound.  Its design
keeps a 64-point tile's activations in shared memory across all layers,
streams each layer's weights (1 MB in bf16, too big for shared memory)
through a 32-row buffer, and runs the products on tensor cores (wmma bf16
with f32 accumulation).  See the source's header for the layout.

Beside it:

* ``sdf_forward_plain`` — the same arithmetic in PyTorch (operands rounded
  with ``.bfloat16().float()`` and multiplied in f32: a bf16 ``matmul``
  would also round its output).  The CPU tests hold it against the JAX
  kernel in interpret mode; ``chip_smoke.py`` holds the kernel against it.
* ``sdf_only_fused`` / ``sdf_apply_fused`` — a CUDA tensor launches the
  kernel (or raises); a CPU tensor takes the plain version, the port's
  counterpart of the JAX package's interpret mode.  Their backward
  differentiates the plain f32 ``nets`` functions, as the JAX custom_vjp
  does; the TPU kernel has no backward kernel, so neither has this one.
* ``LAUNCHES`` — kernel launches so far, counted where the kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from fmov_pose_torch import convert
from fmov_pose_torch.core.embedder import positional_encode
from fmov_pose_torch.fields import nets

LAUNCHES = 0

KCHUNK = 32        # K padding of the packed weights (csrc/sdf_fwd.cu KCHUNK)
MAX_COLS = 384     # widest layer the kernel takes (8 warps x 3 column tiles)
MAX_LIN = 16

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _skip(cfg) -> int:
    return tuple(cfg.get("skip_in", (4,)))[0]


def supported(cfg) -> bool:
    """The configurations the kernel takes (``ops/fused_sdf.py:supported``
    of the JAX package without its backend test: here the tensor's device
    picks kernel or plain version).  The skip layer must have a layer
    before it: ``pack`` lays its input out as [h | xe]."""
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
        h = nets.softplus100(z) if l < n_lin - 1 else z
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


def pack(ws, bs, cfg, want_feature: bool):
    """Zero-padded bf16 W^T blocks and f32 biases in one buffer each, plus
    the kernel's int32 layer table.

    Layer l's block is [Kp, Np]: Np = N rounded up to 16, Kp its input
    width rounded up to KCHUNK.  The inputs are laid out padded: the
    encoding is ``pe_pad`` wide, and the skip layer reads
    [h (Np of the layer before) | xe (pe_pad)], so its rows are re-mapped.
    Without the feature, only column 0 of the last layer is packed."""
    skip = _skip(cfg)
    n_lin = len(ws)
    pe_dim = ws[0].shape[0]
    pe_pad = _round_up(pe_dim, 16)
    if n_lin > MAX_LIN:
        raise ValueError(f"{n_lin} linears; the kernel takes at most {MAX_LIN}")
    dev = ws[0].device
    blocks, metas = [], [n_lin, skip, cfg["multires"]]
    w_off = b_off = 0
    b_parts = []
    np_prev = None
    for l in range(n_lin):
        w = ws[l] if (want_feature or l < n_lin - 1) else ws[l][:, :1]
        b = bs[l] if (want_feature or l < n_lin - 1) else bs[l][:1]
        k, n = w.shape
        n_pad = _round_up(n, 16)
        if n_pad > MAX_COLS:
            raise ValueError(f"layer {l} is {n} wide; the kernel takes <= {MAX_COLS}")
        if l == 0:
            in_w = pe_pad
            rows = [(0, 0, k)]
        elif l == skip:
            in_w = np_prev + pe_pad
            n_h = ws[l - 1].shape[1]
            rows = [(0, 0, n_h), (n_h, np_prev, k - n_h)]
        else:
            in_w = np_prev
            rows = [(0, 0, k)]
        k_pad = _round_up(in_w, KCHUNK)
        block = torch.zeros((k_pad, n_pad), dtype=torch.bfloat16, device=dev)
        for src, dst, cnt in rows:
            block[dst:dst + cnt, :n] = w[src:src + cnt].to(torch.bfloat16)
        blocks.append(block.reshape(-1))
        b_pad = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        b_pad[:n] = b
        b_parts.append(b_pad)
        metas += [k_pad, n_pad, n, w_off, b_off]
        w_off += k_pad * n_pad
        b_off += n_pad
        np_prev = n_pad
    return (torch.cat(blocks), torch.cat(b_parts),
            np.asarray(metas, dtype=np.int32))


def _lib():
    from fmov_pose_torch.ops import build
    lib = build.library("sdf_fwd")
    if not getattr(lib, "_fmov_typed", False):
        lib.fmov_sdf_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.fmov_sdf_fwd.restype = ctypes.c_int
        lib.fmov_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fmov_cuda_error_string.restype = ctypes.c_char_p
        lib._fmov_typed = True
    return lib


def sdf_forward_cuda(ws, bs, x, cfg, want_feature: bool) -> torch.Tensor:
    """Pack the weights and launch the kernel on x's device and stream;
    raises on anything it does not take or on a refused launch."""
    if not supported(cfg):
        raise ValueError(f"SDF config not supported by the kernel: {cfg}")
    if any(w.device != x.device for w in ws):
        raise ValueError("weights and points on different devices")
    return launch(pack(ws, bs, cfg, want_feature), x.contiguous(),
                  float(cfg.get("scale", 1.0)))


def launch(packed, x, scale: float) -> torch.Tensor:
    """One kernel launch on pre-packed weights (``pack``) and a CUDA
    float32 [M, 3] ``x``; the only place that counts LAUNCHES."""
    global LAUNCHES
    w_buf, b_buf, meta = packed
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 2
            and x.shape[1] == 3 and x.is_contiguous()):
        raise ValueError(f"x must be a contiguous CUDA float32 [M, 3] tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if (w_buf.device != x.device or b_buf.device != x.device
            or w_buf.dtype != torch.bfloat16 or b_buf.dtype != torch.float32
            or w_buf.data_ptr() % 16):
        raise ValueError("packed weights must be bf16 / f32 buffers on x's "
                         "device, 16-byte aligned")
    n_out = int(meta[3 + 5 * (int(meta[0]) - 1) + 2])
    out = torch.empty((x.shape[0], n_out), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fmov_sdf_fwd(
            x.data_ptr(), x.shape[0], scale, w_buf.data_ptr(), b_buf.data_ptr(),
            meta.ctypes.data_as(ctypes.c_void_p), int(meta.size),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"sdf_fwd kernel launch failed: {lib.fmov_cuda_error_string(err).decode()}"
            f" (cudaError {err}, M={x.shape[0]})")
    LAUNCHES += 1
    return out


def sdf_forward(ws, bs, x, cfg, want_feature: bool) -> torch.Tensor:
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if x.is_cuda:
        return sdf_forward_cuda(ws, bs, x, cfg, want_feature)
    return sdf_forward_plain(ws, bs, x, cfg, want_feature)


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
        ws, bs = materialize(convert.unflatten(zip(names, leaves)), cfg)
        ctx.cfg, ctx.names, ctx.want_feature = cfg, names, want_feature
        ctx.save_for_backward(x, *leaves)
        return sdf_forward(ws, bs, x, cfg, want_feature)

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
