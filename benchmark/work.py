"""The work of a training step, counted from shapes, and the card's peaks.

The yardstick of the roofline and utilization metrics.  A step's work is
the fields' mathematics, whatever implements it:

* the SDF network (``sdf``): the gradient-free queries of the up-sampler
  (``query``: the sdf column alone), the forward with the input gradient
  d sdf / d x at every training sample (``fwd_grad``), and the backward
  of both to the weights and the inputs (``bwd``, second order);
* the color network (``color``): its forward and its backward at every
  training sample;
* with ``n_outside`` > 0, the NeRF++ background network (``nerf``): its
  forward and its backward at every sample of the sorted union of the
  inside and the outside z-values (``background_points``).

Operations: 2 a multiply-add, each product counted once, nothing
recomputed.  With ``P`` the sum of in x out over the SDF's linears
(``full``) and ``H`` the same without the last (``hidden``):
``query`` = 2 (H + in_last) M; ``fwd_grad`` = 2 (P + H) M (forward, then
the gradient chain back through the hidden layers); ``bwd`` =
2 (2 P + 2 H) M (each forward and gradient-chain product gives one input
and one weight product); the color network 2 C M forward and 4 C M
backward, C its sum of in x out, and the background network the same
with its own sum N.  Elementwise work (encodings,
activations, compositing) is left out.

Bytes: each input read once and each output written once.  The SDF reads
its points (12 B) and its weights (bf16, f32 biases) and writes the
outputs it is asked for (sdf 4 B; all d_out channels and the gradient,
12 B); its backward reads the points, the cotangents of its outputs and
the weights, and writes the points' cotangent and the f32 weight
gradients.  The color network reads points, directions, normals and
features, and writes colors; its backward reads those and the colors'
cotangent and writes the inputs' cotangents and the f32 weight gradients.
The background network reads its points (4 floats) and directions (3)
and f32 weights, and writes density and colors (1 + 3); its backward
reads those and the outputs' cotangent and writes the inputs' cotangents
and the f32 weight gradients.

The least time of a call is the larger of its operations over the bf16
dense peak and its bytes over the memory rate.  Peaks: NVIDIA's H100 SXM
data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12     # bf16 dense tensor-core peak, FLOP/s
PEAK_BYTES = 3.35e12    # HBM3, bytes/s


def _pe(multires, d=3):
    return d * (1 + 2 * multires)


def sdf_layers(cfg):
    """[(in, out)] of the SDF network's linears (the producer of the skip
    layer's input is d_hidden - pe wide)."""
    dims = [_pe(cfg["multires"], cfg["d_in"])] + [cfg["d_hidden"]] * cfg["n_layers"] \
        + [cfg["d_out"]]
    skip = tuple(cfg["skip_in"])
    return [(dims[l], dims[l + 1] - dims[0] if (l + 1) in skip else dims[l + 1])
            for l in range(len(dims) - 1)]


def color_layers(cfg):
    dims = [cfg["d_in"] + cfg["d_feature"] + _pe(cfg["multires_view"]) - 3] \
        + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]
    return [(dims[l], dims[l + 1]) for l in range(len(dims) - 1)]


def nerf_layers(cfg):
    """[(in, out)] of the background network's linears: the point MLP (the
    layer after a skip takes the encoded point again), then ``feature``,
    ``alpha``, ``views0`` (feature and encoded direction) and ``rgb``."""
    W = cfg["W"]
    c, cv = _pe(cfg["multires"], cfg["d_in"]), _pe(cfg["multires_view"], cfg["d_in_view"])
    skips = tuple(cfg["skips"])
    pts = [(c, W)] + [(W + c if i in skips else W, W) for i in range(cfg["D"] - 1)]
    return pts + [(W, W), (W, 1), (W + cv, W // 2), (W // 2, 3)]


def _weight_bytes(layers, wbytes=2):
    return sum(wbytes * i * o + 4 * o for i, o in layers)


def sdf_work(cfg, M, kind):
    """(FLOPs, bytes) of the SDF network's ``kind`` ("query", "fwd_grad",
    "bwd") on M points."""
    layers = sdf_layers(cfg)
    full = sum(i * o for i, o in layers)
    hidden = sum(i * o for i, o in layers[:-1])
    in_last = layers[-1][0]
    d_out = layers[-1][1]
    w_in = _weight_bytes(layers)
    if kind == "query":
        return 2 * (hidden + in_last) * M, M * (12 + 4) + w_in
    if kind == "fwd_grad":
        return 2 * (full + hidden) * M, M * (12 + 4 * d_out + 12) + w_in
    if kind == "bwd":
        w_grads = sum(4 * i * o + 4 * o for i, o in layers)
        return (2 * (2 * full + 2 * hidden) * M,
                M * (12 + 4 * d_out + 12 + 12) + w_in + w_grads)
    raise ValueError(kind)


def color_work(cfg, M, kind):
    """(FLOPs, bytes) of the color network's ``kind`` ("fwd", "bwd") on M
    samples."""
    layers = color_layers(cfg)
    prods = sum(i * o for i, o in layers)
    ins = 4 * (3 + 3 + 3 + cfg["d_feature"])
    w_in = _weight_bytes(layers)
    if kind == "fwd":
        return 2 * prods * M, M * (ins + 12) + w_in
    if kind == "bwd":
        w_grads = sum(4 * i * o + 4 * o for i, o in layers)
        return 4 * prods * M, M * (ins + 12 + ins) + w_in + w_grads
    raise ValueError(kind)


def nerf_work(cfg, M, kind):
    """(FLOPs, bytes) of the background network's ``kind`` ("fwd", "bwd")
    on M samples."""
    layers = nerf_layers(cfg)
    prods = sum(i * o for i, o in layers)
    ins, outs = 4 * (4 + 3), 4 * (1 + 3)
    w_in = _weight_bytes(layers, 4)
    if kind == "fwd":
        return 2 * prods * M, M * (ins + outs) + w_in
    if kind == "bwd":
        w_grads = sum(4 * i * o + 4 * o for i, o in layers)
        return 4 * prods * M, M * (ins + outs + ins) + w_in + w_grads
    raise ValueError(kind)


def least_s(flops, nbytes):
    """The least seconds the card could take for (flops, bytes)."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def step_points(model, rays):
    """(up-sampler query points, training samples) of a step of ``rays``
    rays under the conf's renderer: the coarse samples and every
    up-sampling pass but the last are queried."""
    r = model["neus_renderer"]
    n_s, n_i, steps = r["n_samples"], r["n_importance"], r["up_sample_steps"]
    query = 0
    if n_i > 0:
        query = rays * n_s + (steps - 1) * rays * (n_i // steps)
    return query, rays * (n_s + n_i)


def background_points(model, rays):
    """The background network's samples in a step of ``rays`` rays: every
    inside and outside z-value, or 0 without a background."""
    r = model["neus_renderer"]
    n_out = r.get("n_outside", 0)
    return rays * (r["n_samples"] + r["n_importance"] + n_out) if n_out > 0 else 0


def step_calls(model, rays):
    """{"sdf": [(flops, bytes)], "color": [...]}, and "nerf" with a
    background: a training step's calls."""
    q, m = step_points(model, rays)
    sdf_cfg, col_cfg = model["sdf_network"], model["rendering_network"]
    sdf = [sdf_work(sdf_cfg, m, "fwd_grad"), sdf_work(sdf_cfg, m, "bwd")]
    if q:
        sdf.insert(0, sdf_work(sdf_cfg, q, "query"))
    calls = {"sdf": sdf,
             "color": [color_work(col_cfg, m, "fwd"), color_work(col_cfg, m, "bwd")]}
    b = background_points(model, rays)
    if b:
        calls["nerf"] = [nerf_work(model["nerf"], b, "fwd"), nerf_work(model["nerf"], b, "bwd")]
    return calls


def step_flops(model, rays):
    return sum(f for calls in step_calls(model, rays).values() for f, _ in calls)


def field_least_s(model, rays, field):
    """The least seconds of a step's ``field`` ("sdf", "color" or "nerf")
    work."""
    return sum(least_s(f, b) for f, b in step_calls(model, rays)[field])
