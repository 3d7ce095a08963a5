"""The benchmark's initial weights, made on the device from the seed.

Every leaf is drawn from one device generator in two calls (all the
normal draws, then all the uniform ones) and carved up: the SDF network's
geometric (sphere) init of IDR/NeuS, ``nn.Linear``'s default init for the
color and background networks and the pose nets' first layers, the pose
heads at N(0, 0.01) (the scale head's bias 1, the translation head 0),
the Gaussian-Fourier bands at N(0, 10), and the variance at its conf
value.  Weight-normed layers hold (v, g = |v| a row, b).

The names are the trainable leaves' dotted paths (``sdf.layers.lin0.v``,
``pose.lin1.w``; a segment bank's ``lin1.w`` with a leading segment axis),
so the harness writes them into the program's buffers by name, and the
reference reads the same tensors.
"""

from __future__ import annotations

import math

import torch

EMBED = 128          # Gaussian-Fourier bands of a pose net
POSE_HIDDEN = 64
BAND_SCALE = 10.0


def _pe(multires, d=3):
    return d * (1 + 2 * multires)


def _sdf_specs(cfg):
    """(name, shape, kind, arg) of the SDF network's leaves."""
    dims = [_pe(cfg["multires"], cfg["d_in"])] + [cfg["d_hidden"]] * cfg["n_layers"] \
        + [cfg["d_out"]]
    skip = tuple(cfg["skip_in"])
    n_lin = len(dims) - 1
    out = []
    for l in range(n_lin):
        o = dims[l + 1] - dims[0] if (l + 1) in skip else dims[l + 1]
        i = dims[l]
        std = math.sqrt(2) / math.sqrt(o)
        if l == n_lin - 1:
            spec = ("normal_mean", (math.sqrt(math.pi) / math.sqrt(i), 1e-4), -cfg["bias"])
        elif l == 0:
            spec = ("normal_cols", (std, 0, 3), 0.0)          # only x, y, z
        elif l in skip:
            spec = ("normal_cols", (std, 0, i - (dims[0] - 3)), 0.0)  # not the PE tail
        else:
            spec = ("normal_cols", (std, 0, i), 0.0)
        out.append((f"sdf.layers.lin{l}", (o, i), spec))
    return out


def _uniform_linear(name, i, o):
    b = 1.0 / math.sqrt(i)
    return (name, (o, i), ("uniform", b, b))


def _color_specs(cfg):
    dims = [cfg["d_in"] + cfg["d_feature"] + _pe(cfg["multires_view"]) - 3] \
        + [cfg["d_hidden"]] * cfg["n_layers"] + [cfg["d_out"]]
    return [_uniform_linear(f"color.layers.lin{l}", dims[l], dims[l + 1])
            for l in range(len(dims) - 1)]


def _nerf_specs(cfg):
    D, W = cfg["D"], cfg["W"]
    c = _pe(cfg["multires"], cfg["d_in"])
    cv = _pe(cfg["multires_view"], cfg["d_in_view"])
    skips = tuple(cfg["skips"])
    out = [_uniform_linear("nerf.pts.lin0", c, W)]
    out += [_uniform_linear(f"nerf.pts.lin{i + 1}", W + c if i in skips else W, W)
            for i in range(D - 1)]
    return out + [_uniform_linear("nerf.views0", cv + W, W // 2),
                  _uniform_linear("nerf.feature", W, W),
                  _uniform_linear("nerf.alpha", W, 1),
                  _uniform_linear("nerf.rgb", W // 2, 3)]


def _pose_specs(prefix, emphasize_rot, lead=()):
    out = [(f"{prefix}lin1", lead + (POSE_HIDDEN, 2 * EMBED),
            ("uniform", 1 / math.sqrt(2 * EMBED), 1 / math.sqrt(2 * EMBED))),
           (f"{prefix}lin2", lead + (POSE_HIDDEN, POSE_HIDDEN),
            ("uniform", 1 / math.sqrt(POSE_HIDDEN), 1 / math.sqrt(POSE_HIDDEN)))]
    heads = ((("lin3_rot", 3, 0.01, 0.0), ("lin3_trans", 3, 0.0, 0.0),
              ("lin3_scale", 1, 0.01, 1.0)) if emphasize_rot else (("lin3", 6, 0.01, 0.0),))
    for name, o, std, bias in heads:
        out.append((f"{prefix}{name}", lead + (o, POSE_HIDDEN), ("head", std, bias)))
    return out


def make(model: dict, pose: dict, seed: int, device) -> dict:
    """{"fields": {name: tensor}, "pose_bands": [E, 1] or [S, E, 1],
    "bank": {name: tensor} or None}.  ``model``: the conf's sdf_network,
    rendering_network, nerf and variance_network; ``pose``: {"mode": "gf" |
    "seg", "emphasize_rot", "segments"}."""
    specs = (_sdf_specs(model["sdf_network"]) + _color_specs(model["rendering_network"])
             + _nerf_specs(model["nerf"]))
    wn = {"sdf": model["sdf_network"]["weight_norm"],
          "color": model["rendering_network"]["weight_norm"], "nerf": False}
    S = pose.get("segments", 1)
    bank_specs = []
    if pose["mode"] == "gf":
        specs += _pose_specs("pose.", pose["emphasize_rot"])
        bands_shape = (EMBED, 1)
    else:
        bank_specs = _pose_specs("", pose["emphasize_rot"], (S,))
        bands_shape = (S, EMBED, 1)
    all_specs = specs + bank_specs

    def numel(shape):
        return math.prod(shape)

    n_normal = sum(numel(s) for _, s, k in all_specs if k[0] != "uniform") + numel(bands_shape)
    n_uniform = sum(numel(s) + numel(s[:-1]) for _, s, k in all_specs if k[0] == "uniform")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    pos = {"n": 0, "u": 0}

    def take(kind, shape):
        buf, key = (normal, "n") if kind == "n" else (uniform, "u")
        t = buf[pos[key]:pos[key] + numel(shape)].view(shape)
        pos[key] += numel(shape)
        return t

    def leaf(name, shape, kind):
        out_dim = shape[-2]
        lead = shape[:-2]
        if kind[0] == "uniform":
            w = take("u", shape) * kind[1]
            b = take("u", lead + (out_dim,)) * kind[2]
        elif kind[0] == "head":
            w = take("n", shape) * kind[1]
            b = torch.full(lead + (out_dim,), float(kind[2]), device=device)
        elif kind[0] == "normal_mean":
            mean, std = kind[1]
            w = mean + std * take("n", shape)
            b = torch.full((out_dim,), float(kind[2]), device=device)
        else:  # normal_cols: N(0, std) on columns [lo, hi), 0 elsewhere
            std, lo, hi = kind[1]
            w = torch.zeros(shape, device=device)
            w[:, lo:hi] = std * take("n", (shape[0], hi - lo))
            b = torch.full((out_dim,), float(kind[2]), device=device)
        net = name.split(".")[0]
        if wn.get(net, False):
            return {f"{name}.v": w, f"{name}.g": torch.linalg.norm(w, dim=1),
                    f"{name}.b": b}
        return {f"{name}.w": w, f"{name}.b": b}

    fields = {}
    for name, shape, kind in specs:
        fields.update(leaf(name, shape, kind))
    fields["variance.variance"] = torch.tensor(
        float(model["variance_network"]["init_val"]), device=device)
    bank = {}
    for name, shape, kind in bank_specs:
        bank.update(leaf(name, shape, kind))
    bands = take("n", bands_shape) * BAND_SCALE
    return {"fields": {k: v.contiguous() for k, v in fields.items()},
            "bank": {k: v.contiguous() for k, v in bank.items()} or None,
            "pose_bands": bands.contiguous()}
