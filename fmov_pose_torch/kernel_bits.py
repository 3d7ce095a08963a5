"""The per-point kernels' outputs on seeded inputs, saved so that two
builds of the kernels can be compared bit for bit (a change that must not
move a bit, such as moving shared tile code, is checked so).

    python -m fmov_pose_torch.kernel_bits OUT.pt                 # needs CUDA
    python -m fmov_pose_torch.kernel_bits OUT.pt --against REF.pt

K1 at the full width of the SDF network of ``confs/ho3d_global_womask.conf``
(8x256), through its entries ``sdf_only_fused`` and ``sdf_apply_fused`` at
M = 32,768, 8,192 (the up-sampler's) and 1,000.  At the full widths of
``confs/ho3d_global_womask_tpu_fast.conf`` (the SDF 8x256, the color
network 4x256 on the 289-wide input), through the bare launches on packed
weights: K4 (``launch_fwd_grad``) and K5 (``launch_bwd``) at M = 65,536
and 384, K2 (``launch_fwd_grad_flat``) and K3 (``launch_bwd_flat``) at
32,768 and 1,000, K8 (``launch_fwd``) and K9 (``launch_bwd``) at 512 x 128
and 3 x 128 samples, K6 (``launch_fwd_sample``) and K7
(``launch_bwd_sample``) at 65,536 and 1,000.  Weights and inputs come from
``--seed`` through numpy (the SDF kernels' and the color kernels' from two
streams), so every build sees the same values; the entry points used exist
unchanged since K2's port, so an older tree runs this file as it is.
Prints one JSON line; with ``--against``, each output's bitwise equality
with REF's, and exits 1 where one differs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE1_CONF = os.path.join(ROOT, "confs", "ho3d_global_womask.conf")
CONF = os.path.join(ROOT, "confs", "ho3d_global_womask_tpu_fast.conf")


def _cfg(conf, section):
    from fmov_pose_torch.data import hocon
    cfg = hocon.parse_file(conf)[f"model.{section}"].as_plain_dict()
    if "skip_in" in cfg:
        cfg["skip_in"] = tuple(cfg["skip_in"])
    return cfg


def _sdf_outputs(dev, rng):
    """{name: tensor} of K1-K5's launches."""
    import numpy as np
    import torch

    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_sdf

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def pts(M):  # inside the unit sphere, where the renderer queries
        return torch.from_numpy(rng.uniform(-0.9, 0.9, (M, 3)).astype(np.float32)).to(dev)

    out = {}
    cfg1 = _cfg(SLICE1_CONF, "sdf_network")
    params = convert.to_torch(convert.to_numpy(nets.init_sdf(rng, cfg1)), dev)
    for M in (32768, 8192, 1000):
        x = pts(M)
        out[f"K1_sdf_only_{M}"] = fused_sdf.sdf_only_fused(params, cfg1, x)
        out[f"K1_sdf_apply_{M}"] = fused_sdf.sdf_apply_fused(params, cfg1, x)

    cfg = _cfg(CONF, "sdf_network")
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        nets.init_sdf(rng, cfg)), dev), cfg)
    pk = fused_sdf.RaysPack(ws, bs, cfg)
    for M in (65536, 384):
        x = pts(M)
        for name, v in zip(("out", "sdf", "grad"), fused_sdf.launch_fwd_grad(pk, x)):
            out[f"K4_{name}_{M}"] = v
        cts = (t(M, pk.n_out), t(M), t(M, 3))
        for name, v in zip(("xbar", "dw", "db"), fused_sdf.launch_bwd(pk, x, *cts)):
            out[f"K5_{name}_{M}"] = v
    for M in (32768, 1000):
        xe = fused_sdf.pe_parts(pts(M) * cfg["scale"], cfg["multires"])[0].contiguous()
        for name, v in zip(("out", "d_inputs"), fused_sdf.launch_fwd_grad_flat(pk, xe)):
            out[f"K2_{name}_{M}"] = v
        cts = (t(M, pk.n_out), t(M, xe.shape[1]))
        for name, v in zip(("xebar", "dw", "db"), fused_sdf.launch_bwd_flat(pk, xe, *cts)):
            out[f"K3_{name}_{M}"] = v
    return out


def _color_outputs(dev, rng):
    """{name: tensor} of K6-K9's launches."""
    import numpy as np
    import torch

    from fmov_pose_torch import convert
    from fmov_pose_torch.fields import nets
    from fmov_pose_torch.ops import fused_color

    cfg = _cfg(CONF, "rendering_network")
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        nets.init_color(rng, cfg)), dev), cfg)
    pk = fused_color.RayPack(ws, bs, cfg)
    d_sdf = cfg["d_feature"] + 1

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    out = {}
    for B, N in ((512, 128), (3, 128)):
        M = B * N
        d = t(M, 3)
        geo = (t(M, d_sdf), t(M, 3, scale=0.5), d / d.norm(dim=-1, keepdim=True),
               t(M, 3), t(B, N).abs() / N)
        out[f"K8_color_{M}"] = fused_color.launch_fwd(pk, *geo)
        for name, v in zip(("featbar", "ubar", "d_weights", "dw", "db"),
                           fused_color.launch_bwd(pk, *geo, t(B, 3))):
            out[f"K9_{name}_{M}"] = v
    for M in (65536, 1000):
        xc = t(M, pk.d_in)
        out[f"K6_rgb_{M}"] = fused_color.launch_fwd_sample(pk, xc)
        for name, v in zip(("xcbar", "dw", "db"),
                           fused_color.launch_bwd_sample(pk, xc, t(M, 3, scale=0.01))):
            out[f"K7_{name}_{M}"] = v
    return out


def outputs(dev, seed=0):
    """{name: tensor on the CPU} of K1-K9's launches."""
    import numpy as np
    import torch

    with torch.no_grad():
        out = _sdf_outputs(dev, np.random.default_rng([seed, 1]))
        out.update(_color_outputs(dev, np.random.default_rng(seed)))
    torch.cuda.synchronize(dev)
    return {k: v.cpu() for k, v in out.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out")
    parser.add_argument("--against", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from fmov_pose_torch.device import require_cuda
    got = outputs(require_cuda(), args.seed)
    torch.save(got, args.out)
    line = {"phase": "kernel_bits", "device": torch.cuda.get_device_name(0),
            "saved": args.out, "outputs": len(got)}
    same = True
    if args.against:
        ref = torch.load(args.against)
        equal = {k: k in ref and torch.equal(v, ref[k]) for k, v in got.items()}
        same = all(equal.values()) and set(ref) == set(got)
        line.update(against=args.against, bitwise_equal=same, per_output=equal)
    print(json.dumps(line), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
