"""The workspace of K5 and K3, the second-order SDF backward
(``fmov_pose_torch/ops/fused_sdf.py``, ``bwd_workspace_specs``), and the
build line of ``chip_smoke.py`` that reports the per-point kernels on the
pipeline (K1, K4, K2, K5, K3, and the color MLP's K8, K6, K9 and K7) and
the weight-gradient stage's ``wgrad_kernel``.

The kernels read the workspace through a pointer table in the order of
``sdf_bwd_launch`` (``ops/csrc/sdf_pipe.cuh``): AB_l ([FB_l; X_l]),
BB_l ([D_l; ZB_l]), SIG_l, DS_l, ZC_l, then the partial sums.  The bf16
operands of the weight-gradient product stay row-major; the f32 arrays
that only the per-point pass reads back are stored in its fragment order,
each 64-row tile of a [M_pad, W] array as one row of 64 W values.  So the
table keeps its count and order, and each array its bytes.  The kernels
themselves run only on the card (the ``cuda``-marked tests of
``test_torch_fused_rays.py`` and ``test_torch_fused_flat.py``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_sdf, packing

FULL = {"d_out": 257, "d_in": 3, "d_hidden": 256, "n_layers": 8, "skip_in": (4,),
        "multires": 6, "bias": 0.5, "scale": 1.0, "geometric_init": True,
        "weight_norm": True}
SMALL = {"d_out": 17, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
         "multires": 3, "bias": 0.5, "scale": 0.8, "geometric_init": True,
         "weight_norm": True}


def _pack(cfg):
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(0), cfg))), cfg)
    return fused_sdf.RaysPack(ws, bs, cfg)


def _bytes(rows, width, dtype):
    return rows * width * torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("cfg,M", [(FULL, 65536), (SMALL, 1000), (SMALL, 64)],
                         ids=["full-65536", "small-1000", "small-64"])
def test_bwd_workspace_table(cfg, M):
    pk = _pack(cfg)
    t = pk.table.tolist()
    L = pk.n_lin
    M_pad = packing.round_up(M, packing.TILE_M)
    G, KS = 7, 3
    specs, n_bias = fused_sdf.bwd_workspace_specs(pk.table, M_pad, G, KS,
                                                  packing.dw_elems(pk.meta))
    names = [s[0] for s in specs]
    assert names == ([f"AB{l}" for l in range(L)] + [f"BB{l}" for l in range(L)]
                     + [f"SIG{l}" for l in range(L - 1)]
                     + [f"DS{l}" for l in range(1, L - 1)]
                     + [f"ZC{l}" for l in range(L - 1)] + ["DBPART", "CBPART", "DWPART"])
    assert n_bias == sum(row[1] for row in t)
    # row-major bf16 operands: [FB_l; X_l] and [D_l; ZB_l] over 2 M_pad rows
    for l in range(L):
        assert specs[l][1:] == (2 * M_pad, t[l][0], torch.bfloat16)
        assert specs[L + l][1:] == (2 * M_pad, t[l][1], torch.bfloat16)
    # f32 arrays in fragment order: a row per 64-point tile, the bytes of
    # the row-major [M_pad, W] array
    widths = ([t[l][1] for l in range(L - 1)] + [t[l - 1][1] for l in range(1, L - 1)]
              + [t[l][1] for l in range(L - 1)])
    for (_, rows, width, dtype), w in zip(specs[2 * L:-3], widths):
        assert dtype == torch.float32 and rows == M_pad // packing.TILE_M
        assert width == packing.TILE_M * w and w % 16 == 0
        assert _bytes(rows, width, dtype) == _bytes(M_pad, w, torch.float32)
    assert specs[-3:] == [("DBPART", G, n_bias, torch.float32),
                          ("CBPART", G, t[-2][1], torch.float32),
                          ("DWPART", KS, packing.dw_elems(pk.meta), torch.float32)]
    if cfg is FULL:
        # 8x256 at M = 65,536: 1.16 GB of bf16 operands and 1.52 GB of f32
        # per-point arrays, as before the fragment order
        per_point = [_bytes(r, w, d) for _, r, w, d in specs[:-3]]
        assert sum(per_point[:2 * L]) == 1_161_822_208
        assert sum(per_point[2 * L:]) == 1_518_338_048


def test_bwd_workspace_pointer_order():
    """The allocated table holds one address per array, 256-byte aligned
    within the buffer, in the order of the specs, each array viewed at its
    shape."""
    pk = _pack(SMALL)
    M_pad = packing.round_up(1000, packing.TILE_M)
    ws_, n_bias = fused_sdf._bwd_workspace(pk, M_pad, 2, 1, torch.device("cpu"))
    specs, n_bias2 = fused_sdf.bwd_workspace_specs(pk.table, M_pad, 2, 1,
                                                   packing.dw_elems(pk.meta))
    assert n_bias == n_bias2 and len(ws_.table) == len(specs)
    assert all((int(a) - int(ws_.table[0])) % 256 == 0 for a in ws_.table)
    assert np.all(np.diff(ws_.table.astype(np.int64)) > 0)
    for (name, rows, width, dtype), addr in zip(specs, ws_.table):
        arr = ws_.arrays[name]
        assert arr.shape == (rows, width) and arr.dtype == dtype
        assert arr.data_ptr() == int(addr)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN10fmov_train12_GLOBAL__N_114sdf_bwd_kernelENS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN10fmov_train12_GLOBAL__N_114sdf_bwd_kernelENS_7BwdArgsE
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 251 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN7fmov_wg13reduce_kernelEPKfiiPfS2_iiS3_S2_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN7fmov_wg13reduce_kernelEPKfiiPfS2_iiS3_S2_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN7fmov_wg12wgrad_kernelENS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN7fmov_wg12wgrad_kernelENS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_build_line_names_the_per_point_kernels():
    """chip_smoke's build line reads each kernel's registers and spills
    from ptxas -v by the kernel's own name."""
    got = chip_smoke._ptxas_entries(PTXAS_LOG)
    assert got == {
        "sdf_bwd_kernel": {"registers": 251, "spill_stores": 0, "spill_loads": 0},
        "reduce_kernel": {"registers": 32, "spill_stores": 0, "spill_loads": 0},
        "wgrad_kernel": {"registers": 168, "spill_stores": 4, "spill_loads": 8}}
    assert chip_smoke.STAGE == ("wgrad_kernel",)
    assert chip_smoke._kernel_name(
        "_ZN10fmov_train12_GLOBAL__N_119sdf_bwd_flat_kernelENS_7BwdArgsE") \
        == "sdf_bwd_flat_kernel"
    assert chip_smoke._kernel_name(
        "_ZN10fmov_train12_GLOBAL__N_119sdf_fwd_grad_kernelENS_7SdfArgsEPfiS2_S2_") \
        == "sdf_fwd_grad_kernel"
    assert chip_smoke._kernel_name(
        "_ZN10fmov_train12_GLOBAL__N_124sdf_fwd_grad_flat_kernelENS_7SdfArgsEPfiS2_") \
        == "sdf_fwd_grad_flat_kernel"
    assert chip_smoke._kernel_name(
        "_ZN10fmov_train12_GLOBAL__N_116color_bwd_kernelENS0_9ColorArgsE") \
        == "color_bwd_kernel"
    assert chip_smoke._kernel_name(
        "_ZN10fmov_train12_GLOBAL__N_123color_sample_bwd_kernelENS0_10SampleArgsE") \
        == "color_sample_bwd_kernel"
    assert chip_smoke._kernel_name(
        "_ZN10fmov_train12_GLOBAL__N_116color_fwd_kernelENS0_9ColorArgsE") \
        == "color_fwd_kernel"
    assert chip_smoke._kernel_name(
        "_ZN10fmov_train12_GLOBAL__N_123color_sample_fwd_kernelENS0_10SampleArgsE") \
        == "color_sample_fwd_kernel"
    assert set(chip_smoke.PER_POINT) == {"sdf_fwd_kernel",
                                          "sdf_fwd_grad_kernel", "sdf_fwd_grad_flat_kernel",
                                          "sdf_bwd_kernel", "sdf_bwd_flat_kernel",
                                          "color_fwd_kernel", "color_sample_fwd_kernel",
                                          "color_bwd_kernel", "color_sample_bwd_kernel"}


K1_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN10fmov_train12_GLOBAL__N_114sdf_fwd_kernelENS_7SdfArgsEPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN10fmov_train12_GLOBAL__N_114sdf_fwd_kernelENS_7SdfArgsEPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_build_line_names_k1():
    """K1's per-point kernel is read by its own name (``sdf_fwd_kernel``,
    not a prefix of K4's ``sdf_fwd_grad_kernel``) and is one of the
    kernels the line names."""
    assert chip_smoke._ptxas_entries(K1_PTXAS_LOG) == {
        "sdf_fwd_kernel": {"registers": 168, "spill_stores": 0, "spill_loads": 0}}
    assert "sdf_fwd_kernel" in chip_smoke.PER_POINT
