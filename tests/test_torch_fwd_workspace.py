"""The workspace of K4 and K2, the SDF forward with its gradient chain
(``fmov_pose_torch/ops/fused_sdf.py``, ``fwd_workspace_specs``).

The kernels keep each product's A operand (the layer inputs X_l and the
chain's D_l) in shared memory; only the sigmoids SIG_0..SIG_{L-2}, which
the reverse chain reads back, go to device memory, through a pointer table
in the order of ``sdf_fwd_launch`` (``ops/csrc/sdf_pipe.cuh``).  They are
stored in the per-point pass's fragment order, each 64-row tile of a
[M_pad, np(l)] array as one row of 64 np(l) values.  The kernels
themselves run only on the card (the ``cuda``-marked tests of
``test_torch_fused_rays.py`` and ``test_torch_fused_flat.py``).
"""

import numpy as np
import pytest
import torch

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
def test_fwd_workspace_table(cfg, M):
    pk = _pack(cfg)
    t = pk.table.tolist()
    L = pk.n_lin
    M_pad = packing.round_up(M, packing.TILE_M)
    specs = fused_sdf.fwd_workspace_specs(pk.table, M_pad)
    assert [s[0] for s in specs] == [f"SIG{l}" for l in range(L - 1)]
    # f32 in fragment order: a row per 64-point tile, the bytes of the
    # row-major [M_pad, np(l)] array
    for (_, rows, width, dtype), l in zip(specs, range(L - 1)):
        assert dtype == torch.float32 and rows == M_pad // packing.TILE_M
        assert width == packing.TILE_M * t[l][1] and t[l][1] % 16 == 0
        assert _bytes(rows, width, dtype) == _bytes(M_pad, t[l][1], torch.float32)
    if cfg is FULL:
        # 8x256 at M = 65,536: 0.53 GB, where the X_l, D_l and SIG_l of
        # the first design took 1.07 GB
        assert sum(_bytes(r, w, d) for _, r, w, d in specs) == 528_482_304


def test_fwd_workspace_pointer_order():
    """The allocated table holds one address per array, 256-byte aligned
    within the buffer, in the order of the specs, each array viewed at its
    shape."""
    pk = _pack(SMALL)
    M_pad = packing.round_up(1000, packing.TILE_M)
    ws_ = fused_sdf._fwd_workspace(pk, M_pad, torch.device("cpu"))
    specs = fused_sdf.fwd_workspace_specs(pk.table, M_pad)
    assert len(ws_.table) == len(specs) == pk.n_lin - 1
    assert all((int(a) - int(ws_.table[0])) % 256 == 0 for a in ws_.table)
    assert np.all(np.diff(ws_.table.astype(np.int64)) > 0)
    for (name, rows, width, dtype), addr in zip(specs, ws_.table):
        arr = ws_.arrays[name]
        assert arr.shape == (rows, width) and arr.dtype == dtype
        assert arr.data_ptr() == int(addr)
