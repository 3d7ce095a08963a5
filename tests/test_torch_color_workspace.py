"""The workspace of the color MLP's kernels
(``fmov_pose_torch/ops/fused_color.py``, ``_workspace``), and the packed
layer table their per-point pass walks (``ColorFwdSeq`` and
``ColorBwdSeq`` in ``ops/csrc/color_train.cuh``).

The kernels read the workspace through a pointer table.  The backward K9
and K7 read it in the order of ``color_core_setup``: X_0..X_{L-1},
ZB_0..ZB_{L-1} (bf16, row-major, the operands of the weight-gradient
stage, ``wgrad.py``), DBPART, then DWPART, which only that stage reads
(``wgrad.color_stage``).  The ReLU masks stay in shared
memory, so the table holds only what the weight gradients need.  The
forward K8 and K6 keep every layer's input in shared memory:
``color_core_setup`` reads no pointer for a forward, K8's table is only
the per-sample rgb C that its composite reads (index 0), and K6's is
empty.  The kernels themselves run only on the card (the ``cuda``-marked
tests of ``test_torch_fused_color.py`` and
``test_torch_fused_color_sample.py``).
"""

import numpy as np
import pytest
import torch

from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_color, packing

FULL = {"d_feature": 256, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 256,
        "n_layers": 4, "weight_norm": True, "multires_view": 4, "squeeze_out": True}
RAGGED = {"d_feature": 20, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 40,
          "n_layers": 3, "weight_norm": True, "multires_view": 1, "squeeze_out": True}


def _pack(cfg):
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        tn.init_color(np.random.default_rng(0), cfg))), cfg)
    return fused_color.RayPack(ws, bs, cfg)


SIZES = pytest.mark.parametrize("cfg,M", [(FULL, 65536), (RAGGED, 1000), (RAGGED, 64)],
                                ids=["full-65536", "ragged-1000", "ragged-64"])


@SIZES
def test_color_bwd_workspace_table(cfg, M):
    pk = _pack(cfg)
    t = pk.table.tolist()
    L = pk.n_lin
    M_pad = packing.round_up(M, packing.TILE_M)
    G, KS = 5, 3
    ws_ = fused_color._workspace(pk, M_pad, torch.device("cpu"), True, G, KS)
    assert [s[0] for s in ws_.specs] == ([f"X{l}" for l in range(L)]
                                         + [f"ZB{l}" for l in range(L)]
                                         + ["DBPART", "DWPART"])
    for l in range(L):
        assert ws_.specs[l][1:] == (M_pad, t[l][0], torch.bfloat16)
        assert ws_.specs[L + l][1:] == (M_pad, t[l][1], torch.bfloat16)
    assert ws_.specs[-2:] == [("DBPART", G, sum(r[1] for r in t), torch.float32),
                              ("DWPART", KS, packing.dw_elems(pk.meta), torch.float32)]
    # what the tile assumes of the table: the forward's output width is the
    # next layer's input width, so forward product l and descent product l
    # + 1 share the columns of X_{l+1} (and its mask bits); the 3-wide last
    # layer pads to 16 columns and its reverse block to 32 rows; every
    # product is at most 384 = 16 x 8 warps x 3 column tiles wide
    kp, np_, n, kr, in_w = ([r[c] for r in t] for c in (0, 1, 2, 5, 7))
    assert all(in_w[l] == np_[l - 1] and in_w[l] % 16 == 0 for l in range(1, L))
    assert n[-1] == 3 and np_[-1] == 16 and kr[-1] == 32
    assert all(k % 32 == 0 and k <= 384 for k in kp + kr)
    assert all(w <= 384 for w in np_)
    if cfg is FULL:
        # the 289-wide input pads to 304 columns and 320 rows: layer 0's
        # reverse product is 20 column tiles wide, the one that needs 3 a warp
        assert (in_w[0], kp[0]) == (304, 320) and kp[0] // 16 > 16
        assert (kp[1:], np_[:-1]) == ([256] * 4, [256] * 4)
        per_point = sum(r * w * 2 for _, r, w, _ in ws_.specs[:2 * L])
        assert per_point == 65536 * 2 * (320 + 256 * 3 + 256 * 4 + 256 + 16)


def test_color_bwd_workspace_pointer_order():
    """The allocated table holds one address per array, 256-byte aligned
    within the buffer, in the order of the specs, each array viewed at its
    shape."""
    pk = _pack(RAGGED)
    M_pad = packing.round_up(1000, packing.TILE_M)
    ws_ = fused_color._workspace(pk, M_pad, torch.device("cpu"), True, 2, 1)
    assert len(ws_.table) == 2 * pk.n_lin + 2
    assert all((int(a) - int(ws_.table[0])) % 256 == 0 for a in ws_.table)
    assert np.all(np.diff(ws_.table.astype(np.int64)) > 0)
    for (name, rows, width, dtype), addr in zip(ws_.specs, ws_.table):
        arr = ws_.arrays[name]
        assert arr.shape == (rows, width) and arr.dtype == dtype
        assert arr.data_ptr() == int(addr)


@SIZES
def test_color_fwd_workspace_tables(cfg, M):
    """K8's forward table is only C [M_pad x 4] f32 at index 0, where
    ``color_setup`` reads it after ``color_core_setup`` read nothing; K6's
    is empty.  Neither holds X_0..X_{L-1}: at the full width that was
    65,536 x (320 + 4 x 256) bf16 elements, 176 MB, that the first
    design's forward wrote and read back."""
    pk = _pack(cfg)
    M_pad = packing.round_up(M, packing.TILE_M)
    k8 = fused_color._workspace(pk, M_pad, torch.device("cpu"), False, composite=True)
    assert k8.specs == [("C", M_pad, 4, torch.float32)]
    assert len(k8.table) == 1 and int(k8.table[0]) == k8.arrays["C"].data_ptr()
    assert k8.arrays["C"].shape == (M_pad, 4)
    k6 = fused_color._workspace(pk, M_pad, torch.device("cpu"), False)
    assert k6.specs == [] and len(k6.table) == 0 and k6.arrays == {}
    if cfg is FULL:
        t = pk.table.tolist()
        assert sum(r[0] for r in t) == 320 + 4 * 256
        assert 65536 * 2 * sum(r[0] for r in t) == 176_160_768
        assert k8.buffer.numel() == 65536 * 4 * 4
