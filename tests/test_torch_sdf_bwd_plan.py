"""The launch plan of K5/K3's per-point pass (``ops/csrc/sdf_bwd_pass.cuh``).

* The grid (``fused_sdf._grid``): no more blocks than SMs, and every
  64-point tile in exactly one block (block b takes tiles b, b + grid, ...,
  as ``sdf_bwd_block`` loops), at K5's and K3's main shapes (M = 65,536 /
  32,768), the ragged 300 and 1,000, and a small width.
* The widths: the pass writes a hidden layer's output in one pass of 256
  columns, so the training kernels K2-K5 take hidden layers up to 256 wide
  (``supported_train``); a wider table (K1's ``sdf_setup`` takes up to 384)
  is refused where the training path is chosen and by ``RaysPack`` with a
  ``ValueError``, never at a launch.
* On the card (``cuda``): the plan the library computes
  (``fused_sdf.bwd_launch_plan``, ``fmov_sdf_bwd_plan``), shared memory at
  or under an H100 block's 232,448 bytes at 8x256 and at the widest table
  the pass takes (every hidden layer 256 wide, a 384-wide last layer,
  multires 10).
The kernel itself runs only on the card (the ``cuda``-marked tests of
``test_torch_fused_rays.py`` and ``test_torch_fused_flat.py``).
"""

import types

import numpy as np
import pytest
import torch

from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_sdf, packing
from fmov_pose_torch.render import neus as tneus

FULL = {"d_out": 257, "d_in": 3, "d_hidden": 256, "n_layers": 8, "skip_in": (4,),
        "multires": 6, "bias": 0.5, "scale": 1.0, "geometric_init": True,
        "weight_norm": True}
SMALL = {"d_out": 17, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
         "multires": 3, "bias": 0.5, "scale": 0.8, "geometric_init": True,
         "weight_norm": True}
NARROW = dict(FULL, d_hidden=128, n_layers=5, skip_in=(3,), multires=4, d_out=65)
WIDEST = dict(FULL, multires=10, d_out=384)
SMS = 132


def _dense(cfg, device="cpu"):
    return fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(0), cfg)), device), cfg)


@pytest.mark.parametrize("M", [65536, 32768, 1000, 300, 4160, 64],
                         ids=["K5-65536", "K3-32768", "ragged-1000", "ragged-300",
                              "narrow-4160", "one-tile"])
def test_grid_takes_every_tile_once(monkeypatch, M):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=SMS))
    n_tiles = packing.round_up(M, packing.TILE_M) // packing.TILE_M
    grid = fused_sdf._grid("cuda", n_tiles)
    assert 1 <= grid <= SMS and grid == min(n_tiles, SMS)
    seen = np.zeros(n_tiles, dtype=np.int64)
    blocks = [list(range(b, n_tiles, grid)) for b in range(grid)]
    for tiles in blocks:
        assert tiles
        seen[tiles] += 1
    assert (seen == 1).all()
    if M == 65536:  # 7-8 tiles a block
        assert {len(t) for t in blocks} == {7, 8}


@pytest.mark.parametrize("d_hidden,takes", [(64, True), (128, True), (256, True),
                                            (272, False), (288, False), (320, False),
                                            (384, False)],
                         ids=lambda v: str(v))
def test_training_kernels_take_hidden_widths_up_to_256(d_hidden, takes):
    cfg = dict(FULL, d_hidden=d_hidden)
    assert fused_sdf.supported(cfg)  # K1 takes all of them
    assert fused_sdf.supported_train(cfg) == takes
    assert fused_sdf.supported_rays(cfg, 128, 65536) == takes
    model_cfg = {"sdf": dict(cfg, use_fused_train=True),
                 "color": {"use_fused_train": False}}
    sdf_path, _ = tneus._fused_train_paths(model_cfg, 128, 65536)
    assert sdf_path == ("rays" if takes else None)
    ws, bs = _dense(cfg)
    if takes:
        assert max(row[1] for row in fused_sdf.RaysPack(ws, bs, cfg).table[:-1]) <= 256
    else:
        with pytest.raises(ValueError, match="not supported"):
            fused_sdf.RaysPack(ws, bs, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,passes", [(FULL, 35), (SMALL, 17), (NARROW, 21), (WIDEST, 35)],
                         ids=["full", "small", "narrow", "widest"])
def test_pass_plan_fits_a_block_on_cuda(cfg, passes):
    """The library's own plan: 4 L - 3 products a tile, the 272-wide skip
    input (and any product over 256 columns) in two passes; eight ring
    stages and at most 232,448 bytes of shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    ws, bs = _dense(cfg, torch.device("cuda"))
    plan = fused_sdf.bwd_launch_plan(fused_sdf.RaysPack(ws, bs, cfg))
    assert plan["passes"] == passes
    assert plan["stages"] == 8 and plan["threads"] == 288
    assert plan["smem"] <= 232448
