"""The launch plan of K4/K2's per-point pass (``ops/csrc/sdf_fwd_grad_pass.cuh``).

* The grid (``fused_sdf._fwd_grid``): no more blocks than SMs or pairs of
  tiles, and every 64-point tile in exactly one warpgroup of one block
  (block b takes pairs b, b + grid, ..., warpgroup w tile 2 t + w of pair
  t, as ``sdf_fwd_grad_block`` loops), at K4's and K2's main shapes (M =
  65,536 / 32,768) and the ragged 300 and 1,000.
* The product sequence (``spec_passes``, the plan ``fg_plan`` must give):
  2 L - 1 products, the forward l = 0..L-1 on R_l (the last layer
  included) then the reverse chain l = L-2..0 on F_l, outputs wider than
  256 columns in two passes, the upper columns first: at 8x256 the skip
  layer's reverse product and the last layer's (272 columns each).
* Shared memory (``spec_plan``, ``fg_plan``'s arithmetic): the ring's
  stages beside the two warpgroups' regions fit an H100 block's 232,448
  bytes at 8x256 and at the widest table ``supported_train`` takes (hidden
  layers 256 wide, a 384-wide last layer, an encoding of 128 columns),
  and the ring holds the deepest pass and a stage more, which the
  warpgroups' turns at the tensor cores need.
* A 384-wide hidden table is refused where the training path is chosen
  (``supported_train``, ``neus._fused_train_paths``) and by ``RaysPack``,
  never at a launch.
* On the card (``cuda``): the library's own plan
  (``fused_sdf.fwd_grad_launch_plan``, ``fmov_sdf_fwd_grad_plan``) is the
  spec's, pass for pass.
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
WIDEST_PE = dict(FULL, multires=20, d_out=384)  # pe_pad 128: the skip input 384
CFGS = {"full": FULL, "small": SMALL, "narrow": NARROW, "widest": WIDEST,
        "widest-pe": WIDEST_PE}
SMS = 132
SMEM_LIMIT, ALIGN, STAGE, MAX_STAGES, NW, KS = 232448, 1024, 16384, 12, 256, 32


def _dense(cfg, device="cpu"):
    return fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(0), cfg)), device), cfg)


def _table(cfg):
    """[(kp, np, n, w_off, b_off, kr, r_off, in_w)] of the packed table."""
    ws, bs = _dense(cfg)
    return [tuple(int(v) for v in row) for row in fused_sdf.RaysPack(ws, bs, cfg).table]


def spec_passes(table):
    """[(map, n0, nw, k)] of a tile in ring order: forward l on R_l (map
    2 l + 1, N = np, K = in_w), then the reverse chain on F_l (map 2 l, N =
    in_w, K = np), each output in passes of 256 columns, upper first."""
    out = []

    def add(m, N, K):
        for n0 in range((N - 1) // NW * NW, -1, -NW):
            out.append((m, n0, min(NW, N - n0), K))

    last = len(table) - 1
    for l in range(last + 1):
        add(2 * l + 1, table[l][1], table[l][7])
    for l in range(last - 1, -1, -1):
        add(2 * l, table[l][7], table[l][1])
    return out


def spec_plan(table, pe_pad):
    """(stages, smem bytes, stages of the deepest pass): a warpgroup's
    region holds X_0 and X_S's PE half in 64-column atoms of 8 KB, or DIN
    (f32) over them."""
    atoms = -(-pe_pad // 64)
    region = -(-max(2 * atoms * 8192, 64 * pe_pad * 4) // ALIGN) * ALIGN
    stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN - 2 * region) // (STAGE + 16))
    deepest = max(-(-k // KS) for _, _, _, k in spec_passes(table))
    return stages, ALIGN + stages * STAGE + 2 * region + 16 * stages, deepest


def _pe_pad(cfg):
    return -(-3 * (1 + 2 * cfg["multires"]) // 16) * 16


@pytest.mark.parametrize("M", [65536, 32768, 300, 1000],
                         ids=["K4-65536", "K2-32768", "ragged-300", "ragged-1000"])
def test_grid_takes_every_tile_once(monkeypatch, M):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=SMS))
    n_tiles = packing.round_up(M, packing.TILE_M) // packing.TILE_M
    n_pairs = (n_tiles + 1) // 2
    grid = fused_sdf._fwd_grid("cuda", n_tiles)
    assert 1 <= grid <= SMS and grid == min(n_pairs, SMS)
    seen = np.zeros(n_tiles, dtype=np.int64)
    for b in range(grid):
        pairs = list(range(b, n_pairs, grid))
        assert pairs
        for t in pairs:
            for w in range(2):  # a tile past the last is a warpgroup's empty turn
                if 2 * t + w < n_tiles:
                    seen[2 * t + w] += 1
    assert (seen == 1).all()
    if M == 65536:  # 3-4 pairs a block
        assert {len(range(b, n_pairs, grid)) for b in range(grid)} == {3, 4}


@pytest.mark.parametrize("name", list(CFGS))
def test_products_in_the_forward_then_reverse_order(name):
    cfg = CFGS[name]
    table = _table(cfg)
    n_lin = cfg["n_layers"] + 1
    passes = spec_passes(table)
    # products: a pass at column 0 ends each
    assert sum(1 for p in passes if p[1] == 0) == 2 * n_lin - 1
    maps = [m for m, n0, _, _ in passes if n0 == 0]
    assert maps == ([2 * l + 1 for l in range(n_lin)]
                    + [2 * l for l in range(n_lin - 2, -1, -1)])
    # every pass but the upper ones of a product is 256 columns or narrower,
    # and the hidden outputs (the next A operand, in registers) are one pass
    assert all(nw <= NW for _, _, nw, _ in passes)
    for l in range(n_lin - 1):
        assert table[l][1] <= NW
    if name == "full":
        skip = cfg["skip_in"][0]
        rev_skip = [p for p in passes if p[0] == 2 * skip]
        assert rev_skip == [(2 * skip, 256, 16, 256), (2 * skip, 0, 256, 256)]
        last = [p for p in passes if p[0] == 2 * (n_lin - 1) + 1]
        assert last == [(2 * n_lin - 1, 256, 16, 256), (2 * n_lin - 1, 0, 256, 256)]
        assert len(passes) == 19


@pytest.mark.parametrize("name", list(CFGS))
def test_shared_memory_fits_a_block(name):
    cfg = CFGS[name]
    stages, smem, deepest = spec_plan(_table(cfg), _pe_pad(cfg))
    assert smem <= SMEM_LIMIT
    assert stages > deepest
    if name == "full":
        assert (stages, smem, deepest) == (12, 230592, 9)


@pytest.mark.parametrize("d_hidden,takes", [(256, True), (384, False)],
                         ids=lambda v: str(v))
def test_wide_table_refused_where_the_path_is_chosen(d_hidden, takes):
    cfg = dict(FULL, d_hidden=d_hidden)
    assert fused_sdf.supported(cfg)  # K1 takes both
    assert fused_sdf.supported_train(cfg) == takes
    model_cfg = {"sdf": dict(cfg, use_fused_train=True),
                 "color": {"use_fused_train": False}}
    for n_pts, path in ((65536, "rays"), (32768, "flat")):
        assert tneus._fused_train_paths(model_cfg, 128, n_pts)[0] == (path if takes else None)
    ws, bs = _dense(cfg)
    if takes:
        assert fused_sdf.RaysPack(ws, bs, cfg).n_lin == cfg["n_layers"] + 1
    else:
        with pytest.raises(ValueError, match="not supported"):
            fused_sdf.RaysPack(ws, bs, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_library_plan_is_the_spec_on_cuda(name):
    """The library's own plan: the spec's passes, stages and shared memory,
    384 threads a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    cfg = CFGS[name]
    ws, bs = _dense(cfg, torch.device("cuda"))
    pk = fused_sdf.RaysPack(ws, bs, cfg)
    plan = fused_sdf.fwd_grad_launch_plan(pk)
    table = [tuple(int(v) for v in row) for row in pk.table]
    stages, smem, _ = spec_plan(table, _pe_pad(cfg))
    assert plan["table"] == spec_passes(table)
    assert plan["passes"] == len(plan["table"]) and plan["threads"] == 384
    assert (plan["stages"], plan["smem"]) == (stages, smem)
