"""The work counts against sums worked out by hand for one small layer
table (and the background network's at its published widths), and
against PyTorch's own count of the forward products."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cells, harness, work
from benchmark.reference import model as ref

# pe = 3 (1 + 2) = 9; linears (9, 16), (16, 16 - 9 = 7: the skip's producer), (16, 5)
SDF = {"d_in": 3, "multires": 1, "d_hidden": 16, "n_layers": 2, "skip_in": [2], "d_out": 5,
       "scale": 1.0}
# linears (9 + 8 + 9 - 3 = 23, 8), (8, 8), (8, 3)
COLOR = {"d_in": 9, "d_feature": 8, "multires_view": 1, "d_hidden": 8, "n_layers": 2,
         "d_out": 3}
# pe 4 (1 + 4) = 20, view pe 3 (1 + 4) = 15; linears (20, 16), (16 + 20, 16) after the
# skip, feature (16, 16), alpha (16, 1), views0 (16 + 15, 8), rgb (8, 3)
NERF = {"D": 2, "W": 16, "d_in": 4, "d_in_view": 3, "multires": 2, "multires_view": 2,
        "skips": [0]}
M = 1000


def test_layer_tables():
    assert work.sdf_layers(SDF) == [(9, 16), (16, 7), (16, 5)]
    assert work.color_layers(COLOR) == [(23, 8), (8, 8), (8, 3)]


def test_nerf_by_hand():
    assert work.nerf_layers(NERF) == [(20, 16), (36, 16), (16, 16), (16, 1), (31, 8), (8, 3)]
    # prods = 320 + 576 + 256 + 16 + 248 + 24 = 1440; f32 weights 4 x 1440 and biases
    # 4 x 60; a sample reads 4 (4 + 3) and writes 4 (1 + 3) bytes
    w = 4 * 1440 + 4 * 60
    assert work.nerf_work(NERF, M, "fwd") == (2 * 1440 * M, 44 * M + w)
    assert work.nerf_work(NERF, M, "bwd") == (4 * 1440 * M, 72 * M + 2 * w)


def test_nerf_published_widths():
    """NeuS womask.conf's background: 84 x 256 + 6 x 256^2 + 340 x 256 in the
    point MLP, 256^2, 256, 283 x 128 and 128 x 3 in the heads: 604,160
    multiply-adds a point, 99.0 GFLOP forward at 512 rays x 160 samples."""
    nerf = cells.cell("neus_global.fused")["config"]["model"]["nerf"]
    prods = sum(i * o for i, o in work.nerf_layers(nerf))
    assert prods == 84 * 256 + 6 * 256 ** 2 + 340 * 256 + 256 ** 2 + 256 + 283 * 128 + 128 * 3
    assert prods == 604_160
    fwd, _ = work.nerf_work(nerf, 81_920, "fwd")
    assert fwd == 98_985_574_400 and round(fwd / 1e9, 1) == 99.0
    assert work.nerf_work(nerf, 81_920, "bwd")[0] == 2 * fwd


def test_sdf_by_hand():
    # full = 144 + 112 + 80 = 336, hidden = 256, in_last = 16;
    # weights 2 x 336 bf16 + 4 x (16 + 7 + 5) f32 biases = 784 bytes
    assert work.sdf_work(SDF, M, "query") == (2 * (256 + 16) * M, 16 * M + 784)
    assert work.sdf_work(SDF, M, "fwd_grad") == (2 * (336 + 256) * M, 44 * M + 784)
    assert work.sdf_work(SDF, M, "bwd") == (2 * (2 * 336 + 2 * 256) * M,
                                            56 * M + 784 + 4 * 336 + 4 * 28)


def test_color_by_hand():
    # prods = 184 + 64 + 24 = 272; inputs 4 (3 + 3 + 3 + 8) = 68 bytes a sample
    w = 2 * 272 + 4 * 19
    assert work.color_work(COLOR, M, "fwd") == (2 * 272 * M, 80 * M + w)
    assert work.color_work(COLOR, M, "bwd") == (4 * 272 * M, 148 * M + w + 4 * 272 + 4 * 19)


def test_nothing_recomputed():
    """Each forward and gradient-chain product has exactly two backward
    products (the input's and the weight's cotangent)."""
    fwd, _ = work.sdf_work(SDF, M, "fwd_grad")
    bwd, _ = work.sdf_work(SDF, M, "bwd")
    assert bwd == 2 * fwd
    assert work.color_work(COLOR, M, "bwd")[0] == 2 * work.color_work(COLOR, M, "fwd")[0]
    assert work.nerf_work(NERF, M, "bwd")[0] == 2 * work.nerf_work(NERF, M, "fwd")[0]


def _params(layers, wn=True):
    out = {}
    for l, (i, o) in enumerate(layers):
        v = torch.randn(o, i)
        out[f"lin{l}"] = ({"v": v, "g": v.norm(dim=1), "b": torch.zeros(o)} if wn
                          else {"w": v, "b": torch.zeros(o)})
    return {"layers": out}


def test_forward_products_match_torch_count():
    """PyTorch's count of the reference forward's products is the forward
    part of the work: 2 x full x M for the SDF, 2 x prods x M for color."""
    sdf_p = _params(work.sdf_layers(SDF))
    x = torch.randn(M, 3)
    with FlopCounterMode(display=False) as fc:
        ref.sdf_apply(sdf_p, SDF, x)
    fwd_grad, _ = work.sdf_work(SDF, M, "fwd_grad")
    assert fc.get_total_flops() == 2 * 336 * M == fwd_grad - 2 * 256 * M
    col_p = _params(work.color_layers(COLOR))
    with FlopCounterMode(display=False) as fc:
        ref.color_apply(col_p, COLOR, x, x, x, torch.randn(M, 8))
    assert fc.get_total_flops() == work.color_work(COLOR, M, "fwd")[0]
    nerf_p = {k: {"w": torch.randn(o, i), "b": torch.zeros(o)} for k, (i, o) in zip(
        ["feature", "alpha", "views0", "rgb"], work.nerf_layers(NERF)[NERF["D"]:])}
    nerf_p["pts"] = _params(work.nerf_layers(NERF)[:NERF["D"]], wn=False)["layers"]
    with FlopCounterMode(display=False) as fc:
        ref.nerf_apply(nerf_p, NERF, torch.randn(M, 4), torch.randn(M, 3))
    assert fc.get_total_flops() == work.nerf_work(NERF, M, "fwd")[0]


def test_step_points_and_mfu_base():
    model = {"sdf_network": SDF, "rendering_network": COLOR,
             "neus_renderer": {"n_samples": 8, "n_importance": 8, "up_sample_steps": 2}}
    # the coarse 8 samples and the first of 2 up-sampling passes (4 each) are queried
    assert work.step_points(model, 10) == (10 * 8 + 10 * 4, 160)
    q, m = 120, 160
    assert work.step_flops(model, 10) == (
        work.sdf_work(SDF, q, "query")[0] + work.sdf_work(SDF, m, "fwd_grad")[0]
        + work.sdf_work(SDF, m, "bwd")[0] + work.color_work(COLOR, m, "fwd")[0]
        + work.color_work(COLOR, m, "bwd")[0])
    model["neus_renderer"]["n_importance"] = 0
    assert work.step_points(model, 10) == (0, 80)
    assert work.least_s(work.PEAK_FLOPS, 0) == 1.0
    assert work.least_s(0, work.PEAK_BYTES) == 1.0


# a training step's operations of each configuration, which runs no background
STEP_FLOPS = {"neus_global": 545_993_523_200, "neus_virtual": 246_675_406_848}


@pytest.mark.parametrize("workload", ["neus_global.fused", "neus_virtual.planned"])
def test_step_flops_without_background(workload):
    config = cells.cell(workload)["config"]
    model, rays = config["model"], harness.rays_per_step(config)
    assert model["neus_renderer"]["n_outside"] == 0
    assert work.background_points(model, rays) == 0
    assert "nerf" not in work.step_calls(model, rays)
    assert work.step_flops(model, rays) == STEP_FLOPS[config["name"]]


def test_step_flops_with_background():
    """n_outside = 32: the background at every one of 512 x (64 + 64 + 32)
    samples, forward and backward, on top of the same SDF and color work."""
    model = copy.deepcopy(cells.cell("neus_global.fused")["config"]["model"])
    model["neus_renderer"]["n_outside"] = 32
    assert work.background_points(model, 512) == 81_920
    calls = work.step_calls(model, 512)
    assert calls["nerf"] == [work.nerf_work(model["nerf"], 81_920, k) for k in ("fwd", "bwd")]
    assert work.step_flops(model, 512) == STEP_FLOPS["neus_global"] + 3 * 98_985_574_400
    assert work.field_least_s(model, 512, "nerf") == sum(work.least_s(f, b)
                                                         for f, b in calls["nerf"])
