"""The work counts against sums worked out by hand for one small layer
table, and against PyTorch's own count of the forward products."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import model as ref

# pe = 3 (1 + 2) = 9; linears (9, 16), (16, 16 - 9 = 7: the skip's producer), (16, 5)
SDF = {"d_in": 3, "multires": 1, "d_hidden": 16, "n_layers": 2, "skip_in": [2], "d_out": 5,
       "scale": 1.0}
# linears (9 + 8 + 9 - 3 = 23, 8), (8, 8), (8, 3)
COLOR = {"d_in": 9, "d_feature": 8, "multires_view": 1, "d_hidden": 8, "n_layers": 2,
         "d_out": 3}
M = 1000


def test_layer_tables():
    assert work.sdf_layers(SDF) == [(9, 16), (16, 7), (16, 5)]
    assert work.color_layers(COLOR) == [(23, 8), (8, 8), (8, 3)]


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
