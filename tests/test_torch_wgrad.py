"""The weight-gradient stage of K3, K5, K7 and K9
(``fmov_pose_torch/ops/wgrad.py``; the kernel is ``ops/csrc/wgrad.cu``).

* The plan: the Python mirror of the kernel's block plan at the SDF's full
  width (8x256, K5's and K3's rows), at a small width, and at the color
  MLP's 4x256 (K9/K7): every element of every layer's padded
  [in_w x np] block lies in exactly one block of each row split; each
  i-tile's splits cover its rows once, in 64-row stages; tiles x KS blocks
  are the most splits that keep one wave on 132 SMs; every operand's base
  and row stride meet the tensor map's rules; the argument struct and the
  shared memory fit the card's limits.
* The plain stage: fed the operands the port's plain backwards multiply
  (``sdf_bwd_plain``, ``sdf_bwd_flat_plain``, ``color_bwd_plain``,
  ``color_ray_bwd_plain`` with ``operands``), laid out in the kernels'
  workspace, it gives their weight gradients to f32 round-off (any order
  of n f32 adds is within n 2^-24 of sum |a b|, two orders twice that)
  and their bias gradients bitwise; through ``packing.unpack_grads`` it
  gives the JAX kernels' dW in interpret mode at a small width (K3's
  ``_sdf_bwd_impl``, K7's ``_color_bwd_impl``) within the leaf rule
  (``fused_sdf.leaf_rule``: relative L2 error < 1%, or absolute < 1e-4 x
  the global gradient norm).
* The launch takes only CUDA tensors; a CPU stage takes the plain
  version.  The kernel itself runs only on the card (the ``cuda``-marked
  test; ``chip_smoke.py wgrad`` at the main path's shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_torch import convert
from fmov_pose_torch.fields import nets as tn
from fmov_pose_torch.ops import fused_color, fused_sdf, packing, wgrad

SDF_FULL = {"d_out": 257, "d_in": 3, "d_hidden": 256, "n_layers": 8, "skip_in": (4,),
            "multires": 6, "bias": 0.5, "scale": 1.0, "geometric_init": True,
            "weight_norm": True}
SDF_SMALL = {"d_out": 17, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
             "multires": 3, "bias": 0.5, "scale": 0.8, "geometric_init": True,
             "weight_norm": True}
COLOR_FULL = {"d_feature": 256, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 256,
              "n_layers": 4, "weight_norm": True, "multires_view": 4,
              "squeeze_out": True}
COLOR_SMALL = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
               "n_layers": 2, "weight_norm": True, "multires_view": 2,
               "squeeze_out": True}
SMS = 132


def _sdf_pack(cfg, seed=0):
    ws, bs = fused_sdf.materialize(convert.to_torch(convert.to_numpy(
        tn.init_sdf(np.random.default_rng(seed), cfg))), cfg)
    return ws, bs, fused_sdf.RaysPack(ws, bs, cfg)


def _color_pack(cfg, seed=0):
    ws, bs = fused_color.materialize(convert.to_torch(convert.to_numpy(
        tn.init_color(np.random.default_rng(seed), cfg))), cfg)
    return ws, bs, fused_color.RayPack(ws, bs, cfg)


PLANS = [pytest.param(SDF_FULL, 65536, True, id="sdf-full-K5"),
         pytest.param(SDF_FULL, 32768, True, id="sdf-full-K3"),
         pytest.param(SDF_SMALL, 1000, True, id="sdf-small-1000"),
         pytest.param(SDF_SMALL, 64, True, id="sdf-small-64"),
         pytest.param(COLOR_FULL, 65536, False, id="color-full-K9-K7"),
         pytest.param(COLOR_FULL, 1000, False, id="color-full-1000")]


@pytest.mark.parametrize("cfg,M,sdf", PLANS)
def test_plan_covers_every_element_and_row_once(cfg, M, sdf):
    pk = (_sdf_pack if sdf else _color_pack)(cfg)[2]
    M_pad = packing.round_up(M, packing.TILE_M)
    dims = wgrad.table_dims(pk.table, M_pad, sdf)
    KS = wgrad.split_k(SMS, dims)
    plan = wgrad.plan(dims, KS)
    assert plan["total"] == packing.dw_elems(pk.meta)
    tiles = sum(j["tiles"] for j in plan["jobs"])
    n_blocks = len(plan["blocks"])
    assert n_blocks == tiles * KS
    # one wave: the most splits that fit 132 SMs, unless 512 rows a split
    # (or a single split) caps them
    longest = int(dims[:, 0].max())
    assert n_blocks <= SMS or KS == 1
    assert tiles * (KS + 1) > SMS or (KS + 1) * wgrad.MIN_SPLIT_ROWS > longest
    if M >= 32768:
        assert n_blocks > SMS - tiles and KS >= 7
    off = 0
    for q, job in enumerate(plan["jobs"]):
        rows, ni, nj = job["rows"], job["ni"], job["nj"]
        assert job["out_off"] == off and job["nt"] * wgrad.BOX >= nj
        assert job["nt"] <= wgrad.MAX_NT and job["per"] % wgrad.KR == 0
        off += ni * nj
        blocks = [b for b in plan["blocks"] if b["job"] == q]
        assert all(b["job"] == q for b in
                   plan["blocks"][job["task0"]:job["task0"] + job["tiles"] * KS])
        for split in range(KS):
            cover = np.zeros((ni, nj), dtype=np.int64)
            for b in blocks:
                if b["split"] == split:
                    cover[b["i0"]:b["i0"] + wgrad.TILE_I, :] += 1
            assert (cover == 1).all()
        for i0 in range(0, ni, wgrad.TILE_I):
            rows_seen = np.zeros(rows, dtype=np.int64)
            for b in blocks:
                if b["i0"] == i0:
                    assert b["r_begin"] % wgrad.KR == 0
                    rows_seen[b["r_begin"]:b["r_end"]] += 1
            assert (rows_seen == 1).all()
    assert off == plan["total"]
    assert 2 <= plan["stages"] <= wgrad.MAX_STAGES
    assert plan["smem"] <= wgrad.SMEM_LIMIT
    assert plan["stage_bytes"] % wgrad.ALIGN == 0
    assert wgrad.ARG_BYTES <= wgrad.PARAM_LIMIT
    if cfg is SDF_FULL or cfg is COLOR_FULL:
        assert plan["stages"] == 4


@pytest.mark.parametrize("cfg,M,sdf", PLANS)
def test_stage_operands_meet_the_tensor_map_rules(cfg, M, sdf):
    """The jobs of a stage on the kernels' workspace: row-major bf16 views
    whose bases and row strides meet the tensor map's rules, with the
    plan's dims, the partials at [KS, total]."""
    pk = (_sdf_pack if sdf else _color_pack)(cfg)[2]
    M_pad = packing.round_up(M, packing.TILE_M)
    KS, G = 3, 2
    if sdf:
        ws_, _ = fused_sdf._bwd_workspace(pk, M_pad, G, KS, torch.device("cpu"))
        stage = wgrad.sdf_stage(ws_, pk.table, M_pad, KS)
    else:
        ws_ = fused_color._workspace(pk, M_pad, torch.device("cpu"), True, G, KS)
        stage = wgrad.color_stage(ws_, pk.table, KS)
    base = ws_.buffer.data_ptr()
    np.testing.assert_array_equal(wgrad.job_dims(stage.jobs),
                                  wgrad.table_dims(pk.table, M_pad, sdf))
    for j in stage.jobs:
        for t, w in ((j.a, j.ni), (j.b, j.nj)):
            assert t.dtype == torch.bfloat16 and t.stride(1) == 1
            assert wgrad.tma_ok(t.data_ptr() - base, t.shape[0], w, t.stride(0))
        assert j.ni % 16 == 0 and j.nj % 16 == 0
    assert tuple(stage.dwpart.shape) == (KS, stage.total)
    assert stage.total == packing.dw_elems(pk.meta)
    assert tuple(stage.dbpart.shape) == (G, int(pk.table[:, 1].sum()))
    if sdf:
        t = pk.table.tolist()
        assert tuple(stage.cbpart.shape) == (G, t[-2][1])
        assert stage.cb_ld == t[-1][1]
        assert stage.cb_off == stage.total - t[-1][7] * t[-1][1]
    else:
        assert stage.cbpart is None


def _place(dst, src, row_map):
    """src [M, k] into the padded columns of dst [M_pad, w] (bf16)."""
    for s, d, cnt in packing.input_rows(src.shape[1], row_map):
        dst[:src.shape[0], d:d + cnt] = src[:, s:s + cnt].to(torch.bfloat16)


def _sdf_stage_of(pk, ops, dbs, M):
    """K5/K3's workspace filled with the plain backward's operands: AB_l =
    [FB_l; X_l], BB_l = [D_l; ZB_l], one block's bias and column-0 sums."""
    M_pad = packing.round_up(M, packing.TILE_M)
    ws_, n_bias = fused_sdf._bwd_workspace(pk, M_pad, 1, 1, torch.device("cpu"))
    ws_.buffer.zero_()
    t = pk.table.tolist()
    L = len(t)
    for l in range(L):
        halves = ops[l] if l < L - 1 else [None] + ops[l]
        for h, pair in enumerate(halves):
            if pair is None:
                continue
            a, b = pair
            _place(ws_.arrays[f"AB{l}"][h * M_pad:], a, pk.row_maps[l])
            _place(ws_.arrays[f"BB{l}"][h * M_pad:], b, None)
        ws_.arrays["DBPART"][0, t[l][4]:t[l][4] + dbs[l].shape[0]] = dbs[l]
    col = ops["col"].sum(0)
    ws_.arrays["CBPART"][0, :col.shape[0]] = col
    return wgrad.sdf_stage(ws_, pk.table, M_pad, 1)


def _color_stage_of(pk, ops, dbs, M):
    """K9/K7's workspace filled with the plain backward's operands."""
    M_pad = packing.round_up(M, packing.TILE_M)
    ws_ = fused_color._workspace(pk, M_pad, torch.device("cpu"), True, 1, 1)
    ws_.buffer.zero_()
    t = pk.table.tolist()
    for l in range(len(t)):
        a, b = ops[l]
        _place(ws_.arrays[f"X{l}"], a, None)
        _place(ws_.arrays[f"ZB{l}"], b, None)
        ws_.arrays["DBPART"][0, t[l][4]:t[l][4] + dbs[l].shape[0]] = dbs[l]
    return wgrad.color_stage(ws_, pk.table, 1)


def _check_against(pk, stage, ws, ref_dws, ref_dbs):
    """The stage against the plain backward: every dW element within 2
    rows 2^-24 of sum |a b| (two orders of the same f32 sums), the biases
    bitwise; returns the stage's dense dws."""
    dw, db = wgrad.weight_grads(stage)
    got_w, got_b = packing.unpack_grads(dw, db, pk.meta, ws, pk.row_maps)
    s_stage = wgrad.Stage([wgrad.Job(j.a.abs(), j.b.abs(), j.ni, j.nj)
                           for j in stage.jobs], 1, stage.dwpart, stage.dbpart.abs(),
                           None if stage.cbpart is None else stage.cbpart.abs(),
                           stage.cb_off, stage.cb_ld)
    s_w, _ = packing.unpack_grads(wgrad.weight_grads_plain(s_stage)[0], db, pk.meta,
                                  ws, pk.row_maps)
    rows = max(j.a.shape[0] for j in stage.jobs) + 1
    for l, (r, g, s) in enumerate(zip(ref_dws, got_w, s_w)):
        assert g.shape == r.shape, l
        err = (g.double() - r.double()).abs()
        assert (err <= 2 * rows * 2.0 ** -24 * s.double() + 1e-30).all(), (l, float(err.max()))
    for l, (r, g) in enumerate(zip(ref_dbs, got_b)):
        assert torch.equal(g, r), l
    return got_w


def _sdf_inputs(cfg, M, seed):
    rng = np.random.default_rng(seed)
    pe = 3 * (1 + 2 * cfg["multires"])
    return ((rng.uniform(-1, 1, (M, 3)) * 0.7).astype(np.float32),
            rng.normal(size=(M, cfg["d_out"])).astype(np.float32),
            rng.normal(size=(M, pe)).astype(np.float32),
            rng.normal(size=(M, 3)).astype(np.float32),
            rng.normal(size=M).astype(np.float32))


@pytest.mark.parametrize("cfg,M", [(SDF_SMALL, 100), (SDF_FULL, 70)],
                         ids=["small-100", "full-70"])
def test_plain_stage_gives_the_sdf_plain_backwards(cfg, M):
    """K3's and K5's plain backwards: their operands through the stage give
    their dws to f32 round-off and their dbs bitwise."""
    ws, bs, pk = _sdf_pack(cfg, 1)
    x, ybar, gbar, ct_grad, ct_sdf = (torch.from_numpy(a) for a in _sdf_inputs(cfg, M, 2))
    xe = fused_sdf.pe_parts(x * cfg["scale"], cfg["multires"])[0]
    ops = {}
    _, dws, dbs = fused_sdf.sdf_bwd_flat_plain(ws, bs, xe, ybar, gbar, cfg, operands=ops)
    _check_against(pk, _sdf_stage_of(pk, ops, dbs, M), ws, dws, dbs)
    ops = {}
    _, dws, dbs = fused_sdf.sdf_bwd_plain(ws, bs, x, ybar, ct_sdf, ct_grad, cfg,
                                          operands=ops)
    _check_against(pk, _sdf_stage_of(pk, ops, dbs, M), ws, dws, dbs)


@pytest.mark.parametrize("cfg,B,N", [(COLOR_SMALL, 5, 20), (COLOR_FULL, 3, 24)],
                         ids=["small", "full"])
def test_plain_stage_gives_the_color_plain_backwards(cfg, B, N):
    """K7's and K9's plain backwards, the same way."""
    ws, bs, pk = _color_pack(cfg, 3)
    rng = np.random.default_rng(4)
    M = B * N
    d_in = tn.color_dims(cfg)[0]
    xc = torch.from_numpy(rng.normal(size=(M, d_in)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(M, 3)).astype(np.float32))
    ops = {}
    _, dws, dbs = fused_color.color_bwd_plain(ws, bs, xc, ct, operands=ops)
    _check_against(pk, _color_stage_of(pk, ops, dbs, M), ws, dws, dbs)
    dirs = rng.normal(size=(M, 3))
    geo = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(M, 1 + cfg["d_feature"])), rng.uniform(-1, 1, (M, 3)),
        dirs / np.linalg.norm(dirs, axis=-1, keepdims=True), rng.normal(size=(M, 3)),
        rng.uniform(0, 1, (B, N)) / N)]
    ct_ray = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    ops = {}
    *_, dws, dbs = fused_color.color_ray_bwd_plain(ws, bs, *geo, ct_ray, cfg,
                                                   operands=ops)
    _check_against(pk, _color_stage_of(pk, ops, dbs, M), ws, dws, dbs)


@pytest.fixture()
def interpret(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    from fmov_pose_tpu.ops import fused_color as jc
    from fmov_pose_tpu.ops import fused_sdf as jf
    monkeypatch.setattr(jf, "TILE", 32)
    monkeypatch.setattr(jc, "TILE", 32)
    yield jf, jc
    jax.clear_caches()


def _jax_params(init, cfg, seed):
    pj = init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    pj = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), pj)
    return pj, convert.to_torch(jax.tree_util.tree_map(np.asarray, pj))


def _leaf_ok(ref, got):
    res = fused_sdf.leaf_rule(
        {f"w{l}": torch.tensor(np.asarray(w)) for l, w in enumerate(ref)},
        {f"w{l}": w for l, w in enumerate(got)})
    assert res["ok"], res


def test_stage_gives_the_jax_k3_dw(interpret):
    """K3 at the small SDF width (45 points: a full tile and a ragged one):
    the plain backward's operands through the stage and unpack_grads
    against the JAX kernel's dW in interpret mode."""
    jf, _ = interpret
    cfg, M = SDF_SMALL, 45
    pj, pt = _jax_params(jn.init_sdf, cfg, 0)
    x, ybar, gbar, _, _ = _sdf_inputs(cfg, M, 1)
    ws_j, bs_j = jf._materialize(pj, cfg)
    dws_j, _, _ = jf._sdf_bwd_impl(ws_j, bs_j, jnp.asarray(x), jnp.asarray(ybar),
                                   jnp.asarray(gbar), jf._cfg_key(cfg))
    ws, bs = fused_sdf.materialize(pt, cfg)
    pk = fused_sdf.RaysPack(ws, bs, cfg)
    xe = fused_sdf.pe_parts(torch.from_numpy(x) * cfg["scale"], cfg["multires"])[0]
    ops = {}
    _, dws, dbs = fused_sdf.sdf_bwd_flat_plain(ws, bs, xe, torch.from_numpy(ybar),
                                               torch.from_numpy(gbar), cfg, operands=ops)
    got = _check_against(pk, _sdf_stage_of(pk, ops, dbs, M), ws, dws, dbs)
    _leaf_ok(dws_j, got)


def test_stage_gives_the_jax_k7_dw(interpret):
    """K7 at the small color width (40 samples), the same way."""
    _, jc = interpret
    cfg, M = COLOR_SMALL, 40
    pj, pt = _jax_params(jn.init_color, cfg, 2)
    rng = np.random.default_rng(3)
    xc = rng.normal(size=(M, tn.color_dims(cfg)[0])).astype(np.float32)
    ct = rng.normal(size=(M, 3)).astype(np.float32)
    n_lin = cfg["n_layers"] + 1
    ws_j, bs_j = jc._materialize(pj, n_lin)
    _, dws_j, _ = jc._color_bwd_impl(ws_j, bs_j, jnp.asarray(xc), jnp.asarray(ct), n_lin)
    ws, bs = fused_color.materialize(pt, cfg)
    pk = fused_color.RayPack(ws, bs, cfg)
    ops = {}
    _, dws, dbs = fused_color.color_bwd_plain(ws, bs, torch.from_numpy(xc),
                                              torch.from_numpy(ct), operands=ops)
    got = _check_against(pk, _color_stage_of(pk, ops, dbs, M), ws, dws, dbs)
    _leaf_ok(dws_j, got)


def test_launch_takes_only_cuda_tensors():
    """A CPU stage: ``launch`` raises, ``weight_grads`` takes the plain
    version; split_k keeps one wave and at least 512 rows a split."""
    ws, bs, pk = _sdf_pack(SDF_SMALL)
    M_pad = 128
    ws_, _ = fused_sdf._bwd_workspace(pk, M_pad, 1, 1, torch.device("cpu"))
    ws_.buffer.zero_()
    stage = wgrad.sdf_stage(ws_, pk.table, M_pad, 1)
    before = wgrad.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        wgrad.launch(stage)
    dw, db = wgrad.weight_grads(stage)
    assert wgrad.LAUNCHES == before
    assert dw.shape == (packing.dw_elems(pk.meta),) and not dw.any() and not db.any()
    dims = wgrad.table_dims(_sdf_pack(SDF_FULL)[2].table, 65536, True)
    assert wgrad.split_k(132, dims) == 7 and wgrad.split_k(264, dims) == 14
    assert wgrad.split_k(132, wgrad.table_dims(pk.table, 64, True)) == 1


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """K5's per-point pass fills its workspace at the full width (M =
    4,096); the stage's kernel against its plain version (chip_smoke.py's
    rule: max |err| / sum |a b| <= 2e-4, the biases bitwise), twice
    bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ws, bs, pk = _sdf_pack(SDF_FULL)
    pk = fused_sdf.RaysPack([w.to(dev) for w in ws], [b.to(dev) for b in bs], SDF_FULL)
    M = 4096
    x, ct_out, _, ct_grad, ct_sdf = (torch.from_numpy(a).to(dev)
                                     for a in _sdf_inputs(SDF_FULL, M, 5))
    _, stage = fused_sdf.bwd_pass(pk, x, ct_out, ct_sdf, ct_grad)
    before = wgrad.LAUNCHES
    res = chip_smoke._wgrad_check("K5", stage, "pass")
    assert res["ok"] and wgrad.LAUNCHES == before + 2
