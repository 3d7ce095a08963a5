"""Mesh extraction: the port's grid, marching cubes, PLY files and the
Runner's ``validate_mesh`` against the JAX package's on the CPU.

* The port's copy of the native extractor gives JAX's vertices and
  triangles exactly (the sphere of ``tests/test_marching.py``, an empty
  grid, a random grid); ``write_ply`` writes JAX's bytes (binary and
  ascii, with and without colors) and ``read_ply`` reads them back.
* ``extract_fields`` at resolution 32 at a small SDF width: with K1 off
  (the f32 networks on both sides) within 1e-5 of JAX's grid; with K1 on
  (the port's plain K1 against JAX's Pallas K1 in interpret mode) within
  K1's rule (``fused_sdf.tolerance_check``: median |err| <= 1e-5, max <=
  1e-2).  ``extract_geometry`` on the f32 path gives JAX's triangles and
  its vertices within 1e-5.
* ``extract_color`` within 1e-5 of JAX's.  ``validate_mesh(
  use_norml_color=True)`` (a Runner loaded from the JAX Runner's
  checkpoint, both on the f32 path): the same file name and triangles,
  vertices within 1e-5, and on the same vertices the normal colors within
  1e-5.  (Each side's colors on its own vertices differ by up to 1.01e-5:
  the vertices' own 1e-5 moves the normals.)
* One K1 pack serves a whole mesh: the weights are materialised once
  however many chunks the grid has; on the card (the ``cuda`` test) the
  mesh launches K1 ceil(res^3 / 262,144) times on one pack.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fmov_pose_tpu.fields import nets as jn
from fmov_pose_tpu.native.mc import marching_cubes as j_marching_cubes
from fmov_pose_tpu.pipeline import meshio as jmeshio
from fmov_pose_tpu.render import geometry as jgeo
from fmov_pose_torch import convert
from fmov_pose_torch.native.mc import marching_cubes
from fmov_pose_torch.ops import fused_sdf, packing
from fmov_pose_torch.pipeline import meshio
from fmov_pose_torch.render import geometry

SDF = {"d_out": 33, "d_in": 3, "d_hidden": 32, "n_layers": 4, "skip_in": (2,),
       "multires": 4, "bias": 0.5, "scale": 1.0, "geometric_init": True,
       "weight_norm": True}
COLOR = {"d_feature": 32, "mode": "idr", "d_in": 9, "d_out": 3, "d_hidden": 32,
         "n_layers": 2, "weight_norm": True, "multires_view": 2, "squeeze_out": True}
BMIN, BMAX = np.full(3, -1.01, np.float32), np.full(3, 1.01, np.float32)


@pytest.fixture(scope="module")
def params():
    """JAX-initialised SDF and color parameters (numpy leaves), the sphere
    of radius 0.5 of the geometric init."""
    k1, k2 = jax.random.split(jax.random.key(3))
    return jax.tree_util.tree_map(np.asarray, {"sdf": jn.init_sdf(k1, SDF),
                                               "color": jn.init_color(k2, COLOR)})


def sphere_grid(res, radius=0.5):
    """The signed distance to a sphere on [-1, 1]^3 (``tests/test_marching.py``)."""
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt(x**2 + y**2 + z**2) - radius


def _cfgs(use_fused):
    return ({"sdf": dict(SDF, use_fused=use_fused), "color": dict(COLOR)},
            {"sdf": dict(SDF, use_fused=use_fused), "color": dict(COLOR)})


GRIDS = {
    "sphere": lambda: -sphere_grid(48),
    "empty": lambda: np.ones((16, 16, 16), np.float32),
    "random": lambda: np.random.default_rng(7).normal(size=(20, 24, 28)).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_marching_cubes_matches_jax(name):
    grid = GRIDS[name]()
    v, t = marching_cubes(grid, 0.0)
    jv, jt = j_marching_cubes(grid, 0.0)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)
    assert (len(t) == 0) == (name == "empty")


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("colors", [True, False], ids=["colors", "plain"])
def test_write_ply_matches_jax_bytes(tmp_path, binary, colors):
    v, t = marching_cubes(-sphere_grid(16), 0.0)
    c = np.random.default_rng(1).random((len(v), 3)) if colors else None
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "jax.ply")
    meshio.write_ply(ours, v, t, vertex_colors=c, binary=binary)
    jmeshio.write_ply(theirs, v, t, vertex_colors=c, binary=binary)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    rv, rt = meshio.read_ply(ours)
    np.testing.assert_array_equal(rt, t)
    if binary:
        np.testing.assert_array_equal(rv, v)
    else:  # ascii holds repr(float32) digits
        np.testing.assert_allclose(rv, v, rtol=1e-6)
    jv, jt = jmeshio.read_ply(ours)
    np.testing.assert_array_equal(rv, jv)
    np.testing.assert_array_equal(rt, jt)


def _queries(params, use_fused):
    jcfg, tcfg = _cfgs(use_fused)
    jq = jgeo.make_sdf_query(params, jcfg)
    tq = geometry.make_sdf_query(convert.to_torch(params), tcfg)
    return jq, tq


@pytest.fixture
def interp(monkeypatch):
    jax.clear_caches()
    monkeypatch.setenv("FMOV_PALLAS_INTERPRET", "1")
    yield
    jax.clear_caches()


def test_extract_fields_matches_jax_f32(params):
    jq, tq = _queries(params, False)
    ref = jgeo.extract_fields(BMIN, BMAX, 32, jq)
    got = geometry.extract_fields(BMIN, BMAX, 32, tq, "cpu", chunk=10_000)
    assert got.shape == ref.shape == (32, 32, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (got < 0).any() and (got > 0).any()  # the sphere crosses the grid


def test_extract_fields_matches_jax_k1(params, interp):
    """The port's plain K1 on one pack against JAX's Pallas K1 (interpret
    mode); JAX's chunk is the grid itself, so interpret mode runs no
    padding."""
    jq, tq = _queries(params, True)
    ref = jgeo.extract_fields(BMIN, BMAX, 32, jq, chunk=32 ** 3)
    got = geometry.extract_fields(BMIN, BMAX, 32, tq, "cpu", chunk=10_000)
    err = fused_sdf.tolerance_check(torch.from_numpy(ref.reshape(-1, 1)),
                                    torch.from_numpy(got.reshape(-1, 1)))
    assert err["ok"], err


def test_extract_geometry_matches_jax_f32(params):
    jq, tq = _queries(params, False)
    jv, jt = jgeo.extract_geometry(BMIN, BMAX, 32, 0.0, jq)
    seconds = {}
    v, t = geometry.extract_geometry(BMIN, BMAX, 32, 0.0, tq, "cpu", seconds=seconds)
    assert len(t) > 100
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)
    assert sorted(seconds) == ["copy", "grid", "marching_cubes"]


def test_extract_color_matches_jax(params):
    jcfg, tcfg = _cfgs(False)
    v = np.random.default_rng(2).normal(size=(3000, 3)).astype(np.float32) * 0.3
    ref = jgeo.extract_color(params, jcfg, v, chunk=1024)
    got = geometry.extract_color(convert.to_torch(params), tcfg, v, "cpu", chunk=1000)
    assert got.shape == (3000, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_one_k1_pack_per_mesh(params, monkeypatch):
    """The grid's 72^3 points run in two chunks on one materialisation of
    the weights (K1's plain version here)."""
    calls = []
    materialize = fused_sdf.materialize
    monkeypatch.setattr(fused_sdf, "materialize",
                        lambda *a: calls.append(1) or materialize(*a))
    _, tcfg = _cfgs(True)
    tq = geometry.make_sdf_query(convert.to_torch(params), tcfg)
    got = geometry.extract_fields(BMIN, BMAX, 72, tq, "cpu")
    assert len(calls) == 1 and got.shape == (72,) * 3
    assert -(-72 ** 3 // geometry.CHUNK) == 2


@pytest.mark.cuda
def test_mesh_launches_k1_per_chunk_on_one_pack(params, monkeypatch):
    """On the card: a mesh of resolution 80 (512,000 points) packs once and
    launches K1 twice, ceil(80^3 / 262,144), and its grid is within K1's
    rule of the plain version's on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    packs = []
    pack_train = packing.pack_train
    monkeypatch.setattr(packing, "pack_train", lambda *a, **k: packs.append(1)
                        or pack_train(*a, **k))
    _, tcfg = _cfgs(True)
    dev = torch.device("cuda")
    before = fused_sdf.LAUNCHES
    got = geometry.extract_fields(
        BMIN, BMAX, 80, geometry.make_sdf_query(convert.to_torch(params, dev), tcfg), dev)
    assert fused_sdf.LAUNCHES - before == -(-80 ** 3 // geometry.CHUNK) == 2
    assert len(packs) == 1
    ref = geometry.extract_fields(
        BMIN, BMAX, 80, geometry.make_sdf_query(convert.to_torch(params), tcfg), "cpu")
    err = fused_sdf.tolerance_check(torch.from_numpy(ref.reshape(-1, 1)),
                                    torch.from_numpy(got.reshape(-1, 1)))
    assert err["ok"], err


def test_validate_mesh_matches_jax(tmp_path, monkeypatch):
    """A port Runner loaded from the JAX Runner's checkpoint writes JAX's
    mesh: the same file name and triangles, vertices within 1e-5, and on
    the same vertices normal colors within 1e-5 (the f32 networks on both
    sides)."""
    from fmov_pose_tpu.train.runner import Runner as JRunner
    from fmov_pose_torch.train.runner import Runner
    from tests.test_torch_runner import CONF, _write_sequence
    data_dir, _ = _write_sequence(tmp_path, 3, 32, 40, seed=1)
    conf = tmp_path / "tiny.conf"
    conf.write_text(CONF.format(exp_dir=tmp_path / "exp", data_dir=data_dir))
    jr = JRunner(str(conf))
    jr.save_checkpoint()
    tr = Runner(str(conf), is_continue=True, device="cpu")
    tr.model_cfg["sdf"]["use_fused"] = False  # JAX takes f32 on the CPU
    written = {}
    for mod, key in ((jmeshio, "jax"), (meshio, "port")):
        monkeypatch.setattr(mod, "write_ply", lambda path, v, t, vertex_colors=None, k=key:
                            written.__setitem__(k, (os.path.basename(path), v, t,
                                                    vertex_colors)))
    jr.validate_mesh(resolution=32, use_norml_color=True)
    tr.validate_mesh(resolution=32, use_norml_color=True)
    (jname, jv, jt, _), (name, v, t, c) = written["jax"], written["port"]
    assert name == jname == "00000003_00000000_32_train.ply"
    assert len(t) > 100
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)
    # JAX's normal colors on the port's vertices
    monkeypatch.setattr(jgeo, "extract_geometry", lambda *a, **k: (v, t))
    jr.validate_mesh(resolution=32, use_norml_color=True)
    np.testing.assert_allclose(c, written["jax"][3], rtol=0, atol=1e-5)
    assert sorted(tr.mesh_seconds) == ["copy", "grid", "marching_cubes", "normals",
                                       "write"]
