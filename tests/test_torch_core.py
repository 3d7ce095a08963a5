"""The port's core, sampling and ray modules against the JAX package.

Inputs come from a seeded numpy Generator and go to both sides as the same
arrays.  Everything is f32; the tolerance is atol 1e-5 (both sides do the
same f32 operations, in orders that may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmov_pose_tpu.core import embedder as jemb
from fmov_pose_tpu.core import lie as jlie
from fmov_pose_tpu.core import pose as jpose
from fmov_pose_tpu.core import sampling as jsamp
from fmov_pose_tpu.data import rays as jrays
from fmov_pose_torch.core import embedder as temb
from fmov_pose_torch.core import lie as tlie
from fmov_pose_torch.core import pose as tpose
from fmov_pose_torch.core import sampling as tsamp
from fmov_pose_torch.data import rays as trays

ATOL = 1e-5


def _close(a, b, atol=ATOL):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(b, np.asarray(a), atol=atol, rtol=0)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _rot_vecs(rng, n):
    """Axis-angle vectors from 0 (series branch) to ~pi."""
    v = _f32(rng, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ang = np.concatenate([[0.0, 1e-4, 5e-3], np.linspace(0.02, 3.0, n - 3)])
    return (v * ang[:, None]).astype(np.float32)


def _poses(rng, n):
    R = np.asarray(jlie.so3_exp(jnp.asarray(_f32(rng, n, 3))))
    t = _f32(rng, n, 3)
    return np.concatenate([R, t[..., None]], -1).astype(np.float32)


# ---------------------------------------------------------------- lie

@pytest.mark.parametrize("fn", ["skew", "so3_exp", "axis_angle_to_R",
                                "taylor_A", "taylor_B", "taylor_C"])
def test_lie_vector_maps(rng, fn):
    w = _rot_vecs(rng, 16)
    if fn.startswith("taylor"):
        w = np.linalg.norm(w, axis=-1)
    _close(getattr(jlie, fn)(jnp.asarray(w)), getattr(tlie, fn)(torch.from_numpy(w)))


@pytest.mark.parametrize("only_rot", [False, True])
def test_lie_se3_exp(rng, only_rot):
    wu = np.concatenate([_rot_vecs(rng, 16), _f32(rng, 16, 3)], -1)
    _close(jlie.se3_exp(jnp.asarray(wu), only_rot=only_rot),
           tlie.se3_exp(torch.from_numpy(wu), only_rot=only_rot))


def test_lie_logs_and_distance(rng):
    P = _poses(rng, 16)
    _close(jlie.so3_log(jnp.asarray(P[..., :3])), tlie.so3_log(torch.from_numpy(P[..., :3])),
           atol=1e-4)
    _close(jlie.se3_log(jnp.asarray(P)), tlie.se3_log(torch.from_numpy(P)), atol=1e-4)
    Q = _poses(rng, 16)
    _close(jlie.rotation_distance(jnp.asarray(P[..., :3]), jnp.asarray(Q[..., :3])),
           tlie.rotation_distance(torch.from_numpy(P[..., :3]), torch.from_numpy(Q[..., :3])),
           atol=1e-4)


def test_lie_make_c2w_gradient_at_zero():
    r = torch.zeros(3, requires_grad=True)
    c2w = tlie.make_c2w(r, torch.zeros(3))
    (g,) = torch.autograd.grad(c2w.sum(), r)
    gj = jax.grad(lambda v: jlie.make_c2w(v, jnp.zeros(3)).sum())(jnp.zeros(3))
    _close(gj, g)


# ---------------------------------------------------------------- pose

@pytest.mark.parametrize("fn", ["invert", "to_4x4"])
def test_pose_unary(rng, fn):
    P = _poses(rng, 8)
    _close(getattr(jpose, fn)(jnp.asarray(P)), getattr(tpose, fn)(torch.from_numpy(P)))


def test_pose_compose(rng):
    A, B, C = _poses(rng, 8), _poses(rng, 8), _poses(rng, 8)
    _close(jpose.compose_pair(jnp.asarray(A), jnp.asarray(B)),
           tpose.compose_pair(torch.from_numpy(A), torch.from_numpy(B)))
    _close(jpose.compose([jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)]),
           tpose.compose([torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(C)]))


def test_pose_projections(rng):
    P = _poses(rng, 1)[0]
    X = _f32(rng, 20, 3)
    K = np.array([[100.0, 0, 32], [0, 110.0, 24], [0, 0, 1]], np.float32)
    _close(jpose.world2cam(jnp.asarray(X), jnp.asarray(P)),
           tpose.world2cam(torch.from_numpy(X), torch.from_numpy(P)))
    _close(jpose.cam2world(jnp.asarray(X), jnp.asarray(P)),
           tpose.cam2world(torch.from_numpy(X), torch.from_numpy(P)))
    _close(jpose.cam2img(jnp.asarray(X), jnp.asarray(K)),
           tpose.cam2img(torch.from_numpy(X), torch.from_numpy(K)), atol=1e-3)
    _close(jpose.img2cam(jnp.asarray(X), jnp.asarray(K)),
           tpose.img2cam(torch.from_numpy(X), torch.from_numpy(K)))
    _close(jpose.make_pose(jnp.asarray(P[:, :3]), jnp.asarray(P[:, 3])),
           tpose.make_pose(torch.from_numpy(P[:, :3]), torch.from_numpy(P[:, 3])))


def test_pose_procrustes(rng):
    X1 = _f32(rng, 30, 3)
    P = _poses(rng, 1)[0]
    X0 = 1.7 * X1 @ P[:, :3].T + P[:, 3]
    sj = jpose.procrustes(jnp.asarray(X0), jnp.asarray(X1))
    st = tpose.procrustes(torch.from_numpy(X0), torch.from_numpy(X1))
    for k in ("t0", "t1", "s0", "s1", "R"):
        _close(sj[k], st[k], atol=1e-4)
    _close(jpose.apply_sim3(sj, jnp.asarray(X1)),
           tpose.apply_sim3(st, torch.from_numpy(X1)), atol=1e-4)


# ---------------------------------------------------------------- embedder

@pytest.mark.parametrize("multires", [2, 4, 6, 10])
def test_positional_encode(rng, multires):
    x = _f32(rng, 50, 3)
    assert temb.embed_dim(multires) == jemb.embed_dim(multires)
    # arguments reach 2^(L-1)|x|: compare relative to that scale
    _close(jemb.positional_encode(jnp.asarray(x), multires),
           temb.positional_encode(torch.from_numpy(x), multires),
           atol=ATOL * 2 ** (multires - 1))


def test_fourier_features(rng):
    b = _f32(rng, 128, 1, scale=10.0)
    cam = np.arange(5, dtype=np.float32)[:, None]
    _close(jemb.fourier_features(jnp.asarray(cam), jnp.asarray(b)),
           temb.fourier_features(torch.from_numpy(cam), torch.from_numpy(b)),
           atol=1e-4)


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("n_samples", [4, 16])
def test_sample_pdf(rng, n_samples):
    B, N = 12, 33
    bins = np.sort(rng.uniform(0.5, 3.0, (B, N)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (B, N - 1)).astype(np.float32)
    w[0] = 0.0            # uniform pdf after the floor
    w[1, 5] = 50.0        # a spike
    _close(jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n_samples),
           tsamp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n_samples))


def test_sample_pdf_random_draws_are_sorted_and_inside(rng):
    bins = np.sort(rng.uniform(0.5, 3.0, (6, 17)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (6, 16)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    z = tsamp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 9, g)
    assert torch.all(z[:, 1:] >= z[:, :-1])
    assert torch.all(z >= torch.from_numpy(bins[:, :1]) - 1e-6)
    assert torch.all(z <= torch.from_numpy(bins[:, -1:]) + 1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_merge_sorted(rng, ties):
    za = np.sort(rng.uniform(0, 1, (5, 9)), -1).astype(np.float32)
    zb = np.sort(rng.uniform(0, 1, (5, 4)), -1).astype(np.float32)
    if ties:
        zb[:, 1] = za[:, 3]
        zb[:, 2] = za[:, 3]
        zb[0] = za[0, :4]
    va = rng.normal(size=za.shape).astype(np.float32)
    vb = rng.normal(size=zb.shape).astype(np.float32)
    zj, vj = jsamp.merge_sorted(*(jnp.asarray(a) for a in (za, zb, va, vb)))
    zt, vt = tsamp.merge_sorted(*(torch.from_numpy(a) for a in (za, zb, va, vb)))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))  # tie order
    np.testing.assert_array_equal(
        tsamp.merge_sorted(torch.from_numpy(za), torch.from_numpy(zb)).numpy(),
        np.asarray(jsamp.merge_sorted(jnp.asarray(za), jnp.asarray(zb))))


# ---------------------------------------------------------------- rays

H, W, N_IMG = 24, 32, 3


@pytest.fixture
def frames(rng):
    images = rng.uniform(0, 1, (N_IMG, H, W, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (N_IMG, H, W)) > 0.5).astype(np.float32)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    intr = np.tile(np.eye(4), (N_IMG, 1, 1))
    intr[:, :3, :3] = K
    intr_inv = np.linalg.inv(intr).astype(np.float32)
    bbox = np.array([[5, 15, 8, 20], [0, H, 0, W], [10, 12, 3, 4]], np.int32)
    pose = _poses(rng, 1)[0]
    return images, masks, intr_inv, bbox, pose


def _jax_pixel_draw(key, bbox, img_idx, batch, patch, mask_guided):
    """The pixel ids data/rays.py:gen_random_rays of the JAX package draws."""
    k_guide, k_x, k_y = jax.random.split(key, 3)
    if mask_guided:
        use_bbox = jax.random.uniform(k_guide) < 0.7
        y0, y1, x0, x1 = jnp.asarray(bbox)[img_idx]
        y_lo = jnp.where(use_bbox, jnp.maximum(y0 - patch, 0), 0)
        y_hi = jnp.where(use_bbox, jnp.minimum(y1 + patch, H), H)
        x_lo = jnp.where(use_bbox, jnp.maximum(x0 - patch, 0), 0)
        x_hi = jnp.where(use_bbox, jnp.minimum(x1 + patch, W), W)
    else:
        y_lo, y_hi, x_lo, x_hi = 0, H, 0, W
    px = jax.random.randint(k_x, (batch,), x_lo, x_hi)
    py = jax.random.randint(k_y, (batch,), y_lo, y_hi)
    return np.array(px), np.array(py)


@pytest.mark.parametrize("mask_guided,img_idx", [(False, 0), (True, 0), (True, 2)])
def test_gen_random_rays_given_pixels(frames, mask_guided, img_idx):
    images, masks, intr_inv, bbox, pose = frames
    key = jax.random.key(7 + img_idx)
    batch, patch = 40, 3
    out_j = jrays.gen_random_rays(
        key, jnp.asarray(images.transpose(3, 0, 1, 2)), jnp.asarray(masks),
        jnp.asarray(intr_inv), jnp.asarray(pose), img_idx, batch,
        jnp.asarray(bbox), patch, mask_guided, H, W)
    px, py = _jax_pixel_draw(key, bbox, img_idx, batch, patch, mask_guided)
    out_t = trays.gen_random_rays(
        None, torch.from_numpy(images), torch.from_numpy(masks),
        torch.from_numpy(intr_inv), torch.from_numpy(pose), img_idx, batch,
        torch.from_numpy(bbox), patch, mask_guided, H, W,
        pixels=(torch.from_numpy(px).long(), torch.from_numpy(py).long()))
    _close(out_j, out_t)


@pytest.mark.parametrize("mask_guided", [False, True])
def test_sample_pixels_window(frames, mask_guided):
    _, _, _, bbox, _ = frames
    g = torch.Generator().manual_seed(3)
    patch = 2
    y0, y1, x0, x1 = bbox[2]
    in_box = 0
    for _ in range(40):
        px, py = trays.sample_pixels(g, torch.from_numpy(bbox), 2, 64, patch,
                                     mask_guided, H, W)
        assert px.min() >= 0 and px.max() < W and py.min() >= 0 and py.max() < H
        inside = ((px >= max(x0 - patch, 0)) & (px < min(x1 + patch, W))
                  & (py >= max(y0 - patch, 0)) & (py < min(y1 + patch, H)))
        in_box += int(inside.all())
    if mask_guided:
        assert 15 <= in_box <= 38   # ~70% of the batches use the bbox window
    else:
        assert in_box == 0


def test_rays_grid_and_near_far(frames):
    _, _, intr_inv, _, pose = frames
    oj, dj = jrays.gen_rays_grid(jnp.asarray(intr_inv[0]), jnp.asarray(pose), H, W, 2)
    ot, dt = trays.gen_rays_grid(torch.from_numpy(intr_inv[0]), torch.from_numpy(pose), H, W, 2)
    _close(oj, ot)
    _close(dj, dt)
    nj, fj = jrays.near_far_from_sphere(oj.reshape(-1, 3), dj.reshape(-1, 3))
    nt, ft = trays.near_far_from_sphere(ot.reshape(-1, 3), dt.reshape(-1, 3))
    _close(nj, nt)
    _close(fj, ft)


# ---------------------------------------------------------------------------
# core/quaternion.py (tests/test_quaternion.py against the JAX functions)
# ---------------------------------------------------------------------------

def _random_R(n, seed=0):
    from scipy.spatial.transform import Rotation
    return Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)


def _quats():
    from fmov_pose_tpu.core import quaternion as jq
    from fmov_pose_torch.core import quaternion as tq
    return jq, tq


def test_quaternion_R_round_trip_matches_jax():
    from scipy.spatial.transform import Rotation
    jq, tq = _quats()
    R = _random_R(64)
    q = tq.R_to_q(torch.from_numpy(R))
    _close(jq.R_to_q(jnp.asarray(R)), q, 1e-6)
    _close(jq.q_to_R(jnp.asarray(q.numpy())), tq.q_to_R(q), 1e-6)
    np.testing.assert_allclose(tq.q_to_R(q).numpy(), R, atol=2e-3)
    # against scipy's, up to the quaternion's sign
    q_sp = Rotation.from_matrix(R[:32]).as_quat()
    q_sp = np.concatenate([q_sp[:, 3:], q_sp[:, :3]], axis=-1)
    sign = np.sign(np.sum(q.numpy()[:32] * q_sp, axis=-1, keepdims=True))
    np.testing.assert_allclose(q.numpy()[:32], q_sp * sign, atol=2e-3)


def test_quaternion_product_invert_matches_jax():
    from scipy.spatial.transform import Rotation
    jq, tq = _quats()
    R = _random_R(16, seed=2)
    q_sp = Rotation.from_matrix(R).as_quat()
    q = np.concatenate([q_sp[:, 3:], q_sp[:, :3]], axis=-1).astype(np.float32)
    qt = torch.from_numpy(q)
    _close(jq.q_invert(jnp.asarray(q)), tq.q_invert(qt), 1e-6)
    prod = tq.q_product(qt[:8], qt[8:])
    _close(jq.q_product(jnp.asarray(q[:8]), jnp.asarray(q[8:])), prod, 1e-6)
    ident = tq.q_product(qt, tq.q_invert(qt)).numpy()
    np.testing.assert_allclose(ident, np.tile([1.0, 0, 0, 0], (16, 1)), atol=1e-5)
    np.testing.assert_allclose(tq.q_to_R(prod).numpy(), R[:8] @ R[8:], atol=1e-5)


@pytest.mark.parametrize("u", [0.0, 0.25, 0.5, 1.0])
def test_quaternion_slerp_matches_jax(u):
    from scipy.spatial.transform import Rotation
    jq, tq = _quats()
    R = _random_R(2, seed=3)
    q0, q1 = tq.R_to_q(torch.from_numpy(R))
    got = tq.slerp(q0, q1, u)
    _close(jq.slerp(jnp.asarray(q0.numpy()), jnp.asarray(q1.numpy()), u), got, 1e-6)
    if u == 0.5:  # the midpoint is equidistant in rotation angle
        Rm = tq.q_to_R(got).numpy()
        d0 = Rotation.from_matrix(R[0].T @ Rm).magnitude()
        d1 = Rotation.from_matrix(R[1].T @ Rm).magnitude()
        np.testing.assert_allclose(d0, d1, atol=1e-4)
    # near-equal quaternions take the linear branch
    _close(jq.slerp(jnp.asarray(q0.numpy()), jnp.asarray(q0.numpy()), u),
           tq.slerp(q0, q0.clone(), u), 1e-6)


@pytest.mark.parametrize("axis", ["X", "Y", "Z"])
def test_angle_to_rotation_matrix_matches_jax(axis):
    jq, tq = _quats()
    a = np.linspace(-3.0, 3.0, 7).astype(np.float32)
    _close(jq.angle_to_rotation_matrix(jnp.asarray(a), axis),
           tq.angle_to_rotation_matrix(torch.from_numpy(a), axis), 1e-6)


def test_novel_view_poses_match_jax():
    jq, tq = _quats()
    anchor = np.eye(3, 4, dtype=np.float32)
    anchor[2, 3] = 2.0
    anchor[:3, :3] = _random_R(1, seed=5)[0]
    for n, scale in ((12, 1.0), (60, 0.5)):
        got = tq.get_novel_view_poses(torch.from_numpy(anchor), N=n, scale=scale)
        assert got.shape == (n, 3, 4)
        _close(jq.get_novel_view_poses(jnp.asarray(anchor), N=n, scale=scale), got, 1e-5)
        R = got[:, :, :3].numpy()
        np.testing.assert_allclose(np.einsum("nij,nik->njk", R, R),
                                   np.broadcast_to(np.eye(3), (n, 3, 3)), atol=1e-5)


# ---------------------------------------------------------------------------
# utils/misc.py against the JAX copy
# ---------------------------------------------------------------------------

def _miscs():
    pytest.importorskip("cv2")
    from fmov_pose_tpu.utils import misc as jm
    from fmov_pose_torch.utils import misc as tm
    return jm, tm


def test_misc_numpy_helpers_match_jax():
    jm, tm = _miscs()
    rng = np.random.default_rng(0)
    pred, gt = rng.random((20, 30)) > 0.4, rng.random((20, 30)) > 0.5
    assert tm.calculate_mask_metrics(pred, gt) == jm.calculate_mask_metrics(pred, gt)
    assert tm.calculate_mask_metrics(pred * 0, gt) == jm.calculate_mask_metrics(pred * 0, gt)
    flow = rng.normal(size=(24, 32, 2)) * 3
    np.testing.assert_array_equal(tm.flow_to_color(flow), jm.flow_to_color(flow))
    for pose in (rng.normal(size=(4, 4)), np.eye(4)):
        np.testing.assert_array_equal(tm.normalize_pose_translation(pose),
                                      jm.normalize_pose_translation(pose))
    v = rng.normal(size=(100, 3))
    for a, b in zip(tm.get_center_radius(v), jm.get_center_radius(v)):
        np.testing.assert_array_equal(a, b)


def test_misc_cv2_helpers_match_jax():
    jm, tm = _miscs()
    rng = np.random.default_rng(1)
    mask = np.zeros((60, 80), bool)
    mask[10:50, 15:70] = True
    for ratio in (0.9, 0.5):
        got = tm.shrink_mask(mask, ratio)
        np.testing.assert_array_equal(got, jm.shrink_mask(mask, ratio))
        assert got.sum() < mask.sum() or ratio > 0.8  # a 1-pixel element at 0.9
    img1 = rng.integers(0, 255, (40, 50, 3)).astype(np.uint8)
    img2 = rng.integers(0, 255, (30, 60, 3)).astype(np.uint8)
    pts1, pts2 = rng.random((120, 2)) * 30, rng.random((120, 2)) * 30
    np.testing.assert_array_equal(tm.draw_matches(img1, pts1, img2, pts2),
                                  jm.draw_matches(img1, pts1, img2, pts2))


def test_misc_colorize_matches_jax(monkeypatch):
    matplotlib = pytest.importorskip("matplotlib")
    import matplotlib.cm as cm
    jm, tm = _miscs()
    # the JAX copy asks matplotlib.cm for get_cmap, which matplotlib 3.9
    # removed; the port reads matplotlib.colormaps, which it stands for
    monkeypatch.setattr(cm, "get_cmap", lambda name: matplotlib.colormaps[name],
                        raising=False)
    rng = np.random.default_rng(2)
    x, mask = rng.normal(size=(16, 20)), rng.random((16, 20)) > 0.3
    for kw in ({}, {"mask": mask}, {"cmap_name": "viridis", "mask": mask}):
        np.testing.assert_array_equal(tm.colorize_np(x, **kw), jm.colorize_np(x, **kw))


def test_misc_cluster_matches_jax():
    pytest.importorskip("sklearn")
    jm, tm = _miscs()
    img = np.random.default_rng(3).random((12, 14, 3)).astype(np.float32)
    (lt, ct), (lj, cj) = tm.cluster_and_color_image(img, 3), jm.cluster_and_color_image(img, 3)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ct, cj)
