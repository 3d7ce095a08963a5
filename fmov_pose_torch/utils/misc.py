"""Image and mask helpers on the host (port of
``fmov_pose_tpu/utils/misc.py``): mask erosion, segmentation metrics,
depth colorization, the optical-flow color wheel, match drawing, pose
normalization, color clustering and a point set's bounding sphere.

numpy throughout; OpenCV, matplotlib and scikit-learn are imported inside
the helpers that call them, so the module imports where they are absent.
"""

from __future__ import annotations

import numpy as np

__all__ = ["shrink_mask", "calculate_mask_metrics", "colorize_np",
           "flow_to_color", "draw_matches", "normalize_pose_translation",
           "cluster_and_color_image", "get_center_radius"]


def shrink_mask(mask: np.ndarray, shrink_ratio: float = 0.9) -> np.ndarray:
    """Erode a boolean mask to ~shrink_ratio of its area
    (`util.py:31-46` / `dataset.py:56-67`)."""
    import cv2
    mask_uint8 = mask.astype(np.uint8) * 255
    selem_size = max(int((1 - np.sqrt(shrink_ratio)) * np.sqrt(mask.size) / 2), 1)
    selem = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                      (selem_size, selem_size))
    return cv2.erode(mask_uint8, selem).astype(bool)


def calculate_mask_metrics(pred_mask: np.ndarray, gt_mask: np.ndarray):
    """Precision / recall / F1 of a predicted object mask (`util.py:124`)."""
    pred = pred_mask.astype(bool).reshape(-1)
    gt = gt_mask.astype(bool).reshape(-1)
    tp = np.sum(pred & gt)
    precision = tp / max(pred.sum(), 1)
    recall = tp / max(gt.sum(), 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {"precision": float(precision), "recall": float(recall),
            "f1": float(f1)}


def colorize_np(x: np.ndarray, cmap_name: str = "jet", mask=None,
                append_cbar: bool = False):
    """Normalize a scalar map to a color image (`util.py:393-467`)."""
    import matplotlib
    x = np.asarray(x, np.float64)
    if mask is not None:
        vals = x[mask.astype(bool)]
    else:
        vals = x.reshape(-1)
    lo, hi = (vals.min(), vals.max()) if vals.size else (0.0, 1.0)
    xn = (x - lo) / max(hi - lo, 1e-9)
    rgb = matplotlib.colormaps[cmap_name](np.clip(xn, 0, 1))[..., :3]
    if mask is not None:
        rgb = rgb * mask[..., None].astype(np.float64)
    return rgb


def _flow_colorwheel():
    """Middlebury color wheel (`util.py:470-530`)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_color(flow: np.ndarray) -> np.ndarray:
    """[H, W, 2] optical flow -> uint8 color image (`util.py:533-591`)."""
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-9)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u**2 + v**2)
    wheel = _flow_colorwheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255
        col1 = wheel[k1, c] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img


def draw_matches(img1, pts1, img2, pts2, max_draw=100):
    """Side-by-side correspondence visualization (`util.py:268`)."""
    import cv2
    h1, w1 = img1.shape[:2]
    h2, w2 = img2.shape[:2]
    canvas = np.zeros((max(h1, h2), w1 + w2, 3), np.uint8)
    canvas[:h1, :w1] = img1
    canvas[:h2, w1:w1 + w2] = img2
    n = min(len(pts1), max_draw)
    rng = np.random.default_rng(0)
    for i in range(n):
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        p1 = (int(pts1[i][0]), int(pts1[i][1]))
        p2 = (int(pts2[i][0]) + w1, int(pts2[i][1]))
        cv2.circle(canvas, p1, 2, color, -1)
        cv2.circle(canvas, p2, 2, color, -1)
        cv2.line(canvas, p1, p2, color, 1)
    return canvas


def normalize_pose_translation(pose: np.ndarray) -> np.ndarray:
    """Unit-norm translation copy of a pose (`util.py:22`)."""
    out = np.array(pose, copy=True)
    n = np.linalg.norm(out[:3, 3])
    if n > 1e-9:
        out[:3, 3] /= n
    return out


def cluster_and_color_image(image: np.ndarray, n_clusters: int = 5,
                            seed: int = 0):
    """KMeans color clustering of an image (`util.py:79`). Returns the
    label map and the cluster-colored image."""
    from sklearn.cluster import KMeans
    h, w = image.shape[:2]
    pixels = image.reshape(-1, image.shape[-1]).astype(np.float64)
    km = KMeans(n_clusters=n_clusters, n_init=4, random_state=seed)
    labels = km.fit_predict(pixels)
    colored = km.cluster_centers_[labels].reshape(h, w, -1)
    return labels.reshape(h, w), colored.astype(image.dtype)


def get_center_radius(vertices: np.ndarray):
    """Bbox center + max radius of a point set (`dataset.py:87-92`)."""
    bbox_max = vertices.max(axis=0)
    bbox_min = vertices.min(axis=0)
    center = (bbox_max + bbox_min) * 0.5
    radius = np.linalg.norm(vertices - center, axis=-1).max()
    return center, radius
