"""On-device ray generation (port of ``fmov_pose_tpu/data/rays.py``).

The image and mask stacks live on the device; each step gathers its ray
batch there from a frame id and a ``torch.Generator``.  Pixels are plain
index gathers (the JAX module's one-hot contractions exist because
gathers serialize on a TPU).  Images are [N, H, W, 3], masks [N, H, W].
"""

from __future__ import annotations

import torch

__all__ = [
    "gather_rgb",
    "pixels_to_rays",
    "sample_pixels",
    "gen_random_rays",
    "gen_flow_rays",
    "gen_rays_grid",
    "near_far_from_sphere",
]


def gather_rgb(images, img_idx, py, px):
    """Colors [B, 3] of frame ``img_idx`` of images [N, H, W, 3] at integer
    pixel ids py, px [B] (the JAX module's one-hot gather)."""
    return images[img_idx, py, px]


def pixels_to_rays(px, py, intr_inv, pose):
    """Pixel coords -> world rays.

    px, py: [...] float pixel coordinates; intr_inv: [3, 3] (or [4, 4]);
    pose: [3, 4].  Returns (rays_o [..., 3], rays_d [..., 3], p_norm [..., 1]).
    """
    p = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    p = p @ intr_inv[:3, :3].T
    p_norm = torch.linalg.norm(p, dim=-1, keepdim=True)
    rays_v = (p / p_norm) @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_v.shape)
    return rays_o, rays_v, p_norm


def sample_pixels(generator, bbox_table, img_idx, batch_size: int,
                  patch_size: int, mask_guided: bool, H: int, W: int,
                  mask_guided_active: float = 1.0):
    """Uniform pixel ids (px, py) [B] of one frame; with mask guiding on,
    70% of draws restrict the window to the dilated mask bbox
    (``bbox_table[img_idx]`` = ymin, ymax, xmin, xmax).  All on the table's
    device, with no host sync."""
    dev = bbox_table.device
    u = torch.rand((3, batch_size), generator=generator, device=dev)
    if mask_guided and mask_guided_active > 0:
        use_bbox = torch.rand((), generator=generator, device=dev) < 0.7
        y0, y1, x0, x1 = bbox_table[img_idx].unbind()
        y_lo = torch.where(use_bbox, torch.clamp(y0 - patch_size, min=0), 0)
        y_hi = torch.where(use_bbox, torch.clamp(y1 + patch_size, max=H), H)
        x_lo = torch.where(use_bbox, torch.clamp(x0 - patch_size, min=0), 0)
        x_hi = torch.where(use_bbox, torch.clamp(x1 + patch_size, max=W), W)
    else:
        y_lo, y_hi, x_lo, x_hi = 0, H, 0, W  # host ints: no copy to the device
    px = x_lo + torch.floor(u[0] * (x_hi - x_lo)).long()
    py = y_lo + torch.floor(u[1] * (y_hi - y_lo)).long()
    # u * n can round up to n in f32
    return torch.clamp(px, max=x_hi - 1), torch.clamp(py, max=y_hi - 1)


def gen_random_rays(generator, images, masks, intr_inv_all, pose, img_idx,
                    batch_size: int, bbox_table, patch_size: int,
                    mask_guided: bool, H: int, W: int,
                    mask_guided_active: float = 1.0, pixels=None):
    """Random ray batch from one frame.

    images: [N, H, W, 3], masks: [N, H, W], intr_inv_all: [N, 4, 4],
    pose: [3, 4] c2w, img_idx: int, bbox_table: [N, 4].  ``pixels``: an
    optional given (px, py) pair of int tensors [B], in place of the draw.
    Returns data [batch, 10] = (rays_o, rays_d, color, mask).
    """
    if pixels is None:
        px, py = sample_pixels(generator, bbox_table, img_idx, batch_size,
                               patch_size, mask_guided, H, W,
                               mask_guided_active)
    else:
        px, py = pixels
    color = gather_rgb(images, img_idx, py, px)  # [B, 3]
    mask = masks[img_idx, py, px][:, None]     # [B, 1]
    rays_o, rays_v, _ = pixels_to_rays(px.to(pose.dtype), py.to(pose.dtype),
                                       intr_inv_all[img_idx], pose)
    return torch.cat([rays_o, rays_v, color, mask], dim=-1)


def gen_flow_rays(pixels_xy, intr_inv, pose):
    """Rays (rays_o, rays_d) [B, 3] through match pixel coords [B, 2]
    (fractional) of a frame with pose [3, 4]."""
    rays_o, rays_v, _ = pixels_to_rays(pixels_xy[:, 0], pixels_xy[:, 1], intr_inv, pose)
    return rays_o, rays_v


def gen_rays_grid(intr_inv, pose, H: int, W: int, resolution_level: int = 1):
    """Full-frame ray grid; returns rays_o, rays_d of shape [H//l, W//l, 3]."""
    l = resolution_level
    tx = torch.linspace(0, W - 1, W // l, device=pose.device)
    ty = torch.linspace(0, H - 1, H // l, device=pose.device)
    py, px = torch.meshgrid(ty, tx, indexing="ij")
    rays_o, rays_v, _ = pixels_to_rays(px, py, intr_inv, pose)
    return rays_o, rays_v


def near_far_from_sphere(rays_o, rays_d):
    """mid -/+ 1 heuristic of the unit-sphere scene."""
    a = torch.sum(rays_d ** 2, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0
