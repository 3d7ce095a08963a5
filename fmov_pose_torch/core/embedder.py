"""Positional / Fourier encoders (port of ``fmov_pose_tpu/core/embedder.py``).

Layout: [x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...] with each
block the full input width, so geometric-init slicing stays
index-compatible.  The BARF coarse-to-fine weights, which the reference
computes but never applies, are not ported.
"""

from __future__ import annotations

import math

import torch

__all__ = ["embed_dim", "positional_encode", "fourier_features"]


def embed_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    """NeRF positional encoding [..., d] -> [..., d*(1 + 2*multires)] with
    log-spaced frequencies 2^k, k < multires."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # [..., L, d]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., L, 2, d]
    sc = sc.reshape(x.shape[:-1] + (2 * multires * x.shape[-1],))
    return torch.cat([x, sc], dim=-1)


def fourier_features(cam_id: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[sin(2*pi*id @ b.T), cos(2*pi*id @ b.T)] / sqrt(E).

    cam_id: [..., 1] float; b: [E, 1] fixed gaussian bands.  Returns [..., 2E].
    """
    ang = (2.0 * math.pi * cam_id) @ b.T  # [..., E]
    feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return feats / math.sqrt(b.shape[0])
