"""Inverse-CDF importance sampling (port of ``fmov_pose_tpu/core/sampling.py``).

The JAX module replaces ``searchsorted`` and argsort with compare-all
reductions because gathers serialize on a TPU.  On a GPU the natural forms
are fast, so this port uses ``torch.searchsorted`` and a stable sort with
the same numerics: 1e-5 weight floor, right-side search, denominator clamp,
and ties in concatenation order.
"""

from __future__ import annotations

import torch

__all__ = ["sample_pdf", "merge_sorted"]


def merge_sorted(z_a: torch.Tensor, z_b: torch.Tensor,
                 v_a: torch.Tensor | None = None,
                 v_b: torch.Tensor | None = None):
    """Merge two per-ray ascending arrays by a stable sort of the concat,
    so on ties every z_a sorts before z_b.  v_a/v_b: optional payloads
    carried through the same permutation.  Returns z or (z, v)."""
    z = torch.cat([z_a, z_b], dim=-1)
    z_sorted, order = torch.sort(z, dim=-1, stable=True)
    if v_a is None:
        return z_sorted
    v = torch.cat([v_a, v_b], dim=-1)
    return z_sorted, torch.gather(v, -1, order)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Draw n_samples per ray from the piecewise-constant pdf over bins.

    bins: [B, N] bin edges; weights: [B, N-1].  generator=None gives the
    deterministic mid-stratified samples the renderer uses.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, N]

    shape = cdf.shape[:-1] + (n_samples,)
    if generator is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device).expand(shape)
    else:
        u = torch.sort(torch.rand(shape, generator=generator, dtype=cdf.dtype,
                                  device=cdf.device), dim=-1).values
    u = u.contiguous()

    n = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
