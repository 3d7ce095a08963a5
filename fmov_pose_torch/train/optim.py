"""Flat Adam with a dynamic learning rate, and the segment-bank Adam (port
of ``fmov_pose_tpu/train/optim.py:31-152``).

Moments live in one raveled [P] buffer in ``convert.ParamLayout`` order
(JAX's ``ravel_pytree`` order).  A zero gradient still steps: the moments
decay and the parameters move by momentum, which is torch's
``zero_grad(); step()`` drift that the ``detach_mesh_at_warm_up`` gate
relies on.  The update is in place, on the flat parameter buffer the
training state owns.  The training steps keep the step count on the
device (``adam_update_flat_dev_``; the per-step loop beside the host's
count, the scanned and planned steps advancing the host's by a chunk):
the count and the bias corrections never reach the host, so a captured
step reads nothing back, and every loop takes the same arithmetic.

The segment-bank Adam is S independent Adams over one flat bank buffer
(leaves [S, ...], so the ravel is segment-major): per-segment step
counts, and per step a 0/1 ``touch`` [S] (which segments' optimizers step)
and per-segment learning rates, all on the device, so a step reads
nothing back.  An untouched segment keeps its moments and parameters; a
touched but frozen one (its gradient gated to 0) still drifts by
momentum, as torch's ``zero_grad(); step()`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    step: int
    mu: torch.Tensor   # [P]
    nu: torch.Tensor   # [P]


def adam_init(flat: torch.Tensor) -> AdamState:
    if flat.dtype != torch.float32:
        raise TypeError(f"flat Adam assumes f32 params, got {flat.dtype}")
    return AdamState(step=0, mu=torch.zeros_like(flat), nu=torch.zeros_like(flat))


@torch.no_grad()
def adam_update_flat_(flat_g: torch.Tensor, state: AdamState,
                      flat_p: torch.Tensor, lr: float) -> AdamState:
    """One Adam step from a raveled (and gated) gradient; updates
    ``flat_p``, ``state.mu`` and ``state.nu`` in place.  The bias
    corrections are computed in f32, like the JAX module's."""
    state.step += 1
    state.mu.mul_(B1).add_(flat_g, alpha=1 - B1)
    state.nu.mul_(B2).addcmul_(flat_g, flat_g, value=1 - B2)
    stepf = torch.tensor(float(state.step), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** stepf)
    bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** stepf)
    denom = torch.sqrt(state.nu / bc2) + EPS
    flat_p.sub_(lr * (state.mu / bc1) / denom)
    return state


@torch.no_grad()
def adam_update_flat_dev_(flat_g: torch.Tensor, state: AdamState,
                          flat_p: torch.Tensor, lr: torch.Tensor,
                          step: torch.Tensor) -> AdamState:
    """``adam_update_flat_`` with the step count ``step`` (0-d int32) and
    the learning rate ``lr`` (0-d f32) on the device: the count is
    incremented in place and the bias corrections are computed from it in
    f32, as the JAX module computes them.  ``state.step`` (the host count)
    is left to the caller, which advances it by the steps it ran."""
    step.add_(1)
    stepf = step.to(torch.float32)
    state.mu.mul_(B1).add_(flat_g, alpha=1 - B1)
    state.nu.mul_(B2).addcmul_(flat_g, flat_g, value=1 - B2)
    bc1 = 1 - torch.pow(B1, stepf)
    bc2 = 1 - torch.pow(B2, stepf)
    denom = torch.sqrt(state.nu / bc2) + EPS
    flat_p.sub_(lr * (state.mu / bc1) / denom)
    return state


@dataclass
class SegAdamState:
    step: torch.Tensor  # [S] int32 per-segment step counts
    mu: torch.Tensor    # [P]
    nu: torch.Tensor    # [P]


def seg_adam_init(flat: torch.Tensor, shapes, n_segments: int) -> SegAdamState:
    """Zero moments over the flat bank buffer; ``shapes``: the bank leaves'
    shapes, each leading with the segment axis."""
    for shape in shapes:
        if shape[0] != n_segments:
            raise ValueError(f"bank leaf {shape} does not lead with the segment "
                             f"axis ({n_segments})")
    return SegAdamState(step=torch.zeros(n_segments, dtype=torch.int32,
                                         device=flat.device),
                        mu=torch.zeros_like(flat), nu=torch.zeros_like(flat))


def seg_index(shapes, device=None) -> torch.Tensor:
    """int64 [P]: the segment owning each position of the flat bank."""
    parts = [torch.arange(shape[0]).repeat_interleave(
        int(torch.tensor(shape[1:]).prod())) for shape in shapes]
    idx = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    return idx.to(device) if device is not None else idx


@torch.no_grad()
def seg_adam_update_flat_(flat_g: torch.Tensor, state: SegAdamState,
                          flat_p: torch.Tensor, touch: torch.Tensor,
                          seg_lr: torch.Tensor, idx: torch.Tensor) -> SegAdamState:
    """One step of the segment Adams from a raveled (and gated) gradient;
    touch [S] 0/1 and seg_lr [S] f32 on the device, idx = ``seg_index``.
    Updates ``flat_p``, the moments and the step counts in place."""
    state.step += touch.to(torch.int32)
    stepf = torch.clamp(state.step.to(torch.float32), min=1.0)
    bc1 = 1 - torch.pow(B1, stepf)  # [S]
    bc2 = 1 - torch.pow(B2, stepf)
    t = touch[idx] > 0
    state.mu.copy_(torch.where(t, B1 * state.mu + (1 - B1) * flat_g, state.mu))
    state.nu.copy_(torch.where(t, B2 * state.nu + (1 - B2) * flat_g * flat_g,
                               state.nu))
    delta = (state.mu / bc1[idx]) / (torch.sqrt(state.nu / bc2[idx]) + EPS)
    flat_p.sub_(seg_lr[idx] * touch[idx] * delta)
    return state
