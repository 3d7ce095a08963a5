"""Flat Adam with a dynamic learning rate (port of
``fmov_pose_tpu/train/optim.py:31-73``).

Moments live in one raveled [P] buffer in ``convert.ParamLayout`` order
(JAX's ``ravel_pytree`` order).  A zero gradient still steps: the moments
decay and the parameters move by momentum, which is torch's
``zero_grad(); step()`` drift that the ``detach_mesh_at_warm_up`` gate
relies on.  The update is in place, on the flat parameter buffer the
training state owns.  The segment-bank Adam is slice 2 of the port.
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
