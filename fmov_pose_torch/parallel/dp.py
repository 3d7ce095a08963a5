"""Data parallelism over ``torch.distributed`` (port of
``fmov_pose_tpu/parallel/dp.py``).

The ray batch is split over the ranks, one process a rank, each on
``cuda:(rank mod device_count)``.  Parameters, Adam moments and pose banks
are replicated.  Every ratio-of-sums loss sums its numerator and its
denominator over the ranks (``step._render_and_losses`` with a process
group), so the objective and its gradient are the single-device ones; one
all-reduce of the flat gradient buffer (with a segment bank's, in one
buffer) is the whole synchronisation of a step, and every rank then
applies the same update and ends the step with bitwise the same state.
No ``DistributedDataParallel`` wrapper: the port's gradients are already
one flat buffer.

The process group is the JAX module's mesh, so ``make_mesh`` has no
counterpart: the step functions take a ``group`` (None: the default group).
NCCL is the backend on CUDA and gloo on the CPU, unless the caller names
one; gloo also takes CUDA tensors (staged through the host), which lets
two ranks share one card, as NCCL does not.

Random draws: every rank's ``TrainState.generator`` is seeded alike and
draws what the ranks decide together (the scanned steps' frames, the JAX
module's replicated key); ``attach_rank_generator`` gives each rank its
own generator for its rays and the render's perturbation (JAX's per-device
keys).  The host planner (the Runner's numpy RNG) is the same on every
rank, and each rank takes its rows of what it plans (``make_dp_flow_step``).

On CUDA with NCCL the scanned steps (``make_dp_scan_photo_steps``) capture
the all-reduces into the step's CUDA graph; under gloo, which stages
through the host and cannot be captured, a chunk's steps run eagerly.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from fmov_pose_torch.train import step as step_mod

__all__ = ["make_dp_photo_step", "make_dp_flow_step", "make_dp_scan_photo_steps",
           "maybe_initialize_distributed", "initialize", "is_main", "world_size", "rank",
           "replicate_tree", "attach_rank_generator", "gather_generator_states",
           "local_device", "barrier", "capturable", "shutdown"]

def maybe_initialize_distributed(backend=None) -> bool:
    """Join the process group when launched as one of several ranks:
    env-gated (``FMOV_DISTRIBUTED=1``), idempotent, a no-op by default.
    ``FMOV_COORDINATOR`` (host:port) with ``FMOV_NUM_PROCESSES`` and
    ``FMOV_PROCESS_ID`` gives a ``tcp://`` init; without it the ``env://``
    variables that ``torchrun`` sets.  ``backend``: NCCL where CUDA is
    available, else gloo, unless named.  With NCCL the rank's device is
    made current first (``local_device``).  Returns whether a group
    exists."""
    if dist.is_initialized():
        return True
    env = os.environ
    if env.get("FMOV_DISTRIBUTED") != "1":
        return False
    if env.get("FMOV_COORDINATOR"):
        initialize(env["FMOV_COORDINATOR"], int(env["FMOV_NUM_PROCESSES"]),
                   int(env["FMOV_PROCESS_ID"]), backend)
    else:
        initialize("env://", int(env["WORLD_SIZE"]), int(env["RANK"]), backend)
    return True


def initialize(coordinator: str, n_ranks: int, rank_id: int, backend=None):
    """``init_process_group`` at ``coordinator`` (host:port, or a URL such
    as ``env://``) as rank ``rank_id`` of ``n_ranks``; ``backend`` as in
    ``maybe_initialize_distributed``.  A failure raises with its cause."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=coordinator if "://" in coordinator else f"tcp://{coordinator}",
        world_size=n_ranks, rank=rank_id, timeout=datetime.timedelta(minutes=10))


def world_size(group=None) -> int:
    """The ranks of ``group`` (the default group), 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``, 0 without one."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main() -> bool:
    """True on the process that owns the host's writes (checkpoints,
    meshes, validation images, pose files): rank 0, or the only one."""
    return rank() == 0


def local_device() -> torch.device:
    """This rank's card, ``cuda:(rank mod device_count)``; raises without
    CUDA (``device.require_cuda``)."""
    from fmov_pose_torch.device import require_cuda
    require_cuda()
    return require_cuda(rank() % torch.cuda.device_count())


def barrier():
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown():
    """Leave the process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _broadcast_(t: torch.Tensor, group):
    """``t`` set to rank 0's in place (a host tensor under NCCL goes
    through the rank's card)."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    if _nccl(group) and t.device.type != "cuda":
        dev = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.broadcast(dev, src, group=group)
        t.copy_(dev.cpu())
    else:
        dist.broadcast(t, src, group=group)


@torch.no_grad()
def replicate_tree(tree, group=None):
    """Every tensor and every generator's state in ``tree`` (nested dicts,
    lists and tuples) set in place to rank 0's: the ranks' state made one
    (a no-op without a group).  Host values are left alone: the caller
    keeps them equal.  Returns ``tree``."""
    if world_size(group) == 1:
        return tree

    def visit(x):
        if isinstance(x, torch.Tensor):
            _broadcast_(x.detach(), group)
        elif isinstance(x, torch.Generator):
            state = x.get_state()
            _broadcast_(state, group)
            x.set_state(state)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    return tree


def attach_rank_generator(state: step_mod.TrainState, seed: int, group=None):
    """Give ``state`` this rank's own generator for its rays and the
    render's perturbation, seeded from ``seed`` and the rank through
    numpy's ``SeedSequence`` (32 bits: the CPU generator keeps no more).
    With one rank the state's generator draws everything, so a group of
    one is the single-device step, bitwise."""
    if world_size(group) == 1:
        state.ray_generator = None
        return state
    gen = torch.Generator(device=state.flat.device)
    gen.manual_seed(int(np.random.SeedSequence([seed, rank(group)]).generate_state(1)[0]))
    state.ray_generator = gen
    return state


def gather_generator_states(generator, group=None):
    """[the generator state of each rank] on every rank (a collective)."""
    states = [None] * world_size(group)
    dist.all_gather_object(states, generator.get_state().numpy(), group=group)
    return states


def capturable(group, device) -> bool:
    """Whether a data-parallel step on ``device`` can be captured into a
    CUDA graph: on CUDA under NCCL; gloo stages through the host."""
    return torch.device(device).type == "cuda" and _nccl(group)


def _local_cfg(cfg: step_mod.StepConfig, group, flow: bool) -> step_mod.StepConfig:
    """``cfg`` with this rank's share of the global ``batch_size``."""
    n = world_size(group)
    if cfg.batch_size % n or (flow and (cfg.batch_size // 2) % n):
        raise ValueError(f"a global batch of {cfg.batch_size} rays does not split "
                         f"over {n} ranks")
    return dataclasses.replace(cfg, batch_size=cfg.batch_size // n)


def make_dp_photo_step(cfg: step_mod.StepConfig, images, masks, intr_inv_all,
                       bbox_table, group=None, depths=None):
    """``step.make_photo_step`` with the ray batch split over ``group``:
    ``cfg.batch_size`` is the global batch, each rank draws ``batch_size /
    world`` rays (and as many maintain_shape rays) from its own generator;
    given ``pixels`` / ``add_pixels`` are this rank's."""
    return step_mod.make_photo_step(_local_cfg(cfg, group, False), images, masks,
                                    intr_inv_all, bbox_table, depths=depths,
                                    group=_group(group))


def make_dp_flow_step(cfg: step_mod.StepConfig, images, masks, intr_inv_all,
                      bbox_table, group=None):
    """``step.make_flow_step`` with the match batch split over ``group``:
    every rank is given the whole ``pixels_pair`` [B/2, 4] the host
    planned and takes its rows (rank r: rows r*B/(2*world) onward), the
    maintain_shape rays drawn per rank as in the photo step."""
    n, r = world_size(group), rank(group)
    local = _local_cfg(cfg, group, True)
    rows = cfg.batch_size // 2 // n
    run = step_mod.make_flow_step(local, images, masks, intr_inv_all, bbox_table,
                                  group=_group(group))

    def run_one(state, scalars, img_id, img_id_corr, add_img_id, pixels_pair,
                add_pixels=None):
        if len(pixels_pair) != cfg.batch_size // 2:
            raise ValueError(f"{len(pixels_pair)} match pairs, the global batch has "
                             f"{cfg.batch_size // 2}")
        return run(state, scalars, img_id, img_id_corr, add_img_id,
                   pixels_pair[r * rows:(r + 1) * rows], add_pixels)

    return run_one


def make_dp_scan_photo_steps(cfg: step_mod.StepConfig, images, masks, intr_inv_all,
                             bbox_table, schedule, k_steps: int, group=None,
                             depths=None, capture=None):
    """``step.ScanPhotoSteps`` with the ray batch split over ``group``: the
    frame from the generator the ranks share, the rays from each rank's
    own.  Captured into a CUDA graph, all-reduces included, where
    ``capturable`` says so (CUDA and NCCL); under gloo a chunk's steps run
    eagerly.  ``capture=False`` runs them eagerly anyway (a test's
    reference)."""
    g = _group(group)
    if capture is None:
        capture = capturable(g, images.device)
    return step_mod.ScanPhotoSteps(
        _local_cfg(cfg, group, False), images, masks, intr_inv_all, bbox_table,
        schedule, k_steps, capture=capture, depths=depths, group=g)


def _group(group):
    """The process group a step reduces over: ``group``, or the default
    one (which must exist)."""
    if group is not None:
        return group
    if not dist.is_initialized():
        raise RuntimeError("data parallelism needs a process group: "
                           "maybe_initialize_distributed() found none")
    return dist.group.WORLD
