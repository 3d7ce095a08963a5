"""One training step captured into a CUDA graph and replayed: the port's
counterpart of the JAX package's ``jax.jit`` + ``lax.scan`` dispatch
(``train/step.py``'s ``ScanPhotoSteps`` replays it k times a chunk).

A step of the port is ~900-1,500 kernel launches that the host issues one
by one; the device idles while it does.  A captured step is one graph
launch: the host enqueues it in microseconds, and the device runs its
kernels back to back.

What a graph needs of the step it captures:

* every tensor the step reads or writes outlives the graph at a fixed
  address (the state's flat parameters, the Adam moments, the pose
  buffers, the device counters), and is updated in place;
* nothing in it reads a value back to the host or copies host memory to
  the device (frame ids, gates and counts are device tensors there);
* its random draws come from generators registered with the graph, so
  that every replay draws anew (``register_generator_state``): a replay
  takes each generator's next offsets exactly as the eager step would, so
  a replayed step and an eager one from the same state and generator
  states draw the same numbers;
* the host tables a kernel wrapper passes at launch (layer tables, the
  workspace pointer tables) are read into the launch's arguments at
  capture, and the workspaces live in the graph's memory pool.

``StepGraph`` warms the step up on a side stream (``WARMUP_STEPS`` eager
steps: they build what PyTorch and the kernels' libraries set up at their
first use, which a capture cannot; every step after the first runs with
synchronising operations made errors, which names the operation a capture
would fail on), restores the state and the generator to where they were,
then captures one step.  A data-parallel step's NCCL all-reduces
(``parallel/dp.py``) are captured with it: the warm-up's steps run them
first, which sets up NCCL's communicator, as a capture cannot.  A failed
capture or replay raises with its cause: there is no return to eager
steps.  The whole is the span ``fmov::capture``, its warm-up
``fmov::warmup`` (``tracing.span``); the step's device marks are kernel
nodes of the graph.

Launch counts: a kernel wrapper counts a launch when it runs
(``fused_sdf.LAUNCHES*``, ``fused_color.LAUNCHES*``, ``wgrad.LAUNCHES``,
``LAUNCH_SIZES``).
The warm-up's launches ran and stay counted; the capture's did not run
and are taken back; each replay adds the launches the capture recorded
(``per_replay``), since a replay runs those kernels once more.
"""

from __future__ import annotations

import collections

import torch

from fmov_pose_torch import tracing

WARMUP_STEPS = 2
_SIDE_STREAMS = {}  # device -> the stream every capture warms up and captures on


def _side_stream(device) -> torch.cuda.Stream:
    """One side stream a device for every capture: PyTorch keeps a cuBLAS
    workspace for each stream a GEMM ran on, for the life of the process,
    so a new stream a capture would leave one more allocated each time."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _launch_counters():
    """{(module, name): count} of every kernel wrapper's launch counter,
    and a copy of the launches by (kernel, M)."""
    from fmov_pose_torch.ops import fused_color, fused_sdf, wgrad
    counts = {(mod, name): getattr(mod, name) for mod in (fused_sdf, fused_color, wgrad)
              for name in dir(mod) if name.startswith("LAUNCHES")}
    return counts, collections.Counter(fused_sdf.LAUNCH_SIZES)


def _counts_since(before):
    counts0, sizes0 = before
    counts, sizes = _launch_counters()
    sizes.subtract(sizes0)
    return ({key: counts[key] - counts0[key] for key in counts},
            +sizes)  # unary + drops the zero entries


def _add_counts(delta, times: int = 1):
    from fmov_pose_torch.ops import fused_sdf
    counts, sizes = delta
    for (mod, name), n in counts.items():
        setattr(mod, name, getattr(mod, name) + times * n)
    for key, n in sizes.items():
        fused_sdf.LAUNCH_SIZES[key] += times * n


def launches_by_kernel(delta) -> dict:
    """{"K1": n, ...} of a count delta (``per_replay``, ``warmup_launches``):
    K1-K9; the weight-gradient stage, launched once by each of K3, K5, K7
    and K9, is left out."""
    from fmov_pose_torch.ops import fused_sdf
    out = {}
    for (mod, name), n in delta[0].items():
        if mod is fused_sdf or name != "LAUNCHES":
            out["K1" if name == "LAUNCHES" else name.split("_")[-1]] = n
    return out


def _steady_step(fn):
    """``fn()`` with every synchronising CUDA operation an error, and the
    forward traceback of a failing backward op printed (anomaly mode
    without its NaN test, which would itself synchronise): what a capture
    cannot hold shows here with its cause."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.autograd.detect_anomaly(check_nan=False):
            fn()
    except RuntimeError as e:
        raise RuntimeError(f"the step waits on the host, which a captured step "
                           f"cannot (the forward traceback of a backward op is "
                           f"printed above): {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class StepGraph:
    """``fn()``, one training step, as a CUDA graph: warmed up, captured
    once, replayed by ``replay()``.

    ``generators``: the state's CUDA generators (``TrainState.generators``),
    each registered with the graph.  ``mutable``: every tensor the step
    writes; the warm-up's steps are undone by copying them back, with the
    generators' states.  ``fn`` is
    not kept past the capture: a step that holds its graph would
    otherwise keep both, and the graph's memory, alive until the garbage
    collector breaks the cycle."""

    def __init__(self, fn, generators, mutable, warmup: int = WARMUP_STEPS):
        self.device = mutable[0].device
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph captures CUDA work, not {self.device}")
        try:
            self._capture(fn, list(generators), list(mutable), warmup)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the training step failed: "
                               f"{type(e).__name__}: {e}") from e

    @tracing.span("fmov::capture")
    def _capture(self, fn, generators, mutable, warmup):
        dev = self.device
        saved = [t.detach().clone() for t in mutable]
        gen_states = [g.get_state() for g in generators]
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = _launch_counters()
        with torch.cuda.stream(side), tracing.span("fmov::warmup"):
            for i in range(warmup):
                if i == 0:
                    fn()  # first uses may copy to and from the host
                else:
                    _steady_step(fn)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warmup_launches = _counts_since(before)
        with torch.no_grad():
            for t, s in zip(mutable, saved):
                t.copy_(s)
        for g, state in zip(generators, gen_states):
            g.set_state(state)
        del saved

        self.graph = torch.cuda.CUDAGraph()
        register = getattr(self.graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                f"torch {torch.__version__} cannot register the state's generators "
                f"with a CUDA graph (CUDAGraph.register_generator_state): every "
                f"replay would draw the same frames and rays")
        for g in generators:
            register(g)
        before = _launch_counters()
        with torch.cuda.graph(self.graph, stream=side):
            fn()
        self.per_replay = _counts_since(before)
        _add_counts(self.per_replay, -1)  # the capture launched nothing

    def replay(self):
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"CUDA graph replay of the training step failed: "
                               f"{type(e).__name__}: {e}") from e
        _add_counts(self.per_replay)
