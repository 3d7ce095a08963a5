"""The weight-gradient stage of K3, K5, K7 and K9: one product per layer,
``dW_l = A_l^T B_l`` over all rows, and the bias sums, with its plan, its
plain version and its launch.

The per-point passes of the four backward kernels store the bf16
operands of these products row-major in their workspace (K5/K3:
``A_l = [FB_l; X_l]`` and ``B_l = [D_l; ZB_l]`` over 2 M_pad rows, only the
Phase-B halves for the last layer, which also takes a column-0 term;
K9/K7: ``A_l = X_l`` and ``B_l = ZB_l`` over M_pad rows), and per-block
partial sums of the biases.  The backward wrappers of ``fused_sdf`` and
``fused_color`` then launch this stage (``launch``): ``csrc/wgrad.cu``'s
``wgrad_kernel`` (TMA ring, wgmma; see the source's header) writes one
f32 partial per row split, and ``reduce_kernel`` adds the splits, the bias
partials and the column-0 term in a fixed order into the padded
``[in_w x np]`` blocks ``packing.unpack_grads`` reads.

The TPU kernels accumulate these products in their own bodies
(``fmov_pose_tpu/ops/fused_sdf.py:499-525`` for K3, ``:845-871`` for K5,
``fused_color.py:139`` for K7 and ``:452`` for K9), so the stage is a
kernel written here; no library product is on its path.

* ``plan`` — the Python mirror of the kernel's block plan (jobs, i-tiles,
  row splits, stages, shared memory, argument bytes) that the CPU tests
  check.
* ``split_k`` — the number of row splits: the most that keep every block
  in one wave on the card's SMs, at least 512 rows a split.
* ``sdf_stage`` / ``color_stage`` — the stage's jobs on a filled K5/K3 or
  K9/K7 workspace.
* ``launch`` — the kernels on a CUDA stage -> (dw, db); the only place
  that counts ``LAUNCHES``.  ``weight_grads`` — ``launch`` for a CUDA
  stage, the plain version for a CPU one.
* ``weight_grads_plain`` — each job's ``A[:, :ni].T @ B[:, :nj]`` in f32
  (TF32 off), the bias and column-0 partials added in the reduction's
  order.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from fmov_pose_torch.ops import packing

LAUNCHES = 0

TILE_I = 128          # columns of A a block: two consumer warpgroups of 64
KR = 64               # rows a ring stage
BOX = 64              # columns a TMA box (128 bytes, the swizzle's span)
BOX_BYTES = KR * BOX * 2
MAX_NT = 5            # boxes of B a stage: nj <= 320
MAX_STAGES = 8
SMEM_LIMIT = 232448   # an H100 block's opt-in shared memory
ALIGN = 1024
MIN_SPLIT_ROWS = 512
MAX_JOBS = packing.MAX_LIN
# the kernel's argument struct: 2 tensor maps of 128 bytes and a job of 8
# ints per job, a pointer and 4 ints, padded to the maps' 64-byte alignment
TENSOR_MAP_BYTES = 128
ARG_BYTES = -(-(MAX_JOBS * (2 * TENSOR_MAP_BYTES + 8 * 4) + 8 + 4 * 4) // 64) * 64
PARAM_LIMIT = 32764   # kernel parameter bytes on Hopper (CUDA 12.1 and later)


@dataclasses.dataclass
class Job:
    """One layer's product: a [rows, lda] and b [rows, ldb] bf16 row-major
    views of the workspace, of which columns [0, ni) and [0, nj) count."""
    a: torch.Tensor
    b: torch.Tensor
    ni: int
    nj: int


@dataclasses.dataclass
class Stage:
    """The stage's inputs on one workspace: the jobs, the row splits KS,
    the partial sums DWPART [KS, total], the bias partials DBPART [G, nb]
    and, for K5/K3, the column-0 partials CBPART [G, ncb] added at
    ``cb_off + i * cb_ld`` of dw."""
    jobs: list
    KS: int
    dwpart: torch.Tensor
    dbpart: torch.Tensor
    cbpart: torch.Tensor = None
    cb_off: int = 0
    cb_ld: int = 1

    @property
    def total(self) -> int:
        return sum(j.ni * j.nj for j in self.jobs)


def job_dims(jobs) -> np.ndarray:
    """[n_jobs, 5] int32: rows, lda, ldb, ni, nj (the kernel's ``dims``)."""
    return np.asarray([[j.a.shape[0], j.a.stride(0), j.b.stride(0), j.ni, j.nj]
                       for j in jobs], dtype=np.int32).reshape(-1, 5)


def table_dims(table, M_pad: int, sdf: bool) -> np.ndarray:
    """``job_dims`` of a layer table's stage without a workspace: K5/K3's
    (``sdf``: 2 M_pad rows, M_pad for the last layer) or K9/K7's."""
    t = np.asarray(table).tolist()
    rows = [2 * M_pad if sdf and l < len(t) - 1 else M_pad for l in range(len(t))]
    return np.asarray([[r, row[0], row[1], row[7], row[1]] for r, row in zip(rows, t)],
                      dtype=np.int32).reshape(-1, 5)


def split_k(sms: int, dims) -> int:
    """Row splits: the most that keep tiles x KS blocks within one wave of
    ``sms`` (one block fills an SM's shared memory), at least
    MIN_SPLIT_ROWS rows a split of the longest job."""
    dims = np.asarray(dims)
    tiles = int(sum(-(-int(ni) // TILE_I) for ni in dims[:, 3]))
    return max(1, min(sms // tiles, int(dims[:, 0].max()) // MIN_SPLIT_ROWS))


def plan(dims, KS: int) -> dict:
    """The kernel's plan (``fmov_wgrad``): per job its i-tiles, first
    block, rows a split and boxes of B, per block (blockIdx order) its job,
    first column i0, split and rows [r_begin, r_end), the ring's stages and
    the shared memory a block takes."""
    dims = np.asarray(dims).tolist()
    jobs, blocks = [], []
    total = task = 0
    nt_max = 1
    for q, (rows, lda, ldb, ni, nj) in enumerate(dims):
        tiles = -(-ni // TILE_I)
        per = -(-(-(-rows // KS)) // KR) * KR
        nt = -(-nj // BOX)
        jobs.append({"rows": rows, "lda": lda, "ldb": ldb, "ni": ni, "nj": nj,
                     "out_off": total, "tiles": tiles, "task0": task, "per": per,
                     "nt": nt})
        for local in range(tiles * KS):
            tile, split = local % tiles, local // tiles
            r0 = split * per
            blocks.append({"job": q, "i0": tile * TILE_I, "split": split,
                           "r_begin": r0, "r_end": min(rows, r0 + per)})
        task += tiles * KS
        total += ni * nj
        nt_max = max(nt_max, nt)
    stage_bytes = (2 + nt_max) * BOX_BYTES
    stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN - 16 * MAX_STAGES) // stage_bytes)
    return {"jobs": jobs, "blocks": blocks, "total": total, "stages": stages,
            "stage_bytes": stage_bytes,
            "smem": ALIGN + stages * stage_bytes + 16 * stages}


def tma_ok(ptr: int, rows: int, cols: int, ld: int) -> bool:
    """A bf16 [rows, cols] array of row stride ld meets the tensor map's
    rules: a 16-byte aligned base, a row stride of a multiple of 16 bytes
    below 2^40, and dimensions within 2^32."""
    return (ptr % 16 == 0 and (2 * ld) % 16 == 0 and 2 * ld < 2 ** 40
            and 0 < cols <= ld and 0 < rows < 2 ** 32)


def sdf_stage(ws_, table, M_pad: int, KS: int) -> Stage:
    """K5/K3's stage on their workspace (``fused_sdf.bwd_workspace_specs``):
    AB_l / BB_l over 2 M_pad rows, the last layer's X / ZB halves, the
    column-0 term on the last layer's column 0."""
    t = np.asarray(table).tolist()
    L = len(t)
    jobs = []
    for l, row in enumerate(t):
        a, b = ws_.arrays[f"AB{l}"], ws_.arrays[f"BB{l}"]
        if l == L - 1:
            a, b = a[M_pad:], b[M_pad:]
        jobs.append(Job(a, b, row[7], row[1]))
    total = sum(j.ni * j.nj for j in jobs)
    return Stage(jobs, KS, ws_.arrays["DWPART"], ws_.arrays["DBPART"],
                 ws_.arrays["CBPART"], total - t[-1][7] * t[-1][1], t[-1][1])


def color_stage(ws_, table, KS: int) -> Stage:
    """K9/K7's stage on their workspace (``fused_color._workspace``)."""
    t = np.asarray(table).tolist()
    jobs = [Job(ws_.arrays[f"X{l}"], ws_.arrays[f"ZB{l}"], row[7], row[1])
            for l, row in enumerate(t)]
    return Stage(jobs, KS, ws_.arrays["DWPART"], ws_.arrays["DBPART"])


def _lib():
    from fmov_pose_torch.ops import build, fused_sdf
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # (ptrs, dims, n_jobs, KS, dwpart, dw, dbpart, G, nb, db, cbpart, ncb,
    #  cb_off, cb_ld, stream)
    return fused_sdf._typed(build.library("wgrad"), {
        "fmov_wgrad": [vp, vp, ci, ci, vp, vp, vp, ci, ci, vp, vp, ci, ci, ci, vp]})


def _check(stage: Stage):
    dev = stage.dwpart.device
    for j in stage.jobs:
        if j.a.shape[0] != j.b.shape[0]:
            raise ValueError(f"job operands of {j.a.shape[0]} and {j.b.shape[0]} rows")
        for name, t, w in (("a", j.a, j.ni), ("b", j.b, j.nj)):
            if not (t.is_cuda and t.device == dev and t.dtype == torch.bfloat16
                    and t.dim() == 2 and t.stride(1) == 1
                    and tma_ok(t.data_ptr(), t.shape[0], w, t.stride(0))):
                raise ValueError(f"job operand {name} must be a CUDA bf16 row-major "
                                 f"array on {dev} meeting the tensor-map rules, got "
                                 f"{t.dtype} {tuple(t.shape)} stride {t.stride()}")
    parts = [("dwpart", stage.dwpart, (stage.KS, stage.total)),
             ("dbpart", stage.dbpart, tuple(stage.dbpart.shape))]
    if stage.cbpart is not None:
        parts.append(("cbpart", stage.cbpart, (stage.dbpart.shape[0],
                                               stage.cbpart.shape[1])))
    for name, t, shape in parts:
        if not (t.is_cuda and t.device == dev and t.dtype == torch.float32
                and tuple(t.shape) == shape and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA float32 {shape} "
                             f"tensor on {dev}, got {t.dtype} {tuple(t.shape)}")


def launch(stage: Stage):
    """The stage's kernels on a CUDA stage -> (dw [total], db [nb]), the
    padded [ni x nj] blocks concatenated and the padded biases; the only
    place that counts LAUNCHES."""
    global LAUNCHES
    from fmov_pose_torch.ops import fused_sdf
    _check(stage)
    dev = stage.dwpart.device
    dw = torch.empty(stage.total, dtype=torch.float32, device=dev)
    db = torch.empty(stage.dbpart.shape[1], dtype=torch.float32, device=dev)
    ptrs = np.asarray([p for j in stage.jobs for p in (j.a.data_ptr(), j.b.data_ptr())],
                      dtype=np.uint64)
    dims = np.ascontiguousarray(job_dims(stage.jobs))
    G, nb = stage.dbpart.shape
    cb = stage.cbpart
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fmov_wgrad(
            ptrs.ctypes.data_as(ctypes.c_void_p), dims.ctypes.data_as(ctypes.c_void_p),
            len(stage.jobs), stage.KS, stage.dwpart.data_ptr(), dw.data_ptr(),
            stage.dbpart.data_ptr(), G, nb, db.data_ptr(),
            None if cb is None else cb.data_ptr(), 0 if cb is None else cb.shape[1],
            stage.cb_off, stage.cb_ld, stream)
    fused_sdf._raise_on(lib, err, "wgrad", stage.jobs[0].a.shape[0])
    LAUNCHES += 1
    return dw, db


def _ordered_rows_sum(parts: torch.Tensor) -> torch.Tensor:
    """sum_b parts[b] row after row (the reduction's order)."""
    s = torch.zeros_like(parts[0])
    for row in parts:
        s = s + row
    return s


def weight_grads_plain(stage: Stage):
    """(dw [total], db [nb]) in PyTorch: each job's A^T B in f32 with TF32
    off, the bias partials and the column-0 partials summed block after
    block, as ``reduce_kernel`` sums them."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dw = torch.cat([(j.a[:, :j.ni].float().T @ j.b[:, :j.nj].float()).reshape(-1)
                        for j in stage.jobs])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if stage.cbpart is not None:
        cb = _ordered_rows_sum(stage.cbpart)
        idx = stage.cb_off + stage.cb_ld * torch.arange(cb.shape[0], device=dw.device)
        dw[idx] = dw[idx] + cb
    return dw, _ordered_rows_sum(stage.dbpart)


def weight_grads(stage: Stage):
    """(dw, db): the kernel for a CUDA stage (``launch``), the plain
    version for a CPU one."""
    return launch(stage) if stage.dwpart.is_cuda else weight_grads_plain(stage)
