"""Weight and workspace layouts of the fused training kernels (K4, K5, K8, K9).

The kernels (``csrc/train_common.cuh``) run every product of a 64-point
tile as ``A [64, K] @ W [K, N]`` with A a bf16 tile in shared memory and W
a bf16 block streamed from device memory in 32-row chunks.  A layer l is
packed twice:

* forward block ``F_l [kp, np]`` = W^T in the padded input layout of the
  layer: the input is ``in_w`` wide (its real width rounded up to 16, or
  ``[h (np of the layer before) | pe (pe_pad)]`` at the SDF skip layer,
  whose rows are re-mapped), and kp is in_w rounded up to 32; np is the
  output width rounded up to 16.
* reverse block ``R_l [kr, kp]`` = F_l^T with its rows rounded up to 32
  (kr), for the products with a cotangent on the layer's output.

Biases are f32, zero-padded to np.  ``meta`` is the int32 layer table the
kernels read: per layer ``kp, np, n, w_off, b_off, kr, r_off, in_w``.

Per-point intermediates live in a workspace of [M_pad, width] arrays (bf16
or f32), carved out of one byte buffer by ``Workspace``; the kernels get
their addresses in a pointer table.
"""

from __future__ import annotations

import numpy as np
import torch

KCHUNK = 32
MAX_COLS = 384     # widest product a tile takes (8 warps x 3 column tiles)
MAX_LIN = 16
TILE_M = 64
META_PER_LAYER = 8


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def input_rows(k: int, row_map) -> list:
    """[(src row, dst row, count)] pieces of a layer's real input rows."""
    return row_map if row_map is not None else [(0, 0, k)]


def pack_train(ws, bs, in_ws, row_maps):
    """Forward and reverse bf16 blocks, f32 biases and the layer table.

    ws[l]: dense W^T [in, out] f32; in_ws[l]: padded input width;
    row_maps[l]: None (rows map one to one) or [(src, dst, count)]."""
    n_lin = len(ws)
    if n_lin > MAX_LIN:
        raise ValueError(f"{n_lin} linears; the kernels take at most {MAX_LIN}")
    dev = ws[0].device
    blocks, b_parts, metas = [], [], []
    off = b_off = 0
    for l in range(n_lin):
        k, n = ws[l].shape
        in_w = in_ws[l]
        kp, np_ = round_up(in_w, KCHUNK), round_up(n, 16)
        kr = round_up(np_, KCHUNK)
        if np_ > MAX_COLS or kp > MAX_COLS:
            raise ValueError(f"layer {l} is {k}x{n}; the kernels take <= {MAX_COLS}")
        fwd = torch.zeros((kp, np_), dtype=torch.float32, device=dev)
        for src, dst, cnt in input_rows(k, row_maps[l]):
            fwd[dst:dst + cnt, :n] = ws[l][src:src + cnt]
        rev = torch.zeros((kr, kp), dtype=torch.float32, device=dev)
        rev[:np_] = fwd.T
        w_off, r_off = off, off + kp * np_
        off = r_off + kr * kp
        blocks += [fwd.reshape(-1), rev.reshape(-1)]
        b_pad = torch.zeros(np_, dtype=torch.float32, device=dev)
        b_pad[:n] = bs[l]
        b_parts.append(b_pad)
        metas += [kp, np_, n, w_off, b_off, kr, r_off, in_w]
        b_off += np_
    w_buf = torch.cat(blocks).to(torch.bfloat16)
    return w_buf, torch.cat(b_parts), np.asarray(metas, dtype=np.int32)


def layer_table(meta) -> np.ndarray:
    """meta -> [n_lin, 8] (kp, np, n, w_off, b_off, kr, r_off, in_w)."""
    return np.asarray(meta).reshape(-1, META_PER_LAYER)


def unpack_grads(dw_pad, db_pad, meta, ws, row_maps):
    """Padded per-layer dW [in_w, np] (concatenated) and db -> dense
    dW [in, out] and db [out] in the layout of ``ws``."""
    table = layer_table(meta)
    dws, dbs = [], []
    off = 0
    for l, (kp, np_, n, _, b_off, _, _, in_w) in enumerate(table.tolist()):
        block = dw_pad[off:off + in_w * np_].view(in_w, np_)
        off += in_w * np_
        k = ws[l].shape[0]
        pieces = [block[dst:dst + cnt, :n]
                  for _, dst, cnt in input_rows(k, row_maps[l])]
        dws.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, 0))
        dbs.append(db_pad[b_off:b_off + n])
    return dws, dbs


def dw_elems(meta) -> int:
    return int(sum(in_w * np_ for _, np_, _, _, _, _, _, in_w
                   in layer_table(meta).tolist()))


class Workspace:
    """Named [rows, width] arrays carved out of one byte buffer, each
    256-byte aligned; ``table`` is the int64 address array the kernels
    read, in the order the arrays were added."""

    def __init__(self):
        self.specs = []     # (name, rows, width, dtype)

    def add(self, name, rows, width, dtype):
        self.specs.append((name, int(rows), int(width), dtype))

    def allocate(self, device):
        offs, total = [], 0
        for _, rows, width, dtype in self.specs:
            total = round_up(total, 256)
            offs.append(total)
            total += rows * width * torch.empty((), dtype=dtype).element_size()
        self.buffer = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
        base = self.buffer.data_ptr()
        self.table = np.asarray([base + o for o in offs], dtype=np.uint64)
        self.arrays = {}
        for (name, rows, width, dtype), o in zip(self.specs, offs):
            n = rows * width * torch.empty((), dtype=dtype).element_size()
            self.arrays[name] = self.buffer[o:o + n].view(dtype).view(rows, width)
        return self
