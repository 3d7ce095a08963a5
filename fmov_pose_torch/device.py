"""Device selection: callers pass a ``torch.device`` explicitly."""

from __future__ import annotations

import torch


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when CUDA is absent.

    Measurement and kernel paths call this instead of falling back to the
    CPU: a CPU run there would report CPU numbers under a GPU's name."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this path needs an NVIDIA GPU "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present")
    return torch.device("cuda", index)


def disable_tf32() -> None:
    """f32 matmuls and convolutions in full f32 (TF32 keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
