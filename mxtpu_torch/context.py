"""Device resolution (the role of ``mxtpu/context.py``).

Entry points run on the card: ``device=None`` means ``cuda:0``, and
without CUDA that raises instead of quietly picking the CPU.  The CPU
is used only when a caller asks for it (``device="cpu"``), as the
tests do.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device", "strict_f32"]


def cpu() -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0``; a string or ``torch.device`` passes
    through.  A CUDA device without CUDA raises."""
    dev = gpu(0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested (the default) but CUDA is not "
                f"available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = gpu(0)
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev


def strict_f32() -> None:
    """Float32 products in true f32, never TF32 — the reference
    computes its f32 contractions at HIGHEST precision
    (``mxtpu/kernels/flash_attention.py:184-189``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
