"""Base utilities: the framework error type and the reference's
ctypes-protocol check.

Copied from ``mxtpu/base.py`` (the jax-free part this package needs);
``mxtpu_torch`` never imports ``mxtpu``.
"""
from __future__ import annotations

__all__ = ["MXNetError", "check_call"]


class MXNetError(RuntimeError):
    """Framework error type (parity with ``mxnet.base.MXNetError``,
    ``python/mxnet/base.py``†).  Python exceptions propagate directly,
    including asynchronous CUDA errors re-raised at sync points."""


def check_call(ret: int) -> None:
    """Raise on a non-zero return code (reference
    ``python/mxnet/base.py``† ``check_call``)."""
    if ret != 0:
        raise MXNetError("non-zero return code %d" % ret)
