"""Gluon layers and losses on PyTorch modules (``mxtpu.gluon``
counterpart)."""
from . import loss, nn  # noqa: F401
