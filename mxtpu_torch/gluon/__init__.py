"""Gluon layers on PyTorch modules (``mxtpu.gluon`` counterpart)."""
from . import nn  # noqa: F401
