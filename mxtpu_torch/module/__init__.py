"""Module system — the symbolic trainer (the counterpart of
``mxtpu/module``): ``BaseModule`` with ``fit``/``score``/``predict`` and
``Module``."""
from .base_module import BaseModule, BatchEndParam
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module"]
