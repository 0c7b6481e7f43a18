"""Module system — the symbolic trainer (the counterpart of
``mxtpu/module``): ``BaseModule`` with ``fit``/``score``/``predict``,
``Module``, ``BucketingModule``, ``SequentialModule``, ``PythonModule``
and ``PythonLossModule``."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import (SequentialModule, PythonModule,
                                PythonLossModule)

__all__ = ["BaseModule", "BatchEndParam", "Module", "BucketingModule",
           "SequentialModule", "PythonModule", "PythonLossModule"]
