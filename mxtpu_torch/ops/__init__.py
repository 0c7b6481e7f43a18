"""Op registry package: typed op parameters and the registry of torch
rules behind ``nd`` and ``sym`` (the counterpart of ``mxtpu/ops``)."""
from .params import Param, ParamSet
from .registry import Op, OP_REGISTRY, get_op, list_ops, register_op

__all__ = ["Param", "ParamSet", "Op", "OP_REGISTRY", "get_op", "list_ops",
           "register_op"]
