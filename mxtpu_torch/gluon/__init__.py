"""Gluon on PyTorch modules (the ``mxtpu.gluon`` counterpart):
``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``/
``SymbolBlock``, ``Trainer``, the layers, the losses, the utilities,
the model zoo and the data API; ``rnn`` and ``contrib`` load on first
use, as in mxtpu."""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, utils, model_zoo, data  # noqa: F401

__all__ = ["Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "loss", "utils", "model_zoo",
           "data", "rnn", "contrib"]


def __getattr__(name):
    import importlib
    if name in ("rnn", "contrib"):
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'mxtpu_torch.gluon' has no attribute {name!r}")
