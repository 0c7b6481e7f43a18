"""Gluon on PyTorch modules (the ``mxtpu.gluon`` counterpart):
``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``/
``SymbolBlock``, ``Trainer``, the layers, the losses, the utilities,
the model zoo and the data API."""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, utils, model_zoo, data  # noqa: F401

__all__ = ["Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "loss", "utils", "model_zoo",
           "data"]
