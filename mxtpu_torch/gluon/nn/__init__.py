"""Neural-network layers (``mxtpu.gluon.nn`` counterpart)."""
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .basic_layers import *   # noqa: F401,F403
from .conv_layers import *    # noqa: F401,F403
from .activations import *    # noqa: F401,F403

from . import basic_layers, conv_layers, activations

__all__ = (basic_layers.__all__ + conv_layers.__all__ +
           activations.__all__ + ["Block", "HybridBlock", "SymbolBlock"])
