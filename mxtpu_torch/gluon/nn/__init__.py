"""Neural-network layers (``mxtpu.gluon.nn`` counterpart)."""
from .basic_layers import (BatchNorm, Dense, Dropout,  # noqa: F401
                           Embedding, FusedResidualLayerNorm,
                           HybridSequential, LayerNorm, gelu)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D  # noqa: F401
