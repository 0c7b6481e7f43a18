"""Neural-network layers (``mxtpu.gluon.nn`` counterpart)."""
from .basic_layers import (Dense, Dropout, Embedding,  # noqa: F401
                           FusedResidualLayerNorm, HybridSequential,
                           LayerNorm, gelu)
