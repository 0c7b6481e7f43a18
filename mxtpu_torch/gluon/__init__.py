"""Gluon layers, losses and the model zoo on PyTorch modules
(``mxtpu.gluon`` counterpart)."""
from . import loss, model_zoo, nn  # noqa: F401
