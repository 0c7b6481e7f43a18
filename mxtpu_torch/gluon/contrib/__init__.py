"""``gluon.contrib`` (the counterpart of ``mxtpu/gluon/contrib``)."""
from . import nn  # noqa: F401

__all__ = ["nn"]
