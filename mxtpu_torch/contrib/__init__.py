"""``mx.contrib`` (the counterpart of ``mxtpu/contrib/``): the
calibration search of post-training quantization."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]
