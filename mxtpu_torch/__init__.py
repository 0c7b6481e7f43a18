"""mxtpu_torch — the PyTorch/CUDA port of mxtpu for NVIDIA Hopper.

The package mirrors ``mxtpu``'s layout and names (``serving``,
``models``, ``gluon``, ``optimizer``, ``parallel``, ``random``,
``kernels``) on torch tensors.  Each Pallas
kernel of a ported path becomes a kernel written by hand for ``sm_90a``
under ``csrc/``, built with ``nvcc`` at first use.  Entry points run on
``cuda:0`` unless the caller passes ``device="cpu"``.

This package imports torch and numpy only — never jax or mxtpu.
"""
from .base import MXNetError  # noqa: F401
from . import context, kernels, random  # noqa: F401
from .context import cpu, gpu  # noqa: F401

__version__ = "0.1.0"
