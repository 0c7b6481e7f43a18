"""mxtpu_torch — the PyTorch/CUDA port of mxtpu for NVIDIA Hopper.

The package mirrors ``mxtpu``'s layout and names (``nd``, ``autograd``,
``sym``, ``mod``, ``serving``, ``models``, ``gluon``, ``optimizer``,
``lr_scheduler``, ``parallel``, ``random``, ``rtc``, ``kernels``,
``io``, ``recordio``, ``image``, ``profiler``, ``obs``) on
torch tensors, so ``import mxtpu_torch as mx`` runs MXNet-1.x-style
code.  Each Pallas kernel of a ported path becomes a kernel written by
hand for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use.
Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``.

This package imports torch and numpy only — never jax or mxtpu.
"""
from .base import MXNetError  # noqa: F401
from . import context, kernels, random  # noqa: F401
from .context import cpu, gpu  # noqa: F401
from . import ndarray, autograd, symbol, executor  # noqa: F401
from . import initializer, optimizer, io, metric, callback  # noqa: F401
from . import model, module, operator, rtc  # noqa: F401
from . import recordio, image  # noqa: F401
from . import profiler, obs  # noqa: F401
from . import gluon  # noqa: F401

nd = ndarray
sym = symbol
mod = module
lr_scheduler = optimizer.lr_scheduler
init = initializer

__version__ = "0.1.0"
