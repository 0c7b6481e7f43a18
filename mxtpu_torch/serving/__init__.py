"""Dynamic-batching inference serving on PyTorch (``mxtpu.serving``
counterpart: runner, batcher, server, stats)."""
from .batcher import (DynamicBatcher, InferenceRequest,  # noqa: F401
                      RequestTimeout, RetriableError, ServerBusy,
                      WorkerLost)
from .runner import ModelRunner, batch_ladder  # noqa: F401
from .server import InferenceServer  # noqa: F401
from .stats import ServingStats  # noqa: F401
