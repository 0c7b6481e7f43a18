"""Dynamic-batching inference serving on PyTorch (``mxtpu.serving``
counterpart: runner, batcher, server, stats, and generation serving:
``GenerateRunner``, ``GenerateBatcher``, ``GenerateRequest`` and
``sample_token``)."""
from .batcher import (DynamicBatcher, InferenceRequest,  # noqa: F401
                      RequestTimeout, RetriableError, ServerBusy,
                      WorkerLost)
from .generate import (GenerateBatcher, GenerateRequest,  # noqa: F401
                       GenerateRunner, sample_token)
from .runner import ModelRunner, batch_ladder  # noqa: F401
from .server import InferenceServer  # noqa: F401
from .stats import ServingStats  # noqa: F401
