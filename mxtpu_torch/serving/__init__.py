"""Dynamic-batching inference serving on PyTorch (``mxtpu.serving``
counterpart).

- :class:`ModelRunner` (runner.py): bucketed inference over an exported
  graph, one entry a bucket (on the card a captured CUDA graph).
- :class:`DynamicBatcher` (batcher.py): bounded queue, batch assembly,
  deadlines and :class:`ServerBusy` backpressure, clock-injected.
- :class:`InferenceServer` (server.py): name → version → runner
  registry with worker threads.
- :class:`ServingStats` (stats.py): rolling percentiles, queue ETA,
  the ``mxtpu_torch.obs`` metrics.
- :class:`GenerateRunner` / :class:`GenerateBatcher` (generate.py):
  KV-cache incremental decode with continuous batching and streaming.
- :class:`FleetRouter` / :class:`FleetWorker` (router.py): the
  fault-tolerant fleet — canary health checks driving the
  :class:`WorkerHealth` state machine (health.py), retry with capped
  backoff and hedging, draining with a ladder handoff, requeue-never-
  drop on worker death, and fleet generation with replay on steal.
- :mod:`faults` (faults.py): scripted fault injection.
- :mod:`controlplane` (controlplane.py): :class:`Autoscaler` and
  :class:`PriorityClass`.

Error taxonomy: :class:`RetriableError` is the base; ``ServerBusy``
and ``WorkerLost`` are retriable, ``RequestTimeout`` is terminal.
mxtpu's persistent executable cache (``cache.py``) is not ported yet.
"""
from .batcher import (Batch, DynamicBatcher, InferenceRequest,
                      RequestTimeout, RetriableError, ServerBusy,
                      WorkerLost)
from .controlplane import Autoscaler, PriorityClass, parse_classes
from .faults import (CorruptEntry, CrashAt, Corrupt, Fault, FaultPlan,
                     Hang, QueueWedge, ReadOnlyDir, SlowExec,
                     SlowStart, SlowStartError, StaleKey,
                     TruncateEntry, WorkerCrashed)
from .generate import (GenerateBatcher, GenerateRequest,
                       GenerateRunner, sample_token)
from .health import WorkerHealth, WorkerState
from .router import (FleetGenerateRequest, FleetRequest, FleetRouter,
                     FleetWorker)
from .runner import ModelRunner, batch_ladder
from .server import InferenceServer
from .stats import ServingStats

__all__ = ["ModelRunner", "InferenceServer", "DynamicBatcher",
           "ServingStats", "InferenceRequest", "Batch", "ServerBusy",
           "RequestTimeout", "RetriableError", "WorkerLost",
           "batch_ladder",
           "GenerateRunner", "GenerateBatcher", "GenerateRequest",
           "sample_token",
           "FleetRouter", "FleetWorker", "FleetRequest",
           "FleetGenerateRequest",
           "WorkerHealth", "WorkerState",
           "Autoscaler", "PriorityClass", "parse_classes",
           "Fault", "FaultPlan", "Hang", "SlowStart", "CrashAt",
           "Corrupt", "QueueWedge", "WorkerCrashed", "SlowStartError",
           "SlowExec", "CorruptEntry", "TruncateEntry", "StaleKey",
           "ReadOnlyDir"]
