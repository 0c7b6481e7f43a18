"""InferenceServer — multi-model serving front end.

Counterpart of ``mxtpu/serving/server.py``: a name → version →
:class:`ModelRunner` registry; each registered (model, version)
endpoint owns one :class:`DynamicBatcher`, one :class:`ServingStats`,
and one worker thread per replica runner that assembles micro-batches
and dispatches them round-robin across the endpoint's replicas.
Generation endpoints (``register_generator``) own a
:class:`GenerateRunner`, one continuous-batching
:class:`GenerateBatcher` and a stepping thread.  The profiler/trace
hooks are not ported yet.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..base import MXNetError
from .. import knobs
from .batcher import DynamicBatcher, InferenceRequest
from .generate import GenerateBatcher, GenerateRequest, GenerateRunner
from .runner import ModelRunner
from .stats import ServingStats

__all__ = ["InferenceServer"]


class _GenEndpoint:
    """One (model, version) GENERATION endpoint: a
    :class:`GenerateRunner` + one continuous-batching
    :class:`GenerateBatcher` + a stepping thread that advances the
    whole lane table one decode step at a time.  Requests join at step
    boundaries and stream tokens through their ``on_token``
    callbacks."""

    def __init__(self, name: str, version: int,
                 runner: GenerateRunner, max_queue: Optional[int],
                 log_every_s: float):
        self.name = name
        self.version = version
        self.runner = runner
        self.stats = ServingStats(name=f"{name}:v{version}:gen",
                                  log_every_s=log_every_s)
        self.batcher = GenerateBatcher(
            runner, max_queue=max_queue, stats=self.stats,
            on_timeout=self.stats.record_timeout)
        # the last step failure, kept for diagnosis
        self.last_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._work, daemon=True,
            name=f"mxtpu-torch-gen-{name}-v{version}")

    def start(self) -> None:
        self.thread.start()

    def _work(self) -> None:
        while not self._stop.is_set():
            if self.batcher.drain():
                # idle: no lanes, no queue — park briefly
                self._stop.wait(0.005)
                continue
            try:
                self.batcher.step()
            except Exception as e:  # noqa: BLE001 — a failed decode
                # step leaves every lane's state intact; back off and
                # retry (a persistent failure surfaces as caller
                # deadlines)
                self.last_error = e
                self.stats.bump("step_failures")
                self._stop.wait(0.01)
                continue
            self.stats.maybe_log()

    def snapshot(self) -> Dict:
        snap = self.stats.snapshot()
        snap["lanes"] = self.runner.max_lanes
        snap["compiled_buckets"] = self.runner.num_compiled()
        return snap

    def stop(self) -> None:
        # same wind-down order as _Endpoint: let the stepping thread
        # finish its current step (those tokens are real), then close
        # the batcher so queued + in-lane callers all unblock
        self._stop.set()
        self.thread.join(timeout=2.0)
        self.batcher.close()


class _Endpoint:
    """One (model, version): runners + batcher + stats + workers."""

    def __init__(self, name: str, version: int,
                 runners: List[ModelRunner],
                 max_queue_delay_us: float, max_queue: Optional[int],
                 log_every_s: float):
        self.name = name
        self.version = version
        self.runners = runners
        r0 = runners[0]
        for r in runners[1:]:
            if r.max_batch_size != r0.max_batch_size or \
                    r.seq_buckets != r0.seq_buckets:
                raise MXNetError(
                    "serving: replica runners must share the bucket "
                    "ladder (max_batch_size/seq_buckets)")
        self.stats = ServingStats(name=f"{name}:v{version}",
                                  log_every_s=log_every_s)
        self.batcher = DynamicBatcher(
            max_batch_size=r0.max_batch_size,
            max_queue_delay_us=max_queue_delay_us,
            max_queue=max_queue,
            on_timeout=self.stats.record_timeout,
            on_depth=self.stats.record_queue_depth)
        self._rr_lock = threading.Lock()
        self._rr = 0  # guarded-by: _rr_lock
        # per-replica dispatch tally  # guarded-by: _rr_lock
        self.dispatched: Dict[int, int] = {i: 0
                                           for i in range(len(runners))}
        # the last batch failure, kept for diagnosis
        self.last_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self.threads = [
            threading.Thread(
                target=self._work, daemon=True,
                name=f"mxtpu-torch-serve-{name}-v{version}-{i}")
            for i in range(len(runners))]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def _next_runner(self) -> int:
        with self._rr_lock:
            i = self._rr % len(self.runners)
            self._rr += 1
            self.dispatched[i] += 1
            return i

    def dispatch_counts(self) -> Dict[int, int]:
        with self._rr_lock:
            return dict(self.dispatched)

    def _work(self) -> None:
        while not self._stop.is_set():
            batch = self.batcher.wait_next(timeout=0.1)
            if batch is None:
                continue
            runner = self.runners[self._next_runner()]
            try:
                bucket, _ = runner.run_requests(batch.requests)
            except Exception as e:  # noqa: BLE001 — requeue the batch,
                # never kill the worker.  Each request re-enters the
                # queue exactly once (deadline intact); a second
                # failure — or an expired deadline — fails it there.
                self.last_error = e
                n = self.batcher.requeue(batch.requests)
                if n:
                    self.stats.bump("requeues", n)
                continue
            self.stats.record_batch(len(batch.requests), bucket[0])
            for r in batch.requests:
                if r.latency_us is not None:
                    self.stats.record_completion(
                        r.latency_us, r.queue_us or 0.0)
            self.stats.maybe_log()

    def stop(self) -> None:
        # signal the workers first and let them finish their current
        # batch (those results are real), then close the batcher, which
        # fails everything still queued or in flight with WorkerLost
        self._stop.set()
        for t in self.threads:
            t.join(timeout=2.0)
        self.batcher.close()


class InferenceServer:
    """Multi-model dynamic-batching front end.

    >>> server = InferenceServer()
    >>> server.register("bert", runner)           # version 1
    >>> out = server.infer("bert", {"data": toks}, seq_len=40)
    >>> server.stats("bert")["latency_ms"]["p99"]
    """

    def __init__(self, log_every_s: float = 10.0):
        self._endpoints: Dict[str, Dict[int, _Endpoint]] = {}  # guarded-by: _lock
        # generation endpoints, the same name → version shape; a model
        # may have both a batch-inference and a generation registration
        # under one name
        self._gen: Dict[str, Dict[int, _GenEndpoint]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._log_every_s = log_every_s
        self._closed = False          # guarded-by: _lock

    # -- registry ---------------------------------------------------------
    def register(self, name: str,
                 runners: Union[ModelRunner, Sequence[ModelRunner]],
                 version: int = 1,
                 max_queue_delay_us: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 warmup: bool = False) -> None:
        """Attach a model version.  ``runners`` may be a single
        ModelRunner or one per device replica (round-robin dispatch).
        ``warmup=True`` runs every replica's bucket ladder once before
        the endpoint accepts traffic."""
        if isinstance(runners, ModelRunner):
            runners = [runners]
        runners = list(runners)
        if not runners:
            raise MXNetError("serving: register needs >= 1 runner")
        if max_queue_delay_us is None:
            max_queue_delay_us = knobs.get("MXTPU_SERVING_MAX_DELAY_US")
        if max_queue is None:
            mq = knobs.get("MXTPU_SERVING_MAX_QUEUE")
            if mq:  # 0 = unbounded (knob unset)
                max_queue = mq
        if warmup:
            for r in runners:
                r.warmup()
        ep = _Endpoint(name, version, runners, max_queue_delay_us,
                       max_queue, self._log_every_s)
        with self._lock:
            if self._closed:
                raise MXNetError("serving: server is closed")
            if version in self._endpoints.get(name, {}):
                raise MXNetError(
                    f"serving: {name!r} v{version} already registered")
            self._endpoints.setdefault(name, {})[version] = ep
        ep.start()

    def register_generator(self, name: str, runner: GenerateRunner,
                           version: int = 1,
                           max_queue: Optional[int] = None,
                           warmup: bool = False) -> None:
        """Attach a GENERATION endpoint: a :class:`GenerateRunner`
        serving streamed incremental decode with continuous batching.
        ``warmup=True`` builds the prefill ladder and the decode step on
        the endpoint's slot table before traffic."""
        if not isinstance(runner, GenerateRunner):
            raise MXNetError("serving: register_generator needs a "
                             "GenerateRunner")
        if max_queue is None:
            mq = knobs.get("MXTPU_SERVING_MAX_QUEUE")
            if mq:  # 0 = unbounded (knob unset)
                max_queue = mq
        ep = _GenEndpoint(name, version, runner, max_queue,
                          self._log_every_s)
        if warmup:
            ep.batcher.warmup()
        with self._lock:
            if self._closed:
                raise MXNetError("serving: server is closed")
            if version in self._gen.get(name, {}):
                raise MXNetError(
                    f"serving: generator {name!r} v{version} already "
                    f"registered")
            self._gen.setdefault(name, {})[version] = ep
        ep.start()

    def unregister(self, name: str,
                   version: Optional[int] = None) -> None:
        with self._lock:
            versions = self._endpoints.get(name)
            gversions = self._gen.get(name)
            if not versions and not gversions:
                raise MXNetError(f"serving: unknown model {name!r}")
            if version is not None and \
                    version not in (versions or {}) and \
                    version not in (gversions or {}):
                raise MXNetError(
                    f"serving: {name!r} has no version {version}")
            eps: List[Any] = []
            for reg, vs in ((self._endpoints, versions),
                            (self._gen, gversions)):
                if not vs:
                    continue
                drop = list(vs) if version is None else \
                    [v for v in (version,) if v in vs]
                for v in drop:
                    eps.append(vs.pop(v))
                if not vs:
                    del reg[name]
        for ep in eps:
            ep.stop()

    def _endpoint(self, name: str,
                  version: Optional[int]) -> _Endpoint:
        with self._lock:
            versions = self._endpoints.get(name)
            if not versions:
                raise MXNetError(f"serving: unknown model {name!r}")
            if version is None:
                version = max(versions)   # latest by default
            ep = versions.get(version)
            if ep is None:
                raise MXNetError(
                    f"serving: {name!r} has no version {version} "
                    f"(have {sorted(versions)})")
            return ep

    # -- request path -----------------------------------------------------
    def submit(self, name: str, inputs: Dict[str, np.ndarray],
               seq_len: Optional[int] = None,
               version: Optional[int] = None,
               timeout_s: Optional[float] = None) -> InferenceRequest:
        """Async single-example submit: ``inputs`` are ONE example (no
        batch axis).  Returns a future; raises ServerBusy under
        backpressure.  ``timeout_s`` is the request deadline — expiry
        yields RequestTimeout, never a stale result."""
        with self._lock:
            if self._closed:
                raise MXNetError("serving: server is closed")
        ep = self._endpoint(name, version)
        r0 = ep.runners[0]
        if seq_len is None and r0.seq_buckets is not None:
            first = np.asarray(inputs[next(iter(r0._input_specs))])
            seq_len = int(first.shape[0])
        group = r0.seq_bucket_for(seq_len)
        try:
            return ep.batcher.submit(inputs, group=group, seq_len=seq_len,
                                     timeout_s=timeout_s)
        except Exception:
            ep.stats.record_rejected()
            raise

    def infer(self, name: str, inputs: Dict[str, np.ndarray],
              seq_len: Optional[int] = None,
              version: Optional[int] = None,
              timeout_s: Optional[float] = None) -> List[np.ndarray]:
        """Blocking convenience wrapper over ``submit``."""
        req = self.submit(name, inputs, seq_len=seq_len,
                          version=version, timeout_s=timeout_s)
        # +grace so the batcher's own deadline machinery (not the
        # caller-side wait) decides timeout in the normal case
        return req.result(timeout=None if timeout_s is None
                          else timeout_s + 5.0)

    def _gen_endpoint(self, name: str,
                      version: Optional[int]) -> _GenEndpoint:
        with self._lock:
            versions = self._gen.get(name)
            if not versions:
                raise MXNetError(
                    f"serving: no generator registered for {name!r}")
            if version is None:
                version = max(versions)   # latest by default
            ep = versions.get(version)
            if ep is None:
                raise MXNetError(
                    f"serving: generator {name!r} has no version "
                    f"{version} (have {sorted(versions)})")
            return ep

    def submit_generate(self, name: str, prompt: Sequence[int], *,
                        max_tokens: Optional[int] = None,
                        eos_id: Optional[int] = None,
                        top_k: int = 1, seed: int = 0,
                        version: Optional[int] = None,
                        timeout_s: Optional[float] = None,
                        on_token=None) -> GenerateRequest:
        """Async streamed generation: the request joins the endpoint's
        continuous batch at the next step boundary; ``on_token(token,
        index)`` fires per decoded token.  Returns a future whose
        result is the full generated token list."""
        with self._lock:
            if self._closed:
                raise MXNetError("serving: server is closed")
        ep = self._gen_endpoint(name, version)
        try:
            return ep.batcher.submit(
                prompt, max_tokens=max_tokens, eos_id=eos_id,
                top_k=top_k, seed=seed, timeout_s=timeout_s,
                on_token=on_token)
        except Exception:
            ep.stats.record_rejected()
            raise

    def generate(self, name: str, prompt: Sequence[int], *,
                 max_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None, top_k: int = 1,
                 seed: int = 0, version: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 on_token=None) -> List[int]:
        """Blocking convenience wrapper over ``submit_generate``."""
        req = self.submit_generate(
            name, prompt, max_tokens=max_tokens, eos_id=eos_id,
            top_k=top_k, seed=seed, version=version,
            timeout_s=timeout_s, on_token=on_token)
        return req.result(timeout=None if timeout_s is None
                          else timeout_s + 5.0)

    # -- observability ----------------------------------------------------
    def stats(self, name: Optional[str] = None,
              version: Optional[int] = None) -> Dict:
        """Stats snapshot: one endpoint when ``name`` is given, else
        ``{"name:vN": snapshot}`` for the whole registry (generation
        endpoints under a ``:gen`` suffix)."""
        if name is not None:
            with self._lock:
                has_batch = version in self._endpoints.get(name, {}) \
                    if version is not None \
                    else bool(self._endpoints.get(name))
            if not has_batch:
                return self._gen_endpoint(name, version).snapshot()
            ep = self._endpoint(name, version)
            snap = ep.stats.snapshot()
            snap["replicas"] = len(ep.runners)
            snap["dispatched_per_replica"] = ep.dispatch_counts()
            snap["compiled_buckets"] = [r.num_compiled()
                                        for r in ep.runners]
            return snap
        with self._lock:
            items = [(n, v) for n, vs in self._endpoints.items()
                     for v in vs]
            gitems = [(n, v) for n, vs in self._gen.items()
                      for v in vs]
        out = {f"{n}:v{v}": self.stats(n, v) for n, v in items}
        for n, v in gitems:
            out[f"{n}:v{v}:gen"] = self._gen_endpoint(n, v).snapshot()
        return out

    def close(self) -> None:
        """Stop every endpoint's workers and fail anything still
        queued.  The registry stays readable: ``stats()`` after
        ``close()`` (which joins the workers) is the consistent final
        reading."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            eps: List[Any] = [ep for vs in self._endpoints.values()
                              for ep in vs.values()]
            eps += [ep for vs in self._gen.values()
                    for ep in vs.values()]
        for ep in eps:
            ep.stop()

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
