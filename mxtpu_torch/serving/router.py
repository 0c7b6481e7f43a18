"""Fault-tolerant serving fleet: a front-end router over N workers
(counterpart of ``mxtpu/serving/router.py``).

``InferenceServer`` round-robins device replicas inside one process
with no notion of a worker dying; this layer is the fleet story on
top: N :class:`FleetWorker`\\ s (each one runner + one bounded
:class:`DynamicBatcher` + optionally one execution thread) behind a
:class:`FleetRouter` that

* runs **active health checks** — periodic canary inferences (result
  compared against an expected output, so silent corruption is a
  detected failure) plus liveness deadlines on dispatched batches and
  queued requests — driving the per-worker
  :class:`~.health.WorkerHealth` state machine
  (HEALTHY → SUSPECT → DRAINING → DEAD → RECOVERING);
* **retries with capped exponential backoff + deterministic jitter**
  (seeded RNG), preferring a worker the request has not tried, with
  optional **hedged requests** (a second attempt dispatched when the
  first is slow; first completion wins, the loser is discarded);
* **requeues — never drops** — the outstanding requests of a dead
  worker: its batcher is closed with :class:`WorkerLost`, the
  attempt watchers fire, and every request whose deadline still
  permits re-enters the dispatch loop (late ones fail fast as
  :class:`RequestTimeout`);
* supports **preemption-safe draining**: ``drain(name)`` stops new
  admissions, the worker flushes its queue and completes in-flight
  work, and :meth:`FleetWorker.handoff` exposes the compiled-ladder
  metadata a replacement warms from (``ModelRunner.warm_from``; on the
  card the replacement captures the donor's buckets as CUDA graphs
  before its first canary).

Determinism: the router is clock-injected and tick-driven.  With
``threaded=False`` nothing runs in the background — tests call
``tick(now)`` with a hand-stepped clock and every recovery path in
``tests/test_torch_fleet.py`` is exercised reproducibly against the
scripted :mod:`~.faults` plans.  With ``threaded=True`` (production)
each worker runs an execution thread and the router runs a ticker
thread; the policy code is identical.

The control plane rides this layer: requests carry a
:class:`~.controlplane.PriorityClass` name, the router's parked
backlog dispatches by weighted round-robin with per-class in-system
quotas, submit-time admission control sheds by *predicted* deadline
feasibility (``ServingStats.queue_eta_us``, class-aware: only
same-or-higher-priority backlog counts ahead — a brownout sheds low
classes first), and ``add_controller`` lets an
:class:`~.controlplane.Autoscaler` ride the tick.

Lock order (must hold): ``FleetRouter._lock`` → ``DynamicBatcher
._cond`` → leaf locks (``_evlock``, ``_class_lock``, request
``_wlock``, ``ServingStats._lock``).  Completion watchers can fire
under a batcher lock, so they only ever touch ``_evlock`` /
``_class_lock`` / request / stats state — never the router lock.
Control-plane hooks (``add_controller``) run at the end of ``tick``
with NO router lock held, because they call back into
``add_worker``/``drain``.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..base import MXNetError
from .. import knobs
from .. import obs
from .. import profiler
from .batcher import (DynamicBatcher, InferenceRequest, RequestTimeout,
                      ServerBusy, WorkerLost)
from .controlplane import PriorityClass, parse_classes
from .faults import FaultPlan, HangSignal, WorkerCrashed
from .generate import GenerateBatcher
from .health import WorkerHealth, WorkerState
from .stats import ServingStats

__all__ = ["FleetRequest", "FleetGenerateRequest", "FleetWorker",
           "FleetRouter"]

logger = logging.getLogger("mxtpu_torch.serving.fleet")


class FleetRequest:
    """Caller-side future spanning every attempt (retries, hedges) the
    router makes for one logical request.  One-shot completion under a
    leaf lock: with hedging, two workers can finish simultaneously."""

    __slots__ = ("payload", "group", "seq_len", "t_submit", "deadline",
                 "retries", "requeues", "hedges", "tried", "last_error",
                 "t_done", "won_by_hedge", "trace_id", "priority",
                 "_event", "_value", "_error", "_wlock", "_on_done")

    def __init__(self, payload: Any, group: Any, seq_len: Optional[int],
                 t_submit: float, deadline: Optional[float],
                 trace_id: Optional[str] = None,
                 priority: str = "default"):
        self.payload = payload
        self.group = group
        self.seq_len = seq_len
        self.t_submit = t_submit
        self.deadline = deadline
        self.trace_id = trace_id  # obs: minted at FleetRouter.submit
        self.priority = priority  # PriorityClass name
        # completion hook for the router's class accounting: set once
        # at submit before any dispatch, invoked exactly once after
        # the one-shot completion — no concurrent mutation by design
        self._on_done: Optional[
            Callable[["FleetRequest"], None]] = None
        self.retries = 0          # router-level re-dispatches
        self.requeues = 0         # of those, forced by a worker death
        self.hedges = 0           # hedge attempts dispatched
        self.tried: List[str] = []    # worker names, dispatch order
        self.last_error: Optional[BaseException] = None
        # outcome fields are event-sequenced like InferenceRequest's:
        # written under _wlock before _event.set(), read after wait().
        self.t_done: Optional[float] = None
        self.won_by_hedge = False
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._wlock = threading.Lock()

    def _complete(self, value: Any, now: float,
                  hedge: bool = False) -> bool:
        with self._wlock:
            if self._event.is_set():
                return False
            if self.deadline is not None and now > self.deadline:
                self._error = RequestTimeout(
                    f"serving: fleet request missed its deadline by "
                    f"{(now - self.deadline) * 1e3:.2f} ms")
            else:
                self._value = value
                self.won_by_hedge = hedge
            self.t_done = now
            self._event.set()
            return True

    def _fail(self, error: BaseException, now: float) -> bool:
        with self._wlock:
            if self._event.is_set():
                return False
            self._error = error
            self.t_done = now
            self._event.set()
            return True

    def _notify_done(self) -> None:
        """Run the router's class-accounting hook.  Called by whoever
        won the one-shot ``_complete``/``_fail``, AFTER its stats
        accounting and outside ``_wlock`` (keeps ``_wlock`` a leaf:
        the hook takes the router's class leaf lock)."""
        cb = self._on_done
        if cb is not None:
            try:
                cb(self)
            except Exception:   # noqa: BLE001 — accounting must never
                pass            # poison a completing worker

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise RequestTimeout(
                "serving: fleet result() wait timed out (request "
                "still in flight)")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_us(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e6


class FleetGenerateRequest(FleetRequest):
    """Caller-side streamed-generation future spanning every attempt:
    tokens arrive through an incremental result channel
    (``_note_token``, wired as the worker attempt's ``on_token``) and
    are DEDUPED BY STREAM INDEX under a leaf lock — a replay after a
    worker death re-emits nothing the caller already saw, and a
    replayed worker disagreeing with the original stream is counted
    as a wrong token (the kill-mid-generation test asserts both stay
    zero).  The dedup ledger doubles as the replay prefix: the next
    attempt prefills ``prompt + tokens_snapshot()`` and resumes."""

    __slots__ = ("prompt", "max_tokens", "eos_id", "top_k", "seed",
                 "on_token", "finish_reason", "_tok_lock", "_stream",
                 "duplicate_tokens", "wrong_tokens")

    def __init__(self, prompt: List[int], *, max_tokens: int,
                 eos_id: Optional[int], top_k: int, seed: int,
                 t_submit: float, deadline: Optional[float],
                 trace_id: Optional[str] = None,
                 priority: str = "default",
                 on_token: Optional[Callable[[int, int], None]] = None):
        super().__init__(None, None, len(prompt), t_submit, deadline,
                         trace_id=trace_id, priority=priority)
        self.prompt = [int(t) for t in prompt]
        self.max_tokens = int(max_tokens)
        self.eos_id = eos_id
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.on_token = on_token
        self.finish_reason: Optional[str] = None
        # leaf lock (may fire under a GenerateBatcher step): the
        # deduped stream ledger + anomaly counters
        self._tok_lock = threading.Lock()
        self._stream: List[int] = []   # guarded-by: _tok_lock
        self.duplicate_tokens = 0      # guarded-by: _tok_lock
        self.wrong_tokens = 0          # guarded-by: _tok_lock

    def tokens_snapshot(self) -> List[int]:
        """The deduped stream so far — what the NEXT attempt prefills
        as its replay prefix."""
        with self._tok_lock:
            return list(self._stream)

    def _note_token(self, tok: int, index: int) -> None:
        """Incremental result channel (the worker attempt's
        ``on_token``).  Exactly-once forwarding: only the first
        arrival of each stream index reaches the caller; duplicates
        (a replay racing the original) and disagreements are
        counted, never forwarded."""
        fire = False
        with self._tok_lock:
            if index == len(self._stream):
                self._stream.append(int(tok))
                fire = True
            elif index < len(self._stream):
                self.duplicate_tokens += 1
                if self._stream[index] != int(tok):
                    self.wrong_tokens += 1
            else:
                # a gap means the stream skipped indices — count it
                # as wrong rather than silently reordering
                self.wrong_tokens += 1
        if fire and self.on_token is not None:
            try:
                self.on_token(int(tok), int(index))
            except Exception:   # noqa: BLE001 — a stream consumer
                pass            # must never poison the decode loop

    def _merge_partial(self, partial: Dict[str, Any]) -> None:
        """Fold a dead worker's ``WorkerLost.partial`` into the
        ledger: tokens the stream channel already delivered must
        AGREE (else they count as wrong); tokens it never delivered
        (e.g. MXTPU_GEN_STREAM=0) extend it and reach the caller
        exactly once."""
        toks = partial.get("tokens") or []
        added: List[tuple] = []
        with self._tok_lock:
            for i, t in enumerate(toks):
                if i < len(self._stream):
                    if self._stream[i] != int(t):
                        self.wrong_tokens += 1
                else:
                    self._stream.append(int(t))
                    added.append((int(t), i))
        if self.on_token is not None:
            for t, i in added:
                try:
                    self.on_token(t, i)
                except Exception:  # noqa: BLE001
                    pass

    def anomalies(self) -> Dict[str, int]:
        with self._tok_lock:
            return {"duplicate_tokens": self.duplicate_tokens,
                    "wrong_tokens": self.wrong_tokens}


class FleetWorker:
    """One fleet worker: a runner + its own bounded batcher + health
    record (+ an execution thread in threaded mode).  The dispatch
    seam consults an optional :class:`~.faults.FaultPlan`, which is
    how every failure mode is injected deterministically."""

    def __init__(self, runner, name: str = "w0", *,
                 clock=time.monotonic,
                 max_queue_delay_us: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 faults: Optional[FaultPlan] = None,
                 start_recovering: bool = False,
                 liveness_s: Optional[float] = None,
                 dead_after: Optional[int] = None,
                 exec_recovers: bool = False,
                 gen_runner=None):
        if runner is None and gen_runner is None:
            raise ValueError("FleetWorker needs a runner, a "
                             "gen_runner, or both")
        self.runner = runner
        self.name = name
        self._clock = clock
        self.faults = faults
        if max_queue_delay_us is None:
            max_queue_delay_us = knobs.get("MXTPU_SERVING_MAX_DELAY_US")
        if max_queue is None:
            mq = knobs.get("MXTPU_SERVING_MAX_QUEUE")
            max_queue = mq if mq else None
        self.stats = ServingStats(name=f"fleet/{name}", clock=clock)
        # obs flight recorder: bounded ring of structured events for
        # this worker — health transitions, canary verdicts, fault
        # firings, evictions — dumped by the router on death.  The
        # shared no-op when MXTPU_OBS=0.
        self.recorder = obs.flight(f"fleet/{name}", clock=clock)
        self.batcher = DynamicBatcher(
            max_batch_size=runner.max_batch_size if runner is not None
            else 1,
            max_queue_delay_us=max_queue_delay_us,
            max_queue=max_queue, clock=clock,
            on_timeout=self._on_evicted,
            on_depth=self.stats.record_queue_depth)
        # decode plane: its own continuous batcher so
        # generation lanes and one-shot inference batches never
        # contend for admission — both planes share the worker's
        # health record and stats
        self.generator = None if gen_runner is None else \
            GenerateBatcher(gen_runner, clock=clock, stats=self.stats,
                            on_timeout=self._on_evicted)
        self.health = WorkerHealth(
            name,
            liveness_s=liveness_s if liveness_s is not None
            else knobs.get("MXTPU_FLEET_LIVENESS_S"),
            dead_after=dead_after if dead_after is not None
            else knobs.get("MXTPU_FLEET_DEAD_AFTER"),
            start_recovering=start_recovering,
            exec_recovers=exec_recovers,
            on_transition=self._on_health_transition)
        self._lock = threading.Lock()
        self._inflight_t: Optional[float] = None  # guarded-by: _lock
        self._inflight_n = 0  # guarded-by: _lock
        self._stuck = False  # guarded-by: _lock
        self._batch_seq = 0  # guarded-by: _lock
        self._stop = threading.Event()
        # control-plane lifecycle, not data-plane state: start() runs
        # once from add_worker before the thread exists; shutdown()
        # is idempotent and joins.  The router serializes both.
        self._thread: Optional[threading.Thread] = None
        self._shut = False

    # -- obs hooks (leaf-lock only: both may fire under batcher or
    #    router locks) ----------------------------------------------------
    def _on_health_transition(self, now: float, frm: str, to: str,
                              reason: str) -> None:
        self.recorder.record("health", frm=frm, to=to, reason=reason)

    def _on_evicted(self, n: int) -> None:
        self.stats.record_timeout(n)
        self.recorder.record("evicted", n=n)

    # -- admission --------------------------------------------------------
    def submit_attempt(self, payload: Any, group: Any,
                       seq_len: Optional[int],
                       deadline: Optional[float], now: float,
                       canary: bool = False,
                       trace_id: Optional[str] = None
                       ) -> InferenceRequest:
        """Admit one attempt into this worker's queue.  Client traffic
        only lands on a HEALTHY worker; canaries also probe SUSPECT
        and RECOVERING ones (that IS the recovery path).  Raises
        :class:`WorkerLost` (retriable) on refusal, :class:`ServerBusy`
        when the bounded queue is full."""
        if self.runner is None:
            raise WorkerLost(
                f"serving: worker {self.name} is decode-only — "
                f"no inference runner")
        ok = self.health.admits_canary() if canary \
            else self.health.admits()
        if not ok:
            raise WorkerLost(
                f"serving: worker {self.name} is {self.health.state} "
                f"({self.health.reason}) — not admitting")
        timeout_s = None if deadline is None \
            else max(0.0, deadline - now)
        try:
            return self.batcher.submit(payload, group=group,
                                       seq_len=seq_len,
                                       timeout_s=timeout_s,
                                       trace_id=trace_id)
        except ServerBusy as e:
            # price the refusal: the caller's retry can sleep exactly
            # the predicted drain time instead of blind backoff
            if e.retry_after_us is None:
                e.retry_after_us = self.stats.queue_eta_us()
            raise

    def submit_generate_attempt(self, freq: "FleetGenerateRequest",
                                now: float) -> "GenerateRequest":
        """Admit one GENERATION attempt.  The replay
        contract lives here: the attempt's prefix is the fleet
        request's deduped stream snapshot, so a resumed rollout
        prefills ``prompt + already-streamed tokens`` and the lane
        picks up at the exact next stream index — tokens the caller
        already saw are never re-emitted (``_note_token`` dedupes by
        index even if a worker disagrees)."""
        if self.generator is None:
            raise WorkerLost(
                f"serving: worker {self.name} has no decode plane — "
                f"cannot host generation")
        if not self.health.admits():
            raise WorkerLost(
                f"serving: worker {self.name} is {self.health.state} "
                f"({self.health.reason}) — not admitting")
        prefix = freq.tokens_snapshot()
        timeout_s = None if freq.deadline is None \
            else max(0.0, freq.deadline - now)
        try:
            return self.generator.submit(
                freq.prompt, max_tokens=freq.max_tokens,
                eos_id=freq.eos_id, top_k=freq.top_k, seed=freq.seed,
                prefix=prefix, timeout_s=timeout_s,
                trace_id=freq.trace_id, on_token=freq._note_token)
        except ServerBusy as e:
            # price a decode refusal in TOKENS, not batches: the ETA
            # is lanes-freeing time, which scales with max_tokens
            if e.retry_after_us is None:
                e.retry_after_us = self.stats.token_eta_us(
                    max(1, freq.max_tokens - len(prefix)))
            raise

    # -- execution ---------------------------------------------------------
    def pump(self, now: Optional[float] = None) -> bool:
        """Deterministic single-step execution: assemble at most one
        ready batch and run it inline.  Returns True if a batch was
        dispatched.  The threaded loop and the router's sync tick both
        funnel through `_dispatch`, so the policy is identical."""
        now = self._clock() if now is None else now
        with self._lock:
            if self._stuck or self._inflight_t is not None:
                return False
            k = self._batch_seq
        if self._stop.is_set() or \
                self.health.state == WorkerState.DEAD or \
                (self.faults is not None and self.faults.wedged(k)):
            return False            # a dead worker executes nothing
        batch = self.batcher.poll(now)
        if batch is None:
            return False
        self._dispatch(batch, now)
        return True

    def pump_generate(self, now: Optional[float] = None) -> bool:
        """One decode step of the continuous-batching loop:
        admit joiners at the step boundary, run one fused decode step
        across every occupied lane, emit tokens.  Returns True if the
        step did any work.  The threaded loop and the router's sync
        tick both funnel through ``GenerateBatcher.step``, so
        join/evict policy is identical in both modes."""
        if self.generator is None:
            return False
        now = self._clock() if now is None else now
        with self._lock:
            if self._stuck:
                return False
        if self._stop.is_set() or \
                self.health.state == WorkerState.DEAD:
            return False
        if self.generator.drain():
            return False
        try:
            out = self.generator.step(now)
        except Exception as e:  # noqa: BLE001 — decode-step failure:
            # lanes keep their state; health decides if it's terminal
            self.health.exec_fail(now)
            self.recorder.record("gen_exec_fail", error=str(e))
            logger.debug("fleet worker %s: decode step failed (%s)",
                         self.name, e)
            return False
        if out["admitted"] or out["active"]:
            self.health.exec_ok(now)
        return bool(out["admitted"] or out["active"])

    def _dispatch(self, batch, now: float) -> None:
        with self._lock:
            k = self._batch_seq
            self._batch_seq += 1
            self._inflight_t = now
            self._inflight_n = len(batch.requests)
        # obs queue-wait spans: submit → dequeue, per traced request.
        # Emitted before execution so a mid-flight kill still leaves
        # the wait on record (the worker-clock time base, so the
        # deterministic fake-clock tests see exact phase timings).
        if profiler.is_active():
            for r in batch.requests:
                if r.trace_id is not None and r.t_dequeue is not None:
                    obs.span(obs.SPAN_QUEUE_WAIT, r.t_submit * 1e6,
                             (r.t_dequeue - r.t_submit) * 1e6,
                             trace_id=r.trace_id, worker=self.name)
        try:
            if self.faults is not None:
                self.faults.before_batch(k)
            mutate = self.faults.mutator(k) \
                if self.faults is not None else None
            bucket, _ = self.runner.run_requests(
                batch.requests, now=self._clock(), mutate=mutate)
        except HangSignal:
            # the dispatch would block forever: leave the batch
            # registered in-flight (liveness will notice) and park —
            # from the outside this IS a hung executable
            with self._lock:
                self._stuck = True
            self.stats.bump("hangs")
            self.recorder.record("fault", fault="hang", batch_seq=k,
                                 n=len(batch.requests))
            return
        except WorkerCrashed as e:
            with self._lock:
                self._inflight_t = None
                self._inflight_n = 0
            self.health.crashed(now, str(e))
            self.stats.bump("crashes")
            self.recorder.record("fault", fault="crash", batch_seq=k,
                                 n=len(batch.requests), error=str(e))
            # requests stay incomplete; the router observes DEAD and
            # closes the batcher, which fails them to their watchers
            return
        except Exception as e:  # noqa: BLE001 — transient execution
            with self._lock:    # failure: requeue-once, stay alive
                self._inflight_t = None
                self._inflight_n = 0
            n = self.batcher.requeue(batch.requests, now=self._clock())
            if n:
                self.stats.bump("requeues", n)
            self.health.exec_fail(now)
            self.recorder.record("exec_fail", batch_seq=k,
                                 requeued=n, error=str(e))
            logger.debug("fleet worker %s: batch failed (%s), "
                         "requeued %d", self.name, e, n)
            return
        with self._lock:
            self._inflight_t = None
            self._inflight_n = 0
        # obs execute spans: dispatch → completion on the worker clock
        if profiler.is_active():
            t_end = self._clock()
            for r in batch.requests:
                if r.trace_id is not None:
                    obs.span(obs.SPAN_EXECUTE, now * 1e6,
                             (t_end - now) * 1e6,
                             trace_id=r.trace_id, worker=self.name,
                             batch=len(batch.requests),
                             bucket=str(bucket))
        self.health.exec_ok(now)
        self.stats.record_batch(len(batch.requests), bucket[0])
        for r in batch.requests:
            if r.latency_us is not None:
                self.stats.record_completion(r.latency_us,
                                             r.queue_us or 0.0)
        self.stats.maybe_log()

    # -- liveness signals --------------------------------------------------
    def inflight_age(self, now: float) -> Optional[float]:
        with self._lock:
            return None if self._inflight_t is None \
                else now - self._inflight_t

    def queued_age(self, now: float) -> Optional[float]:
        ages = [self.batcher.oldest_waiting_age(now)]
        if self.generator is not None:
            ages.append(self.generator.oldest_waiting_age(now))
        ages = [a for a in ages if a is not None]
        return max(ages) if ages else None

    def outstanding(self) -> int:
        with self._lock:
            inflight = self._inflight_n
        n = self.batcher.depth + inflight
        if self.generator is not None:
            # live decode lanes count as outstanding work so drain()
            # waits for every stream to finish, not just one-shots
            n += self.generator.depth + len(self.generator.active())
        return n

    # -- threaded mode -----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"mxtpu-fleet-{self.name}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                stuck, k = self._stuck, self._batch_seq
            if stuck or self.health.state == WorkerState.DEAD or \
                    (self.faults is not None
                     and self.faults.wedged(k)):
                # a hung/wedged worker: the thread parks; the router's
                # liveness check is what reaps it
                self._stop.wait(0.02)
                continue
            gen_busy = self.pump_generate()
            # a busy decode plane polls tightly (every lane step emits
            # a token); an idle one parks on the one-shot queue
            batch = self.batcher.wait_next(
                timeout=0.002 if gen_busy else 0.05)
            if batch is None:
                continue
            self._dispatch(batch, self._clock())

    def shutdown(self, error: Optional[BaseException] = None) -> None:
        """Stop the thread (if any) and fail every queued + in-flight
        request with WorkerLost so no waiter hangs.  Idempotent."""
        if self._shut:
            return
        self._shut = True
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=1.0)
        self.batcher.close(error=error)
        if self.generator is not None:
            # every live lane fails with its partial-generation state
            # attached (WorkerLost.partial) — the router's replay path
            # folds that into the fleet request before re-dispatch
            self.generator.close(error=error)

    # -- drain handoff -----------------------------------------------------
    def handoff(self) -> Dict[str, Any]:
        """The donor metadata a replacement warms from: which buckets
        this worker's ladder actually compiled (see
        ``ModelRunner.ladder_metadata``)."""
        meta = {} if self.runner is None \
            else self.runner.ladder_metadata()
        if self.generator is not None:
            meta = dict(meta)
            meta["generate"] = self.generator.runner.ladder_metadata()
        return meta


class _Pending:
    """One parked (re)dispatch: due time + the fleet request."""
    __slots__ = ("due", "freq")

    def __init__(self, due: float, freq: FleetRequest):
        self.due = due
        self.freq = freq


class FleetRouter:
    """Front-end router over N :class:`FleetWorker`\\ s.  See module
    docstring for the full contract.

    >>> router = FleetRouter(clock=..., threaded=False,
    ...                      canary={"data": x}, canary_expect=[y])
    >>> router.add_worker(FleetWorker(runner, "w0", clock=...))
    >>> req = router.submit({"data": x}, timeout_s=1.0)
    >>> router.tick(now)   # deterministic mode: crank the loop
    >>> req.result(timeout=0)
    """

    def __init__(self, *, clock=time.monotonic, threaded: bool = True,
                 canary: Optional[Dict[str, np.ndarray]] = None,
                 canary_expect: Optional[List[np.ndarray]] = None,
                 canary_seq_len: Optional[int] = None,
                 canary_interval_s: Optional[float] = None,
                 canary_timeout_s: Optional[float] = None,
                 retry_max: Optional[int] = None,
                 backoff_base_us: Optional[int] = None,
                 backoff_cap_us: Optional[int] = None,
                 jitter: Optional[float] = None,
                 hedge_after_us: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 tick_s: Optional[float] = None,
                 classes: Optional[List[PriorityClass]] = None,
                 admission: Optional[bool] = None,
                 admission_margin: Optional[float] = None,
                 seed: int = 0, log_every_s: float = 10.0):
        self._clock = clock
        self._threaded = threaded
        self._lock = threading.Lock()
        self._workers: Dict[str, FleetWorker] = {}  # guarded-by: _lock
        self._order: List[str] = []  # guarded-by: _lock
        self._rr = 0  # guarded-by: _lock
        self._pending: List[_Pending] = []  # guarded-by: _lock
        self._live: List[tuple] = []  # guarded-by: _lock
        self._dead_handled: set = set()  # guarded-by: _lock
        self._next_canary: Dict[str, float] = {}  # guarded-by: _lock
        # completion events from attempt watchers; leaf lock ONLY —
        # watchers fire under batcher locks (see module lock order)
        self._evlock = threading.Lock()
        self._events: deque = deque()  # guarded-by: _evlock
        self._canary = canary
        self._canary_expect = canary_expect
        self._canary_seq_len = canary_seq_len
        g = knobs.get
        self._canary_interval_s = canary_interval_s \
            if canary_interval_s is not None \
            else g("MXTPU_FLEET_CANARY_INTERVAL_S")
        self._canary_timeout_s = canary_timeout_s \
            if canary_timeout_s is not None \
            else g("MXTPU_FLEET_CANARY_TIMEOUT_S")
        self._retry_max = retry_max if retry_max is not None \
            else g("MXTPU_FLEET_RETRY_MAX")
        self._backoff_base_us = backoff_base_us \
            if backoff_base_us is not None \
            else g("MXTPU_FLEET_BACKOFF_BASE_US")
        self._backoff_cap_us = backoff_cap_us \
            if backoff_cap_us is not None \
            else g("MXTPU_FLEET_BACKOFF_CAP_US")
        self._jitter = jitter if jitter is not None \
            else g("MXTPU_FLEET_JITTER")
        self._hedge_after_us = hedge_after_us \
            if hedge_after_us is not None \
            else g("MXTPU_FLEET_HEDGE_AFTER_US")
        self._max_pending = max_pending if max_pending is not None \
            else g("MXTPU_FLEET_MAX_PENDING")
        self._tick_s = tick_s if tick_s is not None \
            else g("MXTPU_FLEET_TICK_S")
        # -- priority/fairness + admission control ----------------------
        cls_list = classes if classes is not None \
            else parse_classes(g("MXTPU_FLEET_CLASSES"))
        if not cls_list:
            cls_list = [PriorityClass("default")]
        self._classes: Dict[str, PriorityClass] = \
            {c.name: c for c in cls_list}
        if len(self._classes) != len(cls_list):
            raise MXNetError("serving: duplicate priority class names")
        self._default_class = "default" if "default" in self._classes \
            else max(cls_list, key=lambda c: c.weight).name
        # guarded-by: _lock
        self._wrr_credit: Dict[str, float] = \
            {n: 0.0 for n in self._classes}
        # in-system (admitted, not completed) requests per class.
        # Leaf lock: decrements fire from completion hooks that may
        # run under a batcher lock (see module lock order).
        self._class_lock = threading.Lock()
        # guarded-by: _class_lock
        self._class_n: Dict[str, int] = \
            {n: 0 for n in self._classes}
        self._admission = admission if admission is not None \
            else g("MXTPU_FLEET_ADMISSION")
        self._admission_margin = admission_margin \
            if admission_margin is not None \
            else g("MXTPU_FLEET_ADMISSION_MARGIN")
        # control-plane hooks (e.g. Autoscaler.tick) run at the END of
        # every tick with NO router lock held
        self._controllers: List[Callable[[float], None]] = []  # guarded-by: _lock
        self._slo = None                # guarded-by: _lock
        self.recorder = obs.flight("fleet/router", clock=clock)
        self._rng = random.Random(seed)
        self.stats = ServingStats(name="fleet", clock=clock,
                                  log_every_s=log_every_s)
        # set when a fleet request fails terminally; tick() checks it
        # outside locks and dumps flight recorders when
        # MXTPU_OBS_DUMP_ON_ERROR asks for it
        self._dump_terminal = False  # guarded-by: _lock
        self._closed = False          # guarded-by: _lock
        self._stop = threading.Event()
        self._ticker: Optional[threading.Thread] = None
        if threaded:
            self._ticker = threading.Thread(
                target=self._tick_loop, daemon=True,
                name="mxtpu-fleet-router")
            self._ticker.start()

    # -- fleet membership --------------------------------------------------
    def add_worker(self, worker: FleetWorker,
                   warm_from: Optional[Dict[str, Any]] = None
                   ) -> Optional[str]:
        """Attach a worker.  ``warm_from`` is a donor's
        :meth:`FleetWorker.handoff` — the replacement pre-compiles the
        donor's bucket working set before its first canary.  With no
        donor metadata, any ladder buckets present in the persistent
        compile cache are warmed from disk instead, so a
        replacement after preemption still serves its first request
        with zero data-path compiles.  All workers must share the
        bucket ladder (same batching groups).  Returns how the worker
        was actually warmed — ``"donor"``, ``"disk_cache"``, or None
        (cold) — so callers (the Autoscaler) can label their events
        without re-probing the cache."""
        warmed = None
        if warm_from is not None:
            if worker.runner is not None and \
                    warm_from.get("compiled_buckets") is not None:
                worker.runner.warm_from(warm_from)
                warmed = "donor"
            if worker.generator is not None and \
                    warm_from.get("generate") is not None:
                # through the batcher: on the card the decode plane's
                # entries are captured on the batcher's own KV table
                worker.generator.warm_from(warm_from["generate"])
                warmed = "donor"
        if warmed is None:
            # one ladder probe per plane: warm_from_disk() returns the
            # buckets it warmed (empty when no cache / no entries); the
            # decode plane's through its batcher, whose KV table the
            # entries are captured on
            hit = worker.runner is not None and \
                bool(worker.runner.warm_from_disk())
            if worker.generator is not None and \
                    worker.generator.warm_from_disk():
                hit = True
            warmed = "disk_cache" if hit else None
        with self._lock:
            if self._closed:
                raise WorkerLost("serving: fleet router is closed")
            if worker.name in self._workers:
                raise MXNetError(
                    f"serving: fleet already has worker "
                    f"{worker.name!r}")
            if self._order:
                r0 = self._workers[self._order[0]].runner
                r = worker.runner
                if r is not None and r0 is not None and (
                        r.max_batch_size != r0.max_batch_size or
                        r.seq_buckets != r0.seq_buckets):
                    raise MXNetError(
                        "serving: fleet workers must share the bucket "
                        "ladder (max_batch_size/seq_buckets)")
                g0 = self._workers[self._order[0]].generator
                g = worker.generator
                if g is not None and g0 is not None and (
                        g.runner.max_lanes != g0.runner.max_lanes or
                        g.runner.prompt_buckets !=
                        g0.runner.prompt_buckets):
                    raise MXNetError(
                        "serving: fleet workers must share the decode "
                        "ladder (max_lanes/prompt_buckets)")
            self._workers[worker.name] = worker
            self._order.append(worker.name)
            self._next_canary[worker.name] = self._clock()
        if self._threaded:
            worker.start()
        return warmed

    def drain(self, name: str, now: Optional[float] = None
              ) -> Dict[str, Any]:
        """Preemption-safe retirement: stop new admissions on
        ``name``; its queue flushes and in-flight work completes on
        the next ticks (bounded by the liveness deadline — a hung
        drain is reaped like any hang).  Returns the handoff metadata
        a replacement warms from."""
        now = self._clock() if now is None else now
        with self._lock:
            worker = self._require_locked(name)
        worker.health.drain(now)
        self.stats.bump("drains")
        return worker.handoff()

    def kill(self, name: str, now: Optional[float] = None) -> None:
        """Operator/preemption kill: the worker is DEAD immediately;
        its outstanding requests are stolen and retried on the next
        tick (deadline permitting) — never dropped."""
        now = self._clock() if now is None else now
        with self._lock:
            worker = self._require_locked(name)
        worker.health.crashed(now, "killed (preemption)")

    def _require_locked(self, name: str) -> FleetWorker:
        w = self._workers.get(name)
        if w is None:
            raise MXNetError(f"serving: fleet has no worker {name!r}")
        return w

    def workers(self) -> Dict[str, str]:
        with self._lock:
            return {n: w.health.state
                    for n, w in self._workers.items()}

    def members(self) -> List[FleetWorker]:
        """Worker objects in attach order (controller read surface)."""
        with self._lock:
            return [self._workers[n] for n in self._order]

    def pending_depth(self) -> int:
        """Requests parked in the router backlog right now."""
        with self._lock:
            return len(self._pending)

    def add_controller(self, fn: Callable[[float], None]) -> None:
        """Register a control-plane hook (e.g. ``Autoscaler.tick``)
        called at the END of every tick with ``now``, no router lock
        held — the hook may call :meth:`add_worker` / :meth:`drain`."""
        with self._lock:
            self._controllers.append(fn)

    def attach_slo(self, engine) -> None:
        """Attach an :class:`~mxtpu_torch.obs.SLOEngine`: its ``tick``
        runs as a controller (end of every router tick, no router lock)
        and its snapshot joins :meth:`fleet_stats` /
        :meth:`postmortem`.  A no-op for the ``MXTPU_OBS=0`` null
        engine — nothing is registered, ticks stay untouched."""
        if not getattr(engine, "enabled", True):
            return
        with self._lock:
            self._slo = engine
        self.add_controller(engine.tick)

    # -- request path ------------------------------------------------------
    def submit(self, payload: Dict[str, np.ndarray], *,
               seq_len: Optional[int] = None,
               timeout_s: Optional[float] = None,
               priority: Optional[str] = None) -> FleetRequest:
        """Route one request into the fleet.  Returns a
        :class:`FleetRequest` future; raises :class:`ServerBusy` when
        the router's pending buffer is full, the class quota is
        exhausted, or admission control predicts the deadline is
        already infeasible (``retry_after_us`` carries the predicted
        queue ETA in every case)."""
        now = self._clock()
        cname = self._default_class if priority is None else priority
        cls = self._classes.get(cname)
        if cls is None:
            raise MXNetError(
                f"serving: unknown priority class {cname!r} "
                f"(have {sorted(self._classes)})")
        with self._lock:
            if self._closed:
                raise WorkerLost("serving: fleet router is closed")
            if not self._order:
                raise MXNetError("serving: fleet has no workers")
            r0 = next((self._workers[n].runner for n in self._order
                       if self._workers[n].runner is not None), None)
            if r0 is None:
                raise MXNetError("serving: fleet has no inference-"
                                 "capable worker (runner)")
            if len(self._pending) >= self._max_pending:
                self._shed_locked(cls, now, "backlog")
                raise ServerBusy(
                    f"serving: fleet pending buffer full "
                    f"({self._max_pending}); retry with backoff",
                    retry_after_us=self._fleet_eta_locked(cls))
            if cls.quota is not None:
                with self._class_lock:
                    n_cls = self._class_n.get(cls.name, 0)
                if n_cls >= cls.quota:
                    self._shed_locked(cls, now, "quota",
                                      in_system=n_cls)
                    raise ServerBusy(
                        f"serving: class {cls.name!r} quota "
                        f"({cls.quota}) exhausted",
                        retry_after_us=self._fleet_eta_locked(cls))
            if self._admission and timeout_s is not None:
                eta_us = self._fleet_eta_locked(cls)
                budget_us = timeout_s * 1e6
                if eta_us is not None and \
                        self._admission_margin * eta_us > budget_us:
                    self._shed_locked(cls, now, "admission",
                                      eta_us=round(eta_us, 1),
                                      budget_us=round(budget_us, 1))
                    raise ServerBusy(
                        f"serving: predicted queue ETA {eta_us:.0f}us "
                        f"exceeds the {budget_us:.0f}us deadline "
                        f"budget for class {cls.name!r} — shed at "
                        f"submit", retry_after_us=eta_us)
        group = r0.seq_bucket_for(seq_len)
        freq = FleetRequest(payload, group, seq_len, now,
                            None if timeout_s is None
                            else now + timeout_s,
                            trace_id=obs.new_trace_id()
                            if profiler.is_active() else None,
                            priority=cls.name)
        freq._on_done = self._note_request_done
        with self._class_lock:
            self._class_n[cls.name] = \
                self._class_n.get(cls.name, 0) + 1
        if freq.trace_id is not None:
            obs.span(obs.SPAN_SUBMIT, now * 1e6, 0.0,
                     trace_id=freq.trace_id, group=str(group),
                     cls=cls.name)
        with self._lock:
            if not self._dispatch_locked(freq, now):
                self._park_locked(freq, now, now)
        return freq

    def infer(self, payload: Dict[str, np.ndarray], *,
              seq_len: Optional[int] = None,
              timeout_s: Optional[float] = None) -> Any:
        """Blocking convenience wrapper (threaded mode)."""
        req = self.submit(payload, seq_len=seq_len, timeout_s=timeout_s)
        return req.result(timeout=None if timeout_s is None
                          else timeout_s + 5.0)

    def submit_generate(self, prompt: Sequence[int], *,
                        max_tokens: Optional[int] = None,
                        eos_id: Optional[int] = None,
                        top_k: int = 1, seed: int = 0,
                        timeout_s: Optional[float] = None,
                        priority: Optional[str] = None,
                        on_token: Optional[Callable[[int, int], None]]
                        = None) -> FleetGenerateRequest:
        """Route one streamed GENERATION into the fleet.
        Returns a :class:`FleetGenerateRequest`; ``on_token(tok,
        index)`` fires exactly once per stream index across every
        retry/steal.  Rides the same priority classes, backlog cap,
        and admission control as :meth:`submit`, except the admission
        ETA is TOKEN-aware: prefill queue ETA plus ``max_tokens``
        decode steps priced from the per-token histogram."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("serving: generate needs a non-empty "
                             "prompt")
        if max_tokens is None:
            max_tokens = knobs.get("MXTPU_GEN_MAX_TOKENS")
        max_tokens = int(max_tokens)
        if max_tokens < 1:
            raise MXNetError("serving: generate needs max_tokens >= 1")
        now = self._clock()
        cname = self._default_class if priority is None else priority
        cls = self._classes.get(cname)
        if cls is None:
            raise MXNetError(
                f"serving: unknown priority class {cname!r} "
                f"(have {sorted(self._classes)})")
        with self._lock:
            if self._closed:
                raise WorkerLost("serving: fleet router is closed")
            if not self._order:
                raise MXNetError("serving: fleet has no workers")
            if not any(self._workers[n].generator is not None
                       for n in self._order):
                raise MXNetError("serving: fleet has no decode-capable "
                                 "worker (gen_runner)")
            if len(self._pending) >= self._max_pending:
                self._shed_locked(cls, now, "backlog")
                raise ServerBusy(
                    f"serving: fleet pending buffer full "
                    f"({self._max_pending}); retry with backoff",
                    retry_after_us=self._fleet_eta_locked(cls))
            if cls.quota is not None:
                with self._class_lock:
                    n_cls = self._class_n.get(cls.name, 0)
                if n_cls >= cls.quota:
                    self._shed_locked(cls, now, "quota",
                                      in_system=n_cls)
                    raise ServerBusy(
                        f"serving: class {cls.name!r} quota "
                        f"({cls.quota}) exhausted",
                        retry_after_us=self._fleet_eta_locked(cls))
            if self._admission and timeout_s is not None:
                # per-token admission: a rollout is only feasible if
                # the queue wait PLUS the whole decode fits the budget
                eta_us = self._gen_eta_locked(cls, max_tokens)
                budget_us = timeout_s * 1e6
                if eta_us is not None and \
                        self._admission_margin * eta_us > budget_us:
                    self._shed_locked(cls, now, "admission",
                                      eta_us=round(eta_us, 1),
                                      budget_us=round(budget_us, 1),
                                      tokens=max_tokens)
                    raise ServerBusy(
                        f"serving: predicted generation ETA "
                        f"{eta_us:.0f}us ({max_tokens} tokens) exceeds "
                        f"the {budget_us:.0f}us deadline budget for "
                        f"class {cls.name!r} — shed at submit",
                        retry_after_us=eta_us)
        freq = FleetGenerateRequest(
            prompt, max_tokens=max_tokens, eos_id=eos_id, top_k=top_k,
            seed=seed, t_submit=now,
            deadline=None if timeout_s is None else now + timeout_s,
            trace_id=obs.new_trace_id()
            if profiler.is_active() else None,
            priority=cls.name, on_token=on_token)
        freq._on_done = self._note_request_done
        with self._class_lock:
            self._class_n[cls.name] = \
                self._class_n.get(cls.name, 0) + 1
        if freq.trace_id is not None:
            obs.span(obs.SPAN_SUBMIT, now * 1e6, 0.0,
                     trace_id=freq.trace_id, cls=cls.name,
                     kind="generate", prompt_len=len(prompt),
                     max_tokens=max_tokens)
        with self._lock:
            if not self._dispatch_locked(freq, now):
                self._park_locked(freq, now, now)
        return freq

    def generate(self, prompt: Sequence[int], *,
                 max_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None, top_k: int = 1,
                 seed: int = 0, timeout_s: Optional[float] = None,
                 on_token: Optional[Callable[[int, int], None]] = None
                 ) -> List[int]:
        """Blocking convenience wrapper (threaded mode): the full
        generated token list."""
        req = self.submit_generate(
            prompt, max_tokens=max_tokens, eos_id=eos_id, top_k=top_k,
            seed=seed, timeout_s=timeout_s, on_token=on_token)
        return req.result(timeout=None if timeout_s is None
                          else timeout_s + 5.0)

    # -- admission control ------------------------------------------------
    def _shed_locked(self, cls: PriorityClass, now: float, kind: str,
                     **detail: Any) -> None:
        """Account one shed verdict (backlog / quota / admission):
        counters, flight recorder, and a ``fleet/shed`` span."""
        self.stats.record_rejected()
        self.stats.bump(f"shed_{kind}")
        self.recorder.record("shed", reason=kind, cls=cls.name,
                             **detail)
        if profiler.is_active():
            obs.span(obs.SPAN_SHED, now * 1e6, 0.0, cat="fleet",
                     kind=kind, cls=cls.name, **detail)

    def _fleet_eta_locked(self, cls: PriorityClass) -> Optional[float]:
        """Predicted queue wait for a new request of ``cls``: only
        same-or-higher-priority in-system traffic counts as "ahead"
        (WRR serves it first), spread over the admitting workers, each
        priced by its own service-time histogram — the best (lowest)
        endpoint wins, matching where dispatch would place it.  None
        until some worker has a histogram (cold fleet admits
        optimistically)."""
        admitting = [self._workers[n] for n in self._order
                     if self._workers[n].health.admits()]
        if not admitting:
            return None
        with self._class_lock:
            ahead = sum(n for c, n in self._class_n.items()
                        if self._classes[c].weight >= cls.weight)
        share = ahead / len(admitting)
        best: Optional[float] = None
        for w in admitting:
            e = w.stats.queue_eta_us(depth=share)
            if e is None:
                return None     # a cold worker: no histogram — admit
            if best is None or e < best:
                best = e
        return best

    def _gen_eta_locked(self, cls: PriorityClass,
                        max_tokens: int) -> Optional[float]:
        """Per-token admission ETA: queue wait (class-aware,
        as in :meth:`_fleet_eta_locked`) PLUS the decode time for
        ``max_tokens`` steps priced from the per-token latency
        histogram, minimized over decode-capable admitting workers.
        None while any candidate is cold — a cold fleet admits
        optimistically and lets real traffic build the histogram."""
        admitting = [self._workers[n] for n in self._order
                     if self._workers[n].generator is not None
                     and self._workers[n].health.admits()]
        if not admitting:
            return None
        with self._class_lock:
            ahead = sum(n for c, n in self._class_n.items()
                        if self._classes[c].weight >= cls.weight)
        share = ahead / len(admitting)
        best: Optional[float] = None
        for w in admitting:
            q = w.stats.queue_eta_us(depth=share)
            t = w.stats.token_eta_us(max_tokens)
            if t is None:
                return None     # cold decode plane — admit
            e = (q or 0.0) + t
            if best is None or e < best:
                best = e
        return best

    def _note_request_done(self, freq: FleetRequest) -> None:
        # FleetRequest._notify_done hook — fires outside _wlock, may
        # run under a batcher lock; touches only the class leaf lock
        with self._class_lock:
            n = self._class_n.get(freq.priority, 0)
            if n > 0:
                self._class_n[freq.priority] = n - 1

    # -- dispatch core -----------------------------------------------------
    def _pick_locked(self, freq: Optional[FleetRequest]
                     ) -> Optional[FleetWorker]:
        """Round-robin over HEALTHY workers, preferring one this
        request has not tried yet ("retry elsewhere")."""
        healthy = [n for n in self._order
                   if self._workers[n].health.admits()]
        if not healthy:
            return None
        tried = set(freq.tried) if freq is not None else ()
        fresh = [n for n in healthy if n not in tried]
        pool = fresh or healthy
        name = pool[self._rr % len(pool)]
        self._rr += 1
        return self._workers[name]

    def _dispatch_locked(self, freq: FleetRequest, now: float,
                         hedge: bool = False) -> bool:
        """Try to place one attempt; False = no worker took it (park
        it).  Called with ``_lock`` held."""
        is_gen = isinstance(freq, FleetGenerateRequest)
        if is_gen and len(freq.tokens_snapshot()) >= freq.max_tokens:
            # the dead worker's partial state already finished the
            # stream — nothing left to replay, complete directly
            if freq._complete(freq.tokens_snapshot(), now):
                freq.finish_reason = freq.finish_reason or "length"
                self.stats.record_completion(
                    (now - freq.t_submit) * 1e6, 0.0)
                freq._notify_done()
            return True
        for _ in range(len(self._order)):
            worker = self._pick_locked(freq)
            if worker is None:
                return False
            try:
                if is_gen:
                    attempt = worker.submit_generate_attempt(freq, now)
                else:
                    attempt = worker.submit_attempt(
                        freq.payload, freq.group, freq.seq_len,
                        freq.deadline, now, trace_id=freq.trace_id)
            except (WorkerLost, ServerBusy) as e:
                # this worker refused; round-robin advances, try next.
                # Keep the refusal: a ServerBusy's retry_after_us hint
                # lets _park_locked price the wait.
                freq.last_error = e
                continue
            freq.tried.append(worker.name)
            if hedge:
                freq.hedges += 1
            if freq.trace_id is not None:
                if is_gen and freq.requeues > 0:
                    obs.span(obs.SPAN_REPLAY, now * 1e6, 0.0,
                             trace_id=freq.trace_id,
                             worker=worker.name,
                             resumed=len(freq.tokens_snapshot()))
                if hedge:
                    obs.span(obs.SPAN_HEDGE, now * 1e6, 0.0,
                             trace_id=freq.trace_id,
                             worker=worker.name)
                elif freq.retries > 0:
                    obs.span(obs.SPAN_REDISPATCH, now * 1e6, 0.0,
                             trace_id=freq.trace_id,
                             worker=worker.name, retry=freq.retries)
            self._live.append((freq, attempt, worker.name, now,
                               hedge))
            attempt.add_done_callback(
                self._watcher(freq, attempt, worker.name, hedge))
            return True
        return False

    def _watcher(self, freq: FleetRequest, attempt: InferenceRequest,
                 wname: str, hedge: bool):
        """Attempt-completion hook.  May fire under a batcher lock:
        touches only the fleet request, stats, and the event deque
        (leaf locks) — never the router lock."""
        def cb() -> None:
            now = self._clock()
            if attempt._error is None:
                value = attempt._value
                if isinstance(freq, FleetGenerateRequest):
                    # the stream channel already deduped every token;
                    # the ledger snapshot IS the authoritative result
                    # (identical to attempt._value on a clean run,
                    # still complete across a mid-stream steal)
                    freq.finish_reason = getattr(
                        attempt, "finish_reason", None)
                    value = freq.tokens_snapshot()
                if freq._complete(value, now, hedge=hedge):
                    self.stats.record_completion(
                        (now - freq.t_submit) * 1e6,
                        (attempt.queue_us or 0.0))
                    if hedge:
                        self.stats.bump("hedges_won")
                    freq._notify_done()
            else:
                with self._evlock:
                    self._events.append(
                        ("attempt_failed", freq, wname,
                         attempt._error))
        return cb

    def _backoff_s(self, n_retry: int) -> float:
        base = min(float(self._backoff_cap_us),
                   float(self._backoff_base_us) * (2 ** (n_retry - 1)))
        return base * (1.0 + self._jitter * self._rng.random()) / 1e6

    def _park_locked(self, freq: FleetRequest, now: float,
                     due: float) -> None:
        """Park a request that found no worker.  When the refusal
        carried a ``retry_after_us`` ETA hint, wait exactly that long
        (capped at the backoff ceiling) instead of retrying every
        tick against a queue we know is full."""
        e = freq.last_error
        hint = getattr(e, "retry_after_us", None)
        if hint:
            due = max(due, now + min(float(hint),
                                     float(self._backoff_cap_us)) / 1e6)
        self._pending.append(_Pending(due, freq))

    def _wrr_next_locked(self, active: Any) -> str:
        """Smooth weighted round-robin over the class names in
        ``active``: each pick adds every active class's weight to its
        credit, serves the max, and charges it the round total —
        interleaves ~weight-proportionally with no starvation.
        Deterministic: sorted names, strictly-greater comparison."""
        names = sorted(active)
        total = 0.0
        best = names[0]
        for n in names:
            w = self._classes[n].weight
            total += w
            self._wrr_credit[n] = self._wrr_credit.get(n, 0.0) + w
            if self._wrr_credit[n] > self._wrr_credit[best]:
                best = n
        self._wrr_credit[best] -= total
        return best

    def _handle_attempt_failed_locked(self, freq: FleetRequest,
                                      wname: str, error: BaseException,
                                      now: float) -> None:
        if freq.done():
            return              # a hedge already won (or terminal)
        freq.last_error = error
        retriable = bool(getattr(error, "retriable", False))
        if freq.deadline is not None and now >= freq.deadline:
            if freq._fail(RequestTimeout(
                    "serving: deadline expired before a retry could "
                    "be placed"), now):
                self.stats.record_timeout()
                freq._notify_done()
            self._dump_terminal = True
            return
        if not retriable or freq.retries >= self._retry_max:
            if freq._fail(error, now):
                freq._notify_done()
            self._dump_terminal = True
            return
        freq.retries += 1
        self.stats.bump("retries")
        if isinstance(error, WorkerLost):
            # the attempt died WITH its worker: this is the
            # requeue-never-drop path, counted separately
            freq.requeues += 1
            self.stats.bump("requeues")
            if isinstance(freq, FleetGenerateRequest) and \
                    getattr(error, "partial", None):
                # fold the dead lane's partial-generation state into
                # the replay ledger: tokens the stream never delivered
                # (MXTPU_GEN_STREAM=0) reach the caller here, and the
                # next attempt's prefix resumes past them — replay
                # never double-bills already-emitted tokens
                freq._merge_partial(error.partial)
            if freq.trace_id is not None:
                obs.span(obs.SPAN_STEAL, now * 1e6, 0.0,
                         trace_id=freq.trace_id, worker=wname)
        hint = getattr(error, "retry_after_us", None)
        if hint:
            # the worker priced its own queue: sleep the predicted
            # drain time (capped), not blind exponential backoff
            due = now + min(float(hint),
                            float(self._backoff_cap_us)) / 1e6
        else:
            due = now + self._backoff_s(freq.retries)
        if freq.trace_id is not None:
            obs.span(obs.SPAN_BACKOFF, now * 1e6, (due - now) * 1e6,
                     trace_id=freq.trace_id, retry=freq.retries)
        self._pending.append(_Pending(due, freq))

    # -- canaries ----------------------------------------------------------
    def _canary_due_locked(self, now: float) -> List[FleetWorker]:
        if self._canary is None or self._canary_interval_s <= 0:
            return []
        due = []
        for name in self._order:
            w = self._workers[name]
            if w.runner is None:
                continue        # decode-only worker: no canary payload
            if not w.health.admits_canary():
                continue
            if now >= self._next_canary.get(name, now):
                self._next_canary[name] = now + self._canary_interval_s
                due.append(w)
        return due

    def _send_canary(self, worker: FleetWorker, now: float) -> None:
        try:
            attempt = worker.submit_attempt(
                self._canary, self._canary_group(), self._canary_seq_len,
                now + self._canary_timeout_s, now, canary=True)
        except ServerBusy:
            # a full queue means the worker is saturated with real
            # traffic, not broken — skip this round (liveness
            # deadlines still catch a wedged queue)
            return
        except WorkerLost:
            with self._evlock:
                self._events.append(("canary", worker.name, False,
                                     "refused"))
            return
        expect = self._canary_expect

        def cb() -> None:
            if attempt._error is not None:
                ok, why = False, f"error: {attempt._error}"
            elif expect is None:
                ok, why = True, "completed"
            else:
                try:
                    ok = len(attempt._value) == len(expect) and all(
                        np.allclose(np.asarray(got), np.asarray(want),
                                    rtol=1e-4, atol=1e-5)
                        for got, want in zip(attempt._value, expect))
                    why = "match" if ok else "result CORRUPT " \
                        "(mismatch vs expected canary output)"
                except Exception as e:  # noqa: BLE001
                    ok, why = False, f"compare failed: {e}"
            with self._evlock:
                self._events.append(("canary", worker.name, ok, why))
        attempt.add_done_callback(cb)

    def _canary_group(self) -> Any:
        with self._lock:
            r0 = next((self._workers[n].runner for n in self._order
                       if self._workers[n].runner is not None), None)
        return None if r0 is None \
            else r0.seq_bucket_for(self._canary_seq_len)

    # -- the tick ----------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One scheduling round: canaries → (sync) pump → liveness →
        reap the dead → process completion events → re-dispatch due
        retries → hedge slow attempts.  In threaded mode a background
        ticker calls this every ``tick_s``; deterministic tests call
        it directly with the fake clock."""
        now = self._clock() if now is None else now
        with self._lock:
            canary_due = self._canary_due_locked(now)
        for w in canary_due:
            self._send_canary(w, now)
        with self._lock:
            workers = [self._workers[n] for n in self._order]
        if not self._threaded:
            for w in workers:
                for _ in range(64):     # bounded drain of ready work
                    if not w.pump(now):
                        break
                # exactly ONE decode step per worker per tick: joiners
                # land at step boundaries, so a hand-stepped clock sees
                # deterministic join/evict ordering (lane accounting in
                # the continuous-batching tests depends on this)
                w.pump_generate(now)
        # liveness + death reaping
        for w in workers:
            w.health.liveness(now, w.inflight_age(now),
                              w.queued_age(now))
            if w.health.state == WorkerState.DRAINING and \
                    w.outstanding() == 0:
                w.health.drained(now)
                self.stats.bump("drains_completed")
            if w.health.state == WorkerState.DEAD:
                with self._lock:
                    if w.name in self._dead_handled:
                        continue
                    self._dead_handled.add(w.name)
                if not w.health.retired:
                    self.stats.bump("deaths")
                    logger.warning(
                        "fleet: worker %s is DEAD (%s) — stealing "
                        "outstanding requests", w.name, w.health.reason)
                # flight-recorder postmortem: the death event plus an
                # automatic dump of everything the ring still holds
                w.recorder.record("death", reason=w.health.reason,
                                  retired=w.health.retired,
                                  outstanding=w.outstanding())
                w.recorder.dump(
                    reason=f"worker {w.name} DEAD: {w.health.reason}",
                    path=obs.dump_on_error_path() or None)
                # closing the batcher fails queued+inflight with
                # WorkerLost → watchers enqueue retry events below
                w.shutdown(error=None if w.health.retired else
                           WorkerLost(f"serving: worker {w.name} died "
                                      f"({w.health.reason})"))
        # completion / canary events
        while True:
            with self._evlock:
                if not self._events:
                    break
                ev = self._events.popleft()
            if ev[0] == "attempt_failed":
                with self._lock:
                    self._handle_attempt_failed_locked(
                        ev[1], ev[2], ev[3], now)
            elif ev[0] == "canary":
                _, wname, ok, why = ev
                with self._lock:
                    w = self._workers.get(wname)
                if w is None:
                    continue
                w.recorder.record("canary", ok=ok, why=why)
                if not ok and "CORRUPT" in why:
                    # silent corruption is a correctness failure: it
                    # feeds the availability SLO's "wrong" leg
                    self.stats.bump("wrong_results")
                if ok:
                    w.health.canary_ok(now)
                else:
                    prev = w.health.state
                    w.health.canary_fail(now, f"canary ({why})")
                    if prev != w.health.state:
                        logger.warning(
                            "fleet: worker %s %s → %s: %s", wname,
                            prev, w.health.state, why)
        # due retries / parked dispatches
        with self._lock:
            # a live attempt stuck on a slow worker must still honor
            # the caller's deadline — fail the fleet request now (the
            # stale attempt, whenever it surfaces, finds it done)
            for entry in self._live:
                freq = entry[0]
                if not freq.done() and freq.deadline is not None \
                        and now > freq.deadline:
                    if freq._fail(RequestTimeout(
                            "serving: deadline expired with the "
                            "attempt still in flight"), now):
                        self.stats.record_timeout()
                        freq._notify_done()
            pending, self._pending = self._pending, []
            due_by_class: Dict[str, deque] = {}
            for p in pending:
                if p.freq.done():
                    continue
                if p.freq.deadline is not None and \
                        now > p.freq.deadline:
                    if p.freq._fail(RequestTimeout(
                            "serving: deadline expired while waiting "
                            "for a fleet worker"), now):
                        self.stats.record_timeout()
                        p.freq._notify_done()
                    continue
                if p.due > now:
                    self._pending.append(p)
                else:
                    due_by_class.setdefault(
                        p.freq.priority, deque()).append(p)
            # weighted round-robin over the due backlog: classes
            # interleave by weight (FIFO within a class), so a hot
            # tenant cannot starve the others
            while due_by_class:
                cname = self._wrr_next_locked(due_by_class)
                q = due_by_class[cname]
                p = q.popleft()
                if not q:
                    del due_by_class[cname]
                if not self._dispatch_locked(p.freq, now):
                    self._park_locked(p.freq, now, p.due)
            # hedging: a slow single IN-FLIGHT attempt gets a second
            # chance on another worker; first completion wins.  An
            # entry whose attempt already finished (either way) is out
            # of hedging scope — retries own that path.
            self._live = [e for e in self._live
                          if not e[0].done() and not e[1].done()]
            if self._hedge_after_us > 0:
                for freq, attempt, wname, t0, hedge in list(self._live):
                    if hedge or freq.hedges > 0:
                        continue
                    if isinstance(freq, FleetGenerateRequest):
                        # never hedge a stream: two lanes decoding the
                        # same rollout would double-emit tokens
                        continue
                    if (now - t0) * 1e6 >= self._hedge_after_us:
                        if self._dispatch_locked(freq, now,
                                                 hedge=True):
                            self.stats.bump("hedges")
            dump_terminal, self._dump_terminal = \
                self._dump_terminal, False
        if dump_terminal and obs.dump_on_error_path() is not None:
            obs.dump_all(reason="fleet request failed terminally",
                         path=obs.dump_on_error_path() or None)
        # control-plane hooks (autoscaler etc.) run LAST, with no
        # router lock held — they may call add_worker/drain freely
        with self._lock:
            controllers = list(self._controllers)
        for fn in controllers:
            try:
                fn(now)
            except Exception:   # noqa: BLE001 — a broken controller
                logger.exception("fleet: controller failed")  # ≠ outage
        self.stats.maybe_log()

    def _tick_loop(self) -> None:
        while not self._stop.wait(self._tick_s):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — the ticker must never
                logger.exception("fleet: tick failed")  # die silently

    # -- observability -----------------------------------------------------
    def fleet_stats(self) -> Dict[str, Any]:
        """Fleet-level aggregation: router counters (retries,
        requeues, hedges won, drains, deaths + rolling end-to-end
        percentiles) plus one per-worker block (state machine snapshot
        + that worker's ServingStats)."""
        snap = self.stats.snapshot()
        with self._lock:
            workers = dict(self._workers)
            snap["pending"] = len(self._pending)
        with self._class_lock:
            class_n = dict(self._class_n)
        snap["classes"] = {
            n: {"weight": c.weight, "quota": c.quota,
                "in_system": class_n.get(n, 0)}
            for n, c in self._classes.items()}
        snap["workers"] = {
            n: {**w.health.snapshot(), **w.stats.snapshot()}
            for n, w in workers.items()}
        states = [w.health.state for w in workers.values()]
        snap["healthy_workers"] = sum(
            1 for s in states if s == WorkerState.HEALTHY)
        snap["total_workers"] = len(states)
        with self._lock:
            slo = self._slo
        if slo is not None:
            snap["slo"] = slo.snapshot()
        return snap

    def postmortem(self, name: str) -> Dict[str, Any]:
        """Everything known about one worker, dead or alive: health
        state machine snapshot + full transition log, serving stats,
        and the flight-recorder ring (health transitions, canary
        verdicts, faults, evictions) — the single dict an operator
        reads after ``kill``/death to answer *why*."""
        with self._lock:
            w = self._require_locked(name)
            slo = self._slo
        doc = {
            "worker": name,
            "health": w.health.snapshot(),
            "transitions": list(w.health.transitions),
            "stats": w.stats.snapshot(),
            "flight": w.recorder.snapshot(),
        }
        if slo is not None:
            # the SLO/error-budget table at the moment of the
            # postmortem — which alerts were firing while this worker
            # was dying answers the operator's "did users notice?"
            doc["slo"] = slo.snapshot()
        return doc

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = list(self._workers.values())
            pending = self._pending
            self._pending = []
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
        now = self._clock()
        for p in pending:
            if p.freq._fail(WorkerLost(
                    "serving: fleet router closed"), now):
                p.freq._notify_done()
        for w in workers:
            w.shutdown()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
