"""Dynamic micro-batcher (copy of ``mxtpu/serving/batcher.py``).

A bounded request queue with ``max_batch_size`` / ``max_queue_delay_us``
batch assembly.  The batching *policy* is pure and clock-injected —
``submit(..)`` + ``poll(now)`` never touch wall time or threads, so
unit tests drive it deterministically; the server wraps it in worker
threads via ``wait_next()``.

Safety contract (acceptance criteria):
- the queue is bounded: ``submit`` past ``max_queue`` raises
  :class:`ServerBusy` — load sheds at the edge, memory never grows
  unboundedly;
- a request whose deadline passed is failed with
  :class:`RequestTimeout`, both while queued (dropped at poll) and when
  its batch finishes late (checked at completion) — a caller that timed
  out can never read a stale/late result;
- requests only ever batch with same-``group`` requests (the shape
  bucket), so pad/scatter cannot mix shapes.

Degradation to batch=1 when traffic is sparse falls out of the flush
rule: a lone request flushes after ``max_queue_delay_us`` and runs in
the smallest bucket.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from ..base import MXNetError
from .. import profiler
from ..obs import trace as _trace

__all__ = ["RetriableError", "ServerBusy", "RequestTimeout",
           "WorkerLost", "InferenceRequest", "Batch", "DynamicBatcher"]


class RetriableError(MXNetError):
    """Common base of the serving error taxonomy: every
    request-path error carries a ``retriable`` attribute so a caller
    (or the fleet router) can distinguish "retry elsewhere / later"
    from "give up".  Subclasses with ``retriable = False`` are
    terminal — retrying cannot help."""
    retriable = True


class ServerBusy(RetriableError):
    """Backpressure: the bounded request queue is full, a class quota
    is exhausted, or admission control predicted a deadline miss.
    Retriable — back off and resubmit, or route to another worker.

    ``retry_after_us``, when set, is the predicted queue ETA at the
    rejecting endpoint (``ServingStats.queue_eta_us``): the earliest
    resubmit that could plausibly succeed.  The fleet router parks a
    rejected dispatch for exactly this long instead of exponential
    guessing; external callers should do the
    same."""

    def __init__(self, msg: str = "",
                 retry_after_us: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_us = retry_after_us


class RequestTimeout(RetriableError):
    """The request's deadline expired before a result was available.
    Terminal: the deadline is gone no matter where you retry."""
    retriable = False


class WorkerLost(RetriableError):
    """The worker/batcher holding this request died or shut down
    before completing it.  Retriable — the same payload may well
    succeed on another worker.

    ``partial``, when set, carries the partial-generation state of a
    request that died mid-decode: prompt + already-emitted tokens + the
    ORIGINAL ``t_submit``/``deadline``, so a replay resumes the stream
    instead of restarting it, and inherits the first attempt's deadline
    clock instead of resetting it."""

    def __init__(self, msg: str = "", partial: Optional[dict] = None):
        super().__init__(msg)
        self.partial = partial


class InferenceRequest:
    """Submit-side future.  ``result()`` blocks for the outcome;
    completion is one-shot — whichever of {result, timeout, error}
    lands first wins and later writes are ignored (a tiny per-request
    lock arbitrates concurrent completers: a hung worker coming back
    to life races the router failing it with :class:`WorkerLost`).

    ``add_done_callback`` lets the fleet router observe attempt
    outcomes without polling; callbacks may fire while a batcher lock
    is held, so they must only touch leaf state (the router appends to
    an event deque)."""

    __slots__ = ("payload", "group", "seq_len", "t_submit", "deadline",
                 "_event", "_value", "_error", "t_dequeue", "t_done",
                 "requeues", "trace_id", "_wlock", "_watchers")

    def __init__(self, payload: Any, group: Any = None,
                 seq_len: Optional[int] = None,
                 t_submit: float = 0.0,
                 deadline: Optional[float] = None,
                 trace_id: Optional[str] = None):
        self.payload = payload
        self.trace_id = trace_id   # obs: minted at the submit edge
        self.group = group
        self.seq_len = seq_len
        self.t_submit = t_submit
        self.deadline = deadline
        self.t_dequeue: Optional[float] = None
        # outcome fields are event-sequenced, not lock-shared: written
        # under _wlock strictly before _event.set(), read by callers
        # only after _event.wait() — the Event is the happens-before
        # edge, so no single lock covers both sides by design.
        # mxrace: disable=unguarded-attr (event-sequenced via _event)
        self.t_done: Optional[float] = None
        self.requeues = 0          # times this re-entered a queue
        self._event = threading.Event()
        # mxrace: disable=unguarded-attr (event-sequenced via _event)
        self._value: Any = None
        # mxrace: disable=unguarded-attr (event-sequenced via _event)
        self._error: Optional[BaseException] = None
        self._wlock = threading.Lock()
        self._watchers: List[Callable[[], None]] = []  # guarded-by: _wlock

    # -- completion (batcher/server side) -------------------------------
    def _finish(self, value: Any, error: Optional[BaseException],
                now: float) -> bool:
        with self._wlock:
            if self._event.is_set():
                return False
            self._value = value
            self._error = error
            self.t_done = now
            self._event.set()
            watchers, self._watchers = self._watchers, []
        for fn in watchers:
            try:
                fn()
            except Exception:   # noqa: BLE001 — a watcher must never
                pass            # poison the completing worker
        return True

    def _complete(self, value: Any, now: float) -> bool:
        """Deliver a result — unless the deadline already passed, in
        which case the caller gets RequestTimeout, never a late
        payload."""
        if self.deadline is not None and now > self.deadline:
            return self._fail(RequestTimeout(
                f"serving: request missed its deadline by "
                f"{(now - self.deadline) * 1e3:.2f} ms"), now)
        return self._finish(value, None, now)

    def _fail(self, error: BaseException, now: float) -> bool:
        return self._finish(None, error, now)

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` (no args) once the request completes — or
        immediately if it already has."""
        with self._wlock:
            if not self._event.is_set():
                self._watchers.append(fn)
                return
        fn()

    # -- caller side ----------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise RequestTimeout(
                "serving: result() wait timed out (request still "
                "in flight)")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_us(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e6

    @property
    def queue_us(self) -> Optional[float]:
        if self.t_dequeue is None:
            return None
        return (self.t_dequeue - self.t_submit) * 1e6


def _lost_for(req: InferenceRequest,
              err: BaseException) -> BaseException:
    """The WorkerLost a dying batcher hands one request: a request
    that can describe its partial-generation progress
    (``partial_state()`` — GenerateRequest does) gets a per-request
    error carrying that state so a replay can resume the stream
    without resetting its deadline clock."""
    state_fn = getattr(req, "partial_state", None)
    if state_fn is None:
        return err
    try:
        partial = state_fn()
    except Exception:  # noqa: BLE001 — a broken state provider must
        return err     # not mask the loss itself
    if partial is None:
        return err
    return WorkerLost(str(err) or "serving: worker lost mid-"
                      "generation", partial=partial)


class Batch:
    """One assembled micro-batch: same-group requests, FIFO order."""

    __slots__ = ("requests", "group")

    def __init__(self, requests: List[InferenceRequest], group: Any):
        self.requests = requests
        self.group = group

    def __len__(self) -> int:
        return len(self.requests)


class DynamicBatcher:
    """Bounded FIFO + flush policy.

    Flush rule, evaluated against the oldest queued request (per
    group): dispatch when the group has ``max_batch_size`` requests
    waiting, OR when the oldest has waited ``max_queue_delay_us``.
    FIFO head priority keeps tail latency bounded under mixed-shape
    traffic: the assembled batch is always the one the *oldest*
    request belongs to.
    """

    def __init__(self, max_batch_size: int = 32,
                 max_queue_delay_us: float = 2000.0,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_timeout: Optional[Callable[[int], None]] = None,
                 on_depth: Optional[Callable[[int], None]] = None):
        if max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_us = float(max_queue_delay_us)
        self.max_queue = int(max_queue) if max_queue is not None \
            else 8 * self.max_batch_size
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: List[InferenceRequest] = []  # guarded-by: _cond
        # dispatched (pulled into a Batch) but not yet completed —
        # what close() must fail so no waiter hangs on a dead worker
        self._inflight: List[InferenceRequest] = []  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        self._on_timeout = on_timeout
        self._on_depth = on_depth
        self._peak_depth = 0  # guarded-by: _cond

    # -- submit side ----------------------------------------------------
    def submit(self, payload: Any, *, group: Any = None,
               seq_len: Optional[int] = None,
               timeout_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> InferenceRequest:
        """Enqueue one request; raises :class:`ServerBusy` when the
        bounded queue is full (explicit rejection, never unbounded
        growth).  ``trace_id`` (obs) rides the request through
        assembly into the runner's phase spans."""
        now = self._clock()
        req = InferenceRequest(
            payload, group=group, seq_len=seq_len, t_submit=now,
            deadline=None if timeout_s is None else now + timeout_s,
            trace_id=trace_id)
        with self._cond:
            if self._closed:
                raise WorkerLost(
                    "serving: batcher is closed (worker shut down or "
                    "lost) — resubmit elsewhere")
            if len(self._queue) >= self.max_queue:
                raise ServerBusy(
                    f"serving: queue full ({self.max_queue} waiting); "
                    f"retry with backoff")
            self._queue.append(req)
            self._note_depth_locked()
            self._cond.notify()
        return req

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def peak_depth(self) -> int:
        """Locked snapshot — the raw attr races the submit path
        (mxrace guarded-by-violation when read bare)."""
        with self._cond:
            return self._peak_depth

    def _note_depth_locked(self) -> None:
        d = len(self._queue)
        if d > self._peak_depth:
            self._peak_depth = d
        if self._on_depth is not None:
            self._on_depth(d)

    # -- policy (pure, clock-injected) ----------------------------------
    def _expire_locked(self, now: float) -> None:
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        if not expired:
            return
        self._queue = [r for r in self._queue if r not in expired]
        self._note_depth_locked()
        # stat BEFORE the event-set wakes any result() waiter: a
        # caller observing its RequestTimeout must already find the
        # timeout counted in stats() (mxrace-exposed ordering race)
        if self._on_timeout is not None:
            self._on_timeout(len(expired))
        for r in expired:
            r._fail(RequestTimeout(
                "serving: deadline expired while queued"), now)

    def _poll_locked(self, now: float) -> Optional[Batch]:
        self._expire_locked(now)
        if not self._queue:
            return None
        head = self._queue[0]
        group = [r for r in self._queue if r.group == head.group]
        full = len(group) >= self.max_batch_size
        overdue = (now - head.t_submit) * 1e6 >= self.max_queue_delay_us
        if not (full or overdue):
            return None
        take = group[:self.max_batch_size]
        taken = set(map(id, take))
        self._queue = [r for r in self._queue if id(r) not in taken]
        self._note_depth_locked()
        for r in take:
            r.t_dequeue = now
        # register in-flight (reaping completed ones keeps it bounded)
        self._inflight = [r for r in self._inflight if not r.done()]
        self._inflight.extend(take)
        return Batch(take, head.group)

    def requeue(self, requests: List[InferenceRequest],
                now: Optional[float] = None) -> int:
        """Return the not-yet-done requests of a FAILED batch execution
        to the queue — each request re-enters AT MOST ONCE, with its
        original deadline and ``t_submit`` (so ``queue_us`` accounting
        stays honest: it spans submit → final dequeue).  A request
        whose deadline already passed expires as :class:`RequestTimeout`
        (it must not loop); one that already burned its requeue — or
        arriving after close — fails as :class:`WorkerLost` so the
        fleet layer can retry it on another worker.  Returns the number
        actually requeued."""
        now = self._clock() if now is None else now
        requeued: List[InferenceRequest] = []
        expired: List[InferenceRequest] = []
        lost: List[InferenceRequest] = []
        with self._cond:
            processed = set(map(id, requests))
            self._inflight = [r for r in self._inflight
                              if id(r) not in processed]
            for r in requests:
                if r.done():
                    continue
                if r.deadline is not None and now > r.deadline:
                    expired.append(r)
                elif r.requeues >= 1 or self._closed:
                    lost.append(r)
                else:
                    r.requeues += 1
                    r.t_dequeue = None
                    requeued.append(r)
            # stat BEFORE the event-set wakes any result() waiter —
            # same ordering contract as _expire_locked
            if expired and self._on_timeout is not None:
                self._on_timeout(len(expired))
            for r in expired:
                r._fail(RequestTimeout(
                    "serving: deadline expired before the failed "
                    "batch could requeue"), now)
            for r in lost:
                r._fail(WorkerLost(
                    "serving: batch execution failed "
                    + ("again after a requeue"
                       if r.requeues else "and the batcher is "
                       "closed")), now)
            if requeued:
                # back to the FRONT: they were the oldest waiters and
                # FIFO head priority is what bounds tail latency
                self._queue[0:0] = requeued
                self._note_depth_locked()
                self._cond.notify_all()
        if requeued and profiler.is_active():
            for r in requeued:
                if r.trace_id is not None:
                    _trace.span(_trace.SPAN_REQUEUE, now * 1e6, 0.0,
                                trace_id=r.trace_id,
                                requeues=r.requeues)
        return len(requeued)

    def oldest_waiting_age(self, now: Optional[float] = None
                           ) -> Optional[float]:
        """Age of the oldest QUEUED request — the queue-wedge liveness
        signal: on a healthy worker this stays under the assembly
        delay, on a wedged one it grows without bound."""
        with self._cond:
            if not self._queue:
                return None
            return (self._clock() if now is None else now) \
                - self._queue[0].t_submit

    def poll(self, now: Optional[float] = None) -> Optional[Batch]:
        """Non-blocking assembly decision at time ``now`` (defaults to
        the injected clock).  Returns a Batch when the flush rule fires,
        else None.  This is the whole policy — tests call it directly
        with a hand-stepped clock."""
        with self._cond:
            return self._poll_locked(
                self._clock() if now is None else now)

    def _next_event_locked(self, now: float) -> Optional[float]:
        """Seconds until the next time-driven state change (flush of
        the current head, or earliest deadline) — how long a worker may
        sleep without missing a flush."""
        if not self._queue:
            return None
        head = self._queue[0]
        wake = head.t_submit + self.max_queue_delay_us / 1e6
        for r in self._queue:
            if r.deadline is not None and r.deadline < wake:
                wake = r.deadline
        return max(0.0, wake - now)

    # -- thread side (server workers) -----------------------------------
    def wait_next(self, timeout: Optional[float] = None
                  ) -> Optional[Batch]:
        """Block until a batch is ready (or ``timeout``).  Used by
        server worker threads; the policy itself stays in ``poll``."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                now = self._clock()
                if self._closed:
                    return None
                batch = self._poll_locked(now)
                if batch is not None:
                    return batch
                wait = self._next_event_locked(now)
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None \
                        else min(wait, remaining)
                # a flush can only become due by time passing or a new
                # submit — both bounded by `wait` (None = submit only)
                self._cond.wait(wait if wait is None or wait > 0
                                else 1e-4)

    def close(self, error: Optional[BaseException] = None) -> None:
        """Fail everything still queued AND still in flight with a
        terminal-for-this-worker :class:`WorkerLost` (retriable
        elsewhere), and wake all waiters.  Nothing may be left blocked
        in ``result()`` after a worker dies — this is the
        no-hung-waiters contract.  ``error`` overrides the default
        WorkerLost (e.g. the router passes the death reason)."""
        with self._cond:
            self._closed = True
            now = self._clock()
            err = error if error is not None else WorkerLost(
                "serving: batcher closed — worker lost before the "
                "request completed")
            for r in self._queue:
                r._fail(err, now)
            self._queue.clear()
            for r in self._inflight:
                if not r.done():
                    r._fail(err, now)
            self._inflight = []
            self._note_depth_locked()
            self._cond.notify_all()
