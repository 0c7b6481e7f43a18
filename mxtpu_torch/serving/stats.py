"""Serving observability — rolling latency percentiles, queue depth,
batch fill-rate and request rate, and a generation endpoint's
time-to-first-token and per-token latency, as a ``stats()`` snapshot
dict and a Speedometer-style periodic log line.

Copy of ``mxtpu/serving/stats.py`` without the ``mxtpu.obs`` metrics
registry wiring.  Everything is O(1) per event under one lock:
percentiles come from a bounded ring of recent latencies, rates from a
deque of completion timestamps.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

__all__ = ["ServingStats"]

logger = logging.getLogger("mxtpu_torch.serving")

# queue_eta_us sorts at most this many recent service-time samples —
# bounds the admission-path cost independently of the stats window
_ETA_SAMPLE = 256


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile on a pre-sorted sequence, ``q`` in
    [0, 100] (``mxtpu.obs.metrics.percentile``)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class ServingStats:
    """Per-endpoint rolling counters.  One instance per registered
    (model, version); the server updates it from its worker threads,
    ``snapshot()`` is safe from any thread."""

    def __init__(self, name: str = "", window: int = 2048,
                 rate_window_s: float = 30.0,
                 log_every_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._lock = threading.Lock()
        self._clock = clock
        self._lat_us = deque(maxlen=window)  # guarded-by: _lock
        self._queue_us = deque(maxlen=window)  # guarded-by: _lock
        self._done_ts = deque()  # guarded-by: _lock
        # generation rings: time-to-first-token and per-token decode
        # latency
        self._ttft_us = deque(maxlen=window)  # guarded-by: _lock
        self._tok_us = deque(maxlen=window)  # guarded-by: _lock
        self.tokens_emitted = 0  # guarded-by: _lock
        self._rate_window_s = rate_window_s
        self._log_every_s = log_every_s
        self._last_log = clock()  # guarded-by: _lock
        # monotonically increasing totals
        self.completed = 0  # guarded-by: _lock
        self.timed_out = 0  # guarded-by: _lock
        self.rejected = 0  # guarded-by: _lock
        self.batches = 0  # guarded-by: _lock
        self.padded_slots = 0  # guarded-by: _lock
        self.batched_requests = 0  # guarded-by: _lock
        self.queue_depth = 0  # guarded-by: _lock
        self.peak_queue_depth = 0  # guarded-by: _lock
        # open-ended fleet counters (retries, requeues, hedges_won,
        # drains, deaths, ...) — bump() increments, snapshot() exposes
        # them under "extras", maybe_log() appends the nonzero ones to
        # the Speedometer line (extended, not duplicated)
        self.extras: Dict[str, int] = {}  # guarded-by: _lock

    # -- event hooks (called by batcher/server) -------------------------
    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            if depth > self.peak_queue_depth:
                self.peak_queue_depth = depth

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self.rejected += n

    def record_timeout(self, n: int = 1) -> None:
        with self._lock:
            self.timed_out += n

    def bump(self, key: str, n: int = 1) -> None:
        """Increment a named fleet counter (``retries``, ``requeues``,
        ``hedges_won``, ``drains``, ``deaths``, ...)."""
        with self._lock:
            self.extras[key] = self.extras.get(key, 0) + n

    def record_batch(self, n_real: int, capacity: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += n_real
            self.padded_slots += max(0, capacity - n_real)

    def record_completion(self, latency_us: float,
                          queue_us: float = 0.0) -> None:
        now = self._clock()
        with self._lock:
            self.completed += 1
            self._lat_us.append(latency_us)
            self._queue_us.append(queue_us)
            self._done_ts.append(now)
            horizon = now - self._rate_window_s
            while self._done_ts and self._done_ts[0] < horizon:
                self._done_ts.popleft()

    def record_ttft(self, ttft_us: float) -> None:
        """Time-to-first-token of one generation request."""
        with self._lock:
            self._ttft_us.append(ttft_us)

    def record_token(self, tok_us: float, n: int = 1) -> None:
        """One (or ``n`` same-latency) emitted decode tokens."""
        with self._lock:
            self._tok_us.append(tok_us)
            self.tokens_emitted += n

    # -- views ----------------------------------------------------------
    def queue_eta_us(self, depth: Optional[float] = None,
                     percentile: float = 95.0) -> Optional[float]:
        """Predicted wait for a request entering this endpoint's queue
        now: histogram-derived per-batch service time × queued batches
        ahead (depth / mean batch fill), plus the request's own batch.
        This is the admission-control signal: unlike raw
        queue length it is deadline-comparable, so a doomed request
        can be shed at submit time.

        ``depth`` overrides the live queue depth (the fleet router
        passes its own class-aware backlog); ``percentile`` picks the
        service-time rank (p95 default — admission should be
        pessimistic about stragglers).  Returns ``None`` until at
        least one batch has completed (a cold endpoint has no
        histogram — callers treat that as "no prediction", not zero).
        """
        with self._lock:
            if not self._lat_us or not self.batches:
                return None
            # service time = end-to-end latency minus queue wait, per
            # completed request; recent window keeps the sort cheap on
            # the admission path
            serv = sorted(
                max(0.0, l - q) for l, q in
                zip(list(self._lat_us)[-_ETA_SAMPLE:],
                    list(self._queue_us)[-_ETA_SAMPLE:]))
            s = _percentile(serv, percentile)
            fill = max(1.0, self.batched_requests / self.batches)
            d = float(self.queue_depth) if depth is None \
                else max(0.0, float(depth))
            return s * (1.0 + d / fill)

    def requests_per_sec(self) -> float:
        with self._lock:
            return self._rps_locked(self._clock())

    def _rps_locked(self, now: float) -> float:
        # Prune on the read path too: after an
        # idle period the ring otherwise still holds — and counts —
        # completions far outside the rate window.
        horizon = now - self._rate_window_s
        while self._done_ts and self._done_ts[0] < horizon:
            self._done_ts.popleft()
        if not self._done_ts:
            return 0.0
        span = max(now - self._done_ts[0], 1e-6)
        return len(self._done_ts) / span

    def snapshot(self) -> Dict:
        """One coherent stats dict (the ``stats()`` surface of the
        serving layer)."""
        with self._lock:
            lat = sorted(self._lat_us)
            queued = sorted(self._queue_us)
            ttft = sorted(self._ttft_us)
            toks = sorted(self._tok_us)
            cap = self.batched_requests + self.padded_slots
            gen = {}
            if ttft or toks:
                gen = {"generate": {
                    "tokens_emitted": self.tokens_emitted,
                    "ttft_ms": {
                        "p50": round(_percentile(ttft, 50) / 1e3, 3),
                        "p95": round(_percentile(ttft, 95) / 1e3, 3),
                        "n": len(ttft)},
                    "token_ms": {
                        "p50": round(_percentile(toks, 50) / 1e3, 3),
                        "p95": round(_percentile(toks, 95) / 1e3, 3),
                        "n": len(toks)},
                }}
            return {
                **gen,
                "completed": self.completed,
                "timed_out": self.timed_out,
                "rejected": self.rejected,
                "batches": self.batches,
                "requests_per_sec": round(
                    self._rps_locked(self._clock()), 2),
                "latency_ms": {
                    "p50": round(_percentile(lat, 50) / 1e3, 3),
                    "p95": round(_percentile(lat, 95) / 1e3, 3),
                    "p99": round(_percentile(lat, 99) / 1e3, 3),
                    "n": len(lat),
                },
                "queue_ms": {
                    "p50": round(_percentile(queued, 50) / 1e3, 3),
                    "p99": round(_percentile(queued, 99) / 1e3, 3),
                },
                "batch_fill_rate": round(
                    self.batched_requests / cap, 4) if cap else None,
                "mean_batch_size": round(
                    self.batched_requests / self.batches, 2)
                if self.batches else None,
                "queue_depth": self.queue_depth,
                "peak_queue_depth": self.peak_queue_depth,
                "extras": dict(self.extras),
            }

    def maybe_log(self) -> Optional[str]:
        """Speedometer-style throttled log line — call after each batch;
        emits at most once per ``log_every_s``.  Returns the line when
        one was emitted (tests hook this)."""
        now = self._clock()
        with self._lock:
            if now - self._last_log < self._log_every_s:
                return None
            self._last_log = now
            lat = sorted(self._lat_us)
            cap = self.batched_requests + self.padded_slots
            line = (f"Serving [{self.name}] "
                    f"{self._rps_locked(now):.1f} req/sec\t"
                    f"p50={_percentile(lat, 50) / 1e3:.2f}ms "
                    f"p95={_percentile(lat, 95) / 1e3:.2f}ms "
                    f"p99={_percentile(lat, 99) / 1e3:.2f}ms\t"
                    f"fill={self.batched_requests / cap if cap else 0.0:.2f} "
                    f"queue={self.queue_depth} "
                    f"(peak {self.peak_queue_depth}) "
                    f"timeout={self.timed_out} busy={self.rejected}")
            extras = " ".join(f"{k}={v}" for k, v in
                              sorted(self.extras.items()) if v)
            if extras:
                line += " " + extras
        logger.info(line)
        return line
