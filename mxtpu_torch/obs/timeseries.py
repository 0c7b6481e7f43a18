"""Bounded time-series sampler over the metrics registry.

The registry (PR 8) is instantaneous: a scrape sees totals, never
history, so "requests/sec over the last minute" or "p95 in the last 5
minutes" — the inputs every SLO and every ``/statusz`` row needs —
cannot be answered in-process.  :class:`Sampler` closes that gap with
a deliberately small design:

* **injected clock** — every sample is stamped with the caller's
  clock (the fleet's fake clock in tests), so windows, rates and
  quantiles are bit-reproducible with no sleeps;
* **bounded ring per series** — one ``deque(maxlen=capacity)`` per
  ``(metric, label-set)``; memory is O(series x capacity) forever;
* **windowed reads** — counters become rates/deltas between the
  oldest and newest sample inside the window, gauges read their last
  level, histograms expose windowed p50/p95/p99 from cumulative
  *bucket deltas* (:func:`.metrics.bucket_quantile`) — the standard
  Prometheus ``rate``/``histogram_quantile`` arithmetic, computed
  locally.

``sample()`` reads the registry through its public :meth:`snapshot`
surface with NO sampler lock held, then appends under ``_lock`` (a
leaf — the sampler never calls out while holding it).  Zero-overhead
contract: with ``MXTPU_OBS=0`` the ``obs.sampler()`` factory hands
back the shared :data:`NULL_SAMPLER` whose methods do nothing and
whose reads return ``None`` — asserted by ``obs.self_check()``.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import knobs
from .metrics import bucket_quantile

__all__ = ["Sampler", "NULL_SAMPLER"]

# (metric name, sorted label items) — one ring per series
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[Dict[str, Any]]) -> _Key:
    items = tuple(sorted((k, str(v))
                         for k, v in (labels or {}).items()))
    return (name, items)


class Sampler:
    """Periodic snapshots of a :class:`~.metrics.MetricsRegistry`
    into bounded per-series rings, plus the windowed read API.

    >>> smp = Sampler(obs.registry(), clock=clk)
    >>> smp.maybe_sample(now)            # period-gated (tick-driven)
    >>> smp.rate("mxtpu_serving_completed_total",
    ...          {"endpoint": "fleet"}, window_s=60.0)
    >>> smp.quantile("mxtpu_serving_latency_seconds",
    ...              {"endpoint": "fleet"}, q=95, window_s=300.0)
    """

    def __init__(self, registry, *, capacity: int = 512,
                 period_us: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self._registry = registry
        self._capacity = int(capacity)
        if period_us is None:
            period_us = knobs.get("MXTPU_OBS_SAMPLE_PERIOD_US")
        self._period_s = max(0.0, float(period_us)) / 1e6
        self._clock = clock
        self._lock = threading.Lock()
        # counter/gauge rings hold (ts, value); histogram rings hold
        # (ts, cum_counts incl +Inf, sum) with bounds kept beside the
        # ring (fixed per series)
        self._series: Dict[_Key, deque] = {}       # guarded-by: _lock
        self._bounds: Dict[_Key, Tuple[float, ...]] = {}  # guarded-by: _lock
        self._kind: Dict[_Key, str] = {}           # guarded-by: _lock
        self._last_ts: Optional[float] = None      # guarded-by: _lock
        self._samples = 0                          # guarded-by: _lock

    @property
    def enabled(self) -> bool:
        return True

    # -- writing -----------------------------------------------------------
    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Period-gated :meth:`sample` — the tick-driven entry point.
        Returns True when a sample was actually taken."""
        now = self._now(now)
        with self._lock:
            if self._last_ts is not None and \
                    now - self._last_ts < self._period_s:
                return False
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> None:
        """Snapshot every registered series once, stamped ``now``."""
        now = self._now(now)
        snap = self._registry.snapshot()   # registry locks; ours not held
        rows: List[Tuple[_Key, str, Any]] = []
        for name, fam in snap.items():
            kind = fam["type"]
            for entry in fam["series"]:
                key = _key(name, entry["labels"])
                if kind == "histogram":
                    buckets = entry["buckets"]
                    bounds = tuple(float(b) for b in buckets
                                   if b != "+Inf")
                    cum = tuple(float(buckets[k]) for k in buckets)
                    rows.append((key, kind,
                                 (now, bounds, cum,
                                  float(entry["sum"]))))
                else:
                    rows.append((key, kind,
                                 (now, float(entry["value"]))))
        with self._lock:
            for key, kind, point in rows:
                ring = self._series.get(key)
                if ring is None:
                    ring = self._series[key] = \
                        deque(maxlen=self._capacity)
                    self._kind[key] = kind
                if kind == "histogram":
                    ts, bounds, cum, s = point
                    self._bounds[key] = bounds
                    ring.append((ts, cum, s))
                else:
                    ring.append(point)
            self._last_ts = now
            self._samples += 1

    # -- reading -----------------------------------------------------------
    def level(self, name: str, labels: Optional[Dict[str, Any]] = None
              ) -> Optional[float]:
        """Latest sampled value of a gauge (or counter total)."""
        with self._lock:
            ring = self._series.get(_key(name, labels))
            return ring[-1][1] if ring else None

    def delta(self, name: str,
              labels: Optional[Dict[str, Any]] = None,
              window_s: Optional[float] = None) -> Optional[float]:
        """Counter increase across the window (oldest in-window sample
        vs the newest), clamped at 0 (a reset reads as no increase).
        ``window_s=None`` spans the whole retained ring.  None until
        two samples land in the window."""
        pts = self._window(_key(name, labels), window_s)
        if len(pts) < 2:
            return None
        return max(0.0, pts[-1][1] - pts[0][1])

    def rate(self, name: str,
             labels: Optional[Dict[str, Any]] = None,
             window_s: Optional[float] = None) -> Optional[float]:
        """Counter per-second rate across the window."""
        pts = self._window(_key(name, labels), window_s)
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        return max(0.0, (pts[-1][1] - pts[0][1])
                   / (pts[-1][0] - pts[0][0]))

    def hist_delta(self, name: str,
                   labels: Optional[Dict[str, Any]] = None,
                   window_s: Optional[float] = None
                   ) -> Optional[Tuple[Tuple[float, ...],
                                       Tuple[float, ...], float]]:
        """Windowed histogram increase: ``(bounds, cumulative bucket
        deltas incl +Inf, sum delta)``.  None until two samples land
        in the window."""
        key = _key(name, labels)
        pts = self._window(key, window_s)
        with self._lock:
            bounds = self._bounds.get(key)
        if bounds is None or len(pts) < 2:
            return None
        first, last = pts[0], pts[-1]
        if len(first[1]) != len(last[1]):
            return None     # bucket layout changed (registry reset)
        cum = tuple(max(0.0, b - a)
                    for a, b in zip(first[1], last[1]))
        return (bounds, cum, max(0.0, last[2] - first[2]))

    def quantile(self, name: str,
                 labels: Optional[Dict[str, Any]] = None,
                 q: float = 95.0,
                 window_s: Optional[float] = None) -> Optional[float]:
        """Windowed histogram quantile (``q`` in [0, 100]) from bucket
        deltas — the sampler's p50/p95/p99 surface."""
        d = self.hist_delta(name, labels, window_s)
        if d is None:
            return None
        bounds, cum, _ = d
        return bucket_quantile(bounds, cum, q)

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    def summary(self) -> Dict[str, Any]:
        """Cheap stats block for ``/statusz`` and ``self_check``."""
        with self._lock:
            return {
                "series": len(self._series),
                "samples": self._samples,
                "capacity": self._capacity,
                "period_us": round(self._period_s * 1e6, 1),
                "last_ts": self._last_ts,
            }

    # -- internals ---------------------------------------------------------
    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return float(now)
        if self._clock is not None:
            return float(self._clock())
        import time
        return time.monotonic()

    def _window(self, key: _Key,
                window_s: Optional[float]) -> List[tuple]:
        """Points inside ``[newest_ts - window_s, newest_ts]`` —
        windows are anchored at the series' own latest sample so a
        paused fake clock still reads coherently."""
        with self._lock:
            ring = self._series.get(key)
            pts = list(ring) if ring else []
        if not pts or window_s is None:
            return pts
        horizon = pts[-1][0] - float(window_s)
        return [p for p in pts if p[0] >= horizon]


class _NullSampler:
    """Shared no-op sampler: writes do nothing, reads answer None —
    the ``MXTPU_OBS=0`` singleton (``obs.self_check()`` asserts the
    disabled factory hands back exactly this object)."""

    __slots__ = ()
    enabled = False

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        return False

    def sample(self, now: Optional[float] = None) -> None:
        pass

    def level(self, name: str, labels=None) -> Optional[float]:
        return None

    def delta(self, name: str, labels=None,
              window_s=None) -> Optional[float]:
        return None

    def rate(self, name: str, labels=None,
             window_s=None) -> Optional[float]:
        return None

    def hist_delta(self, name: str, labels=None, window_s=None):
        return None

    def quantile(self, name: str, labels=None, q: float = 95.0,
                 window_s=None) -> Optional[float]:
        return None

    def series_names(self) -> List[str]:
        return []

    def summary(self) -> Dict[str, Any]:
        return {"series": 0, "samples": 0, "capacity": 0,
                "period_us": 0.0, "last_ts": None}


NULL_SAMPLER = _NullSampler()
