"""Declarative SLOs + multi-window burn-rate alerting.

An SLO turns sampled series (:mod:`.timeseries`) into one number per
window — the **error ratio** (fraction of events that violated the
objective) — and the engine turns error ratios into alerts the
Google-SRE way: the **burn rate** (error ratio / error budget, where
budget = 1 - objective) must exceed the rule's factor in BOTH a fast
window (catches it quickly) and a slow window (rejects blips) before
the alert fires.  A fast-only spike never pages; a sustained burn
always does.

Two SLO kinds, matching the serving metrics the fleet already
publishes (``endpoint=`` labeled, PR 8/11):

* :class:`AvailabilitySLO` — availability = 1 - (timeouts + sheds +
  wrong) / admitted, from the windowed deltas of
  ``mxtpu_serving_timeout_total`` / ``mxtpu_serving_rejected_total``
  / ``mxtpu_fleet_events_total{kind=wrong_results}`` over
  ``completed + timeouts + sheds``;
* :class:`LatencySLO` — fraction of requests slower than the target,
  from windowed bucket deltas of ``mxtpu_serving_latency_seconds``
  (the conservative read: a request is "good" only when its bucket's
  upper bound is <= target).  Declarable per class via the
  ``MXTPU_SLO_CLASSES`` knob (:func:`parse_slo_classes`).

:class:`SLOEngine` is tick-driven on the injected clock
(``router.attach_slo(engine)`` rides the router tick with no router
lock held).  Alert edges increment
``mxtpu_slo_alerts_total{slo,window}``, append to the ``fleet/slo``
flight recorder, and land in ``FleetRouter.postmortem()`` /
``fleet_stats()`` / ``/statusz`` via :meth:`SLOEngine.snapshot`.
Error-budget accounting (consumed fraction over the sampler's whole
retained history) rides along in the snapshot.

Lock discipline: evaluation reads the sampler lock-free from
the engine's perspective, the firing-set diff happens under the
engine's leaf ``_lock``, and counters/recorder fire after it is
released — the autoscaler pattern.  Zero-overhead contract: with
``MXTPU_OBS=0`` the ``obs.slo_engine()`` factory returns the shared
:data:`NULL_SLO_ENGINE` (asserted by ``obs.self_check()``).
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

from ..base import MXNetError
from .metrics import _fmt

__all__ = ["AvailabilitySLO", "LatencySLO", "BurnRateRule",
           "DEFAULT_RULES", "SLOEngine", "NULL_SLO_ENGINE",
           "parse_slo_classes"]


class BurnRateRule(NamedTuple):
    """One multi-window burn-rate rule: alert only when the burn rate
    (error ratio / error budget) exceeds ``factor`` in BOTH windows."""
    fast_s: float
    slow_s: float
    factor: float

    @property
    def label(self) -> str:
        return f"{_fmt(self.fast_s)}s/{_fmt(self.slow_s)}s"


# The canonical SRE-workbook pairs: page fast on a 14.4x burn (2% of a
# 30-day budget in an hour), slower on a sustained 6x burn.
DEFAULT_RULES: Tuple[BurnRateRule, ...] = (
    BurnRateRule(fast_s=300.0, slow_s=3600.0, factor=14.4),
    BurnRateRule(fast_s=1800.0, slow_s=21600.0, factor=6.0),
)


class _SLO:
    """Shared SLO bookkeeping: a name, an objective in (0, 1), and
    the derived error budget."""

    kind = "slo"

    def __init__(self, name: str, objective: float):
        if not name:
            raise MXNetError("obs: an SLO needs a name")
        if not 0.0 < float(objective) < 1.0:
            raise MXNetError(
                f"obs: SLO {name!r} objective must be in (0, 1), "
                f"got {objective}")
        self.name = str(name)
        self.objective = float(objective)
        self.budget = 1.0 - self.objective

    def error_ratio(self, sampler,
                    window_s: Optional[float]) -> Optional[float]:
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind, "objective": self.objective,
                "budget": self.budget}

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.name!r}, "
                f"objective={self.objective})")


class AvailabilitySLO(_SLO):
    """availability = 1 - (timeouts + sheds + wrong) / admitted, over
    one serving endpoint's counters (``endpoint="fleet"`` = the
    router-level aggregate)."""

    kind = "availability"

    def __init__(self, name: str, objective: float = 0.999,
                 endpoint: str = "fleet",
                 wrong_kinds: Sequence[str] = ("wrong_results",)):
        super().__init__(name, objective)
        self.endpoint = str(endpoint)
        self.wrong_kinds = tuple(wrong_kinds)

    def error_ratio(self, sampler,
                    window_s: Optional[float]) -> Optional[float]:
        ep = {"endpoint": self.endpoint}
        ok = sampler.delta("mxtpu_serving_completed_total", ep,
                           window_s)
        to = sampler.delta("mxtpu_serving_timeout_total", ep, window_s)
        shed = sampler.delta("mxtpu_serving_rejected_total", ep,
                             window_s)
        if ok is None and to is None and shed is None:
            return None         # series not sampled yet
        wrong = 0.0
        for kind in self.wrong_kinds:
            w = sampler.delta("mxtpu_fleet_events_total",
                              {"endpoint": self.endpoint,
                               "kind": kind}, window_s)
            wrong += w or 0.0
        bad = (to or 0.0) + (shed or 0.0) + wrong
        admitted = (ok or 0.0) + bad
        if admitted <= 0:
            return None         # no traffic in the window: no verdict
        return min(1.0, bad / admitted)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d["endpoint"] = self.endpoint
        return d


class LatencySLO(_SLO):
    """Fraction of requests slower than ``target_s`` over one
    endpoint's latency histogram; ``percentile`` is the display rank
    (:meth:`observed`), the error ratio itself is exact from bucket
    deltas."""

    kind = "latency"

    def __init__(self, name: str, target_s: float,
                 objective: float = 0.95, endpoint: str = "fleet",
                 percentile: float = 95.0,
                 metric: str = "mxtpu_serving_latency_seconds"):
        super().__init__(name, objective)
        if target_s <= 0:
            raise MXNetError(
                f"obs: latency SLO {name!r} target must be positive")
        self.target_s = float(target_s)
        self.endpoint = str(endpoint)
        self.percentile = float(percentile)
        # which latency histogram to burn against: the default is the
        # end-to-end request latency; generation endpoints
        # point this at mxtpu_serving_ttft_seconds or
        # mxtpu_serving_token_seconds for TTFT / per-token objectives
        self.metric = str(metric)

    def error_ratio(self, sampler,
                    window_s: Optional[float]) -> Optional[float]:
        d = sampler.hist_delta(self.metric,
                               {"endpoint": self.endpoint}, window_s)
        if d is None:
            return None
        bounds, cum, _ = d
        total = cum[-1] if cum else 0.0
        if total <= 0:
            return None
        # conservative: good = requests in buckets whose upper bound
        # is <= target (anything straddling the target counts bad)
        i = bisect_right(bounds, self.target_s)
        good = cum[i - 1] if i > 0 else 0.0
        return min(1.0, max(0.0, 1.0 - good / total))

    def observed(self, sampler,
                 window_s: Optional[float]) -> Optional[float]:
        return sampler.quantile(self.metric,
                                {"endpoint": self.endpoint},
                                q=self.percentile, window_s=window_s)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(endpoint=self.endpoint, target_s=self.target_s,
                 percentile=self.percentile, metric=self.metric)
        return d


def parse_slo_classes(spec: str) -> List[LatencySLO]:
    """Parse the ``MXTPU_SLO_CLASSES`` knob:
    ``name:endpoint:target_ms:objective[:percentile],...`` (e.g.
    ``interactive:fleet:50:0.95``).  Empty spec -> no latency SLOs."""
    out: List[LatencySLO] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 4:
            raise MXNetError(
                f"obs: bad SLO class spec {part!r} (want "
                f"name:endpoint:target_ms:objective[:percentile])")
        try:
            target_s = float(bits[2]) / 1e3
            objective = float(bits[3])
            pct = float(bits[4]) if len(bits) > 4 and bits[4] else 95.0
        except ValueError as e:
            raise MXNetError(
                f"obs: bad SLO class spec {part!r}: {e}") from None
        out.append(LatencySLO(bits[0], target_s, objective,
                              endpoint=bits[1] or "fleet",
                              percentile=pct))
    return out


_ALERT_LOG_CAP = 64


class SLOEngine:
    """Tick-driven evaluator: samples, evaluates every SLO x rule,
    edge-triggers alerts.  Construct via ``obs.slo_engine(...)`` so
    the ``MXTPU_OBS=0`` path gets the shared no-op instead.

    >>> engine = obs.slo_engine([AvailabilitySLO("avail", 0.99)],
    ...                         sampler=smp, clock=clk)
    >>> router.attach_slo(engine)     # router tick drives it
    """

    enabled = True

    def __init__(self, slos: Sequence[_SLO], sampler, *,
                 rules: Sequence[BurnRateRule] = DEFAULT_RULES,
                 clock: Optional[Callable[[], float]] = None,
                 alerts=None, recorder=None):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise MXNetError(
                f"obs: duplicate SLO names {sorted(names)}")
        self.slos = list(slos)
        self.rules = tuple(rules)
        self._sampler = sampler
        self._clock = clock
        # instruments are injectable so self_check can run the whole
        # engine against a private registry with obs disabled
        if alerts is None or recorder is None:
            from .. import obs as _obs
            if alerts is None:
                alerts = _obs.counter(
                    "mxtpu_slo_alerts_total",
                    "Burn-rate alert edges (fast+slow windows both "
                    "breached).", labels=("slo", "window"))
            if recorder is None:
                recorder = _obs.flight("fleet/slo", clock=clock)
        self._alerts = alerts
        self.recorder = recorder
        self._lock = threading.Lock()
        # (slo name, rule label) pairs currently firing
        self._active: set = set()       # guarded-by: _lock
        self._alert_log: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._ticks = 0                 # guarded-by: _lock

    # -- the tick ----------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Tuple[str, str]]:
        """One evaluation round: sample (period-gated), evaluate every
        SLO x rule, fire/clear alert edges.  Returns the NEWLY fired
        ``(slo, window)`` pairs — tests key off it.  Runs with no
        caller lock held (it is a router controller hook)."""
        if now is None:
            now = self._clock() if self._clock is not None else None
        self._sampler.maybe_sample(now)
        firing: set = set()
        detail: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for slo in self.slos:
            for rule in self.rules:
                fast = slo.error_ratio(self._sampler, rule.fast_s)
                slow = slo.error_ratio(self._sampler, rule.slow_s)
                if fast is None or slow is None:
                    continue
                fast_burn = fast / slo.budget
                slow_burn = slow / slo.budget
                if fast_burn >= rule.factor and \
                        slow_burn >= rule.factor:
                    key = (slo.name, rule.label)
                    firing.add(key)
                    detail[key] = {
                        "fast_burn": round(fast_burn, 3),
                        "slow_burn": round(slow_burn, 3),
                        "factor": rule.factor,
                    }
        with self._lock:
            self._ticks += 1
            new = sorted(firing - self._active)
            cleared = sorted(self._active - firing)
            self._active = firing
            for name, window in new:
                entry = {"slo": name, "window": window, "t": now,
                         **detail[(name, window)]}
                self._alert_log.append(entry)
                del self._alert_log[:-_ALERT_LOG_CAP]
        # instruments fire OUTSIDE the engine lock (leaf discipline)
        for name, window in new:
            self._alerts.labels(slo=name, window=window).inc()
            self.recorder.record("slo_alert", slo=name, window=window,
                                 **detail[(name, window)])
        for name, window in cleared:
            self.recorder.record("slo_clear", slo=name, window=window)
        return new

    # -- read surfaces -----------------------------------------------------
    def firing(self) -> List[Tuple[str, str]]:
        """Currently-firing ``(slo, window)`` pairs — the autoscaler's
        knob-gated overload signal."""
        with self._lock:
            return sorted(self._active)

    def snapshot(self) -> Dict[str, Any]:
        """The SLO/error-budget table ``/statusz``, ``fleet_stats()``
        and ``postmortem()`` embed."""
        with self._lock:
            active = set(self._active)
            alerts = list(self._alert_log)
            ticks = self._ticks
        table: Dict[str, Any] = {}
        for slo in self.slos:
            overall = slo.error_ratio(self._sampler, None)
            consumed = None if overall is None \
                else overall / slo.budget
            windows: Dict[str, Any] = {}
            for rule in self.rules:
                fast = slo.error_ratio(self._sampler, rule.fast_s)
                slow = slo.error_ratio(self._sampler, rule.slow_s)
                windows[rule.label] = {
                    "factor": rule.factor,
                    "fast_error": fast,
                    "slow_error": slow,
                    "fast_burn": None if fast is None
                    else round(fast / slo.budget, 3),
                    "slow_burn": None if slow is None
                    else round(slow / slo.budget, 3),
                    "firing": (slo.name, rule.label) in active,
                }
            entry = {**slo.describe(), "windows": windows,
                     "budget_consumed": None if consumed is None
                     else round(consumed, 4),
                     "budget_remaining": None if consumed is None
                     else round(1.0 - consumed, 4)}
            if isinstance(slo, LatencySLO):
                entry["observed"] = slo.observed(self._sampler, None)
            table[slo.name] = entry
        return {"slos": table, "firing": sorted(active),
                "alerts": alerts, "ticks": ticks}


class _NullSLOEngine:
    """Shared no-op engine behind ``MXTPU_OBS=0``: ticks do nothing,
    nothing ever fires (``obs.self_check()`` asserts identity)."""

    __slots__ = ()
    enabled = False
    slos: tuple = ()
    rules: tuple = ()

    def tick(self, now: Optional[float] = None) -> list:
        return []

    def firing(self) -> list:
        return []

    def snapshot(self) -> Dict[str, Any]:
        return {"slos": {}, "firing": [], "alerts": [], "ticks": 0}


NULL_SLO_ENGINE = _NullSLOEngine()
