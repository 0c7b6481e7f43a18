"""``mxtpu_torch.obs`` — the one observability layer.

Three surfaces behind one switch (``MXTPU_OBS``, default on):

* **Metrics registry** (:mod:`.metrics`) — typed counters / gauges /
  histograms with label sets, O(1) under leaf locks, exported as
  Prometheus text (:func:`prometheus_text`) and a JSON snapshot
  (:func:`snapshot`) that carry the same values.  ``ServingStats``,
  the fleet counters, ``guards.ChurnDetector``, ``DeviceFeedIter``
  and ``TrainStep`` all publish here.
* **Per-request tracing** (:mod:`.trace`) — trace ids minted at
  submit, phase spans through the chrome-trace profiler,
  :func:`trace_of` to rebuild one request's timeline.
* **Flight recorder** (:mod:`.recorder`) — bounded per-worker ring of
  structured events (health transitions, canary results, compile
  misses, evictions, fault firings), dumped on worker death or
  ``MXTPU_OBS_DUMP_ON_ERROR``.

Zero-overhead-when-off contract (guards-style, asserted by
:func:`self_check`): with
``MXTPU_OBS=0`` the factories return the SHARED no-op singletons
(:data:`metrics.NULL_COUNTER` …, :data:`recorder.NULL_RECORDER`) — no
registration, no locks, no allocation on the hot path — and results
of any serving/training computation are bit-identical on vs off
(observability never touches what is computed).

Naming convention: ``mxtpu_<subsystem>_<metric>[_total|_seconds|_us|
_bytes]`` — mxtpu's metric names, so a dashboard reads either package;
enforced at creation here.  Nothing here imports jax or mxtpu.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence

from .. import knobs
from ..base import MXNetError
from . import http as http
from . import metrics as metrics
from . import recorder as recorder
from . import slo as slo
from . import timeseries as timeseries
from . import trace as trace
from .http import NULL_SERVER, DebugServer
from .metrics import (DEFAULT_BUCKETS, MetricsRegistry, NULL_COUNTER,
                      NULL_GAUGE, NULL_HISTOGRAM, bucket_quantile,
                      parse_prometheus_text, percentile,
                      samples_from_snapshot)
from .recorder import NULL_RECORDER, FlightRecorder
from .slo import (DEFAULT_RULES, NULL_SLO_ENGINE, AvailabilitySLO,
                  BurnRateRule, LatencySLO, SLOEngine,
                  parse_slo_classes)
from .timeseries import NULL_SAMPLER, Sampler
from .trace import (SPAN_BACKOFF, SPAN_EXECUTE, SPAN_HEDGE,
                    SPAN_PAD_SCATTER, SPAN_PREFILL, SPAN_QUEUE_WAIT,
                    SPAN_REDISPATCH, SPAN_REPLAY, SPAN_REQUEUE,
                    SPAN_RUN, SPAN_SCALE, SPAN_SHED, SPAN_STEAL,
                    SPAN_SUBMIT, SPAN_TOKEN,
                    new_trace_id, span, trace_of)

__all__ = [
    "enabled", "registry", "counter", "gauge", "histogram",
    "prometheus_text", "snapshot", "summary", "reset",
    "flight", "flight_recorders", "dump_all", "dump_on_error_path",
    "new_trace_id", "span", "trace_of", "self_check",
    "sampler", "slo_engine", "debug_server",
    "MetricsRegistry", "FlightRecorder", "Sampler", "SLOEngine",
    "DebugServer", "AvailabilitySLO", "LatencySLO", "BurnRateRule",
    "DEFAULT_RULES", "parse_slo_classes",
    "percentile", "bucket_quantile",
    "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM", "NULL_RECORDER",
    "NULL_SAMPLER", "NULL_SLO_ENGINE", "NULL_SERVER",
    "SPAN_SUBMIT", "SPAN_QUEUE_WAIT", "SPAN_EXECUTE", "SPAN_BACKOFF",
    "SPAN_STEAL", "SPAN_REDISPATCH", "SPAN_HEDGE", "SPAN_PAD_SCATTER",
    "SPAN_RUN", "SPAN_REQUEUE", "SPAN_SHED", "SPAN_SCALE",
    "SPAN_PREFILL", "SPAN_TOKEN", "SPAN_REPLAY",
]

_REGISTRY = MetricsRegistry()
_FLIGHT_LOCK = threading.Lock()
_FLIGHT: Dict[str, FlightRecorder] = {}  # guarded-by: _FLIGHT_LOCK
_SAMPLER: Optional[Sampler] = None       # guarded-by: _FLIGHT_LOCK


def enabled() -> bool:
    """Observability on?  ``MXTPU_OBS`` (default on; ``0`` = off)."""
    return bool(knobs.get("MXTPU_OBS"))


def registry() -> MetricsRegistry:
    """The process-wide metrics registry (always the real one —
    gating happens in the factory functions below)."""
    return _REGISTRY


# -- instrument factories (the only sanctioned way to make metrics) ----
def counter(name: str, help: str = "", labels: Sequence[str] = (),
            enabled_override: Optional[bool] = None):
    """Get-or-create a process-wide counter; the shared no-op when
    obs is off.  Construct once (init time), ``inc()`` on hot paths."""
    on = enabled() if enabled_override is None else enabled_override
    if not on:
        return NULL_COUNTER
    return _REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = (),
          enabled_override: Optional[bool] = None):
    on = enabled() if enabled_override is None else enabled_override
    if not on:
        return NULL_GAUGE
    return _REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS,
              enabled_override: Optional[bool] = None):
    on = enabled() if enabled_override is None else enabled_override
    if not on:
        return NULL_HISTOGRAM
    return _REGISTRY.histogram(name, help, labels, buckets)


# -- export surfaces ---------------------------------------------------
def prometheus_text() -> str:
    return _REGISTRY.prometheus_text()


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


def summary() -> Dict[str, Any]:
    """Flat ``{name{labels}: value-or-histogram-summary}`` view."""
    return _REGISTRY.summary()


def reset() -> None:
    """Tests only: drop all metric families, flight recorders and the
    process sampler."""
    global _SAMPLER
    _REGISTRY.reset()
    with _FLIGHT_LOCK:
        _FLIGHT.clear()
        _SAMPLER = None


# -- flight recorders --------------------------------------------------
def flight(name: str, capacity: Optional[int] = None,
           clock: Optional[Callable[[], float]] = None,
           enabled_override: Optional[bool] = None):
    """Get-or-create the named flight recorder; the shared no-op when
    obs is off.  ``clock`` only applies on first creation (fleet
    workers pass their injected clock for deterministic tests)."""
    on = enabled() if enabled_override is None else enabled_override
    if not on:
        return NULL_RECORDER
    with _FLIGHT_LOCK:
        rec = _FLIGHT.get(name)
        if rec is None:
            kw: Dict[str, Any] = {"capacity": capacity}
            if clock is not None:
                kw["clock"] = clock
            rec = _FLIGHT[name] = FlightRecorder(name, **kw)
        return rec


def flight_recorders() -> Dict[str, FlightRecorder]:
    with _FLIGHT_LOCK:
        return dict(_FLIGHT)


def dump_all(reason: str = "", path: Optional[str] = None
             ) -> Dict[str, str]:
    """Dump every live flight recorder (``{name: json}``)."""
    return {name: rec.dump(reason, path=path)
            for name, rec in flight_recorders().items()}


# -- time-series sampler / SLO engine / debug server --------
def sampler(period_us: Optional[float] = None,
            capacity: Optional[int] = None,
            clock: Optional[Callable[[], float]] = None,
            enabled_override: Optional[bool] = None):
    """Get-or-create the process-wide :class:`~.timeseries.Sampler`
    over the process registry; the shared no-op when obs is off.
    Like :func:`flight`, ``period_us``/``capacity``/``clock`` only
    apply on first creation (tests pass the fake clock)."""
    on = enabled() if enabled_override is None else enabled_override
    if not on:
        return NULL_SAMPLER
    global _SAMPLER
    with _FLIGHT_LOCK:
        if _SAMPLER is None:
            kw: Dict[str, Any] = {"period_us": period_us,
                                  "clock": clock}
            if capacity is not None:
                kw["capacity"] = capacity
            _SAMPLER = Sampler(_REGISTRY, **kw)
        return _SAMPLER


_sampler_factory = sampler   # slo_engine's param shadows the name


def slo_engine(slos, sampler=None, *,
               rules=DEFAULT_RULES,
               clock: Optional[Callable[[], float]] = None,
               enabled_override: Optional[bool] = None):
    """Build an :class:`~.slo.SLOEngine` over ``slos``; the shared
    no-op when obs is off.  ``sampler`` defaults to the process
    sampler (:func:`sampler`); wire the result into the fleet with
    ``router.attach_slo(engine)``."""
    on = enabled() if enabled_override is None else enabled_override
    if not on:
        return NULL_SLO_ENGINE
    if sampler is None:
        sampler = _sampler_factory(clock=clock)
    return SLOEngine(slos, sampler, rules=rules, clock=clock)


def debug_server(port: Optional[int] = None, *,
                 host: str = "127.0.0.1", router=None, slo=None,
                 sampler=None,
                 enabled_override: Optional[bool] = None):
    """Start a :class:`~.http.DebugServer` (``/metrics`` ``/varz``
    ``/healthz`` ``/statusz`` ``/tracez``) on a daemon thread; the
    shared no-op when obs is off or the port is negative.  ``port``
    defaults to ``MXTPU_OBS_HTTP_PORT`` (-1 = disabled, 0 =
    ephemeral — read the bound port back from ``server.port``).  The
    caller owns ``close()``."""
    on = enabled() if enabled_override is None else enabled_override
    if not on:
        return NULL_SERVER
    if port is None:
        port = int(knobs.get("MXTPU_OBS_HTTP_PORT"))
    if port < 0:
        return NULL_SERVER
    return DebugServer(port=port, host=host, router=router, slo=slo,
                       sampler=sampler)


def dump_on_error_path() -> Optional[str]:
    """``MXTPU_OBS_DUMP_ON_ERROR`` decoded: None = off, "" = log
    only, a string = also write JSON under that directory."""
    raw = str(knobs.get("MXTPU_OBS_DUMP_ON_ERROR")).strip()
    if not raw or raw.lower() in ("0", "false", "no", "off"):
        return None
    if raw.lower() in ("1", "true", "yes", "on", "stderr"):
        return ""
    return raw


# -- self check --------------------------------------------------------
def self_check(probe: bool = False, device=None) -> Dict[str, Any]:
    """The observability layer's contract check:

    * disabled ⇒ every factory returns its SHARED no-op singleton
      (no allocation, no registration — zero overhead), the
      sampler / SLO-engine / debug-server factories included, and
      when obs is off in THIS process the un-overridden factories are
      asserted null too;
    * the two export surfaces agree: a parsed Prometheus text dump
      carries exactly the samples a flattened JSON snapshot does
      (exercised on a private throwaway registry);
    * the operator layers work end to end on a private registry and
      a fake clock: sampler windows (counter rate, histogram bucket
      quantile), a burn-rate alert edge on a driven availability
      SLO, and every HTTP renderer producing parseable output — no
      socket bound;
    * ``probe=True`` additionally runs a tiny torch computation
      (``v * 3 - 1``) on ``device`` (the entry points' default,
      ``cuda:0``, unless the caller passes another) with instruments
      firing around it and asserts bit-identical results vs the bare
      run (obs never touches what is computed).
    """
    if counter("mxtpu_self_check_total",
               enabled_override=False) is not NULL_COUNTER \
            or gauge("mxtpu_self_check",
                     enabled_override=False) is not NULL_GAUGE \
            or histogram("mxtpu_self_check_seconds",
                         enabled_override=False) is not NULL_HISTOGRAM:
        raise MXNetError(
            "obs self_check: disabled metric factory is not the "
            "shared no-op singleton")
    if flight("self_check",
              enabled_override=False) is not NULL_RECORDER:
        raise MXNetError(
            "obs self_check: disabled flight factory is not the "
            "shared no-op recorder")
    if sampler(enabled_override=False) is not NULL_SAMPLER \
            or slo_engine([], enabled_override=False) \
            is not NULL_SLO_ENGINE \
            or debug_server(enabled_override=False) is not NULL_SERVER:
        raise MXNetError(
            "obs self_check: disabled sampler/SLO/HTTP factory is "
            "not its shared no-op singleton")
    if not enabled():
        # the env-driven path, not just the override: with MXTPU_OBS=0
        # the live factories must hand out the same null singletons
        if sampler() is not NULL_SAMPLER \
                or slo_engine([]) is not NULL_SLO_ENGINE \
                or debug_server() is not NULL_SERVER:
            raise MXNetError(
                "obs self_check: MXTPU_OBS=0 but a live factory did "
                "not return its shared no-op singleton")

    # Round-trip on a private registry (never pollutes the process one)
    reg = MetricsRegistry()
    c = reg.counter("mxtpu_selfcheck_events_total", "probe",
                    labels=("kind",))
    c.labels(kind="a").inc(3)
    c.labels(kind='b"\\esc\n').inc()
    reg.gauge("mxtpu_selfcheck_depth", "probe").set(-2.5)
    h = reg.histogram("mxtpu_selfcheck_lat_seconds", "probe",
                      buckets=(0.001, 0.1, 2.0))
    for v in (0.0005, 0.05, 0.05, 5.0):
        h.observe(v)
    # The compile-cache naming shapes: a source-labeled
    # compile-seconds histogram (source=cold|disk) and a hit counter
    # beside the churn guard's miss counter — asserted here so the
    # exposition surfaces keep agreeing on multi-label histograms too.
    hc = reg.histogram("mxtpu_selfcheck_compile_seconds", "probe",
                       labels=("entry", "source"),
                       buckets=(0.1, 1.0, 10.0))
    hc.labels(entry="(8, 16)", source="cold").observe(2.0)
    hc.labels(entry="(8, 16)", source="disk").observe(0.01)
    reg.counter("mxtpu_selfcheck_cache_hit_total", "probe",
                labels=("entry",)).labels(entry="(8, 16)").inc()
    text_samples = parse_prometheus_text(reg.prometheus_text())
    snap_samples = samples_from_snapshot(reg.snapshot())
    if text_samples != snap_samples:
        raise MXNetError(
            f"obs self_check: exposition surfaces disagree — "
            f"text={text_samples} snapshot={snap_samples}")

    # -- operator layers: sampler windows, a burn-rate
    #    alert edge, and the HTTP renderers — private registry, fake
    #    clock, no socket ------------------------------------------------
    import json as _json
    t = [0.0]
    reg3 = MetricsRegistry()
    smp = Sampler(reg3, capacity=8, period_us=1_000_000,
                  clock=lambda: t[0])
    done = reg3.counter("mxtpu_serving_completed_total", "probe",
                        labels=("endpoint",)).labels(endpoint="fleet")
    tout = reg3.counter("mxtpu_serving_timeout_total", "probe",
                        labels=("endpoint",)).labels(endpoint="fleet")
    lat = reg3.histogram("mxtpu_serving_latency_seconds", "probe",
                         labels=("endpoint",),
                         buckets=(0.01, 0.1, 1.0)
                         ).labels(endpoint="fleet")
    smp.sample(0.0)
    done.inc(10)
    for _ in range(10):
        lat.observe(0.05)
    t[0] = 10.0
    smp.sample(10.0)
    r = smp.rate("mxtpu_serving_completed_total",
                 {"endpoint": "fleet"}, window_s=60.0)
    if r is None or abs(r - 1.0) > 1e-9:
        raise MXNetError(
            f"obs self_check: sampler rate wrong (want 1.0, got {r})")
    q50 = smp.quantile("mxtpu_serving_latency_seconds",
                       {"endpoint": "fleet"}, q=50, window_s=60.0)
    if q50 is None or not 0.01 < q50 <= 0.1:
        raise MXNetError(
            f"obs self_check: sampler quantile wrong (10 samples in "
            f"(0.01, 0.1] but p50={q50})")
    eng = SLOEngine(
        [AvailabilitySLO("selfcheck_avail", objective=0.9)], smp,
        rules=(BurnRateRule(fast_s=5.0, slow_s=30.0, factor=2.0),),
        clock=lambda: t[0],
        alerts=reg3.counter("mxtpu_slo_alerts_total", "probe",
                            labels=("slo", "window")),
        recorder=FlightRecorder("selfcheck/slo", clock=lambda: t[0]))
    tout.inc(40)            # error ratio >> budget in both windows
    t[0] = 12.0
    fired = eng.tick(12.0)
    if not fired or not eng.firing():
        raise MXNetError(
            "obs self_check: burn-rate alert did not fire on a "
            "driven availability SLO (fast+slow windows breached)")
    if parse_prometheus_text(http.render_metrics(reg3)) != \
            samples_from_snapshot(reg3.snapshot()):
        raise MXNetError(
            "obs self_check: /metrics rendering disagrees with the "
            "registry snapshot")
    statusz = _json.loads(http.render_statusz(
        slo=eng, sampler=smp, recorders={}))
    if not statusz["slo"]["firing"]:
        raise MXNetError(
            "obs self_check: /statusz lost the firing SLO alert")
    _json.loads(http.render_varz(reg3))
    _json.loads(http.render_healthz())

    info: Dict[str, Any] = {
        "enabled": enabled(),
        "flight_capacity": int(knobs.get("MXTPU_OBS_FLIGHT_CAPACITY")),
        "round_trip_samples": len(text_samples),
        "slo_probe_alerts": len(fired),
        "sampler_probe_series": smp.summary()["series"],
    }
    if probe:
        import numpy as np
        import torch
        from ..context import resolve_device
        dev = resolve_device(device)

        def fn(v):
            return (v * 3 - 1).cpu().numpy()
        x = torch.arange(8, dtype=torch.float32, device=dev)
        bare = fn(x)
        reg2 = MetricsRegistry()
        pc = reg2.counter("mxtpu_selfcheck_probe_total")
        ph = reg2.histogram("mxtpu_selfcheck_probe_seconds")
        pc.inc()
        instrumented = np.asarray(fn(x))
        ph.observe(0.0)
        if not np.array_equal(bare, instrumented):
            raise MXNetError(
                "obs self_check: instrumented dispatch changed "
                "results")
        info["probe"] = True
        info["probe_device"] = str(dev)
    return info
