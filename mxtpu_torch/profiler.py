"""Profiler (counterpart of ``mxtpu/profiler.py``): scope-level
tracing with chrome://tracing JSON output and per-name aggregate
tables.

The host-side recorder is mxtpu's as it is: spans, tasks, markers and
counters land in one chrome-trace event list (``dumps``/``dump``), and
``mxtpu_torch.obs`` rebuilds per-request timelines from it.  The
device side is captured with ``torch.profiler``:
``start_jax_trace(logdir)`` / ``stop_jax_trace()`` keep mxtpu's names,
so callers port unchanged, and record the CPU ops and every CUDA
kernel launched on the card between the two calls (CUPTI activity
tracing), written to ``logdir`` as a chrome trace
(``device_trace.json``).  ``MXTPU_PROFILER_AUTOSTART=1`` starts the
host recorder at import.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

from .base import MXNetError

__all__ = ["set_config", "set_state", "state", "is_active", "dump",
           "dumps", "pause", "resume", "events", "Task", "Frame",
           "Event", "Counter", "Marker", "record_span",
           "start_jax_trace", "stop_jax_trace"]

_ACTIVE = False          # fast-path flag read by the op dispatcher
_PAUSED = False          # guarded-by: _LOCK
_LOCK = threading.Lock()
_EVENTS: List[dict] = []  # guarded-by: _LOCK
_CONFIG = {"filename": "profile.json", "aggregate_stats": False,
           "profile_imperative": True, "profile_api": True,
           "profile_symbolic": True,
           "profile_memory": False, "profile_all": False}
_START_TS: Optional[float] = None  # guarded-by: _LOCK


def _now_us() -> float:
    return time.perf_counter() * 1e6


def set_config(**kwargs):
    """Configure (reference ``set_config``†).  Recognized keys:
    filename, aggregate_stats, profile_all, profile_symbolic,
    profile_imperative, profile_memory, profile_api.  Unknown keys
    raise — silently accepting a typo (``filname=...``) used to leave
    the profiler writing to the default path with no diagnostic."""
    unknown = set(kwargs) - set(_CONFIG)
    if unknown:
        raise MXNetError(
            f"profiler.set_config: unknown key(s) {sorted(unknown)}; "
            f"recognized: {sorted(_CONFIG)}")
    with _LOCK:
        _CONFIG.update(kwargs)


def set_state(state_: str = "stop"):
    """'run' or 'stop' (reference ``set_state``†).  ``stop`` also
    clears any pending pause so a later ``resume()`` cannot silently
    re-activate a stopped profiler."""
    global _ACTIVE, _START_TS, _PAUSED
    if state_ not in ("run", "stop"):
        raise MXNetError("state must be 'run' or 'stop'")
    with _LOCK:
        if state_ == "run":
            if _START_TS is None:
                _START_TS = _now_us()
            _ACTIVE, _PAUSED = True, False
        else:
            _ACTIVE, _PAUSED = False, False


def state() -> str:
    return "run" if _ACTIVE else "stop"


def is_active() -> bool:
    """Cheap hot-path gate: True while the profiler collects.  Callers
    that build span ``args`` dicts should check this first so the
    profiler-off path stays allocation-free."""
    return _ACTIVE


def pause():
    """Temporarily stop collection (reference ``pause``†)."""
    global _ACTIVE, _PAUSED
    with _LOCK:
        if _ACTIVE:
            _ACTIVE, _PAUSED = False, True


def resume():
    global _ACTIVE, _PAUSED
    with _LOCK:
        if _PAUSED:
            _ACTIVE, _PAUSED = True, False


def _record(name: str, cat: str, ts_us: float, dur_us: float,
            args: Optional[dict] = None):
    if not _ACTIVE:
        return
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": ts_us - (_START_TS or 0.0), "dur": dur_us,
          "pid": os.getpid(), "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    with _LOCK:
        _EVENTS.append(ev)


def record_op(name: str, ts_us: float, dur_us: float,
              shapes=None) -> None:
    """Called by the eager dispatcher per op when profiling."""
    _record(name, "operator", ts_us, dur_us,
            {"shapes": shapes} if shapes else None)


def record_span(name: str, ts_us: float, dur_us: float,
                cat: str = "subsystem", args: Optional[dict] = None
                ) -> None:
    """Public complete-event hook for subsystems that time themselves
    (``mxtpu_torch.serving`` batch execution, io feeds, …): one chrome-trace
    "X" event under category ``cat``.  ``ts_us`` must come from
    ``_now_us()``-compatible time (``time.perf_counter()*1e6``); no-op
    unless the profiler is running."""
    _record(name, cat, ts_us, dur_us, args)


def dumps(reset: bool = False) -> str:
    """Chrome-trace JSON string (reference ``dumps``† returns the
    aggregate table; here the trace itself, plus the aggregate table
    via ``aggregate_stats()``)."""
    with _LOCK:
        out = json.dumps({"traceEvents": list(_EVENTS),
                          "displayTimeUnit": "ms"})
        if reset:
            _EVENTS.clear()
    return out


def events() -> List[dict]:
    """Locked snapshot of the recorded trace events (shallow copies —
    mutating the returned dicts cannot corrupt the trace buffer).
    ``mxtpu_torch.obs.trace_of`` reads this to rebuild per-request
    timelines."""
    with _LOCK:
        return [dict(ev) for ev in _EVENTS]


def dump(finished: bool = True, profile_process: str = "worker"):
    """Write the chrome trace to ``filename`` (reference ``dump``†)."""
    path = _CONFIG["filename"]
    with open(path, "w") as f:
        f.write(dumps())
    return path


def aggregate_stats() -> str:
    """Per-op-name summary table (reference ``aggregate_stats.cc``†)."""
    with _LOCK:
        agg: Dict[str, List[float]] = defaultdict(list)
        for ev in _EVENTS:
            if "dur" in ev:  # complete events only (not markers/counters)
                agg[ev["name"]].append(ev["dur"])
    lines = [f"{'Name':<40}{'Count':>8}{'Total(us)':>14}"
             f"{'Min(us)':>12}{'Max(us)':>12}{'Mean(us)':>12}"]
    for name, durs in sorted(agg.items(),
                             key=lambda kv: -sum(kv[1])):
        lines.append(f"{name:<40}{len(durs):>8}{sum(durs):>14.1f}"
                     f"{min(durs):>12.1f}{max(durs):>12.1f}"
                     f"{sum(durs) / len(durs):>12.1f}")
    return "\n".join(lines)


class _Scope:
    """Base for profiling scopes (Task/Frame/Event; reference
    ``ProfileTask``† etc.)."""

    _cat = "scope"

    def __init__(self, name: str):
        self.name = name
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = _now_us()

    def stop(self):
        if self._t0 is not None:
            _record(self.name, self._cat, self._t0,
                    _now_us() - self._t0)
            self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_Scope):
    _cat = "task"


class Frame(_Scope):
    _cat = "frame"


class Event(_Scope):
    _cat = "event"


class Marker:
    """Instant marker (reference ``ProfileMarker``†)."""

    def __init__(self, name: str):
        self.name = name

    def mark(self, scope: str = "process"):
        if _ACTIVE:
            with _LOCK:
                _EVENTS.append({
                    "name": self.name, "cat": "marker", "ph": "i",
                    "ts": _now_us() - (_START_TS or 0.0),
                    "pid": os.getpid(), "tid": threading.get_ident(),
                    "s": "p" if scope == "process" else "t"})


class Counter:
    """Named counter series (reference ``ProfileCounter``†)."""

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = value
        self._emit()

    def _emit(self):
        if _ACTIVE:
            with _LOCK:
                _EVENTS.append({
                    "name": self.name, "cat": "counter", "ph": "C",
                    "ts": _now_us() - (_START_TS or 0.0),
                    "pid": os.getpid(),
                    "args": {"value": self.value}})

    def set_value(self, value: int):
        self.value = value
        self._emit()

    def increment(self, delta: int = 1):
        self.value += delta
        self._emit()

    def decrement(self, delta: int = 1):
        self.value -= delta
        self._emit()

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


_DEVICE_TRACE = None     # guarded-by: _LOCK — (torch profiler, logdir)


def start_jax_trace(logdir: str):
    """Start a device capture with ``torch.profiler``: CPU ops and, when
    CUDA is available, the card's kernels and copies, until
    :func:`stop_jax_trace`.  mxtpu's name, so callers port unchanged."""
    global _DEVICE_TRACE
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _LOCK:
        if _DEVICE_TRACE is not None:
            raise MXNetError("profiler: a device trace is already "
                             "running")
        prof = profile(activities=acts)
        prof.__enter__()
        _DEVICE_TRACE = (prof, logdir)


def stop_jax_trace() -> str:
    """Stop the capture :func:`start_jax_trace` began and write it to
    ``<logdir>/device_trace.json`` (chrome-trace format); returns the
    path."""
    global _DEVICE_TRACE
    with _LOCK:
        if _DEVICE_TRACE is None:
            raise MXNetError("profiler: no device trace is running")
        prof, logdir = _DEVICE_TRACE
        _DEVICE_TRACE = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "device_trace.json")
    prof.export_chrome_trace(path)
    return path


def _autostart() -> None:
    from . import knobs
    if knobs.get("MXTPU_PROFILER_AUTOSTART"):
        set_state("run")


_autostart()
