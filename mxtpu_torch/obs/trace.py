"""Per-request tracing.

A trace id is minted at ``FleetRouter.submit`` (and
``InferenceServer.submit``) and rides the request object through
worker dispatch, batcher queue/assembly and runner execution.  Every
phase of the request's life — queue-wait, pad/scatter, execute,
retry/backoff, hedge, steal/requeue — is emitted as a chrome-trace
span through the existing :mod:`mxtpu_torch.profiler` with
``args={"trace_id": ...}`` (batch-level spans carry
``args={"trace_ids": [...]}``), so one request's full story — a
mid-flight worker kill included — is reconstructible from a single
``profiler.dumps()``; :func:`trace_of` does the reconstruction
in-process.

Emission is gated on ``profiler.is_active()`` BEFORE any args dict is
built, so the profiler-off request path pays one global-bool read.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

from .. import profiler

__all__ = ["new_trace_id", "span", "trace_of",
           "SPAN_SUBMIT", "SPAN_QUEUE_WAIT", "SPAN_EXECUTE",
           "SPAN_BACKOFF", "SPAN_STEAL", "SPAN_REDISPATCH",
           "SPAN_HEDGE", "SPAN_PAD_SCATTER", "SPAN_RUN",
           "SPAN_REQUEUE", "SPAN_SHED", "SPAN_SCALE",
           "SPAN_PREFILL", "SPAN_TOKEN", "SPAN_REPLAY"]

# Request-phase span names (the committed vocabulary; tests and the
# README's reconstruction example key off these).
SPAN_SUBMIT = "fleet/submit"
SPAN_QUEUE_WAIT = "fleet/queue_wait"
SPAN_EXECUTE = "fleet/execute"
SPAN_BACKOFF = "fleet/backoff"
SPAN_STEAL = "fleet/steal"
SPAN_REDISPATCH = "fleet/redispatch"
SPAN_HEDGE = "fleet/hedge"
SPAN_PAD_SCATTER = "serving/pad_scatter"
SPAN_RUN = "serving/execute"
SPAN_REQUEUE = "serving/requeue"
# control-plane verdicts: instant spans, cat="fleet" —
# every shed and scale decision is reconstructable from one dump
SPAN_SHED = "fleet/shed"
SPAN_SCALE = "fleet/scale"
# generation phases: prefill (prompt → KV cache + first
# token), one instant span per emitted token, and the replay marker a
# stolen generation leaves when it resumes on a surviving worker —
# trace_of() reconstructs a kill-spanning stream from these
SPAN_PREFILL = "gen/prefill"
SPAN_TOKEN = "gen/token"
SPAN_REPLAY = "gen/replay"

_SEQ = itertools.count(1)
_SEQ_LOCK = threading.Lock()


def new_trace_id() -> str:
    """Process-unique, monotonically ordered id (``r<pid>-<seq>``).
    Deterministic modulo pid — fake-clock tests get stable ids."""
    with _SEQ_LOCK:
        seq = next(_SEQ)
    return f"r{os.getpid():x}-{seq:06d}"


def span(name: str, ts_us: float, dur_us: float,
         trace_id: Optional[str] = None, cat: str = "request",
         **args: Any) -> None:
    """Emit one request-phase span (chrome-trace "X" event) tagged
    with its trace id.  No-op unless the profiler is running — call
    sites may still pre-gate on :func:`mxtpu_torch.profiler.is_active` to
    skip computing ``ts``/``dur``."""
    if not profiler.is_active():
        return
    a: Dict[str, Any] = dict(args)
    if trace_id is not None:
        a["trace_id"] = trace_id
    profiler.record_span(name, ts_us, max(0.0, dur_us), cat=cat,
                         args=a)


def _matches(ev: Dict[str, Any], trace_id: str) -> bool:
    args = ev.get("args")
    if not args:
        return False
    if args.get("trace_id") == trace_id:
        return True
    ids: Sequence[str] = args.get("trace_ids") or ()
    return trace_id in ids


def trace_of(trace_id: str,
             events: Optional[List[Dict[str, Any]]] = None
             ) -> List[Dict[str, Any]]:
    """Timeline of one request: every recorded span whose args carry
    its trace id (directly or in a batch-level ``trace_ids`` list),
    sorted by start timestamp.  Reads the live profiler buffer by
    default; pass ``events`` (e.g. ``json.loads(dump)["traceEvents"]``)
    to reconstruct from a saved trace file instead."""
    if events is None:
        events = profiler.events()
    picked = [ev for ev in events if _matches(ev, trace_id)]
    picked.sort(key=lambda ev: (ev.get("ts", 0.0),
                                ev.get("name", "")))
    return picked
