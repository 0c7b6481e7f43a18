"""Flight recorder.

A bounded ring of structured events per component — one recorder per
fleet worker plus process-wide ones ("compile", "train") — capturing
the things a postmortem needs but metrics flatten away: health-state
transitions, canary results, compile-cache misses, deadline
evictions, fault-plan firings.  O(1) appends under a leaf lock; the
oldest event falls off when the ring (``MXTPU_OBS_FLIGHT_CAPACITY``)
is full, and ``dropped`` counts what was lost.

The router dumps a worker's recorder automatically when it declares
the worker DEAD; setting ``MXTPU_OBS_DUMP_ON_ERROR`` extends that to
terminal request failures (and, when the knob is a directory path,
writes each postmortem there as JSON).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .. import knobs

__all__ = ["FlightRecorder", "NULL_RECORDER"]

logger = logging.getLogger("mxtpu_torch.obs")


class FlightRecorder:
    """Bounded ring of ``{"ts", "kind", ...details}`` events."""

    def __init__(self, name: str, capacity: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity is None:
            capacity = int(knobs.get("MXTPU_OBS_FLIGHT_CAPACITY"))
        self.name = name
        self.capacity = max(1, capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self.dropped = 0         # guarded-by: _lock

    def record(self, kind: str, **details: Any) -> None:
        """Append one structured event (O(1); oldest evicted when the
        ring is full)."""
        ev = {"ts": self._clock(), "kind": kind}
        ev.update(details)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            events = [dict(ev) for ev in self._ring]
            dropped = self.dropped
        return {"recorder": self.name, "capacity": self.capacity,
                "dropped": dropped, "events": events}

    def dump(self, reason: str = "", path: Optional[str] = None
             ) -> str:
        """Postmortem: log the ring as one JSON document (and write it
        under ``path`` when given a directory).  Returns the JSON."""
        doc = self.snapshot()
        doc["reason"] = reason
        text = json.dumps(doc, default=str)
        logger.warning("mxtpu_torch.obs flight recorder [%s] dump (%s): %s",
                       self.name, reason or "requested", text)
        if path and os.path.isdir(path):
            safe = self.name.replace("/", "_").replace(":", "_")
            fname = os.path.join(path, f"flight_{safe}.json")
            with open(fname, "w") as f:
                f.write(text)
        return text


class _NullRecorder:
    """Shared no-op recorder (obs disabled): records nothing, dumps
    nothing — the guards-style zero-overhead path."""

    __slots__ = ()
    name = "null"
    capacity = 0
    dropped = 0

    def record(self, kind: str, **details: Any) -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def clear(self) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"recorder": "null", "capacity": 0, "dropped": 0,
                "events": []}

    def dump(self, reason: str = "", path: Optional[str] = None
             ) -> str:
        return ""


NULL_RECORDER = _NullRecorder()
