"""Fleet control plane: metrics-driven
autoscaling, plus the priority/fairness vocabulary the router's
admission control and weighted-round-robin dispatch consume.

The fleet (router.py) gave N workers health states, draining and
``add_worker``; obs gave per-endpoint queue depth, fill rate and
latency histograms.  This module closes the loop:

* :class:`PriorityClass` / :func:`parse_classes` — traffic classes on
  :class:`~.router.FleetRequest`: ``weight`` sets the router's
  weighted-round-robin dispatch share (no tenant starves), ``quota``
  bounds in-system requests per class (one hot tenant cannot own the
  whole pending buffer).  Admission control is class-aware: a
  request's predicted ETA counts only same-or-higher-priority backlog,
  so a brownout sheds low-priority traffic first — see
  ``FleetRouter.submit``.
* :class:`Autoscaler` — scales worker replicas from registry signals
  (mean outstanding per healthy worker including the router backlog,
  and the histogram-derived ``queue_eta_us``) with hysteresis bands
  (``breach_ticks`` consecutive over/under-band evaluations before
  acting), a cooldown between actions, **drain-based scale-down**
  (``FleetRouter.drain``: in-flight work always completes; the victim
  retires, it is never killed) and **warm-handoff scale-up**
  (``add_worker(w, warm_from=donor.handoff())``: the replica
  pre-compiles the donor's bucket working set before taking traffic —
  zero cold compiles on the data path).  The handoff of the most
  recently drained worker is kept, so a scale-up with no live donor
  (burst after scale-to-floor) still warms from the last retiree;
  with no donor AND no cached handoff the replica warms from the
  persistent compile cache when it holds ladder entries — the ``scale_up``
  flight-recorder event's
  ``donor`` field says which path fired (a worker name,
  ``"last_handoff"``, ``"disk_cache"``, or ``None`` for cold).

Determinism: the autoscaler is tick-driven on the injected clock —
``router.add_controller(scaler.tick)`` makes the router's own tick
drive it (threaded and deterministic modes alike), or tests call
``tick(now)`` directly.  Every decision is recorded to the
``fleet/autoscaler`` flight recorder and emitted as a
``fleet/scale`` trace span, so each verdict is reconstructable
post-mortem.

Lock order: :class:`Autoscaler` reads fleet signals (worker stats,
batcher depths) holding NO lock, then updates its own decision state
under ``Autoscaler._lock`` (a leaf — it acquires nothing inside), and
only then acts on the router with no autoscaler lock held.  The
router-side class state is on ``FleetRouter._class_lock`` (leaf; see
router.py's lock-order contract).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..base import MXNetError
from .. import knobs
from .. import obs
from .. import profiler
from .health import WorkerState

__all__ = ["PriorityClass", "parse_classes", "Autoscaler"]

logger = logging.getLogger("mxtpu_torch.serving.fleet")


class PriorityClass:
    """One traffic class.  ``weight`` is the weighted-round-robin
    dispatch share (higher = served first out of the router backlog,
    and counted as "ahead" by lower classes' admission ETA); ``quota``
    bounds the class's in-system (admitted, not yet completed)
    requests — ``None`` means only the router-wide ``max_pending``
    bound applies."""

    __slots__ = ("name", "weight", "quota")

    def __init__(self, name: str, weight: float = 1.0,
                 quota: Optional[int] = None):
        if not name:
            raise MXNetError("serving: priority class needs a name")
        if weight <= 0:
            raise MXNetError(
                f"serving: priority class {name!r} weight must be "
                f"positive, got {weight}")
        if quota is not None and quota < 1:
            raise MXNetError(
                f"serving: priority class {name!r} quota must be "
                f">= 1, got {quota}")
        self.name = str(name)
        self.weight = float(weight)
        self.quota = None if quota is None else int(quota)

    def __repr__(self) -> str:
        return (f"PriorityClass({self.name!r}, weight={self.weight}, "
                f"quota={self.quota})")


def parse_classes(spec: str) -> List[PriorityClass]:
    """Parse the ``MXTPU_FLEET_CLASSES`` knob:
    ``name:weight[:quota],...`` (e.g. ``gold:8,bulk:1:64``).  Empty
    spec → empty list (the router then runs one ``default`` class)."""
    out: List[PriorityClass] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        try:
            weight = float(bits[1]) if len(bits) > 1 and bits[1] \
                else 1.0
            quota = int(bits[2]) if len(bits) > 2 and bits[2] else None
        except ValueError as e:
            raise MXNetError(
                f"serving: bad class spec {part!r} "
                f"(want name:weight[:quota]): {e}") from None
        out.append(PriorityClass(bits[0], weight, quota))
    return out


class Autoscaler:
    """Metrics-driven replica controller for one :class:`FleetRouter`.

    >>> scaler = Autoscaler(router, make_worker, min_workers=1,
    ...                     max_workers=3, up_depth=4.0,
    ...                     breach_ticks=2, cooldown_s=0.5)
    >>> router.add_controller(scaler.tick)   # router tick drives it

    ``make_worker(name)`` must return a fresh, un-attached
    :class:`~.router.FleetWorker` sharing the fleet's bucket ladder.
    """

    def __init__(self, router, make_worker: Callable[[str], Any], *,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 up_depth: Optional[float] = None,
                 down_depth: Optional[float] = None,
                 up_eta_us: Optional[float] = None,
                 breach_ticks: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 name_prefix: str = "auto",
                 clock: Optional[Callable[[], float]] = None,
                 slo=None, burn_scale: Optional[bool] = None):
        self._router = router
        self._make_worker = make_worker
        g = knobs.get
        # optional SLO coupling: when MXTPU_FLEET_AUTOSCALE
        # _BURN is on AND an engine is supplied, a firing burn-rate
        # alert counts as an overload tick.  Both default off, so the
        # decision loop is bit-identical to the pre-SLO autoscaler.
        self._slo = slo
        self.burn_scale = bool(burn_scale) if burn_scale is not None \
            else bool(g("MXTPU_FLEET_AUTOSCALE_BURN"))
        self.min_workers = min_workers if min_workers is not None \
            else g("MXTPU_FLEET_AUTOSCALE_MIN")
        self.max_workers = max_workers if max_workers is not None \
            else g("MXTPU_FLEET_AUTOSCALE_MAX")
        self.up_depth = up_depth if up_depth is not None \
            else g("MXTPU_FLEET_AUTOSCALE_UP_DEPTH")
        self.down_depth = down_depth if down_depth is not None \
            else g("MXTPU_FLEET_AUTOSCALE_DOWN_DEPTH")
        self.up_eta_us = up_eta_us if up_eta_us is not None \
            else g("MXTPU_FLEET_AUTOSCALE_UP_ETA_US")
        self.breach_ticks = breach_ticks if breach_ticks is not None \
            else g("MXTPU_FLEET_AUTOSCALE_BREACH_TICKS")
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else g("MXTPU_FLEET_AUTOSCALE_COOLDOWN_S")
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise MXNetError(
                f"serving: autoscaler wants 1 <= min <= max, got "
                f"min={self.min_workers} max={self.max_workers}")
        self.name_prefix = name_prefix
        self._clock = clock if clock is not None \
            else getattr(router, "_clock", time.monotonic)
        self.recorder = obs.flight("fleet/autoscaler",
                                   clock=self._clock)
        self._lock = threading.Lock()
        self._breach_up = 0       # guarded-by: _lock
        self._breach_down = 0     # guarded-by: _lock
        self._last_action_t: Optional[float] = None  # guarded-by: _lock
        self._seq = 0             # guarded-by: _lock
        self._scale_ups = 0       # guarded-by: _lock
        self._scale_downs = 0     # guarded-by: _lock
        # handoff metadata of the most recently drained worker — the
        # warm source for a scale-up with no live donor
        self._last_handoff: Optional[Dict[str, Any]] = None  # guarded-by: _lock

    # -- the decision loop -------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One evaluation: read fleet signals (no lock held), update
        the hysteresis bands under the autoscaler lock, then act on
        the router lock-free.  Returns the action taken ("up"/"down")
        or None — tests key off it."""
        now = self._clock() if now is None else now
        members = self._router.members()
        healthy = [w for w in members
                   if w.health.state == WorkerState.HEALTHY]
        live = [w for w in members
                if w.health.state != WorkerState.DEAD]
        pending = self._router.pending_depth()
        if healthy:
            depth_per = (sum(w.outstanding() for w in healthy)
                         + pending) / len(healthy)
            eta_us = max((e for e in (w.stats.queue_eta_us()
                                      for w in healthy)
                          if e is not None), default=0.0)
        else:
            depth_per, eta_us = 0.0, 0.0
        burning: list = []
        if self.burn_scale and self._slo is not None:
            burning = self._slo.firing()
        overload = bool(healthy) and (
            depth_per > self.up_depth
            or (self.up_eta_us > 0 and eta_us > self.up_eta_us)
            or bool(burning))
        underload = bool(healthy) and pending == 0 \
            and depth_per < self.down_depth
        action: Optional[str] = None
        seq = 0
        with self._lock:
            self._breach_up = self._breach_up + 1 if overload else 0
            self._breach_down = self._breach_down + 1 if underload \
                else 0
            cooling = self._last_action_t is not None and \
                now - self._last_action_t < self.cooldown_s
            if not cooling:
                if len(live) < self.min_workers:
                    # below floor (deaths, not load): repair is not a
                    # band decision, it just happens
                    action = "up"
                elif self._breach_up >= self.breach_ticks and \
                        len(live) < self.max_workers:
                    action = "up"
                elif self._breach_down >= self.breach_ticks and \
                        len(healthy) > self.min_workers:
                    action = "down"
            if action is not None:
                self._last_action_t = now
                self._breach_up = self._breach_down = 0
                if action == "up":
                    self._seq += 1
                    self._scale_ups += 1
                    seq = self._seq
                else:
                    self._scale_downs += 1
        if action == "up":
            self._scale_up(now, seq, healthy, depth_per, eta_us,
                           pending, burning)
        elif action == "down":
            self._scale_down(now, healthy, depth_per)
        return action

    # -- actions (no autoscaler lock held) ---------------------------------
    def _scale_up(self, now: float, seq: int, healthy: list,
                  depth_per: float, eta_us: float,
                  pending: int, burning: list = ()) -> None:
        donor = healthy[0] if healthy else None
        if donor is not None:
            meta = donor.handoff()
        else:
            with self._lock:
                meta = self._last_handoff
        worker = self._make_worker(f"{self.name_prefix}{seq}")
        # ``add_worker`` warms from the donor metadata when present,
        # else from the persistent compile cache when that
        # holds ladder entries; its return value says which path
        # ACTUALLY fired (no second cache probe, no label that can
        # disagree with what was warmed).
        warmed = self._router.add_worker(worker, warm_from=meta)
        if donor is not None:
            warm_src = donor.name
        elif meta is not None:
            warm_src = "last_handoff"
        else:
            warm_src = warmed  # "disk_cache" or None (cold)
        self._router.stats.bump("scale_ups")
        detail: Dict[str, Any] = dict(
            worker=worker.name, donor=warm_src,
            depth_per=round(depth_per, 2),
            eta_us=round(eta_us, 1), pending=pending)
        if burning:
            # only present when the SLO gate contributed — existing
            # scenario events stay byte-identical with the knob off
            detail["burn_slos"] = list(burning)
        self.recorder.record("scale_up", **detail)
        if profiler.is_active():
            obs.span(obs.SPAN_SCALE, now * 1e6, 0.0, cat="fleet",
                     direction="up", worker=worker.name,
                     depth_per=round(depth_per, 2),
                     eta_us=round(eta_us, 1))
        logger.info("fleet autoscaler: scale UP -> %s (depth/worker "
                    "%.2f, eta %.0fus, pending %d)", worker.name,
                    depth_per, eta_us, pending)

    def _scale_down(self, now: float, healthy: list,
                    depth_per: float) -> None:
        victim = min(healthy, key=lambda w: (w.outstanding(), w.name))
        meta = self._router.drain(victim.name, now)
        with self._lock:
            self._last_handoff = meta
        self._router.stats.bump("scale_downs")
        self.recorder.record("scale_down", worker=victim.name,
                             depth_per=round(depth_per, 2),
                             outstanding=victim.outstanding())
        if profiler.is_active():
            obs.span(obs.SPAN_SCALE, now * 1e6, 0.0, cat="fleet",
                     direction="down", worker=victim.name,
                     depth_per=round(depth_per, 2))
        logger.info("fleet autoscaler: scale DOWN, draining %s "
                    "(depth/worker %.2f)", victim.name, depth_per)

    # -- observability -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "breach_up": self._breach_up,
                "breach_down": self._breach_down,
                "last_action_t": self._last_action_t,
                "warm_handoff_cached": self._last_handoff is not None,
                "burn_scale": self.burn_scale,
            }
