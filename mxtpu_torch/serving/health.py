"""Per-worker health state machine for the serving fleet.

Pure and clock-free: every method takes ``now`` explicitly, so the
router drives one instance per worker from its tick loop and the tests
drive it from a hand-stepped clock.  The machine is deliberately
small — five states, a handful of signals — and every transition is
recorded with its reason so ``stats()`` can explain *why* a worker
stopped taking traffic.

States (README "Fleet & fault tolerance" has the diagram)::

    HEALTHY ──fail──▶ SUSPECT ──fail×dead_after──▶ DEAD
       ▲                │ ok                         │ recover()
       └────────────────┘                            ▼
    RECOVERING ◀──────────── canary ok ───────── (replacement)
       │
       └─▶ HEALTHY            any ──drain()──▶ DRAINING ──▶ DEAD
                                                      (retired)

Signals and their sources:

* ``canary_ok`` / ``canary_fail`` — the router's periodic canary
  inference (result compared against the expected output, so silent
  corruption is a canary *failure*).  Canary verdicts are
  authoritative: they are the only signal that recovers a SUSPECT
  worker or kills one outright (``dead_after`` consecutive failures).
* ``exec_ok`` / ``exec_fail`` — real batch outcomes.  A failed batch
  makes a HEALTHY worker SUSPECT (stop routing new traffic there);
  a successful batch recovers it only when canaries are disabled
  (``exec_recovers=True``) — with canaries on, recovery waits for a
  verified canary so a worker returning corrupt-but-no-exception
  results cannot launder itself back to HEALTHY.
* ``liveness`` — dispatched-batch / queued-request age, checked by the
  router each tick: past ``liveness_s`` the worker is SUSPECT (hang or
  queue wedge), past ``2 * liveness_s`` it is DEAD and the router
  steals its outstanding requests.
* ``crashed`` — the worker raised :class:`~.faults.WorkerCrashed` (or
  the operator killed it): DEAD immediately.
* ``drain`` / ``drained`` — preemption-safe retirement: DRAINING stops
  new admissions but keeps executing; ``drained`` marks the flush
  complete (``retired=True`` distinguishes a graceful exit from a
  death in the fleet stats).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

__all__ = ["WorkerState", "WorkerHealth"]


class WorkerState:
    """String-valued worker states (str constants, not enum, so they
    serialize straight into ``stats()`` snapshots)."""
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DRAINING = "draining"
    DEAD = "dead"
    RECOVERING = "recovering"

    ALL = (HEALTHY, SUSPECT, DRAINING, DEAD, RECOVERING)


class WorkerHealth:
    """One worker's state machine.  Not thread-safe by itself — the
    router mutates it only under its own lock (or single-threaded in
    deterministic tests)."""

    def __init__(self, name: str = "", *, liveness_s: float = 2.0,
                 dead_after: int = 3, start_recovering: bool = False,
                 exec_recovers: bool = False,
                 on_transition: Optional[
                     Callable[[float, str, str, str], None]] = None):
        self.name = name
        self.liveness_s = float(liveness_s)
        self.dead_after = int(dead_after)
        self.exec_recovers = bool(exec_recovers)
        self.state = WorkerState.RECOVERING if start_recovering \
            else WorkerState.HEALTHY
        self.retired = False          # True only via drain()+drained()
        self.failures = 0             # consecutive, reset by canary_ok
        self.reason = "start-recovering" if start_recovering else ""
        # bounded transition log: (now, from, to, reason)
        self.transitions: List[Tuple[float, str, str, str]] = []
        # observer hook (obs flight recorder): called after every real
        # transition with (now, from, to, reason); must be cheap and
        # must not call back into this machine
        self._on_transition = on_transition

    # -- transition core -------------------------------------------------
    def _to(self, now: float, state: str, reason: str) -> bool:
        if self.state == state:
            return False
        if self.state == WorkerState.DEAD and \
                state != WorkerState.RECOVERING:
            return False              # dead is terminal (bar recover())
        prev = self.state
        self.transitions.append((now, prev, state, reason))
        del self.transitions[:-32]
        self.state = state
        self.reason = reason
        if self._on_transition is not None:
            self._on_transition(now, prev, state, reason)
        return True

    # -- canary verdicts (authoritative) ---------------------------------
    def canary_ok(self, now: float) -> None:
        self.failures = 0
        if self.state in (WorkerState.SUSPECT, WorkerState.RECOVERING):
            self._to(now, WorkerState.HEALTHY, "canary ok")

    def canary_fail(self, now: float, reason: str = "canary") -> None:
        self.failures += 1
        if self.state == WorkerState.HEALTHY:
            self._to(now, WorkerState.SUSPECT, f"{reason} failed")
        elif self.state == WorkerState.SUSPECT and \
                self.failures >= self.dead_after:
            self._to(now, WorkerState.DEAD,
                     f"{self.failures} consecutive {reason} failures")
        # RECOVERING absorbs canary failures: a slow-starting worker is
        # expected to fail canaries until it warms up.

    # -- batch execution outcomes ----------------------------------------
    def exec_ok(self, now: float) -> None:
        if self.exec_recovers:        # canaries disabled: a real batch
            self.canary_ok(now)       # is the best health probe we have

    def exec_fail(self, now: float) -> None:
        if self.state == WorkerState.HEALTHY:
            self._to(now, WorkerState.SUSPECT, "batch execution failed")
        elif self.exec_recovers:      # canaries off: failures also
            self.canary_fail(now, "execution")    # count toward DEAD

    # -- liveness (hang / queue wedge), checked every tick ---------------
    def liveness(self, now: float, inflight_age: Optional[float],
                 queued_age: Optional[float]) -> None:
        """``inflight_age`` — oldest dispatched-but-unfinished batch;
        ``queued_age`` — oldest request sitting in the queue.  SUSPECT
        past ``liveness_s``, DEAD past ``2 * liveness_s`` (a DRAINING
        worker is subject too, so a drain can never hang forever)."""
        if self.state == WorkerState.DEAD:
            return
        for age, kind in ((inflight_age, "hang"),
                          (queued_age, "queue wedge")):
            if age is None:
                continue
            if age > 2 * self.liveness_s:
                self._to(now, WorkerState.DEAD,
                         f"{kind}: outstanding for {age:.3f}s "
                         f"(> 2x liveness {self.liveness_s}s)")
                return
            if age > self.liveness_s and \
                    self.state in (WorkerState.HEALTHY,
                                   WorkerState.RECOVERING):
                self._to(now, WorkerState.SUSPECT,
                         f"{kind}: outstanding for {age:.3f}s")

    # -- terminal events --------------------------------------------------
    def crashed(self, now: float, reason: str = "crashed") -> None:
        self._to(now, WorkerState.DEAD, reason)

    def drain(self, now: float, reason: str = "drain requested") -> None:
        if self.state != WorkerState.DEAD:
            self._to(now, WorkerState.DRAINING, reason)

    def drained(self, now: float) -> None:
        if self.state == WorkerState.DRAINING:
            self.retired = True
            self._to(now, WorkerState.DEAD, "drained (retired)")

    def recover(self, now: float, reason: str = "restarting") -> None:
        """DEAD → RECOVERING: a restarted/replacement worker must pass
        a canary before it takes traffic again."""
        if self.state == WorkerState.DEAD:
            self.retired = False
            self.failures = 0
            self._to(now, WorkerState.RECOVERING, reason)

    # -- routing predicates ----------------------------------------------
    def admits(self) -> bool:
        """May NEW client traffic be routed here?  Only HEALTHY —
        SUSPECT stops taking new work (that is the point of the state),
        DRAINING/DEAD/RECOVERING obviously not."""
        return self.state == WorkerState.HEALTHY

    def admits_canary(self) -> bool:
        """Canaries keep probing SUSPECT (recovery path) and
        RECOVERING (warmup path) workers."""
        return self.state in (WorkerState.HEALTHY, WorkerState.SUSPECT,
                              WorkerState.RECOVERING)

    def snapshot(self) -> dict:
        return {"state": self.state, "reason": self.reason,
                "failures": self.failures, "retired": self.retired,
                "transitions": len(self.transitions)}
