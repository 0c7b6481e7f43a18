"""Deterministic fault-injection harness for the serving fleet.

Faults are *scripted*, keyed on the worker's dispatch counter (batch
``k`` = the k-th batch that worker ever dispatched, canaries included)
— the same determinism discipline as the batcher's injected clock: a
test that scripts ``CrashAt(at_batch=1)`` sees the crash on exactly
the second dispatch, every run, no sleeps, no races.  The plan is
consulted by :class:`~.router.FleetWorker` at its dispatch seam, so
every recovery path in the router/health machinery is exercised by
tier-1 tests instead of only showing up in a soak:

* :class:`Hang` — the dispatched batch never completes (the worker
  thread is stuck in the executable).  Detected by the in-flight
  liveness deadline; outstanding requests are stolen and retried.
* :class:`SlowStart` — the first ``first_n`` dispatches fail with a
  retriable startup error (cold replica, weights still loading).
  A RECOVERING worker keeps failing canaries until warm.
* :class:`CrashAt` — dispatch ``k`` raises :class:`WorkerCrashed`
  (preemption / OOM-kill).  DEAD immediately; in-flight requeued.
* :class:`Corrupt` — dispatches from ``k`` on return silently wrong
  results (bit-flip, bad DMA).  No exception anywhere — only a
  canary comparing against its expected output can catch it.
* :class:`QueueWedge` — from dispatch ``k`` on, the worker stops
  pulling from its queue while still accepting submissions.  Detected
  by the queued-request liveness age.

The cache faults of mxtpu's persistent compile cache keep mxtpu's
names and arguments, keyed on the cache's own store counter ``k`` (the
k-th entry that cache ever committed); ``ExecutableCache``
(:mod:`mxtpu_torch.cache`) consults them at its write seams
(``before_cache_write`` before it writes, ``entry_written`` after the
rename), on kernel entries and bucket recipes alike:

* :class:`CorruptEntry` — flip a payload byte of stored entry ``k``
  (bit-rot / bad DMA).
* :class:`TruncateEntry` — cut stored entry ``k`` in half (crash
  mid-copy).
* :class:`StaleKey` — rewrite a key component of stored entry ``k``
  in the port's header, keeping the checksum valid (an entry from an
  old torch or old contracts).
* :class:`ReadOnlyDir` — stores from ``k`` on fail with
  ``PermissionError`` (read-only cache root).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from ..base import MXNetError

__all__ = ["WorkerCrashed", "SlowStartError", "HangSignal",
           "Fault", "Hang", "SlowStart", "CrashAt", "Corrupt",
           "SlowExec", "QueueWedge", "CorruptEntry", "TruncateEntry",
           "StaleKey", "ReadOnlyDir", "FaultPlan"]


class WorkerCrashed(MXNetError):
    """The worker process died mid-dispatch (preemption, OOM-kill)."""


class SlowStartError(MXNetError):
    """Transient startup failure — the replica is not warm yet."""


class HangSignal(Exception):
    """Internal sentinel: the dispatch would block forever.  The
    worker leaves the batch registered in-flight and parks — exactly
    what a hung executable looks like from the outside — instead of
    actually blocking a thread the test could never join."""


class Fault:
    """One scripted fault.  Subclasses override the hooks they need;
    ``k`` is the worker's dispatch counter (0-based)."""

    def wedged(self, k: int) -> bool:
        return False

    def before_batch(self, k: int) -> None:
        """Raise to fail/crash/hang dispatch ``k``."""

    def mutate(self, k: int,
               host: List[np.ndarray]) -> List[np.ndarray]:
        """Transform the host outputs of dispatch ``k`` (corruption)."""
        return host

    # -- compile-cache seams (the persistent cache's, not ported yet;
    #    ``k`` is the cache's store counter, not the dispatch counter) --
    def before_cache_write(self, k: int) -> None:
        """Raise (OSError family) to deny committing entry ``k``."""

    def on_entry_written(self, k: int, path) -> bool:
        """Mutate the just-committed entry file ``k`` on disk; return
        True if this fault touched it (recorded in ``fired``)."""
        return False


class Hang(Fault):
    def __init__(self, at_batch: int = 0):
        self.at_batch = int(at_batch)

    def before_batch(self, k: int) -> None:
        if k == self.at_batch:
            raise HangSignal(f"scripted hang at batch {k}")


class SlowStart(Fault):
    def __init__(self, first_n: int = 2):
        self.first_n = int(first_n)

    def before_batch(self, k: int) -> None:
        if k < self.first_n:
            raise SlowStartError(
                f"scripted slow start: dispatch {k} of first "
                f"{self.first_n} fails (replica still warming)")


class CrashAt(Fault):
    def __init__(self, at_batch: int = 0):
        self.at_batch = int(at_batch)

    def before_batch(self, k: int) -> None:
        if k == self.at_batch:
            raise WorkerCrashed(f"scripted crash at batch {k}")


class Corrupt(Fault):
    """Silently corrupt every output from dispatch ``from_batch`` on
    (negate and offset — guaranteed to miss any expected value)."""

    def __init__(self, from_batch: int = 0):
        self.from_batch = int(from_batch)

    def mutate(self, k: int,
               host: List[np.ndarray]) -> List[np.ndarray]:
        if k < self.from_batch:
            return host
        # the overflow past the dtype's range is part of the fault
        return [np.asarray(-(h.astype(np.float64)) + 1e6)
                .astype(h.dtype)
                if np.issubdtype(h.dtype, np.number) else h
                for h in host]


class SlowExec(Fault):
    """Deterministic service time on the fake clock: each dispatch
    from ``from_batch`` on advances the injected test clock by
    ``service_s`` before the batch runs, so completions carry real
    (nonzero) service-time samples.  This is how the control-plane
    scenarios get a meaningful latency histogram — the
    signal ``queue_eta_us`` and the autoscaler read — without any
    wall-clock sleeps.  ``advance`` is the test clock's ``advance``
    callable; production clocks have no such hook, which is the point:
    this fault is harness-only."""

    def __init__(self, service_s: float,
                 advance: Callable[[float], None],
                 from_batch: int = 0):
        self.service_s = float(service_s)
        self.advance = advance
        self.from_batch = int(from_batch)

    def before_batch(self, k: int) -> None:
        if k >= self.from_batch:
            self.advance(self.service_s)


class QueueWedge(Fault):
    """From dispatch ``after_batches`` on, the worker stops pulling
    batches (its queue wedges) while submissions keep landing."""

    def __init__(self, after_batches: int = 0):
        self.after_batches = int(after_batches)

    def wedged(self, k: int) -> bool:
        return k >= self.after_batches


class CorruptEntry(Fault):
    """Flip a payload byte of the ``at_store``-th committed cache
    entry — structurally intact, the load-time checksum must catch
    it (quarantine + recompile, never executed)."""

    def __init__(self, at_store: int = 0):
        self.at_store = int(at_store)

    def on_entry_written(self, k: int, path) -> bool:
        if k != self.at_store:
            return False
        p = Path(path)
        blob = bytearray(p.read_bytes())
        i = len(blob) - max(1, len(blob) // 16)
        blob[i] ^= 0xFF
        p.write_bytes(bytes(blob))
        return True


class TruncateEntry(Fault):
    """Cut the ``at_store``-th committed cache entry in half (crash
    mid-copy / partial write on a non-atomic filesystem)."""

    def __init__(self, at_store: int = 0):
        self.at_store = int(at_store)

    def on_entry_written(self, k: int, path) -> bool:
        if k != self.at_store:
            return False
        p = Path(path)
        blob = p.read_bytes()
        p.write_bytes(blob[:len(blob) // 2])
        return True


class StaleKey(Fault):
    """Rewrite one key component of the ``at_store``-th committed
    entry keeping its checksum valid — what an entry from an old torch
    or old contracts looks like; key revalidation must catch it."""

    def __init__(self, at_store: int = 0, component: str = "torch",
                 value: str = "0.0.0-stale"):
        self.at_store = int(at_store)
        self.component = component
        self.value = value

    def on_entry_written(self, k: int, path) -> bool:
        if k != self.at_store:
            return False
        from ..cache import poison_stale
        poison_stale(path, self.component, self.value)
        return True


class ReadOnlyDir(Fault):
    """Cache stores from ``from_store`` on fail with
    ``PermissionError`` — a read-only cache root (EROFS container
    mount), scripted rather than chmod'd because uid-0 test runners
    ignore mode bits.  The cache must degrade to plain compile."""

    def __init__(self, from_store: int = 0):
        self.from_store = int(from_store)

    def before_cache_write(self, k: int) -> None:
        if k >= self.from_store:
            raise PermissionError(
                f"scripted read-only cache dir at store {k}")


class FaultPlan:
    """A deterministic script: the union of its faults, consulted by
    the worker at each dispatch.  ``fired`` records what actually
    triggered, so tests can assert the scenario ran."""

    def __init__(self, *faults: Fault):
        self.faults = list(faults)
        self.fired: List[str] = []

    def wedged(self, k: int) -> bool:
        for f in self.faults:
            if f.wedged(k):
                if not self.fired or self.fired[-1] != "wedge":
                    self.fired.append("wedge")
                return True
        return False

    def before_batch(self, k: int) -> None:
        for f in self.faults:
            try:
                f.before_batch(k)
            except Exception:
                self.fired.append(f"{type(f).__name__.lower()}@{k}")
                raise

    def before_cache_write(self, k: int) -> None:
        """Cache write seam (ExecutableCache.store): a fault raising
        here denies committing entry ``k``."""
        for f in self.faults:
            try:
                f.before_cache_write(k)
            except Exception:
                self.fired.append(f"{type(f).__name__.lower()}@{k}")
                raise

    def entry_written(self, k: int, path) -> None:
        """Post-commit seam: faults mutate the entry file in place
        (the next verified load must quarantine it)."""
        for f in self.faults:
            if f.on_entry_written(k, path):
                self.fired.append(f"{type(f).__name__.lower()}@{k}")

    def mutator(self, k: int) -> Optional[
            Callable[[List[np.ndarray]], List[np.ndarray]]]:
        muts = [f for f in self.faults
                if type(f).mutate is not Fault.mutate]
        if not muts:
            return None

        def apply(host: List[np.ndarray]) -> List[np.ndarray]:
            out = host
            for f in muts:
                before = out
                out = f.mutate(k, out)
                if out is not before:
                    self.fired.append(
                        f"{type(f).__name__.lower()}@{k}")
            return out

        return apply
