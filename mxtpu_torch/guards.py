"""Runtime guard rails (the counterpart of ``mxtpu/guards.py``).

Two failure modes that only show at run time:

* **Recompile churn**: an entry whose cache keeps missing (buckets
  built again and again, shapes that never settle) turns a replay into
  a capture.  :class:`ChurnDetector` counts builds per entry; past the
  limit (``MXTPU_GUARDS_CHURN_LIMIT``) it warns, or raises under
  ``MXTPU_GUARDS=2``.
* **Implicit host/device synchronisation**: a ``.item()``, ``.cpu()``
  or a copy from pageable memory inside a dispatch stalls the card.
  :func:`no_implicit_transfers` runs a dispatch under
  ``torch.cuda.set_sync_debug_mode("error")``, so such a call raises
  instead of waiting.  The mode is the process's, not the thread's (as
  ``jax.transfer_guard`` is in mxtpu): while one guarded dispatch runs,
  a synchronising call on another thread raises too.  Scopes open and
  close on several threads in any order; the mode goes back to what it
  was when the last one closes.

With ``MXTPU_GUARDS`` unset, :func:`no_implicit_transfers` returns one
shared ``nullcontext`` and the runners read the knob once, when they
are built.  mxtpu's metrics counter of cache misses waits for the
port's ``obs``.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import warnings
from typing import Any, Dict, Optional

from . import knobs
from .base import MXNetError

__all__ = ["enabled", "strict", "ChurnDetector", "RecompileChurn",
           "no_implicit_transfers"]

logger = logging.getLogger("mxtpu.guards")

_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Guards on?  ``MXTPU_GUARDS=1`` (warn) or ``2`` (raise)."""
    return knobs.get("MXTPU_GUARDS").strip().lower() \
        in ("1", "2", "true", "yes", "on")


def strict() -> bool:
    """``MXTPU_GUARDS=2``: guard trips raise instead of warn."""
    return knobs.get("MXTPU_GUARDS").strip() == "2"


class RecompileChurn(MXNetError):
    """A guarded entry was built more times than its limit."""


class ChurnDetector:
    """Per-entry build counter.

    ``note_compile(key)`` on every build, ``note_call()`` on every
    dispatch; once builds exceed ``limit`` the detector warns ONCE (or
    raises, ``strict=True`` / ``MXTPU_GUARDS=2``) with the builds-per-
    call ratio, the signature of an entry that keeps building instead
    of reusing what it built.
    """

    def __init__(self, name: str, limit: Optional[int] = None,
                 strict: Optional[bool] = None):
        self.name = name
        self._limit = limit
        self._strict = strict
        self._lock = threading.Lock()
        self.compiles = 0        # guarded-by: _lock
        self.calls = 0           # guarded-by: _lock
        self._last_keys = []     # guarded-by: _lock
        self._tripped = False    # guarded-by: _lock

    @property
    def limit(self) -> int:
        if self._limit is not None:
            return self._limit
        return int(knobs.get("MXTPU_GUARDS_CHURN_LIMIT"))

    def note_call(self) -> None:
        with self._lock:
            self.calls += 1

    def note_compile(self, key: Any = None) -> None:
        """Record one build; trips the guard past the limit."""
        with self._lock:
            self.compiles += 1
            self._last_keys.append(key)
            del self._last_keys[:-4]  # keep the most recent few
            over = self.compiles > self.limit and not self._tripped
            if not over:
                return
            self._tripped = True
            msg = (f"mxtpu.guards: recompile churn on {self.name!r} — "
                   f"{self.compiles} compiles over {self.calls} calls "
                   f"(limit {self.limit}). Recent signatures: "
                   f"{self._last_keys}. Unstable shapes/dtypes or "
                   f"Python values flowing into the traced signature "
                   f"keep missing the jit cache; make them static or "
                   f"bucket them.")
        be_strict = self._strict if self._strict is not None else strict()
        if be_strict:
            raise RecompileChurn(msg)
        logger.warning(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"name": self.name, "compiles": self.compiles,
                    "calls": self.calls, "limit": self.limit,
                    "tripped": self._tripped}


# open guarded scopes across threads, and the mode before the first
_scopes_lock = threading.Lock()
_scopes = 0          # guarded-by: _scopes_lock
_saved_mode = None   # guarded-by: _scopes_lock


@contextlib.contextmanager
def _sync_errors():
    """The process's sync debug mode is "error" while any guarded scope
    is open, on any thread; the last scope to close restores the mode
    the first one found, whatever order they close in."""
    import torch
    global _scopes, _saved_mode
    with _scopes_lock:
        if _scopes == 0:
            _saved_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        _scopes += 1
    try:
        yield
    finally:
        with _scopes_lock:
            _scopes -= 1
            if _scopes == 0:
                torch.cuda.set_sync_debug_mode(_saved_mode)


def no_implicit_transfers(enabled_override: Optional[bool] = None,
                          device=None):
    """Context manager: inside it, a call that synchronises with the
    card raises (``torch.cuda.set_sync_debug_mode("error")``).
    Disabled (the default with ``MXTPU_GUARDS`` unset), or for a
    ``device`` that is not a CUDA device, it returns a shared
    ``nullcontext``.  Pass ``enabled_override`` to force either way
    (hot paths pass their cached flag so the knob is not re-read per
    call)."""
    on = enabled() if enabled_override is None else enabled_override
    if not on or (device is not None
                  and getattr(device, "type", str(device)) != "cuda"):
        return _NULL
    return _sync_errors()
