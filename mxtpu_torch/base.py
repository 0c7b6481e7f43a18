"""Base utilities: the framework error type, the reference's
ctypes-protocol check, the name registry and ``_as_list``.

Copied from ``mxtpu/base.py`` (the jax-free part this package needs);
``mxtpu_torch`` never imports ``mxtpu``.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, List, Optional, TypeVar

__all__ = ["MXNetError", "check_call", "Registry", "_as_list"]

T = TypeVar("T")


class MXNetError(RuntimeError):
    """Framework error type (parity with ``mxnet.base.MXNetError``,
    ``python/mxnet/base.py``†).  Python exceptions propagate directly,
    including asynchronous CUDA errors re-raised at sync points."""


def check_call(ret: int) -> None:
    """Raise on a non-zero return code (reference
    ``python/mxnet/base.py``† ``check_call``)."""
    if ret != 0:
        raise MXNetError("non-zero return code %d" % ret)


def _as_list(x) -> list:
    """Wrap a non-list value in a list (lists and tuples pass through
    as lists)."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Registry(Generic[T]):
    """Name → entry registry for ops, metrics, initializers and custom
    ops; lookups fall back to the lowercased name."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}
        self._lower: Dict[str, T] = {}
        self._lock = threading.Lock()

    def register(self, name: Optional[str] = None, *, aliases: tuple = (),
                 allow_override: bool = False) -> Callable[[T], T]:
        def _do(entry: T) -> T:
            key = name or getattr(entry, "__name__", None)
            if key is None:
                raise MXNetError(f"cannot infer registry name for {entry!r}")
            keys = list(dict.fromkeys((key,) + tuple(aliases)))
            with self._lock:
                for k in keys:
                    if k in self._entries and not allow_override:
                        raise MXNetError(
                            f"{self.kind} '{k}' already registered")
                    self._entries[k] = entry
                    self._lower.setdefault(k.lower(), entry)
            return entry
        return _do

    def get(self, name: str) -> T:
        e = self.find(name)
        if e is None:
            raise MXNetError(
                f"unknown {self.kind} '{name}'. known: "
                f"{sorted(self._entries)[:40]}")
        return e

    def find(self, name: str) -> Optional[T]:
        return self._entries.get(name) or self._lower.get(name.lower())

    def __contains__(self, name: str) -> bool:
        return self.find(name) is not None

    def list(self) -> List[str]:
        return sorted(self._entries)
