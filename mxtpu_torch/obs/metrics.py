"""Typed process-wide metrics registry.

One :class:`MetricsRegistry` per process (``mxtpu_torch.obs`` owns the
default) holding three instrument kinds — :class:`Counter` (monotone),
:class:`Gauge` (set/inc/dec), :class:`Histogram` (fixed buckets +
sum/count) — each with an optional label set.  The hot path is O(1)
under one leaf lock per metric family: label resolution is a dict hit,
an increment is a float add.  Nothing here imports torch or jax.

Naming convention (mxtpu's, enforced at creation):

* every metric matches ``^mxtpu_[a-z][a-z0-9_]*$``;
* counters end in ``_total``;
* histograms end in a unit suffix: ``_seconds``, ``_us`` or ``_bytes``.

Two export surfaces are kept equivalent by ``obs.self_check()``:
:meth:`MetricsRegistry.prometheus_text` (Prometheus text exposition)
and :meth:`MetricsRegistry.snapshot` (JSON-able dict) — a parsed text
dump and a flattened snapshot must carry the same sample values
(:func:`parse_prometheus_text` / :func:`samples_from_snapshot`).

Disabled path: ``mxtpu_torch.obs`` hands out the shared :data:`NULL_COUNTER`
/ :data:`NULL_GAUGE` / :data:`NULL_HISTOGRAM` singletons instead of
registering anything — the guards-style zero-overhead contract.
"""
from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM",
           "parse_prometheus_text", "samples_from_snapshot",
           "DEFAULT_BUCKETS", "percentile", "bucket_quantile"]

_NAME_RE = re.compile(r"^mxtpu_[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# Latency-shaped default: 100us .. 10s (seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_HIST_SUFFIXES = ("_seconds", "_us", "_bytes")


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted sequence, ``q`` in
    [0, 100].  THE percentile implementation:
    ``ServingStats`` (snapshot p50/p95/p99, ``queue_eta_us``) and the
    time-series sampler delegate here, pinned by an equivalence test
    on shared sample sets."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def bucket_quantile(bounds: Sequence[float],
                    cum_counts: Sequence[float],
                    q: float) -> Optional[float]:
    """Quantile from cumulative histogram bucket counts (Prometheus
    ``histogram_quantile`` style), ``q`` in [0, 100].

    ``bounds`` are the finite upper bounds; ``cum_counts`` has one
    cumulative count per bound plus the trailing ``+Inf`` total —
    exactly the shape :meth:`_HistogramChild._snap` exposes and the
    sampler stores.  Linear interpolation inside the landing bucket
    (from the previous bound, 0 below the first); a quantile landing
    in ``+Inf`` clamps to the largest finite bound.  None when the
    (windowed) histogram is empty."""
    total = float(cum_counts[-1]) if cum_counts else 0.0
    if total <= 0:
        return None
    rank = q / 100.0 * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in zip(bounds, cum_counts):
        if cum >= rank and cum > prev_cum:
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * max(0.0, frac)
        prev_bound, prev_cum = float(bound), float(cum)
    return float(bounds[-1]) if bounds else None


def _check_name(name: str, kind: str) -> None:
    if not _NAME_RE.match(name):
        raise MXNetError(
            f"obs: metric name {name!r} violates the naming convention "
            f"(^mxtpu_[a-z][a-z0-9_]*$)")
    if kind == "counter" and not name.endswith("_total"):
        raise MXNetError(
            f"obs: counter {name!r} must end in '_total'")
    if kind == "histogram" and not name.endswith(_HIST_SUFFIXES):
        raise MXNetError(
            f"obs: histogram {name!r} must end in a unit suffix "
            f"{_HIST_SUFFIXES}")


def _fmt(v: float) -> str:
    """Float formatting that round-trips through ``float()`` and
    renders integral values bare (Prometheus style)."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Family:
    """A named metric + its per-label-set children.  The family lock
    is a LEAF lock: hold it only for the dict hit / float add, never
    while calling out."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        _check_name(name, self.kind)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise MXNetError(
                    f"obs: bad label name {ln!r} on {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}  # guarded-by: _lock
        # the unlabeled family IS its own child: created once here and
        # never replaced, so _default() reads it lock-free
        self._unlabeled: Any = None
        if not self.labelnames:
            self._unlabeled = self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kw) -> Any:
        """Child for one label-value set (created on first use)."""
        if set(kw) != set(self.labelnames):
            raise MXNetError(
                f"obs: {self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(kw))}")
        key = tuple(str(kw[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default(self):
        if self.labelnames:
            raise MXNetError(
                f"obs: {self.name} is labeled {self.labelnames}; "
                f"use .labels(...)")
        return self._unlabeled

    def _series(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]


class _CounterChild:
    __slots__ = ("_v", "_lock")

    def __init__(self, lock: threading.Lock):
        self._v = 0.0            # guarded-by: _lock
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise MXNetError("obs: counters only go up (inc(n>=0))")
        with self._lock:
            self._v += n

    def value(self) -> float:
        with self._lock:
            return self._v


class Counter(_Family):
    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild(self._lock)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def value(self) -> float:
        return self._default().value()


class _GaugeChild:
    __slots__ = ("_v", "_lock")

    def __init__(self, lock: threading.Lock):
        self._v = 0.0            # guarded-by: _lock
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild(self._lock)

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def value(self) -> float:
        return self._default().value()


class _HistogramChild:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: Tuple[float, ...],
                 lock: threading.Lock):
        self._bounds = bounds
        # one slot per finite bound + the +Inf overflow slot
        self._counts = [0] * (len(bounds) + 1)  # guarded-by: _lock
        self._sum = 0.0          # guarded-by: _lock
        self._count = 0          # guarded-by: _lock
        self._lock = lock

    def observe(self, v: float) -> None:
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def summary(self) -> Dict[str, float]:
        with self._lock:
            n, s = self._count, self._sum
        return {"count": n, "sum": s,
                "mean": (s / n) if n else 0.0}

    def _snap(self) -> Dict[str, Any]:
        with self._lock:
            counts, s, n = list(self._counts), self._sum, self._count
        cum, buckets = 0, {}
        for bound, c in zip(self._bounds, counts):
            cum += c
            buckets[_fmt(bound)] = cum
        buckets["+Inf"] = n
        return {"buckets": buckets, "sum": s, "count": n}


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise MXNetError(f"obs: histogram {name!r} needs buckets")
        self._bounds = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self._bounds, self._lock)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def summary(self) -> Dict[str, float]:
        return self._default().summary()


class _NullChild:
    """Shared no-op instrument: every method accepts anything and does
    nothing; ``labels()`` returns itself so call sites never branch."""

    __slots__ = ()

    def labels(self, **kw) -> "_NullChild":
        return self

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def value(self) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0, "mean": 0.0}


NULL_COUNTER = _NullChild()
NULL_GAUGE = _NullChild()
NULL_HISTOGRAM = _NullChild()


class MetricsRegistry:
    """Name → family map; get-or-create semantics so any module can
    declare its instruments idempotently at construction time."""

    _KINDS = {"counter": Counter, "gauge": Gauge,
              "histogram": Histogram}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Family] = {}  # guarded-by: _lock

    def _get_or_create(self, kind: str, name: str, help: str,
                       labels: Sequence[str],
                       **kw) -> _Family:
        with self._lock:
            fam = self._metrics.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise MXNetError(
                        f"obs: {name!r} already registered as "
                        f"{fam.kind}, requested {kind}")
                if fam.labelnames != tuple(labels):
                    raise MXNetError(
                        f"obs: {name!r} already registered with labels "
                        f"{fam.labelnames}, requested {tuple(labels)}")
                return fam
            fam = self._KINDS[kind](name, help, labels, **kw)
            self._metrics[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create("histogram", name, help, labels,
                                   buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def _families(self) -> List[_Family]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every registered family (tests only)."""
        with self._lock:
            self._metrics.clear()

    # -- export surfaces -------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump: ``{name: {type, help, series: [...]}}``.
        Counter/gauge series carry ``value``; histogram series carry
        cumulative ``buckets`` + ``sum`` + ``count`` — the exact
        numbers :meth:`prometheus_text` exposes."""
        out: Dict[str, Any] = {}
        for fam in self._families():
            series = []
            for labels, child in fam._series():
                entry: Dict[str, Any] = {"labels": labels}
                if fam.kind == "histogram":
                    entry.update(child._snap())
                else:
                    entry["value"] = child.value()
                series.append(entry)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        for fam in self._families():
            if fam.help:
                esc = fam.help.replace("\\", "\\\\").replace(
                    "\n", "\\n")
                lines.append(f"# HELP {fam.name} {esc}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in fam._series():
                if fam.kind == "histogram":
                    snap = child._snap()
                    for le, cum in snap["buckets"].items():
                        bl = dict(labels)
                        bl["le"] = le
                        lines.append(f"{fam.name}_bucket"
                                     f"{_label_str(bl)} {_fmt(cum)}")
                    lines.append(f"{fam.name}_sum{_label_str(labels)} "
                                 f"{_fmt(snap['sum'])}")
                    lines.append(f"{fam.name}_count"
                                 f"{_label_str(labels)} "
                                 f"{_fmt(snap['count'])}")
                else:
                    lines.append(f"{fam.name}{_label_str(labels)} "
                                 f"{_fmt(child.value())}")
        return "\n".join(lines) + "\n"

    def summary(self) -> Dict[str, Any]:
        """Compact flat view for bench rows: counters/gauges map to
        their value, histograms to ``{count, sum, mean}``."""
        out: Dict[str, Any] = {}
        for fam in self._families():
            for labels, child in fam._series():
                key = fam.name + _label_str(labels)
                if fam.kind == "histogram":
                    out[key] = child.summary()
                else:
                    out[key] = child.value()
        return out


# ----------------------------------------------------------------------
# Round-trip helpers (self_check + tests): both export surfaces must
# flatten to the same {(name, labels): value} sample map.
# ----------------------------------------------------------------------
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return float("inf")
    return float(raw)


def parse_prometheus_text(text: str
                          ) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                     ...]], float]:
    """Parse an exposition dump back into a flat sample map keyed by
    ``(sample_name, sorted_label_items)``."""
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise MXNetError(f"obs: unparseable exposition line "
                             f"{line!r}")
        name, labelblob, raw = m.groups()
        labels = tuple(sorted(
            (k, _unescape_label(v))
            for k, v in _LABEL_PAIR_RE.findall(labelblob or "")))
        samples[(name, labels)] = _parse_value(raw)
    return samples


def samples_from_snapshot(snap: Dict[str, Any]
                          ) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                     ...]], float]:
    """Flatten :meth:`MetricsRegistry.snapshot` into the same sample
    map :func:`parse_prometheus_text` produces."""
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for name, fam in snap.items():
        for entry in fam["series"]:
            base = tuple(sorted((k, str(v))
                                for k, v in entry["labels"].items()))
            if fam["type"] == "histogram":
                for le, cum in entry["buckets"].items():
                    key = tuple(sorted(base + (("le", le),)))
                    samples[(name + "_bucket", key)] = float(cum)
                samples[(name + "_sum", base)] = float(entry["sum"])
                samples[(name + "_count", base)] = float(entry["count"])
            else:
                samples[(name, base)] = float(entry["value"])
    return samples
