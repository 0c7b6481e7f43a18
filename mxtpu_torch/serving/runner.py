"""ModelRunner — bucketed inference over an exported graph and one
weight upload (the counterpart of ``mxtpu/serving/runner.py``).

A deployed model is the export mxtpu writes: a ``-symbol.json`` graph
and a ``.params`` file (gluon ``HybridBlock.export`` or
``Module.save_checkpoint``, of either package).  Every request batch
is padded to a bucket of a powers-of-two batch ladder crossed with
optional sequence-length buckets, so the card only ever sees a
bounded set of shapes.  Each bucket gets one entry, built once
(:mod:`.entry`): on the card a CUDA graph of the graph plan captured
over static buffers, on the CPU the plan run eagerly.  The weights are
uploaded once and every bucket's entry reads the same tensors.

Pad-to-bucket contract (unchanged from mxtpu): batch padding repeats
row 0, sequence padding uses ``pad_value``, and attention also covers
the pad positions, so a served result equals the graph's output on the
same padded batch.

With a persistent cache (:mod:`mxtpu_torch.cache`), each bucket's entry
is load-or-build: a verified disk entry is the bucket's recipe, and the
entry built from it (on the card the warm-up and the capture, which no
disk entry can skip; on the CPU the eager plan) is held against it.
What a hit skips is the kernels' ``nvcc`` builds, whose libraries the
same root holds.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .. import guards
from .. import knobs
from .. import obs
from .. import profiler
from ..context import resolve_device, strict_f32
from .batcher import InferenceRequest
from .entry import Entry, GraphPool, recipe_mismatch

__all__ = ["ModelRunner", "batch_ladder"]


# the entry-build instruments ModelRunner and GenerateRunner share
# (mxtpu's metric names)
COMPILE_TOTAL = "mxtpu_serving_compile_total"
COMPILE_TOTAL_HELP = ("Bucket entries built with no verified disk entry "
                      "(on the card, a CUDA graph captured; on the CPU, "
                      "the graph plan bound); disk-cache hits count in "
                      "mxtpu_compile_cache_hit_total instead.")
COMPILE_SECONDS = "mxtpu_serving_compile_seconds"
COMPILE_SECONDS_HELP = ("Per-bucket entry build wall time (source=cold: "
                        "built with no donor; source=donor: built by "
                        "warm_from from a donor's handoff; source=disk: "
                        "built on a verified persistent-cache entry, "
                        "whose recipe the build matched).")
CACHE_HIT = "mxtpu_compile_cache_hit_total"
CACHE_HIT_HELP = ("In-process compile-cache misses served from the "
                  "persistent disk cache instead of a cold build.")
SOURCES = ("cold", "donor", "disk")


class EntryBuilds:
    """The entry-build instruments of one runner (no-op singletons when
    ``MXTPU_OBS=0``): builds feed the registry and the "compile" flight
    recorder, so a postmortem shows every build with its time."""

    def __init__(self, label: str):
        self.label = label
        self.on = obs.enabled()
        self._compile = obs.counter(
            COMPILE_TOTAL, COMPILE_TOTAL_HELP,
            labels=("entry",)).labels(entry=label)
        h = obs.histogram(COMPILE_SECONDS, COMPILE_SECONDS_HELP,
                          labels=("entry", "source"))
        self._seconds = {src: h.labels(entry=label, source=src)
                         for src in SOURCES}
        self._hit = obs.counter(CACHE_HIT, CACHE_HIT_HELP,
                                labels=("entry",)).labels(entry=label)

    def built(self, bucket, source: str, seconds: float) -> None:
        if not self.on:
            return
        (self._hit if source == "disk" else self._compile).inc()
        self._seconds[source].observe(seconds)
        obs.flight("compile").record(
            "compile_miss", entry=self.label, bucket=str(bucket),
            source=source, seconds=round(seconds, 4))


def resolve_cache(who: str, cache: Any):
    """A runner's ``cache=``: "auto" is the knob-configured
    :func:`~mxtpu_torch.cache.default_cache` (None while
    ``MXTPU_CACHE_DIR`` is unset), None none, else an
    :class:`~mxtpu_torch.cache.ExecutableCache`."""
    from ..cache import ExecutableCache, default_cache
    if cache == "auto":
        return default_cache()
    if cache is None or isinstance(cache, ExecutableCache):
        return cache
    raise TypeError(f"{who}: cache= takes \"auto\", None or an "
                    f"ExecutableCache, not {type(cache).__name__}")


def canonical_graph(symbol) -> Dict[str, Any]:
    """The graph's JSON with its op nodes named ``_op{i}``: gensym'd op
    names come from a process-wide counter, edges and heads are
    index-based, so two copies of one graph fingerprint alike; input
    ("null") nodes keep their names, which are semantics."""
    graph = json.loads(symbol.tojson())
    for i, node in enumerate(graph.get("nodes", ())):
        if node.get("op") not in (None, "null"):
            node["name"] = f"_op{i}"
    return graph


def fingerprint(fp: Dict[str, Any], amp: bool, quant: bool,
                scales: Optional[Dict[str, float]]) -> str:
    """sha256 of a runner's fingerprint dict, with ``amp`` and the int8
    thresholds keyed only when on (mxtpu's rule: the off paths keep
    their fingerprints)."""
    if amp:
        fp["amp"] = True
    if quant:
        fp["quant"] = sorted((scales or {}).items()) or True
    blob = json.dumps(fp, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def param_sigs(names, vals) -> List[List]:
    """Parameter signatures (never values: one entry serves every
    checkpoint of an architecture), in mxtpu's dtype names."""
    return [[n, list(v.shape), str(v.dtype).replace("torch.", "")]
            for n, v in zip(names, vals)]


def load_or_build(cache, key, build: "Callable[[bool], Entry]"):
    """One bucket through the persistent cache: ``(entry, hit)``.  A
    stored recipe that the new entry does not match is quarantined as
    "stale_key" and stored anew, and the build counts as cold."""
    if cache is None:
        return build(False), False
    recipe = cache.load(key)
    entry = build(True)
    if recipe is not None:
        why = recipe_mismatch(recipe, entry)
        if not why:
            return entry, True
        cache.quarantine(key, "stale_key", why)
    cache.store(key, entry.recipe())
    return entry, False


def batch_ladder(max_batch_size: int) -> Tuple[int, ...]:
    """Powers-of-two ladder 1,2,4,… capped at ``max_batch_size`` (the
    cap itself is always a rung so full batches never pad)."""
    if max_batch_size < 1:
        raise MXNetError("max_batch_size must be >= 1")
    rungs = []
    b = 1
    while b < max_batch_size:
        rungs.append(b)
        b *= 2
    rungs.append(max_batch_size)
    return tuple(rungs)


def stage_weights(names, params, device, amp_on: bool
                  ) -> Tuple[torch.Tensor, ...]:
    """The one weight upload of a runner: under AMP the f32 weights in
    bf16 (half the device memory), aux-named ones (BatchNorm's running
    statistics) kept f32, as mxtpu stages them."""
    from ..symbol import _is_aux_name
    out = []
    for n in names:
        v = torch.tensor(as_numpy(params[n]), device=device)
        if amp_on and v.dtype == torch.float32 and not _is_aux_name(n):
            v = v.to(torch.bfloat16)
        out.append(v)
    return tuple(out)


def entry_values(vals: Sequence[torch.Tensor], amp_on: bool
                 ) -> Tuple[torch.Tensor, ...]:
    """The weights as a graph reads them: under AMP every float one
    narrower than f32 upcast at the entry, so only the policy's
    contractions (cast back inside the autocast scope) see bf16."""
    if not amp_on:
        return tuple(vals)
    return tuple(v.float() if v.is_floating_point() and
                 v.dtype != torch.float32 else v for v in vals)


def scopes(amp_on: bool, quant_on: bool, scales, who: str
           ) -> contextlib.ExitStack:
    """The scopes a runner's graph runs in: quantize outermost (a
    contraction with a recorded scale becomes an int8 product; one it
    leaves on the float path still gets AMP's cast when both are on),
    then autocast."""
    from .. import amp as _amp
    from .. import quant as _quant
    stack = contextlib.ExitStack()
    if quant_on:
        if scales is None:
            raise MXNetError(
                f"{who}: quantized runner has no calibrated scales — "
                f"run calibrate(batches) (or pass quant_scales) first")
        stack.enter_context(_quant.quantize(scales))
    if amp_on:
        stack.enter_context(_amp.autocast())
    return stack


def as_numpy(v) -> np.ndarray:
    """A param value (NDArray of either package, or array-like) on the
    host."""
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


class ModelRunner:
    """Load-once, build-per-bucket, run-many inference engine.

    Parameters
    ----------
    symbol : mxtpu_torch.symbol.Symbol
        The inference graph (deployment artifact).
    params : dict name -> numpy array / NDArray
        Trained weights (``arg:``/``aux:`` prefixes already stripped).
    input_specs : dict name -> per-example shape tuple
        Shapes EXCLUDE the batch axis.  A ``None`` entry marks the
        variable (sequence) axis of a token model and requires
        ``seq_buckets``; e.g. ``{"data": (None,)}`` for token ids.
    input_dtypes : dict name -> dtype, optional (default float32)
    seq_buckets : ascending ints, optional
        Sequence-length rungs for every ``None`` axis.
    max_batch_size : int, optional (env MXTPU_SERVING_MAX_BATCH, 32)
    device : None (``cuda:0``; raises without CUDA) or a device such as
        ``"cpu"``.  One runner binds one device.
    pad_value : scalar used for sequence padding (default 0).
    donate : bool, optional (env MXTPU_SERVING_DONATE, on): keyed into
        the fingerprint as mxtpu's is; a bucket's entry always reuses
        its own input buffers.
    cache : "auto" (the knob-configured default cache; none while
        ``MXTPU_CACHE_DIR`` is unset), None, or an
        :class:`~mxtpu_torch.cache.ExecutableCache`: each bucket's
        entry is load-or-build through it (see the module docstring).
    amp : policy AMP (:mod:`mxtpu_torch.amp`): the weights are uploaded
        in bf16 (aux-named ones f32), upcast to f32 at the graph's entry,
        and the policy's contractions run on bf16 with f32 outputs.
        ``MXTPU_AMP=0`` forces it off, ``=1`` on.
    quant : int8 (:mod:`mxtpu_torch.quant`): after :meth:`calibrate`
        records activation thresholds, every bucket runs the policy's
        contractions as int8 products with int32 sums.
        ``MXTPU_QUANT=0`` forces it off, ``=1`` on.
    """

    def __init__(self, symbol, params: Dict[str, Any],
                 input_specs: Dict[str, Tuple],
                 input_dtypes: Optional[Dict[str, Any]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_batch_size: Optional[int] = None,
                 device=None, pad_value: float = 0,
                 donate: Optional[bool] = None, cache: Any = "auto",
                 amp=None, quant=None):
        cache = resolve_cache("ModelRunner", cache)
        from .. import amp as _amp
        from .. import quant as _quant
        from ..symbol import _GraphPlan
        if not input_specs:
            raise MXNetError("serving: input_specs is required")
        self._device = resolve_device(device)
        if self._device.type == "cuda":
            strict_f32()
        self._amp = _amp.resolve(amp)
        self._quant = _quant.resolve(quant)
        self._quant_scales: Optional[Dict[str, float]] = None
        self._symbol = symbol
        self._input_names = list(input_specs)
        self._input_specs = {k: tuple(v) for k, v in input_specs.items()}
        self._input_dtypes = {
            k: np.dtype((input_dtypes or {}).get(k, np.float32))
            for k in input_specs}
        # Serving knobs: the env defaults feed every runner that does
        # not pass explicit values
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else knobs.get("MXTPU_SERVING_MAX_BATCH"))
        self.batch_buckets = batch_ladder(self.max_batch_size)
        self.seq_buckets = tuple(sorted(int(s) for s in seq_buckets)) \
            if seq_buckets else None
        has_var = any(None in spec for spec in self._input_specs.values())
        if has_var and not self.seq_buckets:
            raise MXNetError(
                "serving: input_specs contain a variable (None) axis — "
                "pass seq_buckets")
        self._pad_value = pad_value
        self._donate = bool(knobs.get("MXTPU_SERVING_DONATE")
                            if donate is None else donate)

        # -- one weight upload, shared by every bucket's entry ---------
        known = set(symbol.list_inputs())
        self._param_names = tuple(
            n for n in params if n in known and n not in input_specs)
        missing = known - set(self._param_names) - set(input_specs)
        if missing:
            raise MXNetError(
                f"serving: graph inputs {sorted(missing)} have neither "
                f"a param nor an input_spec")
        self._param_vals = stage_weights(self._param_names, params,
                                         self._device, self._amp)
        self._plan = _GraphPlan(symbol)
        self._pool = GraphPool(self._device)

        # server worker threads race through _entry()/warmup(); an
        # entry is built exactly once, under _lock
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, Entry] = {}  # guarded-by: _lock
        self.compile_seconds: Dict[Tuple, float] = {}  # guarded-by: _lock
        # per built entry: "cold" (captured with no donor's list),
        # "donor" (captured by warm_from from a donor's handoff) or
        # "disk" (built on a verified persistent-cache entry)
        self._compile_sources: Dict[Tuple, str] = {}  # guarded-by: _lock
        self._guards = guards.enabled()
        # one build per ladder rung is the design; anything past the
        # ladder (+ slack for explicit extra warmup buckets) is churn
        self._entry_label = f"ModelRunner[{type(symbol).__name__}]"
        self._churn = guards.ChurnDetector(
            self._entry_label, limit=len(self.buckets()) + 4)
        # in this package a "compile" is the build (on the card, the
        # capture) of a bucket's entry
        self._builds = EntryBuilds(self._entry_label)
        # the persistent cache and this runner's model fingerprint
        self._cache = cache
        self._fingerprint = self._model_fingerprint() \
            if cache is not None else ""

    # -- deployment-artifact constructors -------------------------------
    @classmethod
    def from_export(cls, symbol_file: str, params_file: str, **kwargs
                    ) -> "ModelRunner":
        """Load gluon ``HybridBlock.export`` / ``Module.save_checkpoint``
        artifacts (``-symbol.json`` + ``-NNNN.params``) of either
        package."""
        from .. import symbol as sym_mod
        from ..ndarray import load_params
        return cls(sym_mod.load(symbol_file), load_params(params_file),
                   **kwargs)

    @classmethod
    def from_checkpoint(cls, prefix: str, epoch: int, **kwargs
                        ) -> "ModelRunner":
        """``prefix-symbol.json`` + ``prefix-{epoch:04d}.params``."""
        return cls.from_export(f"{prefix}-symbol.json",
                               f"{prefix}-{epoch:04d}.params", **kwargs)

    # -- buckets ---------------------------------------------------------
    def bucket_for(self, n: int, seq_len: Optional[int] = None) -> Tuple:
        """Smallest (batch_bucket, seq_bucket) ladder rung covering a
        batch of ``n`` examples of length ``seq_len``."""
        if n < 1:
            raise MXNetError("serving: empty batch")
        if n > self.max_batch_size:
            raise MXNetError(
                f"serving: batch {n} exceeds max_batch_size "
                f"{self.max_batch_size}")
        b = next(r for r in self.batch_buckets if r >= n)
        if self.seq_buckets is None:
            return (b, None)
        if seq_len is None:
            raise MXNetError("serving: token model needs seq_len")
        if seq_len > self.seq_buckets[-1]:
            raise MXNetError(
                f"serving: seq_len {seq_len} exceeds largest bucket "
                f"{self.seq_buckets[-1]}")
        s = next(r for r in self.seq_buckets if r >= seq_len)
        return (b, s)

    def seq_bucket_for(self, seq_len: Optional[int]) -> Optional[int]:
        """The batcher's grouping key: requests sharing a seq bucket
        may batch together; batch-size bucketing happens at dispatch."""
        if self.seq_buckets is None:
            return None
        return self.bucket_for(1, seq_len)[1]

    def buckets(self) -> List[Tuple]:
        """The full ladder (what ``warmup()`` builds)."""
        seqs = self.seq_buckets or (None,)
        return [(b, s) for s in seqs for b in self.batch_buckets]

    def _concrete_shape(self, name: str, batch: int,
                        seq: Optional[int]) -> Tuple[int, ...]:
        return (batch,) + tuple(seq if d is None else int(d)
                                for d in self._input_specs[name])

    # -- the persistent cache ---------------------------------------------
    def _model_fingerprint(self) -> str:
        """sha256 over everything that shapes a bucket's entry except
        the bucket (``mxtpu/serving/runner.py:299-336``): the canonical
        graph, input specs and types, parameter signatures, donation,
        pad value, and AMP and the int8 thresholds when on."""
        return fingerprint({
            "symbol": canonical_graph(self._symbol),
            "inputs": {n: [list(self._input_specs[n]),
                           str(self._input_dtypes[n])]
                       for n in self._input_names},
            "params": param_sigs(self._param_names, self._param_vals),
            "donate": self._donate, "pad_value": self._pad_value,
        }, self._amp, self._quant, self._quant_scales)

    def _cache_key(self, bucket: Tuple):
        """The persistent-cache key of one bucket: fingerprint x the
        bucket's concrete shapes x one device (+ the environment the
        cache adds); ``quant="int8"`` keys a quantized runner's entries
        apart from its float twin's."""
        batch, seq = bucket
        shapes = {n: list(self._concrete_shape(n, batch, seq))
                  for n in self._input_names}
        extra = {"quant": "int8"} if self._quant else {}
        return self._cache.key(
            model=self._fingerprint, shape=str(sorted(shapes.items())),
            mesh="1dev", device=self._device, **extra)

    def cached_buckets(self) -> List[Tuple]:
        """The ladder's buckets present in the persistent cache now
        (an existence probe; loads verify later) — what the fleet asks
        before warming a donor-less replacement from disk."""
        if self._cache is None:
            return []
        return [b for b in self.buckets()
                if self._cache.contains(self._cache_key(b))]

    def warm_from_disk(self) -> Dict[Tuple, float]:
        """Warm every ladder bucket the persistent cache holds (a
        poisoned or stale entry quarantines and builds cold inside
        ``_entry``, still before the first request).  Returns per-bucket
        build seconds; empty with no cache or no entries."""
        hits = self.cached_buckets()
        if not hits:
            return {}
        return self.warmup(hits)

    # -- int8 calibration -------------------------------------------------
    def calibrate(self, batches: Sequence[Dict[str, Any]],
                  mode: Optional[str] = None,
                  num_batches: Optional[int] = None,
                  collector=None) -> Dict[str, float]:
        """Post-training calibration (``mxtpu/serving/runner.py:379-
        452``): run representative ``batches`` (dicts of batched host
        arrays, one per input) eagerly through the deployed graph, each
        candidate contraction's activations observed by the collector
        (``mode``: minmax | entropy; default the MXTPU_QUANT_CALIB knob),
        at most ``num_batches`` of them (default the
        MXTPU_QUANT_CALIB_BATCHES knob).  The thresholds arm the int8
        path of every bucket built afterwards, so calibration must come
        before any bucket is built (on the card, captured).
        Deterministic given the batches."""
        from .. import autograd
        from .. import quant as _quant
        from ..ndarray.ndarray import NDArray
        if not self._quant:
            raise MXNetError(
                "serving: calibrate() on a non-quantized runner — pass "
                "quant=True (or MXTPU_QUANT=1), and note MXTPU_QUANT=0 "
                "overrides both")
        with self._lock:
            if self._entries:
                raise MXNetError(
                    "serving: calibrate() after buckets were built — "
                    "calibration changes every bucket's graph; calibrate "
                    "before warmup()")
        if num_batches is None:
            _, num_batches = _quant.calib_config()
        if collector is None:
            collector = _quant.make_collector(mode)
        # the weights enter in f32 as _forward enters them, so what is
        # observed is what the quantized graph quantizes
        params = {n: NDArray(v) for n, v in zip(
            self._param_names, entry_values(self._param_vals, self._amp))}
        with autograd.pause(train_mode=False), torch.inference_mode():
            for i, batch in enumerate(batches):
                if i >= num_batches:
                    break
                bindings = dict(params)
                for n in self._input_names:
                    arr = np.asarray(batch[n], self._input_dtypes[n])
                    bindings[n] = NDArray(torch.from_numpy(arr).to(
                        self._device))
                with _quant.calibrating(collector):
                    self._plan.run(bindings)
        scales = collector.thresholds()
        if not scales:
            raise MXNetError(
                "serving: calibration observed no quantizable contraction "
                "— the graph has no FullyConnected/Convolution on f32 "
                "inputs")
        self._quant_scales = scales
        if self._cache is not None:
            # the thresholds are part of what each bucket computes
            self._fingerprint = self._model_fingerprint()
        return dict(scales)

    def quant_scales(self) -> Optional[Dict[str, float]]:
        """The calibrated activation-threshold table (None before
        :meth:`calibrate`)."""
        return dict(self._quant_scales) \
            if self._quant_scales is not None else None

    # -- the entries -------------------------------------------------------
    def _forward(self, *input_vals: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
        """The graph plan on one bucket's inputs and the shared weights,
        in inference mode (no recording, training off: dropout is the
        identity), inside the AMP and int8 scopes the runner was built
        with."""
        from .. import autograd
        from ..ndarray.ndarray import NDArray
        bindings = {n: NDArray(v)
                    for n, v in zip(self._input_names, input_vals)}
        for n, v in zip(self._param_names,
                        entry_values(self._param_vals, self._amp)):
            bindings[n] = NDArray(v)
        with autograd.pause(train_mode=False), torch.inference_mode(), \
                scopes(self._amp, self._quant, self._quant_scales,
                       "serving"):
            outs = self._plan.run(bindings)
        return tuple(o._data for o in outs)

    def _example(self, bucket: Tuple) -> Tuple[torch.Tensor, ...]:
        batch, seq = bucket
        return tuple(
            torch.full(self._concrete_shape(n, batch, seq), self._pad_value,
                       dtype=_torch_dtype(self._input_dtypes[n]),
                       device=self._device)
            for n in self._input_names)

    def _entry(self, bucket: Tuple, source: str = "cold") -> Entry:
        """Build (once) and return the bucket's entry, load-or-build
        through the persistent cache when there is one.  Holding
        ``_lock`` across the build trades warmup parallelism for the
        exactly-once contract: two worker threads hitting the same cold
        bucket would otherwise both capture it.  ``source`` is what
        :meth:`compile_sources` records for a new entry that no verified
        disk entry matched ("disk" where one did)."""
        with self._lock:
            entry = self._entries.get(bucket)
            if entry is not None:
                return entry
            if self._guards:
                self._churn.note_compile(bucket)
            if self._quant and self._quant_scales is None:
                raise MXNetError(
                    "serving: quantized runner has no calibrated scales — "
                    "run calibrate(batches) before building buckets")
            batch, seq = bucket
            t0 = time.perf_counter()

            def build(probe: bool) -> Entry:
                return Entry(self._forward, self._example(bucket),
                             self._pool,
                             label=f"ModelRunner bucket {bucket}",
                             guard=self._guards, probe=probe)

            with profiler.Task(f"serving:compile:b{batch}"
                               f"{'' if seq is None else f's{seq}'}"):
                entry, hit = load_or_build(
                    self._cache,
                    self._cache_key(bucket) if self._cache else None,
                    build)
            if hit:
                source = "disk"
            self.compile_seconds[bucket] = time.perf_counter() - t0
            self._entries[bucket] = entry
            self._compile_sources[bucket] = source
            self._builds.built(bucket, source,
                               self.compile_seconds[bucket])
            return entry

    def _eager_entry(self, bucket: Tuple, source: str = "cold") -> Entry:
        """The bucket's graph plan run eagerly, never captured (what
        ``chip_smoke.py`` holds a captured entry against on the card).
        Takes :meth:`_entry`'s arguments, so it can stand in for it."""
        return Entry(self._forward, (), self._pool, capture=False,
                     label=f"ModelRunner eager {bucket}")

    def warmup(self, buckets: Optional[Sequence[Tuple]] = None,
               _source: str = "cold") -> Dict[Tuple, float]:
        """Build the ladder (or a subset) so no production request pays
        a capture; returns per-bucket build seconds."""
        for bucket in (buckets if buckets is not None else self.buckets()):
            self._entry(tuple(bucket), _source)
        with self._lock:
            return dict(self.compile_seconds)

    def num_compiled(self) -> int:
        with self._lock:
            return len(self._entries)

    def compile_sources(self) -> Dict[Tuple, str]:
        """Per built entry: "cold" (built with no donor's list: by
        :meth:`warmup` or by a call), "donor" (built by
        :meth:`warm_from` from a donor's handoff) or "disk" (built on a
        verified persistent-cache entry)."""
        with self._lock:
            return dict(self._compile_sources)

    def cold_compiles(self) -> int:
        """Entries built cold — zero on a replacement warmed from a
        donor or from disk that then serves only the buckets warmed."""
        with self._lock:
            return sum(1 for s in self._compile_sources.values()
                       if s == "cold")

    # -- execution --------------------------------------------------------
    def _pad_stack(self, rows: List[Dict[str, np.ndarray]],
                   bucket: Tuple) -> Tuple[torch.Tensor, ...]:
        """Per-example input dicts -> padded device tensors of the
        bucket's shape.  Batch padding repeats row 0 (keeps values in
        the embedding/index domain); sequence padding uses
        ``pad_value``."""
        batch, seq = bucket
        vals = []
        for name in self._input_names:
            shape = self._concrete_shape(name, batch, seq)
            dt = self._input_dtypes[name]
            buf = np.empty(shape, dt)
            for i, row in enumerate(rows):
                ex = np.asarray(row[name], dt)
                if ex.shape != shape[1:]:
                    pads = []
                    for d, (want, got) in enumerate(
                            zip(shape[1:], ex.shape)):
                        if got > want:
                            raise MXNetError(
                                f"serving: input {name!r} axis {d} size "
                                f"{got} exceeds bucket {want}")
                        pads.append((0, want - got))
                    ex = np.pad(ex, pads, constant_values=self._pad_value)
                buf[i] = ex
            if len(rows) < batch:
                buf[len(rows):] = buf[0]
            vals.append(torch.from_numpy(buf).to(self._device))
        return tuple(vals)

    def _dispatch(self, input_vals: Tuple[torch.Tensor, ...],
                  bucket: Tuple, n: Optional[int] = None
                  ) -> Tuple[torch.Tensor, ...]:
        """Run the bucket's entry on pre-padded device tensors; returns
        the first ``n`` rows (all, ``None``) of each output as device
        tensors of the caller's own, copied out of a captured entry's
        static outputs under its lock, before the next replay
        overwrites them."""
        entry = self._entry(tuple(bucket))
        if self._guards:
            self._churn.note_call()
        with entry.lock:
            outs = tuple(o[:n] for o in entry.run(input_vals))
            if entry.graph is not None:
                outs = tuple(o.clone() for o in outs)
        return outs

    def run_raw(self, input_vals: Tuple[torch.Tensor, ...],
                bucket: Tuple) -> Tuple[torch.Tensor, ...]:
        """One dispatch on pre-padded device tensors of ``bucket``'s
        shape; returns the outputs as device tensors of the caller's
        own."""
        return self._dispatch(input_vals, bucket)

    def _run_host(self, input_vals: Tuple[torch.Tensor, ...],
                  bucket: Tuple, n: int) -> List[np.ndarray]:
        # only the real rows cross to the host, outside the entry's
        # lock (the next replay need not wait for the copy)
        return [o.cpu().numpy()
                for o in self._dispatch(input_vals, bucket, n)]

    def infer(self, inputs: Dict[str, np.ndarray],
              seq_len: Optional[int] = None) -> List[np.ndarray]:
        """Synchronous batched inference: ``inputs`` carry a leading
        batch axis; pads to the covering bucket, runs, slices back.
        Returns host numpy arrays (one per graph output)."""
        names = self._input_names
        n = int(np.asarray(inputs[names[0]]).shape[0])
        if seq_len is None and self.seq_buckets is not None:
            seq_len = int(np.asarray(inputs[names[0]]).shape[1])
        bucket = self.bucket_for(n, seq_len)
        rows = [{name: np.asarray(inputs[name])[i] for name in names}
                for i in range(n)]
        return self._run_host(self._pad_stack(rows, bucket), bucket, n)

    def run_requests(self, requests: List[InferenceRequest],
                     now: Optional[float] = None,
                     mutate=None) -> Tuple:
        """Server path: execute one assembled same-group batch and
        scatter each request its OWN output rows (sequence axis trimmed
        back to the request's true length).  Returns (bucket, outputs)
        for stats.  ``mutate`` (host outputs -> host outputs) is the
        fault-injection seam — :mod:`.faults` corrupts results here so
        canary-based detection is exercised deterministically;
        production callers leave it None."""
        n = len(requests)
        seq = requests[0].group if self.seq_buckets is not None else None
        bucket = self.bucket_for(n, seq)
        # obs phase spans (pad/scatter, run) — gated BEFORE any
        # timing/args work so the profiler-off path is one bool read
        active = profiler.is_active()
        tids = [r.trace_id for r in requests
                if r.trace_id is not None] if active else []
        t0 = profiler._now_us() if active else 0.0
        vals = self._pad_stack([r.payload for r in requests], bucket)
        if active:
            t1 = profiler._now_us()
            obs.span(obs.SPAN_PAD_SCATTER, t0, t1 - t0, cat="serving",
                     trace_ids=tids, bucket=str(bucket), batch=n)
        host = self._run_host(vals, bucket, n)
        if active:
            obs.span(obs.SPAN_RUN, t1, profiler._now_us() - t1,
                     cat="serving", trace_ids=tids,
                     bucket=str(bucket), batch=n)
        if mutate is not None:
            host = mutate(host)
        done_t = time.monotonic() if now is None else now
        for i, r in enumerate(requests):
            row_outs = []
            for o in host:
                row = o[i]
                # un-pad the sequence axis (axis 0 of the per-example
                # view) when this output still carries the bucket length
                if (seq is not None and r.seq_len is not None
                        and row.ndim >= 1 and row.shape[0] == seq
                        and r.seq_len < seq):
                    row = row[:r.seq_len]
                row_outs.append(row)
            r._complete(row_outs, done_t)
        return bucket, host

    # -- fleet handoff -----------------------------------------------------
    def ladder_metadata(self) -> Dict[str, Any]:
        """What a draining worker hands its replacement: the ladder
        shape plus WHICH buckets were actually built (traffic-driven
        subset) and what each cost — so the replacement warms exactly
        the donor's working set instead of the full cross product."""
        with self._lock:
            compiled = sorted(self._entries)
            secs = dict(self.compile_seconds)
        return {"max_batch_size": self.max_batch_size,
                "seq_buckets": list(self.seq_buckets)
                if self.seq_buckets is not None else None,
                "compiled_buckets": [list(b) for b in compiled],
                "compile_seconds": {str(k): v for k, v in secs.items()},
                "weight_bytes": self.weight_bytes()}

    def warm_from(self, metadata: Dict[str, Any]) -> Dict[Tuple, float]:
        """Warm this (replacement) runner from a donor's
        :meth:`ladder_metadata` — builds the donor's bucket set,
        restricted to buckets this runner's own ladder actually has
        (a replacement with a different ladder warms the
        intersection)."""
        own = set(self.buckets())
        donor = [tuple(b) for b in metadata.get("compiled_buckets", [])]
        return self.warmup([b for b in donor if b in own], "donor")

    # -- introspection ----------------------------------------------------
    def weight_buffers(self) -> Tuple[torch.Tensor, ...]:
        """The device tensors every bucket's entry reads — the same
        tensors, at the same addresses, across the whole ladder."""
        return self._param_vals

    def weight_bytes(self) -> int:
        return int(sum(v.numel() * v.element_size()
                       for v in self._param_vals))


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt)).dtype
