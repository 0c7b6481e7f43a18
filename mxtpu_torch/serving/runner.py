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
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .. import guards
from .. import knobs
from ..context import resolve_device, strict_f32
from .batcher import InferenceRequest
from .entry import Entry, GraphPool

__all__ = ["ModelRunner", "batch_ladder"]

# mxtpu's runner arguments this port refuses when set: the ROADMAP item
# that brings each
_NOT_PORTED = {"cache": "the persistent executable cache (ROADMAP "
                        "queue 1 item 3)"}


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


def refuse_not_ported(who: str, cache: Any) -> None:
    """``TypeError`` for an mxtpu runner option the port has not got:
    an explicit cache object."""
    if cache not in (None, "auto"):
        raise TypeError(f"{who}: cache= is not ported yet: "
                        f"{_NOT_PORTED['cache']}")


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
    donate : accepted for mxtpu's signature; a bucket's entry always
        reuses its own input buffers.
    cache : "auto" or None (both inert until ``cache.py`` is ported);
        an explicit cache object raises ``TypeError``.
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
        refuse_not_ported("ModelRunner", cache)
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
        self._guards = guards.enabled()
        # one build per ladder rung is the design; anything past the
        # ladder (+ slack for explicit extra warmup buckets) is churn
        self._churn = guards.ChurnDetector(
            f"ModelRunner[{type(symbol).__name__}]",
            limit=len(self.buckets()) + 4)

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

    # -- the persistent cache (not ported) --------------------------------
    def cached_buckets(self) -> List[Tuple]:
        """The ladder's buckets in the persistent cache: none until
        ``cache.py`` is ported."""
        return []

    def warm_from_disk(self) -> Dict[Tuple, float]:
        """Warm what the persistent cache holds: nothing until
        ``cache.py`` is ported."""
        return {}

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

    def _entry(self, bucket: Tuple) -> Entry:
        """Build (once) and return the bucket's entry.  Holding
        ``_lock`` across the build trades warmup parallelism for the
        exactly-once contract: two worker threads hitting the same cold
        bucket would otherwise both capture it."""
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
            t0 = time.perf_counter()
            entry = Entry(self._forward, self._example(bucket), self._pool,
                          label=f"ModelRunner bucket {bucket}",
                          guard=self._guards)
            self.compile_seconds[bucket] = time.perf_counter() - t0
            self._entries[bucket] = entry
            return entry

    def _eager_entry(self, bucket: Tuple) -> Entry:
        """The bucket's graph plan run eagerly, never captured (what
        ``chip_smoke.py`` holds a captured entry against on the card)."""
        return Entry(self._forward, (), self._pool, capture=False,
                     label=f"ModelRunner eager {bucket}")

    def warmup(self, buckets: Optional[Sequence[Tuple]] = None
               ) -> Dict[Tuple, float]:
        """Build the ladder (or a subset) so no production request pays
        a capture; returns per-bucket build seconds."""
        for bucket in (buckets if buckets is not None else self.buckets()):
            self._entry(tuple(bucket))
        with self._lock:
            return dict(self.compile_seconds)

    def num_compiled(self) -> int:
        with self._lock:
            return len(self._entries)

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
                     now: Optional[float] = None) -> Tuple:
        """Server path: execute one assembled same-group batch and
        scatter each request its OWN output rows (sequence axis trimmed
        back to the request's true length).  Returns (bucket, outputs)
        for stats."""
        n = len(requests)
        seq = requests[0].group if self.seq_buckets is not None else None
        bucket = self.bucket_for(n, seq)
        vals = self._pad_stack([r.payload for r in requests], bucket)
        host = self._run_host(vals, bucket, n)
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
        return self.warmup([b for b in donor if b in own])

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
