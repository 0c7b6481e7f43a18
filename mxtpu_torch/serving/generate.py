"""KV-cache incremental decode with continuous batching and token
streaming (counterpart of ``mxtpu/serving/generate.py``).

Three pieces, with mxtpu's names and signatures:

- :class:`GenerateRunner` evaluates an incremental export (the graph of
  ``BERTModel(..., causal=True)`` called as ``net(tokens, step,
  cache)``) through the port's symbol interpreter, as a *prefill* over
  a (batch rung x prompt bucket) and as ONE *decode step* over every
  slot of a preallocated KV table.  The table is a slot table: each
  in-flight request owns a cache *lane* (axis 2 of the stacked
  ``(num_layers, 2, slots, heads, L, head_dim)`` tensor);
  ``kv_cache_write`` writes each lane at its own step and
  ``cached_attention`` masks each lane to its valid prefix, so what lies
  past a lane's frontier is never read and lane reuse needs no zeroing.
  Each bucket (every prefill rung and the decode step) gets one entry
  (:mod:`.entry`), as each gets one executable in mxtpu: on the card a
  CUDA graph captured on the KV table it runs on (one ladder for each
  of the last :data:`MAX_TABLES` tables), on the CPU the graph plan run
  eagerly.  AMP and int8 run as in :class:`.ModelRunner` (``amp=``,
  ``quant=`` with the ``quant_scales`` a ``ModelRunner.calibrate``
  gave).  mxtpu's persistent executable cache is not ported (``cache``
  raises ``TypeError``), nor is its introspection of compiled
  programs.

- :class:`GenerateRequest` is the streaming future: tokens fire through
  ``on_token`` as they are sampled, ``result()`` returns the full
  stream, and ``partial_state()`` is what a replay needs (prompt +
  already-streamed tokens + the ORIGINAL submit clock and deadline).

- :class:`GenerateBatcher` is the continuous (in-flight) batching
  policy, pure and clock-injected: each ``step(now)`` admits queued
  requests into freed lanes (join at a step boundary, grouped by prompt
  bucket, prefilled, first token sampled), runs ONE decode step over
  every slot, samples and streams one token per active lane, and
  evicts finished (EOS / max_tokens / capacity) and deadline-expired
  requests.

Sampling is host-side and replay-deterministic: greedy argmax, or top-k
seeded by ``(seed, absolute_position)``, so the same token ids come out
across runs and across a replay that resumes at the same positions.
The tracing spans and profiler tasks of mxtpu's version are left out.
"""
from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .. import guards
from .. import knobs
from ..context import resolve_device, strict_f32
from .batcher import (InferenceRequest, RequestTimeout, ServerBusy,
                      WorkerLost, _lost_for)
from .entry import Entry, GraphPool, tensor_key
from .runner import (_NOT_PORTED, batch_ladder, entry_values, scopes,
                     stage_weights)

__all__ = ["GenerateRequest", "GenerateRunner", "GenerateBatcher",
           "sample_token"]

# KV tables whose captured ladders a runner keeps on the card: a third
# table drops the ladder of the one used least recently
MAX_TABLES = 2

def sample_token(logits, *, position: int, seed: int = 0,
                 top_k: int = 1) -> int:
    """Replay-deterministic host-side sampling of ONE token.

    ``top_k <= 1`` is greedy argmax.  Otherwise the top-k logits are
    softmaxed and drawn with a generator seeded by ``(seed,
    absolute_position)`` — a pure function of (logits, seed, position),
    so a replayed generation that re-reaches the same position samples
    the SAME token whichever worker (or run) computes it."""
    row = np.asarray(logits, np.float64).reshape(-1)
    if top_k is None or top_k <= 1:
        return int(np.argmax(row))
    k = min(int(top_k), row.shape[0])
    idx = np.argpartition(row, -k)[-k:]
    # stable descending order: ties break by token id, not partition
    # order, so the distribution is identical on every platform
    idx = idx[np.lexsort((idx, -row[idx]))]
    sub = row[idx] - row[idx].max()
    p = np.exp(sub)
    p /= p.sum()
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF,
                                 int(position) & 0x7FFFFFFF])
    return int(idx[rng.choice(k, p=p)])


class GenerateRequest(InferenceRequest):
    """Streaming generation future.

    ``prompt`` is the token-id list to condition on; ``prefix`` is the
    already-streamed continuation a REPLAY resumes from (empty for a
    fresh request): the runner prefills ``prompt + prefix`` and the
    first freshly sampled token has stream index ``len(prefix)``.
    ``on_token(token, index)`` fires per emitted token; ``result()``
    returns the full stream ``prefix + new tokens``.  ``finish_reason``
    is "eos" or "length" once complete."""

    __slots__ = ("prompt", "max_tokens", "eos_id", "top_k", "seed",
                 "prefix", "on_token", "tokens", "finish_reason")

    def __init__(self, prompt: Sequence[int], *,
                 max_tokens: int, eos_id: Optional[int] = None,
                 top_k: int = 1, seed: int = 0,
                 prefix: Sequence[int] = (),
                 on_token: Optional[Callable[[int, int], None]] = None,
                 group: Any = None, t_submit: float = 0.0,
                 deadline: Optional[float] = None,
                 trace_id: Optional[str] = None):
        prompt = [int(t) for t in prompt]
        super().__init__(prompt, group=group, seq_len=len(prompt),
                         t_submit=t_submit, deadline=deadline,
                         trace_id=trace_id)
        self.prompt = prompt
        self.max_tokens = int(max_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.prefix = [int(t) for t in prefix]
        self.on_token = on_token
        # tokens emitted by THIS attempt, appended by the (single)
        # stepping thread; readers see them through partial_state() /
        # result() after completion
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None

    @property
    def emitted(self) -> int:
        """Total stream length so far (replayed prefix included)."""
        return len(self.prefix) + len(self.tokens)

    def partial_state(self) -> Dict[str, Any]:
        """What a replay needs (rides ``WorkerLost.partial`` when the
        batcher holding this request closes): the prompt, EVERY token
        streamed so far (prefix + this attempt), and the ORIGINAL
        submit clock + deadline — a replay resumes the stream and
        inherits the first attempt's deadline, it never double-bills."""
        return {"prompt": list(self.prompt),
                "tokens": list(self.prefix) + list(self.tokens),
                "t_submit": self.t_submit,
                "deadline": self.deadline}


class GenerateRunner:
    """Prefill and decode over a slot-table KV cache on one device.

    Parameters
    ----------
    symbol : mxtpu_torch.symbol.Symbol
        A 3-input incremental export (``HybridBlock.export`` of a model
        called in incremental mode, the port's or mxtpu's): inputs
        ``(tokens, step, cache)``, outputs ``(logits, new_cache)``.  The
        cache layout is ``(num_layers, 2, B, heads, L, head_dim)``, what
        ``BERTModel.kv_cache_spec`` describes.
    params : dict name -> numpy array / NDArray
        The weights (uploaded once, shared by prefill and decode).
    kv_spec : tuple
        ``net.kv_cache_spec(max_lanes, max_len)``: axis 2 is the lane
        count, axis 4 the cache capacity L.  The runner allocates ONE
        extra scratch slot (prefill batch padding scatters there; it is
        never read), so the table has ``max_lanes + 1`` slots.
    prompt_buckets : ascending ints
        Prompt-length rungs, crossed with the batch ladder of
        ``max_lanes``.  Prompts (plus replay prefixes) longer than the
        largest bucket prefill in bucket-width chunks.
    device : None (``cuda:0``; raises without CUDA) or a device such as
        ``"cpu"``.
    donate : bool, optional (env MXTPU_SERVING_DONATE, on)
        On, ``prefill``/``decode`` update the table passed in, in place,
        and return it (on the card the decode graph writes the new
        cache into the table it was captured on: that is donation);
        off, they return a new table and leave the old one intact.  Off
        is refused on the card, where a captured step would copy the
        table out of its static output every step (ROADMAP queue 1
        item 3).
    amp : policy AMP, as :class:`.ModelRunner` has it (bf16 weights,
        upcast at the entry; the KV table stays f32).
    quant, quant_scales : int8, as :class:`.ModelRunner` has it, with
        the activation thresholds of a ``ModelRunner.calibrate`` over
        the same architecture (the keys name the graph's contractions in
        dispatch order); a quantized runner without them raises when it
        builds an entry.

    On the card an entry runs only on the table it was captured on:
    each table gets its own ladder, built at its first call or by
    :meth:`warmup` with that table, so a replay never writes a table
    other than the one passed.  The ladders of the last
    :data:`MAX_TABLES` tables are kept.
    """

    def __init__(self, symbol, params: Dict[str, Any],
                 kv_spec: Sequence[int], *,
                 prompt_buckets: Sequence[int],
                 input_names: Sequence[str] = ("data0", "data1",
                                               "data2"),
                 device=None, donate: Optional[bool] = None,
                 amp=None, quant=None,
                 quant_scales: Optional[Dict[str, float]] = None,
                 **kwargs):
        from .. import amp as _amp
        from .. import quant as _quant
        for name in kwargs:
            if name in _NOT_PORTED:
                raise TypeError(
                    f"GenerateRunner: {name}= is not ported yet: "
                    f"{_NOT_PORTED[name]}")
        if kwargs:
            raise TypeError(f"GenerateRunner: unexpected arguments "
                            f"{sorted(kwargs)}")
        self._amp = _amp.resolve(amp)
        self._quant = _quant.resolve(quant)
        self._quant_scales = dict(quant_scales) if quant_scales else None
        self._symbol = symbol
        if len(input_names) != 3:
            raise MXNetError(
                "generate: input_names must be the (tokens, step, "
                "cache) triple of the incremental export")
        self._input_names = tuple(input_names)
        kv_spec = tuple(int(d) for d in kv_spec)
        self.kv_spec = kv_spec
        if len(kv_spec) != 6 or kv_spec[1] != 2:
            raise MXNetError(
                "generate: kv_spec must be (num_layers, 2, lanes, "
                "heads, L, head_dim) — use net.kv_cache_spec()")
        self.max_lanes = kv_spec[2]
        if self.max_lanes < 1:
            raise MXNetError("generate: kv_spec lane count must be >= 1")
        # one scratch slot past the lanes: prefill batch-padding rows
        # scatter there (duplicate writes are garbage by design — the
        # scratch lane is never sampled from)
        self._slots = self.max_lanes + 1
        self.scratch_slot = self.max_lanes
        self._kv_shape = kv_spec[:2] + (self._slots,) + kv_spec[3:]
        self.max_len = kv_spec[4]
        self.prompt_buckets = tuple(sorted(int(s)
                                           for s in prompt_buckets))
        if not self.prompt_buckets:
            raise MXNetError("generate: prompt_buckets must be "
                             "non-empty")
        if self.prompt_buckets[-1] > self.max_len:
            raise MXNetError(
                f"generate: largest prompt bucket "
                f"{self.prompt_buckets[-1]} exceeds KV capacity "
                f"{self.max_len}")
        self.batch_buckets = batch_ladder(self.max_lanes)
        self._device = resolve_device(device)
        self._donate = bool(knobs.get("MXTPU_SERVING_DONATE")
                            if donate is None else donate)
        self._captured = self._device.type == "cuda"
        if self._captured and not self._donate:
            raise MXNetError(
                "GenerateRunner: donate=False is not ported to the card: "
                "a captured step writes the table it was captured on "
                "(ROADMAP queue 1 item 3)")
        if self._captured:
            strict_f32()

        # -- one weight upload shared by prefill AND decode ------------
        known = set(symbol.list_inputs())
        for n in self._input_names:
            if n not in known:
                raise MXNetError(
                    f"generate: graph has no input {n!r} — pass the "
                    f"incremental export's input_names")
        self._param_names = tuple(
            n for n in params
            if n in known and n not in self._input_names)
        missing = known - set(self._param_names) \
            - set(self._input_names)
        if missing:
            raise MXNetError(
                f"generate: graph inputs {sorted(missing)} have "
                f"neither a param nor an input name")
        self._param_vals = stage_weights(self._param_names, params,
                                         self._device, self._amp)
        from ..symbol import _GraphPlan
        self._plan = _GraphPlan(symbol)
        self._pool = GraphPool(self._device)

        # table key (None on the CPU, where no entry binds a table) ->
        # bucket -> entry, least recently used table first; an entry is
        # built exactly once per table it runs on, under _lock
        self._lock = threading.Lock()
        self._tables: "OrderedDict[Any, Dict[Tuple, Entry]]" = \
            OrderedDict()  # guarded-by: _lock
        self.compile_seconds: Dict[Tuple, float] = {}  # guarded-by: _lock
        self._guards = guards.enabled()
        # a ladder for each table kept (+ slack for extra buckets)
        self._churn = guards.ChurnDetector(
            f"GenerateRunner[{type(symbol).__name__}]",
            limit=MAX_TABLES * len(self.buckets()) + 4)

    @classmethod
    def from_export(cls, symbol_file: str, params_file: str,
                    kv_spec: Sequence[int], **kwargs
                    ) -> "GenerateRunner":
        """Load an incremental export's ``-symbol.json`` and
        ``-NNNN.params`` (of this package or mxtpu's)."""
        from .. import symbol as sym_mod
        from ..ndarray import load_params
        return cls(sym_mod.load(symbol_file), load_params(params_file),
                   kv_spec, **kwargs)

    # -- buckets ---------------------------------------------------------
    def prompt_bucket_for(self, need: int) -> int:
        """Smallest prompt bucket covering ``need`` tokens — capped at
        the largest bucket (longer prefills chunk at that width)."""
        if need < 1:
            raise MXNetError("generate: empty prompt")
        for s in self.prompt_buckets:
            if s >= need:
                return s
        return self.prompt_buckets[-1]

    def batch_rung_for(self, n: int) -> int:
        if n < 1 or n > self.max_lanes:
            raise MXNetError(
                f"generate: prefill batch {n} outside 1..{self.max_lanes}")
        return next(r for r in self.batch_buckets if r >= n)

    def buckets(self) -> List[Tuple]:
        """The ladder: every (prefill, (batch, prompt)) rung plus THE
        decode step — what ``warmup()`` runs."""
        out: List[Tuple] = [("prefill", (b, s))
                            for s in self.prompt_buckets
                            for b in self.batch_buckets]
        out.append(("decode", (self._slots,)))
        return out

    def warmup(self, buckets: Optional[Sequence[Tuple]] = None,
               kv: Optional[torch.Tensor] = None) -> Dict[Tuple, float]:
        """Build each bucket's entry (the whole ladder by default), so
        no token pays a capture.  On the card an entry is captured on
        the table it runs on: pass that table as ``kv``
        (:meth:`GenerateBatcher.warmup` passes its own); the CPU needs
        none.  Returns per-entry build seconds."""
        if kv is None and self._captured:
            raise MXNetError(
                "GenerateRunner.warmup: on the card an entry is captured "
                "on the table it runs on; pass kv= (or call "
                "GenerateBatcher.warmup())")
        for kind, shp in (buckets if buckets is not None
                          else self.buckets()):
            self._entry((kind, tuple(shp)), kv)
        with self._lock:
            return dict(self.compile_seconds)

    def num_compiled(self) -> int:
        """Entries held: one per bucket built, for each table kept."""
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    # -- the entries -------------------------------------------------------
    def _prefill_fn(self, tokens, step, lane_idx, kv):
        """Gather-extend-scatter over the slot table: each row's lane
        is pulled from ``kv``, extended by its s tokens at its own step
        offset, and (donating) written back; not donating, the new
        lanes come back for the caller to scatter into a copy."""
        idx = lane_idx.to(torch.int64)
        logits, new_small = self._eval_incremental(tokens, step,
                                                   kv[:, :, idx])
        if not self._donate:
            return logits, new_small
        with torch.no_grad():
            # the padding rows all write the scratch slot: whichever
            # lands is garbage by design
            kv[:, :, idx] = new_small.to(kv.dtype)
        return (logits,)

    def _decode_fn(self, tokens, step, kv):
        """THE decode step over every slot; donating, the new table is
        written into ``kv``."""
        logits, new = self._eval_incremental(tokens, step, kv)
        if not self._donate:
            return logits, new
        with torch.no_grad():
            kv.copy_(new)
        return (logits,)

    def _entry(self, bucket: Tuple, kv: Optional[torch.Tensor]) -> Entry:
        """The bucket's entry for table ``kv``, built once (under
        ``_lock``); on the card each table has its own."""
        table = tensor_key(kv) if self._captured else None
        with self._lock:
            ladder = self._tables.get(table)
            if ladder is None:
                ladder = self._tables[table] = {}
                while len(self._tables) > MAX_TABLES:
                    self._tables.popitem(last=False)
            self._tables.move_to_end(table)
            entry = ladder.get(bucket)
            if entry is not None:
                return entry
            if self._guards:
                self._churn.note_compile(bucket)
            if self._quant and self._quant_scales is None:
                raise MXNetError(
                    "generate: quantized runner has no calibrated scales — "
                    "pass quant_scales (from a ModelRunner.calibrate over "
                    "the same architecture)")
            example = self._entry_inputs(bucket)
            fn = self._prefill_fn if bucket[0] == "prefill" \
                else self._decode_fn
            t0 = time.perf_counter()
            entry = Entry(fn, example, self._pool,
                          bound=(kv,) if self._captured else (),
                          label=f"GenerateRunner {bucket[0]} {bucket[1]}",
                          guard=self._guards)
            self.compile_seconds[bucket] = time.perf_counter() - t0
            ladder[bucket] = entry
            return entry

    def _entry_inputs(self, bucket: Tuple) -> Tuple[torch.Tensor, ...]:
        """A call's device inputs at the bucket's shapes (the padding
        rows of a prefill on the scratch slot)."""
        kind, shp = bucket
        dev = self._device
        if kind == "prefill":
            b, s = shp
            return (torch.zeros((b, s), device=dev),
                    torch.zeros((b,), device=dev),
                    torch.full((b,), float(self.scratch_slot), device=dev))
        if kind == "decode":
            return (torch.zeros((shp[0], 1), device=dev),
                    torch.zeros(shp, device=dev))
        raise MXNetError(f"generate: unknown bucket kind {kind!r}")

    def _eager_entry(self, bucket: Tuple, kv: torch.Tensor) -> Entry:
        """The bucket's graph plan run eagerly, never captured (what
        ``chip_smoke.py`` holds a captured entry against on the card)."""
        fn = self._prefill_fn if bucket[0] == "prefill" else self._decode_fn
        return Entry(fn, (), self._pool, capture=False,
                     label=f"GenerateRunner eager {bucket}")

    # -- execution --------------------------------------------------------
    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self._kv_shape, dtype=torch.float32,
                           device=self._device)

    def new_cache(self) -> torch.Tensor:
        """Fresh zeroed KV slot table on this runner's device."""
        return self._zeros()

    def _upload(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(self._device)

    def _eval_incremental(self, tokens, step, kv_small):
        """The incremental graph once, through its plan: (tokens, step,
        small cache) -> (logits, new small cache), in inference mode
        (autograd neither recording nor training), inside the AMP and
        int8 scopes the runner was built with."""
        from .. import autograd
        from ..ndarray.ndarray import NDArray
        bindings = {self._input_names[0]: NDArray(tokens),
                    self._input_names[1]: NDArray(step),
                    self._input_names[2]: NDArray(kv_small)}
        for n, v in zip(self._param_names,
                        entry_values(self._param_vals, self._amp)):
            bindings[n] = NDArray(v)
        with autograd.pause(train_mode=False), torch.no_grad(), \
                scopes(self._amp, self._quant, self._quant_scales,
                       "generate"):
            outs = self._plan.run(bindings)
        if len(outs) != 2:
            raise MXNetError(
                f"generate: incremental graph must output (logits, "
                f"cache), got {len(outs)} outputs")
        return outs[0]._data, outs[1]._data

    def prefill(self, tokens: np.ndarray, step: np.ndarray,
                lane_idx: np.ndarray, kv: torch.Tensor
                ) -> Tuple[np.ndarray, torch.Tensor]:
        """One prefill on already-bucketed host arrays: ``tokens (b,
        s)`` / ``step (b,)`` / ``lane_idx (b,)`` (the batcher pads).
        Gather-extend-scatter: each row's lane is pulled from the slot
        table, extended by its s tokens at its own step offset, and
        written back, so chunked prefill of a long prompt is repeated
        calls at advancing offsets; padding rows target the scratch
        slot.  Returns (host logits (b, s, V), the table)."""
        b, s = tokens.shape
        entry = self._entry(("prefill", (b, s)), kv)
        vals = (self._upload(tokens), self._upload(step),
                self._upload(lane_idx))
        if self._guards:
            self._churn.note_call()
        with entry.lock:
            outs = entry.run(vals, (kv,))
            logits = outs[0].cpu().numpy()
            if not self._donate:
                with torch.no_grad():
                    kv = kv.clone()
                    kv[:, :, vals[2].to(torch.int64)] = \
                        outs[1].to(kv.dtype)
        return logits, kv

    def decode(self, tokens: np.ndarray, step: np.ndarray,
               kv: torch.Tensor) -> Tuple[np.ndarray, torch.Tensor]:
        """THE decode step: ``tokens (slots, 1)`` / ``step (slots,)``
        advance every slot one position.  Returns (host logits (slots,
        1, V), the table)."""
        entry = self._entry(("decode", (self._slots,)), kv)
        vals = (self._upload(tokens), self._upload(step))
        if self._guards:
            self._churn.note_call()
        with entry.lock:
            outs = entry.run(vals, (kv,))
            logits = outs[0].cpu().numpy()
        if not self._donate:  # the CPU only: the step's new table
            kv = outs[1]
        return logits, kv

    # -- introspection ----------------------------------------------------
    def weight_buffers(self) -> Tuple[torch.Tensor, ...]:
        return self._param_vals

    def weight_bytes(self) -> int:
        return int(sum(v.numel() * v.element_size()
                       for v in self._param_vals))


class _Lane:
    """One in-flight generation: the lane's cache frontier (tokens
    written so far) and the last sampled token (next decode input)."""

    __slots__ = ("req", "frontier", "last_token", "t_last")

    def __init__(self, req: GenerateRequest, frontier: int,
                 last_token: int, t_last: float):
        self.req = req
        self.frontier = frontier
        self.last_token = last_token
        self.t_last = t_last


class GenerateBatcher:
    """Continuous (in-flight) batching over a :class:`GenerateRunner`.

    Pure, clock-injected policy: ``submit()`` enqueues, ``step(now)``
    advances the whole slot table one decode step — admitting queued
    requests into freed lanes at the step boundary first (prompt-
    bucket-grouped prefill, first token sampled from the last valid
    prompt position), then ONE decode over all slots, then per-lane
    sampling, streaming, and eviction (EOS / max_tokens / KV capacity /
    deadline).  No wall time, no threads — fake-clock tests drive it
    step by step; the server wraps it in a stepping thread.

    Lock order: ``_step_lock`` (one stepper at a time) -> ``_cond``
    (queue + lane table); the runner's calls run OUTSIDE ``_cond`` so
    submit never blocks on the device."""

    def __init__(self, runner: GenerateRunner, *,
                 max_queue: Optional[int] = None,
                 max_lanes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 stats=None,
                 default_max_tokens: Optional[int] = None,
                 stream: Optional[bool] = None,
                 on_timeout: Optional[Callable[[int], None]] = None):
        self.runner = runner
        # operational width cap (MXTPU_GEN_MAX_LANES): the runner's KV
        # table is sized at export time; this narrows how many of its
        # lanes continuous batching may occupy at once (the decode step
        # still spans all slots)
        self.max_lanes = max(1, min(
            runner.max_lanes,
            int(max_lanes if max_lanes is not None
                else knobs.get("MXTPU_GEN_MAX_LANES"))))
        self.max_queue = int(max_queue) if max_queue is not None \
            else 8 * runner.max_lanes
        self._clock = clock
        self._stats = stats
        self.default_max_tokens = int(
            default_max_tokens if default_max_tokens is not None
            else knobs.get("MXTPU_GEN_MAX_TOKENS"))
        self.stream = bool(knobs.get("MXTPU_GEN_STREAM")
                           if stream is None else stream)
        self._on_timeout = on_timeout
        self._step_lock = threading.Lock()
        self._cond = threading.Condition()
        self._queue: List[GenerateRequest] = []  # guarded-by: _cond
        # guarded-by: _cond
        self._lanes: List[Optional[_Lane]] = [None] * self.max_lanes
        self._closed = False  # guarded-by: _cond
        self._joins = 0       # guarded-by: _cond — lifetime lane claims
        self._steps = 0       # guarded-by: _cond — decode steps run
        # the slot table; only the stepping thread touches it (single
        # stepper enforced by _step_lock)
        self._kv = None  # guarded-by: _step_lock

    def warmup(self, buckets: Optional[Sequence[Tuple]] = None
               ) -> Dict[Tuple, float]:
        """Build the runner's entries (the whole ladder by default) on
        this batcher's slot table, taken now if it has none, so no
        request pays a capture; returns the runner's per-entry build
        seconds."""
        with self._step_lock:
            if self._kv is None:
                self._kv = self.runner.new_cache()
            return self.runner.warmup(buckets, kv=self._kv)

    # -- submit side ------------------------------------------------------
    def submit(self, prompt: Sequence[int], *,
               max_tokens: Optional[int] = None,
               eos_id: Optional[int] = None, top_k: int = 1,
               seed: int = 0, prefix: Sequence[int] = (),
               timeout_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> GenerateRequest:
        """Enqueue one generation; it joins the running decode batch at
        the next step boundary with a free lane.  ``prefix`` seeds a
        replay (already-streamed tokens — prefilled, not re-emitted).
        Raises :class:`ServerBusy` when the bounded queue is full."""
        now = self._clock()
        prompt = [int(t) for t in prompt]
        prefix = [int(t) for t in prefix]
        if not prompt:
            raise MXNetError("generate: empty prompt")
        need = len(prompt) + len(prefix)
        if need >= self.runner.max_len:
            raise MXNetError(
                f"generate: prompt+prefix ({need}) fills the KV "
                f"capacity ({self.runner.max_len}) — nothing left to "
                f"generate")
        mt = int(max_tokens if max_tokens is not None
                 else self.default_max_tokens)
        if mt <= len(prefix):
            raise MXNetError(
                f"generate: max_tokens {mt} already exhausted by the "
                f"replayed prefix ({len(prefix)} tokens)")
        req = GenerateRequest(
            prompt, max_tokens=mt, eos_id=eos_id, top_k=top_k,
            seed=seed, prefix=prefix, on_token=on_token,
            group=self.runner.prompt_bucket_for(need), t_submit=now,
            deadline=None if timeout_s is None else now + timeout_s,
            trace_id=trace_id)
        with self._cond:
            if self._closed:
                raise WorkerLost(
                    "generate: batcher is closed (worker shut down "
                    "or lost) — resubmit elsewhere")
            if len(self._queue) >= self.max_queue:
                raise ServerBusy(
                    f"generate: queue full ({self.max_queue} "
                    f"waiting); retry with backoff")
            self._queue.append(req)
            self._cond.notify()
        return req

    # -- accounting -------------------------------------------------------
    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def free_lanes(self) -> int:
        with self._cond:
            return sum(1 for l in self._lanes if l is None)

    def active(self) -> Dict[int, GenerateRequest]:
        """Lane table snapshot: {lane index: request}."""
        with self._cond:
            return {i: l.req for i, l in enumerate(self._lanes)
                    if l is not None}

    @property
    def joins(self) -> int:
        """Lifetime lane claims (a request joining the running batch
        bumps this exactly once)."""
        with self._cond:
            return self._joins

    @property
    def steps(self) -> int:
        with self._cond:
            return self._steps

    def oldest_waiting_age(self, now: Optional[float] = None
                           ) -> Optional[float]:
        with self._cond:
            if not self._queue:
                return None
            return (self._clock() if now is None else now) \
                - self._queue[0].t_submit

    # -- the step ---------------------------------------------------------
    def step(self, now: Optional[float] = None) -> Dict[str, int]:
        """Advance the whole batch one decode step; returns counters
        ``{"admitted", "active", "emitted", "finished"}``.  The join
        point for queued requests AND the eviction point for finished/
        expired ones — continuous batching is exactly this loop."""
        with self._step_lock:
            now = self._clock() if now is None else now
            # (req, token, stream index, is_first, seconds since the
            # request's previous emission) — fired outside all locks
            emissions: List[Tuple[GenerateRequest, int, int, bool,
                                  float]] = []
            finished: List[GenerateRequest] = []
            # (req, final value): resolved AFTER _fire so a done-callback
            # observes a fully delivered stream
            completions: List[Tuple[GenerateRequest, List[int]]] = []
            with self._cond:
                if self._closed:
                    return {"admitted": 0, "active": 0, "emitted": 0,
                            "finished": 0}
                self._expire_queued_locked(now)
                self._evict_deadlines_locked(now, finished)
                admitted = self._admit_locked(now)
            if admitted:
                self._prefill_locked(admitted, now, emissions, finished,
                                     completions)
            with self._cond:
                active = [(i, l) for i, l in enumerate(self._lanes)
                          if l is not None]
            n_active = len(active)
            if active:
                self._decode_locked(active, now, emissions, finished,
                                    completions)
            self._fire(emissions)
            for r, value in completions:
                r._complete(value, now)
            return {"admitted": len(admitted), "active": n_active,
                    "emitted": len(emissions),
                    "finished": len(finished)}

    def _finish_reason(self, r: GenerateRequest, lane: _Lane
                       ) -> Optional[str]:
        """Evaluated right after each emission: EOS terminates the
        stream; ``max_tokens`` and KV capacity (no room left to write
        the token just emitted) finish as "length"."""
        if r.eos_id is not None and lane.last_token == r.eos_id:
            return "eos"
        if r.emitted >= r.max_tokens:
            return "length"
        if lane.frontier >= self.runner.max_len:
            return "length"
        return None

    def _expire_queued_locked(self, now: float) -> None:
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        if not expired:
            return
        self._queue = [r for r in self._queue if r not in expired]
        if self._on_timeout is not None:
            self._on_timeout(len(expired))
        for r in expired:
            r._fail(RequestTimeout(
                "generate: deadline expired while queued"), now)

    def _evict_deadlines_locked(self, now: float,
                                finished: List[GenerateRequest]
                                ) -> None:
        """Mid-decode deadline eviction: an expired lane frees at the
        step boundary — its caller gets RequestTimeout, never a late
        stream."""
        n_evicted = 0
        for i, lane in enumerate(self._lanes):
            if lane is None:
                continue
            r = lane.req
            if r.deadline is not None and now > r.deadline:
                self._lanes[i] = None
                n_evicted += 1
                r._fail(RequestTimeout(
                    f"generate: deadline expired mid-decode after "
                    f"{r.emitted} tokens"), now)
                finished.append(r)
        if n_evicted and self._on_timeout is not None:
            self._on_timeout(n_evicted)

    def _admit_locked(self, now: float
                      ) -> List[Tuple[int, GenerateRequest]]:
        """Claim freed lanes for the oldest queued requests — one
        prompt-bucket group per step (FIFO head priority)."""
        free = [i for i, l in enumerate(self._lanes) if l is None]
        if not free or not self._queue:
            return []
        head = self._queue[0]
        take = [r for r in self._queue
                if r.group == head.group][:len(free)]
        taken = set(map(id, take))
        self._queue = [r for r in self._queue if id(r) not in taken]
        pairs = []
        for r in take:
            lane = free.pop(0)
            r.t_dequeue = now
            self._joins += 1
            pairs.append((lane, r))
        return pairs

    def _prefill_locked(self, pairs: List[Tuple[int, GenerateRequest]],
                        now: float, emissions, finished,
                        completions) -> None:
        """Prefill the joiners' prompts (+ replay prefixes) into their
        claimed lanes and sample each one's first token.  Prompts
        longer than the bucket chunk at bucket width; batch padding
        rows target the scratch slot.  The runner's calls run outside
        ``_cond``; the lane-table commit reacquires it."""
        runner = self.runner
        if self._kv is None:
            self._kv = runner.new_cache()
        s = pairs[0][1].group
        b = runner.batch_rung_for(len(pairs))
        full = [r.prompt + r.prefix for _, r in pairs]
        need = [len(f) for f in full]
        chunks = max(1, math.ceil(max(need) / s))
        first_logits: List[Optional[np.ndarray]] = [None] * len(pairs)
        for c in range(chunks):
            base = c * s
            tokens = np.zeros((b, s), np.float32)
            step = np.zeros((b,), np.float32)
            lidx = np.full((b,), runner.scratch_slot, np.float32)
            for row, (lane, r) in enumerate(pairs):
                if base >= need[row]:
                    continue  # this row finished in an earlier chunk
                valid = min(s, need[row] - base)
                tokens[row, :valid] = full[row][base:base + valid]
                step[row] = base
                lidx[row] = lane
            logits, self._kv = runner.prefill(tokens, step, lidx,
                                              self._kv)
            for row in range(len(pairs)):
                last = need[row] - 1
                if base <= last < base + s:
                    first_logits[row] = logits[row, last - base]
        with self._cond:
            if self._closed:
                # the batcher closed between admit and commit: these
                # joiners were already off the queue, so close() could
                # not see them — fail them here, with partial state
                # (nothing emitted yet) for a replay
                err = WorkerLost("generate: batcher closed during "
                                 "prefill")
                for _, r in pairs:
                    if not r.done():
                        r._fail(_lost_for(r, err), now)
                        finished.append(r)
                return
            for row, (lane, r) in enumerate(pairs):
                pos = need[row]  # absolute position of the 1st new token
                tok = sample_token(first_logits[row], position=pos,
                                   seed=r.seed, top_k=r.top_k)
                ln = _Lane(r, frontier=need[row], last_token=tok,
                           t_last=now)
                r.tokens.append(tok)
                emissions.append((r, tok, len(r.prefix), True,
                                  now - r.t_submit))
                reason = self._finish_reason(r, ln)
                if reason is not None:
                    r.finish_reason = reason
                    completions.append(
                        (r, list(r.prefix) + list(r.tokens)))
                    finished.append(r)
                else:
                    self._lanes[lane] = ln
            self._cond.notify_all()

    def _decode_locked(self, active: List[Tuple[int, _Lane]], now: float,
                       emissions, finished, completions) -> None:
        """ONE decode over the whole slot table (each lane's last token
        written at its own frontier), then per-lane sampling, finish
        evaluation, and lane release."""
        runner = self.runner
        slots = runner.max_lanes + 1
        tokens = np.zeros((slots, 1), np.float32)
        steps = np.zeros((slots,), np.float32)
        for i, lane in active:
            tokens[i, 0] = lane.last_token
            steps[i] = lane.frontier
        logits, self._kv = runner.decode(tokens, steps, self._kv)
        done: List[Tuple[int, _Lane, str]] = []
        for i, lane in active:
            r = lane.req
            lane.frontier += 1   # last_token is now in the cache
            dt = now - lane.t_last
            pos = lane.frontier  # absolute position of the new token
            tok = sample_token(logits[i, 0], position=pos,
                               seed=r.seed, top_k=r.top_k)
            lane.last_token = tok
            lane.t_last = now
            r.tokens.append(tok)
            emissions.append((r, tok, r.emitted - 1, False, dt))
            reason = self._finish_reason(r, lane)
            if reason is not None:
                done.append((i, lane, reason))
        with self._cond:
            self._steps += 1
            for i, lane, reason in done:
                if self._lanes[i] is lane:
                    self._lanes[i] = None
                r = lane.req
                r.finish_reason = reason
                completions.append(
                    (r, list(r.prefix) + list(r.tokens)))
                finished.append(r)
            self._cond.notify_all()

    def _fire(self, emissions) -> None:
        """Stream callbacks + per-token stats, OUTSIDE every lock
        (on_token is arbitrary user code)."""
        stats = self._stats
        for r, tok, index, is_first, dt in emissions:
            if stats is not None:
                if is_first and not r.prefix:
                    # true time-to-first-token: submit -> first emit
                    stats.record_ttft(max(0.0, dt) * 1e6)
                else:
                    stats.record_token(max(0.0, dt) * 1e6)
            if self.stream and r.on_token is not None:
                try:
                    r.on_token(tok, index)
                except Exception:  # noqa: BLE001 — a stream consumer
                    pass           # must never poison the decode loop

    # -- wind-down ---------------------------------------------------------
    def drain(self) -> bool:
        with self._cond:
            return not self._queue and all(
                l is None for l in self._lanes)

    def close(self, error: Optional[BaseException] = None) -> None:
        """Fail everything queued AND every in-flight lane with a
        :class:`WorkerLost` carrying each request's partial-generation
        state (``partial_state()``), so a replay can resume the stream
        elsewhere.  No waiter is left hanging."""
        with self._cond:
            self._closed = True
            now = self._clock()
            err = error if error is not None else WorkerLost(
                "generate: batcher closed — worker lost before the "
                "stream completed")
            for r in self._queue:
                r._fail(_lost_for(r, err), now)
            self._queue.clear()
            for i, lane in enumerate(self._lanes):
                if lane is not None and not lane.req.done():
                    lane.req._fail(_lost_for(lane.req, err), now)
                self._lanes[i] = None
            self._cond.notify_all()
